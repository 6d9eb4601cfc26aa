"""The flat engine's ordered accumulate and trace loop of
csrc/flat_sweep.cuh rehearsed on the host (tests/rehearsal_host.py), bit
for bit (torch.equal) against the engine's plain functions (ops/
raytrace.py's Raytracer: _accumulate and the plain loop
flat_trace_sweep_ref), the loop also in device batches of several batches'
sources. The accumulate is held to the plain function as it runs and to the
ordered adds of atomicAdd on the card, which flush float32's subnormal
inputs and results to zero (the host's add.rn.ftz.f32 stand-in); the loop
to the plain loop with the card's arithmetic (rehearsal_flat.py's
_card_arithmetic: glibc's log10 and exp, a division by a Python number as
ATen's CUDA kernels compute it)."""

import numpy as np
import pytest
import torch

from rehearsal_flat import (CASES, DR, DTYPES, PLANS, _card_arithmetic,
                           _case, _dr, _forms, _ftz, _host, _nan)
from rehearsal_host import lib  # noqa: F401


@pytest.mark.parametrize("heat", [False, True])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_flat_accumulate_on_the_host_matches_plain(lib, case, dt, heat):
    """flat_accumulate_kernel (its rows and blocks in either order) bit for
    bit against the plain ordered accumulate (index_add_ source after
    source) of rates over twelve decades into grids that already hold
    values, where a grid cell takes the rates of several sources (two of
    them at one cell)."""
    rt, _, _, pos, _ = _case(case, dt, "heat" if heat else "tables")
    N, B = rt.config.N, pos.shape[1]
    rng = np.random.RandomState(N + B)
    C = rt.geom_np.num_cells

    def rand(*shape, lo=-22.0, hi=-10.0):
        return torch.from_numpy(10 ** rng.uniform(lo, hi, shape)).to(dt)
    vals = [rand(B, C) for _ in range(2)]
    start = [rand(N ** 3, lo=-14.0, hi=-11.0) for _ in range(2)]
    lin = rt._lin_idx(pos[0])
    want = [s.clone() for s in start]
    for g, v in zip(want[:1 + heat], vals):
        rt._accumulate(g, lin, v)
    cover = torch.zeros(N ** 3, dtype=torch.int64)
    for b in range(B):
        cover[lin[b]] += 1
    assert int(cover.max()) >= 2
    for reverse in (0, 1):
        got = [s.clone() for s in start]
        _host(lib, rt, 2, dict(phi=vals[0], heat=vals[1] if heat else None,
                               phi_grid=got[0],
                               heat_grid=got[1] if heat else None),
              pos[0], threads=64, reverse=reverse)
        assert torch.equal(got[0], want[0]), reverse
        assert torch.equal(got[1], want[1]), reverse


@pytest.mark.parametrize("heat", [False, True])
@pytest.mark.parametrize("case", ["N16_R4", "N24_box"])
def test_flat_accumulate_on_the_host_flushes_float32_subnormals(lib, case,
                                                               heat):
    """The float32 accumulate with subnormal rates planted among normal
    ones, and grid cells that start subnormal, bit for bit against the
    ordered adds of atomicAdd on the card (add.rn.ftz.f32: each add's
    inputs and its result flushed to zero where subnormal), source after
    source in batch order; the host's plain index_add_, which keeps
    subnormals, gives other bits there."""
    dt = torch.float32
    rt, _, _, pos, _ = _case(case, dt, "heat" if heat else "tables")
    N, B = rt.config.N, pos.shape[1]
    C = rt.geom_np.num_cells
    rng = np.random.RandomState(7 * N + B)
    tiny = float(torch.finfo(dt).tiny)

    def rates():
        v = 10 ** rng.uniform(-38.5, -36.0, (B, C))
        v[rng.uniform(size=(B, C)) < 0.5] *= 1e-3        # subnormal
        return torch.from_numpy(v).to(dt)
    vals = [rates() for _ in range(2)]
    start = [torch.from_numpy(10 ** rng.uniform(-39.5, -37.5, N ** 3)).to(dt)
             for _ in range(2)]
    assert bool((vals[0].abs() < tiny).any() & (vals[0] > 0).any())
    assert bool((start[0] < tiny).any())
    lin = rt._lin_idx(pos[0])
    want = [s.clone() for s in start]
    plain = [s.clone() for s in start]
    for g, p, v in zip(want[:1 + heat], plain[:1 + heat], vals):
        for b in range(B):
            g[lin[b]] = _ftz(_ftz(g[lin[b]]) + _ftz(v[b]))
        rt._accumulate(p, lin, v)
    assert not torch.equal(plain[0], want[0])
    got = [s.clone() for s in start]
    _host(lib, rt, 2, dict(phi=vals[0], heat=vals[1] if heat else None,
                           phi_grid=got[0],
                           heat_grid=got[1] if heat else None),
          pos[0], threads=64)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("mode", ["grey", "tables", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_flat_loop_on_the_host_matches_plain(lib, monkeypatch, case, dt,
                                             mode):
    """The loop's two batches (sweep, rates, accumulate each, on the
    scratch of one batch) bit for bit against flat_trace_sweep_ref: Gamma
    and with ``heat`` the heating rate, under a cluster size per case."""
    rt, nd, xh, pos, flux = _case(case, dt, mode)
    _card_arithmetic(monkeypatch, dt)
    want = rt.flat_trace_sweep_ref(nd, xh, pos, flux, DR)
    sdr3 = rt._s_over_dr3(_dr(rt))
    monkeypatch.undo()
    nhi = nd * (1.0 - xh)
    B = pos.shape[1]
    grids = [torch.zeros_like(nhi) for _ in range(2)]
    io = dict(nhi=nhi, flux=flux, sdr3=sdr3, cd=_nan(rt, B),
              phi=_nan(rt, B), phi_grid=grids[0])
    if mode == "heat":
        io.update(heat=_nan(rt, B), heat_grid=grids[1])
    cluster, threads = PLANS[list(CASES).index(case) + 1]
    placement = ["ring", "global_"][list(CASES).index(case) % 2]
    _host(lib, rt, 3, io, pos, cluster, threads,
          form=_forms(lib)[placement])
    assert float(want[0].max()) > 0.0
    assert torch.equal(grids[0], want[0])
    if mode == "heat":
        assert torch.equal(grids[1], want[1])
    else:
        assert want[1] is None and not bool(grids[1].any())


@pytest.mark.parametrize("mode", ["tables", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["N16_R4", "N24_box"])
def test_flat_loop_on_the_host_in_device_batches(lib, monkeypatch, case, dt,
                                                 mode):
    """The loop with its two batches swept, rated and accumulated as one
    device batch of 2 B sources (the loop's chunk of two: the sources of
    consecutive batches at once, the accumulate in source order) bit for
    bit against flat_trace_sweep_ref over the two batches one after the
    other."""
    rt, nd, xh, pos, flux = _case(case, dt, mode)
    _card_arithmetic(monkeypatch, dt)
    want = rt.flat_trace_sweep_ref(nd, xh, pos, flux, DR)
    sdr3 = rt._s_over_dr3(_dr(rt))
    monkeypatch.undo()
    nhi = nd * (1.0 - xh)
    nb, B = pos.shape[:2]
    grids = [torch.zeros_like(nhi) for _ in range(2)]
    io = dict(nhi=nhi, flux=flux.reshape(1, nb * B), sdr3=sdr3,
              cd=_nan(rt, nb * B), phi=_nan(rt, nb * B), phi_grid=grids[0])
    if mode == "heat":
        io.update(heat=_nan(rt, nb * B), heat_grid=grids[1])
    _host(lib, rt, 3, io, pos.reshape(1, nb * B, 3), 2, 16)
    assert torch.equal(grids[0], want[0])
    if mode == "heat":
        assert torch.equal(grids[1], want[1])
