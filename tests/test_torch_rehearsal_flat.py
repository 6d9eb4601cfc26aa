"""The flat engine's kernels of csrc/flat_sweep.cuh rehearsed on the host
(tests/rehearsal_host.py): the gather, the sweep, the rate pass, the
ordered accumulate and the trace loop, bit for bit (torch.equal) against
the engine's plain functions (ops/raytrace.py's Raytracer: _gather,
_sweep, _rates, _accumulate and the plain loop flat_trace_sweep_ref), and
the forms of csrc/flat_probe.cu that chip_smoke 3d's design steps time.

The gather and the sweep (its column densities in the ring in distributed
shared memory or in global memory, and the forms the probe measures) are
held to the plain functions as they run; the accumulate and the loop are in
test_torch_rehearsal_flat_loop.py, the shared code in rehearsal_flat.py.
The rate pass and the loop are held to them with the card's arithmetic
where the CPU's differs from it: glibc's log10 and exp (the functions the
host build of the kernels calls) in place of torch's vectorized ones, and a
division by a Python number as ATen's CUDA kernels compute it (a multiply
by the reciprocal, formed in double and rounded to the type; on the CPU
ATen divides)."""

import numpy as np
import pytest
import torch

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.geometry import _corner_tables
from rehearsal_flat import (CASES, DTYPES, PLANS, PROBE_ROWS, SIG, _card_arithmetic,
                           _case, _dr, _forms, _host, _nan)
from rehearsal_host import lib  # noqa: F401


def test_plans_cover_every_cluster_size():
    assert sorted(c for c, _ in PLANS) == sorted(sweep.CLUSTERS)


@pytest.mark.parametrize("placement", ["ring", "global_"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_flat_sweep_on_the_host_matches_plain(lib, case, dt, placement):
    """flat_sweep_kernel at every cluster size (its clusters in either
    order) bit for bit against the plain gather and sweep, its column
    densities in the ring in distributed shared memory or in global memory:
    every cell of every source's octahedron written (the outputs and the
    gathered nHI start as NaN, the ring as the bytes 0xee). The mesh of 24
    has shells wider than the threads of every cluster, those of 1 and 2
    blocks by tens of cells a thread; the whole boxes' shells reach back to
    the source cell and to corners clipped out of the table."""
    rt, nd, xh, pos, _ = _case(case, dt, "tables")
    nhi = nd * (1.0 - xh)
    want = rt._sweep(rt._gather(nhi, pos[0])[1], _dr(rt))
    assert bool(torch.isfinite(want).all())
    form = _forms(lib)[placement]
    for k, (cluster, threads) in enumerate(PLANS):
        cd = _nan(rt, pos.shape[1])
        _host(lib, rt, 0, dict(nhi=nhi, cd=cd), pos[0], cluster, threads,
              reverse=k % 2, form=form)
        assert torch.equal(cd, want), (cluster, threads)


@pytest.mark.parametrize("row", PROBE_ROWS)
def test_flat_probe_forms_on_the_host_match_plain(lib, row):
    """The forms of the sweep that the probe measures (chip_smoke 3d's
    design steps) bit for bit against the plain sweep, at two cluster
    sizes, float64."""
    form = _forms(lib)["probe"][row]
    rt, nd, xh, pos, _ = _case("N24_box", torch.float64, "tables")
    nhi = nd * (1.0 - xh)
    want = rt._sweep(rt._gather(nhi, pos[0])[1], _dr(rt))
    for cluster, threads in PLANS[1:3]:
        cd = _nan(rt, pos.shape[1])
        _host(lib, rt, 0, dict(nhi=nhi, cd=cd), pos[0], cluster, threads,
              form=form)
        assert torch.equal(cd, want), (form, cluster)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_flat_gather_on_the_host_matches_plain(lib, case, dt):
    """flat_gather_kernel (a block a slab and band of rows, staged through
    shared memory, whole warps writing the runs; its blocks and rows in
    either order) bit for bit against the plain gather: every cell of every
    source's octahedron written (the output starts as NaN, the shared
    memory as the bytes 0xee), clipped octahedra and whole boxes, sources
    that wrap on every axis. The probe's forms (the grid-order one, a
    thread a cell in octahedral order, the first staged form, 8 or 16 loads
    in flight a lane) too."""
    rt, nd, xh, pos, _ = _case(case, dt, "tables")
    nhi = nd * (1.0 - xh)
    for b in range(pos.shape[0]):
        want = rt._gather(nhi, pos[b])[1]
        # the engine's form in both batches; the probe's in float64, batch 0
        forms = ((32, b, 2),) if b or dt != torch.float64 else (
            (32, 0, 2), (64, 1, 4), (32, 0, 5), (32, 1, 3), (40, 1, 0),
            (40, 0, 1))
        for threads, reverse, form in forms:
            out = _nan(rt, pos.shape[1])
            _host(lib, rt, 4, dict(nhi=nhi, nhi_octa=out), pos[b],
                  threads=threads, reverse=reverse, form=form)
            assert torch.equal(out, want), (b, threads, form)


def _rates_case(case, dt, mode):
    """The plain rate pass's inputs of batch 0 (a cell past MAX_COLDENSH
    among them) and its result under the card's arithmetic."""
    rt, nd, xh, pos, flux = _case(case, dt, mode)
    nhi = nd * (1.0 - xh)
    nhi_octa = rt._gather(nhi, pos[0])[1]
    cd = rt._sweep(nhi_octa, _dr(rt))
    cd[1, 5] = 1e31
    return rt, nhi, pos, flux, nhi_octa, cd


@pytest.mark.parametrize("mode", ["grey", "tables", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["N16_R4", "N24_box"])
def test_flat_rates_on_the_host_matches_plain(lib, monkeypatch, case, dt,
                                              mode):
    """flat_rates_kernel (its rows and blocks in either order) on the
    gathered nHI bit for bit
    against the plain rate pass on the plain sweep's column densities at
    every rated cell, with a cell past MAX_COLDENSH, the zero-density cell
    and a zero flux: Gamma and with ``heat`` the heating rate per HI atom;
    thin and thick cells. Its outputs start as NaN and it writes the rated
    cells alone: every other cell (R inside the mesh) is still NaN, where
    the plain pass has +0."""
    rt, nhi, pos, flux, nhi_octa, cd = _rates_case(case, dt, mode)
    _card_arithmetic(monkeypatch, dt)
    sdr3 = rt._s_over_dr3(_dr(rt))
    want = rt._rates(cd, nhi_octa, flux[0], _dr(rt))
    monkeypatch.undo()
    dtau = nhi_octa * rt.tables.path * _dr(rt) * SIG
    assert bool((dtau > 1e-7).any()) and bool((dtau < 1e-7).any())
    assert (want[1] is not None) == (mode == "heat")
    rated = rt.tables.rated
    assert bool(rated.all()) == (case == "N24_box")
    for threads, reverse in ((64, 0), (7, 1)):
        phi, heat = _nan(rt, pos.shape[1]), _nan(rt, pos.shape[1])
        _host(lib, rt, 1, dict(nhi_octa=nhi_octa, flux=flux[0], sdr3=sdr3,
                               cd=cd, phi=phi,
                               heat=heat if mode == "heat" else None),
              pos[0], threads=threads, reverse=reverse)
        for got, ref in ((phi, want[0]), (heat, want[1])):
            if ref is None:
                continue
            assert torch.equal(got[:, rated], ref[:, rated]), reverse
            assert bool(got[:, ~rated].isnan().all())
            assert bool((ref[:, ~rated] == 0.0).all())
    assert float(want[0][1, 5]) == 0.0 and float(want[0].max()) > 0.0
    assert not bool(want[0][-1].any())                  # zero flux
    zero = nhi_octa == 0.0
    assert bool(zero.any()) and not bool(want[0][zero].any())


@pytest.mark.parametrize("heat", [False, True])
def test_flat_rate_forms_on_the_host_match_plain(lib, monkeypatch, heat):
    """The rate pass's forms that chip_smoke 3d's design steps time
    (csrc/flat_probe.cu's FLAT_RATE_FORMS: the first form, nHI from the gathered
    layout, the rated cells' list, K sources a thread, the shared lookups)
    bit for bit against the plain rate pass, float64, R inside the mesh:
    the forms over every cell write every cell, those over the list the
    rated cells alone (the rest stays NaN)."""
    dt = torch.float64
    rt, nhi, pos, flux, nhi_octa, cd = _rates_case(
        "N16_R4", dt, "heat" if heat else "tables")
    _card_arithmetic(monkeypatch, dt)
    sdr3 = rt._s_over_dr3(_dr(rt))
    want = rt._rates(cd, nhi_octa, flux[0], _dr(rt))
    monkeypatch.undo()
    rated = rt.tables.rated
    forms = _forms(lib)["rates"]
    assert len(forms) == 10
    for form in forms:
        phi, hout = _nan(rt, pos.shape[1]), _nan(rt, pos.shape[1])
        _host(lib, rt, 5, dict(nhi=nhi, nhi_octa=nhi_octa, flux=flux[0],
                               sdr3=sdr3, cd=cd, phi=phi,
                               heat=hout if heat else None),
              pos[0], threads=32, form=form)
        listed = bool(form & 2)
        for got, ref in ((phi, want[0]), (hout, want[1])):
            if ref is None:
                continue
            assert torch.equal(got[:, rated], ref[:, rated]), form
            if listed:
                assert bool(got[:, ~rated].isnan().all()), form
            else:
                assert torch.equal(got, ref), form


def test_single_cell_shells_have_one_corner_weight():
    """The premise of the sweep's corner order (csrc/flat_sweep.cuh): the
    only shell of one cell, the far corner (-n, -n, -n) of an even mesh's
    whole box, has a single corner of nonzero weight, for every even mesh
    up to 4096, so its sums have the same bits in any order."""
    n = np.arange(1, 2049, dtype=np.int64)
    _, s, _, _ = _corner_tables(-n, -n, -n)
    assert np.all((s != 0.0).sum(axis=0) == 1)
