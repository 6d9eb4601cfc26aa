"""The flat engine's kernels of csrc/flat_sweep.cu rehearsed on the host
(tests/rehearsal_host.py): the sweep, the rate pass, the ordered
accumulate and the trace loop, bit for bit (torch.equal) against the
engine's plain functions (ops/raytrace.py's Raytracer: _gather, _sweep,
_rates, _accumulate and the plain loop flat_trace_sweep_ref).

The sweep (its column densities in the ring in distributed shared memory
or in global memory, and the forms the probe measures) is held to the
plain functions as it runs; the accumulate and the loop are in
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


@pytest.mark.parametrize("mode", ["grey", "tables", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["N16_R4", "N24_box"])
def test_flat_rates_on_the_host_matches_plain(lib, monkeypatch, case, dt,
                                              mode):
    """flat_rates_kernel (its rows and blocks in either order) bit for bit
    against the plain rate pass on the plain sweep's column densities, with
    a cell past MAX_COLDENSH, the zero-density cell and a zero flux: Gamma
    and with ``heat`` the heating rate per HI atom; thin and thick cells,
    rated and (R inside the mesh) unrated ones."""
    rt, nd, xh, pos, flux = _case(case, dt, mode)
    nhi = nd * (1.0 - xh)
    lin, nhi_octa = rt._gather(nhi, pos[0])
    cd = rt._sweep(nhi_octa, _dr(rt))
    cd[1, 5] = 1e31
    _card_arithmetic(monkeypatch, dt)
    sdr3 = rt._s_over_dr3(_dr(rt))
    want = rt._rates(cd, nhi_octa, flux[0], _dr(rt))
    monkeypatch.undo()
    dtau = nhi_octa * rt.tables.path * _dr(rt) * SIG
    assert bool((dtau > 1e-7).any()) and bool((dtau < 1e-7).any())
    assert (want[1] is not None) == (mode == "heat")
    for reverse in (0, 1):
        phi, heat = _nan(rt, pos.shape[1]), _nan(rt, pos.shape[1])
        _host(lib, rt, 1, dict(nhi=nhi, flux=flux[0], sdr3=sdr3, cd=cd,
                               phi=phi, heat=heat if mode == "heat" else None),
              pos[0], threads=64, reverse=reverse)
        assert torch.equal(phi, want[0]), reverse
        if mode == "heat":
            assert torch.equal(heat, want[1]), reverse
    assert float(want[0][1, 5]) == 0.0 and float(want[0].max()) > 0.0
    assert not bool(want[0][-1].any())                  # zero flux
    zero = nhi_octa == 0.0
    assert bool(zero.any()) and not bool(want[0][zero].any())


def test_single_cell_shells_have_one_corner_weight():
    """The premise of the sweep's corner order (csrc/flat_sweep.cu): the
    only shell of one cell, the far corner (-n, -n, -n) of an even mesh's
    whole box, has a single corner of nonzero weight, for every even mesh
    up to 4096, so its sums have the same bits in any order."""
    n = np.arange(1, 2049, dtype=np.int64)
    _, s, _, _ = _corner_tables(-n, -n, -n)
    assert np.all((s != 0.0).sum(axis=0) == 1)
