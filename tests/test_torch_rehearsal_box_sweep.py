"""The box engine's kernels of csrc/box_sweep.cuh and its trace loop
rehearsed on the host (tests/rehearsal_host.py's library), bit for bit
(torch.equal) against the engine's plain functions (ops/raytrace_box.py's
BoxRaytracer: _sheets, _sweep, _rates with _unshear, and the plain loop
box_trace_sweep_ref) with the card's arithmetic (glibc's exp and expm1, the
functions the host build calls). Every scratch buffer starts as NaN, so a
read of a cell the kernels never wrote shows; the rate pass's unrated box
cells must stay NaN. The sweep runs with 7 and 64 threads a block, its
column densities in the ring in shared memory and in global memory, every
grid in both block orders."""

import ctypes

import numpy as np
import pytest
import torch

from pyc2ray_torch.ops import box_sweep as bs
from pyc2ray_torch.ops.raytrace_box import (BoxRaytracer, build_kernel_tables,
                                            grey_bins)
from pyc2ray_torch.ops.sweep import s_over_dr3
from pyc2ray_torch.ops.trace_loop import fold_padding, stage_positions
from rehearsal_flat import _libm
from rehearsal_host import DR, SIG, lib, three_bins  # noqa: F401

# (N, R, the positions of the B = 3 sources of each of three batches): R
# inside the mesh, and beyond it at an odd and an even N (the box clips the
# octahedron: the two sheets' validity differ and Q - 1 exceeds Dc); two
# sources at one cell, sources at the mesh's edges
CASES = {
    "N16_R5": (16, 5.0, [[[3, 3, 3], [3, 3, 3], [15, 0, 15]],
                         [[8, 8, 8], [9, 8, 6], [0, 0, 0]],
                         [[1, 14, 7], [12, 2, 9], [8, 8, 8]]]),
    "N9_clip": (9, 1e9, [[[0, 0, 0], [8, 8, 8], [4, 4, 4]],
                         [[4, 4, 4], [2, 7, 1], [8, 0, 5]],
                         [[6, 6, 6], [0, 8, 3], [3, 1, 8]]]),
    "N8_clip": (8, 1e9, [[[7, 7, 7], [0, 3, 6], [7, 7, 7]],
                         [[4, 4, 4], [1, 2, 3], [5, 0, 2]],
                         [[2, 6, 4], [3, 3, 3], [0, 0, 7]]]),
}
DTYPES = [torch.float64, torch.float32]


def _case(case, dt, spectrum, seed=5):
    """The engine (CPU), the padded nHI frame, the box corners (nb, B, 3)
    and the fluxes (nb, B): densities over ten decades with a zero cell
    beside the first source and one dense enough that the cells behind it
    pass MAX_COLDENSH, the first batch's last flux 0."""
    N, R, pos = CASES[case]
    pos = torch.tensor(pos, dtype=torch.int64)
    nb, B = pos.shape[:2]
    heat = spectrum == "heat"
    bins = grey_bins() if spectrum == "grey" else three_bins()
    rt = BoxRaytracer(N, R, SIG, bins, batch_size=B, dtype=dt,
                      do_heating=heat, device="cpu")
    rng = np.random.RandomState(seed + N)
    nd = 10 ** rng.uniform(-12, -2, (N,) * 3)
    xh = rng.uniform(0.0, 0.9, (N,) * 3)
    x, y, z = pos[0, 0].tolist()
    nd[(x + 1) % N, y, z] = 0.0
    nd[x, (y + 1) % N, z] = 1e12
    flux = rng.uniform(0.5, 2.0, (nb, B))
    flux[0, -1] = 0.0
    nd, xh = (torch.from_numpy(a).to(dt) for a in (nd, xh))
    return rt, nd, xh, pos, torch.from_numpy(flux).to(dt)


def _card_arithmetic(monkeypatch, dt):
    """torch.exp and torch.expm1 as glibc's, the functions the host build
    of the kernels calls (ATen's CUDA kernels call CUDA's exp and expm1,
    the kernels' own)."""
    monkeypatch.setattr(torch, "exp", _libm("exp", dt))
    monkeypatch.setattr(torch, "expm1", _libm("expm1", dt))


def _host(lib, rt, kind, io, n=0, nb=0, B=0, dev_batch=0, threads=7,
          ring=0, reverse=0):
    """Kind ``kind`` of rehearsal.cpp's run_box on the host with the
    tensors ``io`` (absent ones null)."""
    kt = rt.kernel_tables()
    order = ("frame", "pos", "flux", "sdr3", "nhi", "cd", "cdin", "phi",
             "heat", "phi_frame", "heat_frame")
    ptrs = (ctypes.c_void_p * len(order))(
        *[None if io.get(k) is None else io[k].data_ptr() for k in order])
    fn = lib.rehearse_box_f32 if rt.dtype == torch.float32 else \
        lib.rehearse_box_f64
    fn(kind, kt.tabs, kt.dims, bs._vals(kt, DR), ptrs, n, nb, B, dev_batch,
       threads, ring, reverse)


def _nan(*shape, dt):
    return torch.full(shape, float("nan"), dtype=dt)


def _stack_of_valid(rt):
    """The sheet stack index (f Q + q) S + s of each valid cell, in the
    kernels' order."""
    t = build_kernel_tables(rt.geom, rt._tb_np)
    S = rt.geom.Dc ** 2
    return torch.from_numpy((t["vf"] * rt.geom.Q + t["vq"]) * S + t["vs"])


@pytest.mark.parametrize("spectrum,threads", [
    ("grey", 7), ("bins", 7), ("bins", 64), ("heat", 7), ("heat", 64)])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_box_kernels_on_the_host_match_plain(lib, monkeypatch, case, dt,
                                             spectrum, threads):
    """sheet_gather_kernel, sheet_sweep_kernel and sheet_rates_kernel on
    the first batch, in both block orders, on NaN outputs: the gather equal
    to the plain stack at the valid cells, the sweep's incoming column
    densities (in both placements) to the plain sweep's there, and the rate
    boxes to the plain pass's unsheared boxes at the rated cells, NaN at
    every other cell."""
    _card_arithmetic(monkeypatch, dt)
    rt, nd, xh, pos, flux = _case(case, dt, spectrum)
    g, B, heat = rt.geom, pos.shape[1], rt.do_heating
    kt = rt.kernel_tables()
    n_v, D3 = kt.sizes["n_v"], g.Dc ** 3
    frame = rt.wrap_pad(nd, xh)
    stage = stage_positions(pos, frame.shape, g.Dc, "cpu")
    H = rt._sheets(frame, stage[0])
    dr_t = torch.tensor(DR, dtype=dt)
    pathdr = rt.tables.path * dr_t
    sdr3 = s_over_dr3(DR, dt)
    cdin = rt._sweep(H, pathdr, DR)
    phi, heat_s = rt._rates(cdin, H, pathdr, flux[0], sdr3)
    want = [rt._unshear(phi)] + ([rt._unshear(heat_s)] if heat else [])
    stack = _stack_of_valid(rt)
    rated = torch.zeros(D3, dtype=torch.bool)
    rated[kt.tensors[4].long()] = True
    for reverse in (0, 1):
        io = dict(frame=frame, pos=stage[0].contiguous(), flux=flux[0],
                  sdr3=sdr3, nhi=_nan(B, n_v, dt=dt), cd=_nan(B, n_v, dt=dt),
                  cdin=_nan(B, n_v, dt=dt), phi=_nan(B, D3, dt=dt),
                  heat=_nan(B, D3, dt=dt) if heat else None)
        _host(lib, rt, 0, io, n=B, threads=threads, reverse=reverse)
        assert torch.equal(io["nhi"], H.reshape(B, -1)[:, stack]), reverse
        for ring in (1, 0):
            io.update(cd=_nan(B, n_v, dt=dt), cdin=_nan(B, n_v, dt=dt))
            _host(lib, rt, 1, io, n=B, threads=threads, ring=ring,
                  reverse=reverse)
            assert torch.equal(io["cdin"], cdin.reshape(B, -1)[:, stack]), \
                (ring, reverse)
            assert not torch.isnan(io["cd"]).any()
        _host(lib, rt, 2, io, n=B, threads=threads, reverse=reverse)
        for got, w in zip((io["phi"], io["heat"]), want):
            w = w.reshape(B, -1)
            assert torch.equal(got[:, rated], w[:, rated]), reverse
            assert torch.isnan(got[:, ~rated]).all()
            assert not w[:, ~rated].any()
    # the pass visits every kind of rated cell: zero density, the source,
    # a cell behind MAX_COLDENSH, a zero flux
    assert (want[0] == 0).any() and (want[0] > 0).any()


@pytest.mark.parametrize("dev_batch,ring", [(3, 1), (6, 0)])
@pytest.mark.parametrize("spectrum", ["grey", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_box_loop_on_the_host_matches_plain(lib, monkeypatch, case, dt,
                                            spectrum, dev_batch, ring):
    """The trace loop (box_trace of csrc/trace_loop.cu, emulated kernel by
    kernel: the rate boxes zeroed, per device batch of ``dev_batch``
    sources the gather and the sweep (its column densities in the ring
    with ``ring``), per batch of B the rate pass and the accumulate over the
    rated cells) of three batches on NaN scratch, its frames folded, bit
    for bit against the plain loop, in both block orders."""
    _card_arithmetic(monkeypatch, dt)
    rt, nd, xh, pos, flux = _case(case, dt, spectrum)
    g, (nb, B), heat = rt.geom, pos.shape[:2], rt.do_heating
    n_v, D3 = rt.kernel_tables().sizes["n_v"], g.Dc ** 3
    want = rt.box_trace_sweep_ref(nd, xh, pos, flux, DR)
    frame = rt.wrap_pad(nd, xh)
    for reverse in (0, 1):
        io = dict(frame=frame,
                  pos=stage_positions(pos, frame.shape, g.Dc, "cpu"),
                  flux=flux.contiguous(), sdr3=s_over_dr3(DR, dt),
                  nhi=_nan(dev_batch, n_v, dt=dt),
                  cd=_nan(dev_batch, n_v, dt=dt),
                  cdin=_nan(dev_batch, n_v, dt=dt), phi=_nan(B, D3, dt=dt),
                  heat=_nan(B, D3, dt=dt) if heat else None,
                  phi_frame=torch.zeros_like(frame),
                  heat_frame=torch.zeros_like(frame) if heat else None)
        _host(lib, rt, 3, io, nb=nb, B=B, dev_batch=dev_batch, threads=7,
              ring=ring, reverse=reverse)
        got = [fold_padding(io[k], g.c, g.Dc).reshape(-1)
               for k in ("phi_frame", "heat_frame")[:1 + heat]]
        for gt, w in zip(got, want):
            assert torch.equal(gt, w), reverse
        assert (want[1] is None) != heat
        assert float(want[0].max()) > 0.0
