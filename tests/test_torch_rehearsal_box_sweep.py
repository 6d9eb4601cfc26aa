"""The box engine's kernels of csrc/box_sweep.cuh and its trace loop
rehearsed on the host (tests/rehearsal_host.py's library), bit for bit
(torch.equal) against the engine's plain functions (ops/raytrace_box.py's
BoxRaytracer: _sheets, _sweep, _rates with _unshear, and the plain loop
box_trace_sweep_ref) with the card's arithmetic (glibc's exp and expm1, the
functions the host build calls). Every scratch buffer starts as NaN, so a
read of a cell the kernels never wrote shows; the rate pass's unrated box
cells must stay NaN. The sweep runs in the engine's forms (a source a
block, the ring in shared or global memory, fewer blocks than sources) and
in the forms of csrc/box_probe.cu that chip_smoke's design steps time (a
group of 1, 2, 4 or 8 of the 3 sources of a batch a thread, the last group
short); the rate pass in the engine's form and in the probe's on a
persistent grid whose threads do not divide the pairs of a source and a
rated cell; the loop with chunks of rate boxes over several device
batches; every grid in both block orders."""

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


def _host(lib, rt, kind, io, n=0, nb=0, B=0, dev_batch=0, chunk=1,
          threads=7, group=1, shared=0, blocks=1 << 20, param=1, unroll=2,
          rate_blocks=3, reverse=0):
    """Kind ``kind`` of rehearsal.cpp's run_box on the host with the
    tensors ``io`` (absent ones null): the sweep (the probe's: ``group``
    sources a thread) its ring in shared memory with ``shared``, on at most
    ``blocks`` blocks, the rate pass with the bins as parameters
    (``param``; the probe's: ``unroll`` bins a trip, on ``rate_blocks``
    blocks)."""
    kt = rt.kernel_tables()
    order = ("frame", "pos", "flux", "sdr3", "nhi", "ring", "cdin", "phi",
             "heat", "phi_frame", "heat_frame")
    if not shared and io.get("ring") is None:
        rings = min(blocks, -(-max(n, dev_batch) // group))
        io = dict(io, ring=_nan(rings * group * bs.ring_bytes(kt)
                                // rt.dtype.itemsize, dt=rt.dtype))
    ptrs = (ctypes.c_void_p * len(order))(
        *[None if io.get(k) is None else io[k].data_ptr() for k in order])
    fn = lib.rehearse_box_f32 if rt.dtype == torch.float32 else \
        lib.rehearse_box_f64
    rc = fn(kind, kt.tabs, kt.dims, bs._vals(kt, DR), kt.bins, ptrs, n, nb,
            B, dev_batch, chunk, threads, group, shared, blocks, param,
            unroll, rate_blocks, reverse)
    assert rc == 0, "not one of the engine's or the probe's forms"


def _nan(*shape, dt):
    return torch.full(shape, float("nan"), dtype=dt)


def _stack_of_valid(rt):
    """The sheet stack index (f Q + q) S + s of each valid cell, in the
    kernels' order."""
    t = build_kernel_tables(rt.geom, rt._tb_np)
    S = rt.geom.Dc ** 2
    return torch.from_numpy((t["vf"] * rt.geom.Q + t["vq"]) * S + t["vs"])


def _first_batch(case, dt, spectrum):
    """The engine, its tables, the padded frame, the first batch's staged
    positions and fluxes, and the plain functions' results on it: the
    gathered nHI and the incoming column densities at the valid cells (B,
    n_v), the rate boxes unsheared (B, Dc^3 each) and the rated box cells
    (a bool mask)."""
    rt, nd, xh, pos, flux = _case(case, dt, spectrum)
    g, B = rt.geom, pos.shape[1]
    kt = rt.kernel_tables()
    frame = rt.wrap_pad(nd, xh)
    stage = stage_positions(pos, frame.shape, g.Dc, "cpu")
    H = rt._sheets(frame, stage[0])
    pathdr = rt.tables.path * torch.tensor(DR, dtype=dt)
    sdr3 = s_over_dr3(DR, dt)
    cdin = rt._sweep(H, pathdr, DR)
    phi, heat_s = rt._rates(cdin, H, pathdr, flux[0], sdr3)
    want = [rt._unshear(phi).reshape(B, -1)] + (
        [rt._unshear(heat_s).reshape(B, -1)] if rt.do_heating else [])
    stack = _stack_of_valid(rt)
    rated = torch.zeros(g.Dc ** 3, dtype=torch.bool)
    rated[kt.tensors[4].long()] = True
    return dict(rt=rt, frame=frame, pos=stage[0].contiguous(),
                flux=flux[0], sdr3=sdr3, nhi=H.reshape(B, -1)[:, stack],
                cdin=cdin.reshape(B, -1)[:, stack], want=want, rated=rated)


def _rates_match(io, f):
    """The rate boxes of ``io`` equal the plain ones at the rated cells and
    are NaN elsewhere."""
    for got, w in zip((io["phi"], io["heat"]), f["want"]):
        r = f["rated"]
        assert torch.equal(got[:, r], w[:, r])
        assert torch.isnan(got[:, ~r]).all()
        assert not w[:, ~r].any()


@pytest.mark.parametrize("spectrum,threads", [
    ("grey", 7), ("bins", 7), ("bins", 64), ("heat", 7), ("heat", 64)])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_box_kernels_on_the_host_match_plain(lib, monkeypatch, case, dt,
                                             spectrum, threads):
    """sheet_gather_kernel, sheet_sweep_kernel and sheet_rates_kernel on
    the first batch, in both block orders, on NaN outputs: the gather equal
    to the plain stack at the valid cells, the sweep's incoming column
    densities (a source a block, the ring in shared and in global memory)
    to the plain sweep's there, and the rate boxes (the engine's forms: the
    bins as parameters or, as for more than 32 bins, loaded; two a trip) to
    the plain pass's unsheared boxes at the rated cells, NaN at every other
    cell."""
    _card_arithmetic(monkeypatch, dt)
    f = _first_batch(case, dt, spectrum)
    rt, B = f["rt"], f["pos"].shape[0]
    n_v, D3 = rt.kernel_tables().sizes["n_v"], rt.geom.Dc ** 3
    for reverse in (0, 1):
        io = dict(frame=f["frame"], pos=f["pos"], flux=f["flux"],
                  sdr3=f["sdr3"], nhi=_nan(B, n_v, dt=dt),
                  cdin=_nan(B, n_v, dt=dt), phi=_nan(B, D3, dt=dt),
                  heat=_nan(B, D3, dt=dt) if rt.do_heating else None)
        _host(lib, rt, 0, io, n=B, threads=threads, reverse=reverse)
        assert torch.equal(io["nhi"], f["nhi"]), reverse
        for shared in (1, 0):
            io.update(cdin=_nan(B, n_v, dt=dt), ring=None)
            _host(lib, rt, 1, io, n=B, threads=threads, shared=shared,
                  reverse=reverse)
            assert torch.equal(io["cdin"], f["cdin"]), (shared, reverse)
        for param in (1, 0):
            io.update(phi=_nan(B, D3, dt=dt),
                      heat=_nan(B, D3, dt=dt) if rt.do_heating else None)
            _host(lib, rt, 2, io, n=B, threads=threads, param=param,
                  reverse=reverse)
            _rates_match(io, f)
    # the pass visits every kind of rated cell: zero density, the source,
    # a cell behind MAX_COLDENSH, a zero flux
    assert (f["want"][0] == 0).any() and (f["want"][0] > 0).any()


# the sweep's forms (kind, group, shared, blocks, threads): the engine's
# (kind 1) on one block over the 3 sources in each placement; the probe's
# group_sweep_kernel (kind 4) with groups of 1, 2, 4 and 8 of the 3 sources
# (the last group short; threads a multiple of the group, as on the card),
# the shared ring of one and of two sources, and persistent grids of one
# block over 3 and 2 groups
SWEEP_FORMS = [(4, 2, 0, 1 << 20, 8), (4, 4, 0, 1 << 20, 8),
               (4, 8, 0, 1 << 20, 16), (4, 2, 1, 1 << 20, 6),
               (1, 1, 0, 1, 7), (4, 2, 0, 1, 6), (1, 1, 1, 1, 7),
               (4, 1, 0, 1 << 20, 7), (4, 1, 1, 1, 7)]


@pytest.mark.parametrize("form", SWEEP_FORMS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_box_sweep_forms_on_the_host_match_plain(lib, case, dt, form):
    """The engine's sheet_sweep_kernel and the probe's group_sweep_kernel in
    each form of ``form`` on the first batch's gathered nHI, in both block
    orders, on NaN outputs and rings: the incoming column densities equal
    to the plain sweep's at the valid cells."""
    kind, group, shared, blocks, threads = form
    f = _first_batch(case, dt, "bins")
    rt, B = f["rt"], f["pos"].shape[0]
    n_v = rt.kernel_tables().sizes["n_v"]
    for reverse in (0, 1):
        io = dict(nhi=f["nhi"].contiguous(), cdin=_nan(B, n_v, dt=dt))
        _host(lib, rt, kind, io, n=B, threads=threads, group=group,
              shared=shared, blocks=blocks, reverse=reverse)
        assert torch.equal(io["cdin"], f["cdin"]), reverse


@pytest.mark.parametrize("param,unroll,rate_blocks", [
    (0, 1, 2), (0, 2, 3), (1, 1, 5), (1, 2, 1)])
@pytest.mark.parametrize("spectrum", ["grey", "bins", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_box_rate_forms_on_the_host_match_plain(lib, monkeypatch, case, dt,
                                                spectrum, param, unroll,
                                                rate_blocks):
    """csrc/box_probe.cu's grid_rates_kernel in each form (the bins loaded
    or as parameters, one or two a trip) on a persistent grid of
    ``rate_blocks`` blocks of 7 threads, whose threads do not divide the
    pairs of a source and a rated cell (and are fewer than them), in both
    block orders, on NaN boxes: the plain pass's unsheared boxes at the
    rated cells, NaN elsewhere."""
    _card_arithmetic(monkeypatch, dt)
    f = _first_batch(case, dt, spectrum)
    rt, B = f["rt"], f["pos"].shape[0]
    n_r, D3 = rt.kernel_tables().sizes["n_r"], rt.geom.Dc ** 3
    assert B * n_r % (7 * rate_blocks) != 0 and B * n_r > 7 * rate_blocks
    for reverse in (0, 1):
        io = dict(nhi=f["nhi"].contiguous(), cdin=f["cdin"].contiguous(),
                  flux=f["flux"], sdr3=f["sdr3"], phi=_nan(B, D3, dt=dt),
                  heat=_nan(B, D3, dt=dt) if rt.do_heating else None)
        _host(lib, rt, 5, io, n=B, param=param, unroll=unroll,
              rate_blocks=rate_blocks, reverse=reverse)
        _rates_match(io, f)


@pytest.mark.parametrize("dev_batch,shared,blocks,chunk", [
    (3, 1, 1 << 20, 1), (6, 0, 1 << 20, 1), (6, 0, 2, 2), (6, 1, 4, 3),
    (9, 0, 4, 2)])
@pytest.mark.parametrize("spectrum", ["grey", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_box_loop_on_the_host_matches_plain(lib, monkeypatch, case, dt,
                                            spectrum, dev_batch, shared,
                                            blocks, chunk):
    """The trace loop (box_trace of csrc/trace_loop.cu, emulated kernel by
    kernel: a chunk's rate boxes zeroed, per device batch of ``dev_batch``
    sources the gather and the sweep (its ring in shared memory with
    ``shared``, on at most ``blocks`` blocks: fewer than the sources, each
    block sweeps several), per chunk of ``chunk`` batches the rate pass and
    per batch of B the accumulate over the rated cells) of three batches on
    NaN scratch, its frames folded, bit for bit against the plain loop, in
    both block orders."""
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
                  cdin=_nan(dev_batch, n_v, dt=dt),
                  phi=_nan(chunk * B, D3, dt=dt),
                  heat=_nan(chunk * B, D3, dt=dt) if heat else None,
                  phi_frame=torch.zeros_like(frame),
                  heat_frame=torch.zeros_like(frame) if heat else None)
        _host(lib, rt, 3, io, nb=nb, B=B, dev_batch=dev_batch, chunk=chunk,
              threads=8, shared=shared, blocks=blocks, reverse=reverse)
        got = [fold_padding(io[k], g.c, g.Dc).reshape(-1)
               for k in ("phi_frame", "heat_frame")[:1 + heat]]
        for gt, w in zip(got, want):
            assert torch.equal(gt, w), reverse
        assert (want[1] is None) != heat
        assert float(want[0].max()) > 0.0
