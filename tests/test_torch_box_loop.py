"""The box engine's plain loop and its kernels' bindings: the plain loop
``BoxRaytracer.box_trace_sweep_ref`` (what ``trace_batches`` runs on the
CPU) against the JAX package's BoxRaytracer in float64 at rtol 1e-12 above
1e-12 of the peak; the sweep's explicit sums against the reduction they
replaced; the kernels' tables; the bindings of ops/box_sweep.py (they
refuse CPU tensors); and, ``cuda``, each kernel and the loop on the card
bit for bit against their plain versions in float32 and float64. Only the
comparison with the JAX engine imports JAX."""

import numpy as np
import pytest
import torch

from pyc2ray_torch.constants import ev2fr
from pyc2ray_torch.ops import box_sweep as bs
from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace_box import (BoxRaytracer, build_kernel_tables,
                                            grey_bins)
from pyc2ray_torch.ops.sweep import s_over_dr3
from pyc2ray_torch.ops.trace_loop import fold_padding, stage_positions
from pyc2ray_torch.radiation import BlackBodySource
from pyc2ray_torch.radiation.spectral_bins import make_spectral_bins

SIG = 6.30e-18
DR = 6.7e20


def _bb_bins():
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    return make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                              fmin, fmax, panels=2, nodes=4)


def _bins(spectrum):
    return grey_bins() if spectrum == "grey" else _bb_bins()


def _fields(N, seed):
    rng = np.random.RandomState(seed)
    return 10 ** rng.uniform(-4, -2, (N,) * 3), rng.uniform(0.0, 0.9, (N,) * 3)


def _sources(N, ns, seed):
    """ns sources, the first at the frame's edge (N - 1 on two axes, 0 on
    the third), the last two at one cell."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, N, size=(ns, 3))
    src[0] = [N - 1, 0, N - 1]
    src[-1] = src[-2]
    return src, rng.uniform(0.5, 2.0, ns)


def _close(got, want, rtol=1e-12, floor=1e-12):
    """rtol above ``floor`` of the peak (an absolute floor below it)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * np.abs(want).max())


# (spectrum, heat, N, R, sources, batch): R = 1e9 clips the box at the mesh
# (odd and even N, Q - 1 beyond Dc), R inside it; five sources in batches
# of two (three batches, the last padded with a zero-flux source)
CASES = [("grey", False, 10, 1e9, 5, 2), ("grey", True, 9, 1e9, 5, 2),
         ("bb", False, 9, 1e9, 5, 2), ("bb", True, 10, 1e9, 5, 2),
         ("bb", True, 16, 3.5, 5, 2), ("grey", False, 16, 4.0, 5, 2)]


@pytest.mark.parametrize("spectrum,heat,N,R,ns,B", CASES,
                         ids=[f"{s}{'-heat' if h else ''}-N{n}-R{r:g}"
                              for s, h, n, r, _, _ in CASES])
def test_plain_loop_matches_jax(spectrum, heat, N, R, ns, B):
    """box_trace_sweep_ref's Gamma (and heat) against the JAX engine's
    trace: rtol 1e-12 above 1e-12 of the peak; trace_batches on the CPU is
    the plain loop."""
    import jax.numpy as jnp
    from pyc2ray_tpu.ops.raytrace_box import BoxRaytracer as JBox
    nd, xh = _fields(N, N)
    src, flux = _sources(N, ns, N + 1)
    rt = BoxRaytracer(N, R, SIG, _bins(spectrum), batch_size=B,
                      dtype=torch.float64, do_heating=heat, device="cpu")
    pos_b, flux_b = rt.prepare_sources(src, flux)
    assert pos_b.shape[0] == 3
    nd_t, xh_t = torch.from_numpy(nd), torch.from_numpy(xh)
    got = rt.box_trace_sweep_ref(nd_t, xh_t, pos_b, flux_b, DR)
    same = rt.trace_batches(nd_t, xh_t, pos_b, flux_b, DR)
    want = JBox(N, R, SIG, _bins(spectrum), batch_size=B, dtype=jnp.float64,
                do_heating=heat).trace(nd, xh, src, flux, DR)
    want = want if heat else (want,)
    assert (got[1] is None) != heat
    for g, s, w in zip(got, same, want):
        assert torch.equal(g, s)
        _close(g.reshape((N,) * 3), w)
    assert float(got[0].max()) > 0.0


def _sweep_with_sum(rt, H_nhi, pathdr, dr):
    """The sweep as the engine issued it before its sums were spelled out:
    the corners' terms and weights summed by ``.sum(2)``."""
    tb, g = rt.tables, rt.geom
    B, Q = H_nhi.shape[0], g.Q
    S = g.Dc * g.Dc
    H_cd = torch.zeros_like(H_nhi)
    cdin = torch.zeros_like(H_nhi)
    zero = torch.zeros((), dtype=rt.dtype)
    src = g.c * g.Dc + g.c
    H_cd[:, :, 0, src] = H_nhi[:, :, 0, src] * (0.5 * dr)
    flat = H_cd.view(B, 2, Q * S)
    for q in range(1, Q):
        cor = flat[:, :, tb.corner_idx[q]]
        w = cor * rt.sig
        w.clamp_(min=0.6)
        torch.div(tb.sw[q], w, out=w)
        cor.mul_(w)
        num = torch.mul(tb.diag[q], cor.sum(2))
        torch.div(num, w.sum(2), out=cdin[:, :, q])
        cdout = cdin[:, :, q] + H_nhi[:, :, q] * pathdr[q]
        torch.where(tb.valid[q], cdout, zero, out=H_cd[:, :, q])
    return cdin


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R", [(9, 1e9), (10, 1e9), (16, 5.0)])
def test_explicit_sums_match_the_reduction(N, R, dt):
    """The sweep's four-term sums added in the JAX engine's order against
    the ``.sum(2)`` reduction they replaced, on the CPU: rtol 1e-12 of the
    incoming column densities at every cell (both forms give the same
    bits here)."""
    rt = BoxRaytracer(N, R, SIG, grey_bins(), batch_size=2, dtype=dt,
                      device="cpu")
    nd, xh = _fields(N, 3)
    frame = rt.wrap_pad(torch.from_numpy(nd).to(dt),
                        torch.from_numpy(xh).to(dt))
    pos = stage_positions(rt.prepare_sources(_sources(N, 2, 4)[0],
                                             np.ones(2))[0], frame.shape,
                          rt.geom.Dc, "cpu")
    H = rt._sheets(frame, pos[0])
    pathdr = rt.tables.path * torch.tensor(DR, dtype=dt)
    got = rt._sweep(H, pathdr, DR)
    want = _sweep_with_sum(rt, H, pathdr, DR)
    assert float(want.max()) > 0.0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("N,R", [(9, 1e9), (8, 1e9), (16, 3.0), (21, 6.0)])
def test_kernel_tables(N, R):
    """The kernels' tables against the plain tables: the valid cells shell
    after shell; each corner the valid cell the plain corner index names,
    or -1 where the plain stack holds 0 (outside the octahedron); each
    rated cell one box cell, ascending, every rated sheet cell and box cell
    once; the visit 1 at those box cells only."""
    rt = BoxRaytracer(N, R, SIG, grey_bins(), batch_size=2,
                      dtype=torch.float64, device="cpu")
    g, tb = rt.geom, rt._tb_np
    t = build_kernel_tables(g, tb)
    kt = rt.kernel_tables()
    S, Q = g.Dc ** 2, g.Q
    vq, vf, vs = t["vq"], t["vf"], t["vs"]
    assert np.all(np.diff(vq) >= 0) and vq.size == tb["valid"].sum()
    assert np.array_equal(t["shell"], np.searchsorted(vq, np.arange(Q + 1)))
    assert kt.sizes["max_shell"] == np.diff(t["shell"]).max()
    valid = tb["valid"]
    for k in range(4):
        ci = tb["corner_idx"][vq, k, vs]
        inside = valid[ci // S, vf, ci % S] & (vq > 0)
        cor = t["corner"][k]
        assert np.array_equal(cor >= 0, inside)
        w = cor[inside]
        assert np.array_equal(vf[w], vf[inside])
        assert np.array_equal(vq[w] * S + vs[w], ci[inside])
    rated = tb["rated"][vf, vq, vs]
    assert np.array_equal(np.sort(t["rv"]), np.flatnonzero(rated))
    assert np.all(np.diff(t["rcell"]) > 0)
    visit = kt.tensors[9].numpy()
    assert visit.sum() == t["rcell"].size and np.all(visit[t["rcell"]] == 1)
    assert np.array_equal(kt.tensors[1].numpy(),
                          tb["shear_idx"][(vf * Q + vq) * S + vs])


def test_bindings_refuse_cpu_tensors():
    """Every binding of ops/box_sweep.py raises on CPU tensors (nothing
    falls back to the plain version), before it loads a library."""
    rt = BoxRaytracer(9, 1e9, SIG, grey_bins(), batch_size=2,
                      dtype=torch.float64, device="cpu")
    kt = rt.kernel_tables()
    nd, xh = (torch.from_numpy(a) for a in _fields(9, 1))
    frame = rt.wrap_pad(nd, xh)
    pos = torch.zeros((1, 2, 3), dtype=torch.int64)
    n_v = kt.sizes["n_v"]
    nhi = torch.ones((2, n_v), dtype=torch.float64)
    sdr3 = s_over_dr3(DR, torch.float64)
    flux = torch.ones(2, dtype=torch.float64)
    sweep.reset_launches()
    for call in (lambda: bs.box_gather(kt, frame, pos[0]),
                 lambda: bs.box_sweep(kt, nhi, DR),
                 lambda: bs.box_rates(kt, nhi, nhi, flux, sdr3, DR),
                 lambda: bs.box_trace_sweep(kt, frame, pos, flux[None], sdr3,
                                            DR),
                 lambda: bs.box_plan(kt, 2, 2, frame.device)):
        with pytest.raises(ValueError, match="unsupported device cpu"):
            call()
    assert not any(sweep.launches[k] for k in (
        "box_gather", "box_sweep", "box_rates", "box_trace_sweep"))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("spectrum,heat", [("grey", False), ("bb", False),
                                           ("bb", True)])
@pytest.mark.parametrize("N,R", [(32, 6.0), (17, 1e9), (16, 1e9)])
def test_box_kernels_equal_plain_on_cuda(N, R, spectrum, heat, dt):
    """Each kernel (one launch, counted) bit for bit against its plain
    version on the card on the first batch (the gather at the valid cells,
    the sweep's incoming column densities there, the binding's only output,
    with several block sizes in each of the engine's forms: the ring in
    shared or global memory; the rate boxes whole), and the loop (one call)
    against the plain loop over three batches, through the engine and
    through the binding (a rate launch a chunk of the three batches), the
    loop's launches as box_plan counts them."""
    _cuda()
    rt = BoxRaytracer(N, R, SIG, _bins(spectrum), batch_size=4, dtype=dt,
                      do_heating=heat, device="cuda")
    nd, xh = (torch.from_numpy(a).to("cuda", dt) for a in _fields(N, 7))
    src, flux = _sources(N, 12, 8)
    pos_b, flux_b = rt.prepare_sources(src, flux)
    kt = rt.kernel_tables()
    frame = rt.wrap_pad(nd, xh)
    pos = stage_positions(pos_b, frame.shape, rt.geom.Dc, "cuda")
    H = rt._sheets(frame, pos[0])
    pathdr = rt.tables.path * torch.tensor(DR, dtype=dt).to("cuda")
    sdr3 = s_over_dr3(DR, dt).to("cuda")
    cdin = rt._sweep(H, pathdr, DR)
    phi, heat_s = rt._rates(cdin, H, pathdr, flux_b[0], sdr3)
    t = build_kernel_tables(rt.geom, rt._tb_np)
    S = rt.geom.Dc ** 2
    stack = torch.from_numpy((t["vf"] * rt.geom.Q + t["vq"]) * S
                             + t["vs"]).to("cuda")
    B = pos.shape[1]
    sweep.reset_launches()
    nhi = bs.box_gather(kt, frame, pos[0])
    assert torch.equal(nhi, H.reshape(B, -1)[:, stack])
    # (threads, ring)
    forms = [(None, None), (32, False), (128, False), (1024, False),
             (128, True), (1024, True)]
    for threads, ring in forms:
        got = bs.box_sweep(kt, nhi, DR, threads=threads, ring=ring)
        assert torch.equal(got, cdin.reshape(B, -1)[:, stack]), (threads,
                                                                  ring)
    got = bs.box_rates(kt, got, nhi, flux_b[0].contiguous(), sdr3, DR)
    assert torch.equal(got[0], rt._unshear(phi))
    if heat:
        assert torch.equal(got[1], rt._unshear(heat_s))
    loop = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    plain = rt.box_trace_sweep_ref(nd, xh, pos_b, flux_b, DR)
    assert float(plain[0].max()) > 0.0
    for a, b in zip(loop, plain):
        assert (a is None and b is None) or torch.equal(a, b)
    # the plain loop adds its boxes by slice adds: no launch of a kernel
    ns = pos_b.shape[0] * B
    plan = bs.box_plan(kt, ns, B, nd.device)
    want = {k: v + plan.launches[k] for k, v in (
        ("box_gather", 1), ("box_sweep", len(forms)), ("box_rates", 1),
        ("accumulate_boxes", 0))}
    assert sweep.launches["box_trace_sweep"] == 1
    assert all(sweep.launches[k] == v for k, v in want.items()), want
    g = rt.geom
    assert plan.chunk == 3 and plan.launches["box_rates"] == 1, plan
    sweep.reset_launches()
    pads = bs.box_trace_sweep(kt, frame, pos_b, flux_b, sdr3, DR)
    for a, w in zip(pads, plain):
        assert (a is None and w is None) or torch.equal(
            fold_padding(a, g.c, g.Dc).reshape(-1), w)
    assert sweep.launches["box_trace_sweep"] == 1
    assert all(sweep.launches[k] == v for k, v in plan.launches.items()), \
        plan


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("heat", [True, False])
def test_box_loop_over_device_batches_on_cuda(dt, heat):
    """The loop bit for bit against the plain loop over more sources than
    one of its device batches holds (box_plan's own plan: two device
    batches, the second smaller, each of several rate chunks, the last
    short), with and without heat, so the offsets of a later device batch
    into the positions, the fluxes and the batches show; each kernel's
    launches as the loop counts them are box_plan's."""
    _cuda()
    N, B = 24, 8
    rt = BoxRaytracer(N, 5.0, SIG, _bb_bins(), batch_size=B, dtype=dt,
                      do_heating=heat, device="cuda")
    kt = rt.kernel_tables()
    dev = torch.device("cuda")
    dev_batch = bs.box_plan(kt, 1 << 20, B, dev).dev_batch
    ns = dev_batch + 3 * B + 5
    nd, xh = (torch.from_numpy(a).to("cuda", dt) for a in _fields(N, 11))
    src, flux = _sources(N, ns, 12)
    pos_b, flux_b = rt.prepare_sources(src, flux)
    plan = bs.box_plan(kt, ns, B, dev)
    assert plan.launches["box_gather"] >= 2 and plan.dev_batch < ns, plan
    assert plan.launches["box_rates"] > plan.launches["box_gather"], plan
    plain = rt.box_trace_sweep_ref(nd, xh, pos_b, flux_b, DR)
    assert float(plain[0].max()) > 0.0 and (plain[1] is None) != heat
    frame = rt.wrap_pad(nd, xh)
    sdr3 = s_over_dr3(DR, dt).to("cuda")
    sweep.reset_launches()
    pads = bs.box_trace_sweep(kt, frame, pos_b, flux_b, sdr3, DR)
    g = rt.geom
    for a, b in zip(pads, plain):
        assert (a is None and b is None) or torch.equal(
            fold_padding(a, g.c, g.Dc).reshape(-1), b)
    assert all(sweep.launches[k] == v for k, v in plan.launches.items()), \
        plan
    sweep.reset_launches()
    loop = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    for a, b in zip(loop, plain):
        assert (a is None and b is None) or torch.equal(a, b)
    assert all(sweep.launches[k] == v for k, v in plan.launches.items()), \
        plan


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_box_loop_on_nan_scratch_on_cuda(dt):
    """The loop bit for bit against the plain loop over 16 batches of 8
    at a bench-like shape (N = 64, R = 12) with the allocator's blocks
    filled with NaN first, so a read of a cell no kernel wrote shows."""
    _cuda()
    N = 64
    rt = BoxRaytracer(N, 12.0, SIG, _bb_bins(), batch_size=8, dtype=dt,
                      do_heating=True, device="cuda")
    nd, xh = (torch.from_numpy(a).to("cuda", dt) for a in _fields(N, 9))
    src, flux = _sources(N, 128, 10)
    pos_b, flux_b = rt.prepare_sources(src, flux)
    plain = rt.box_trace_sweep_ref(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 26,), float("nan"), dtype=dt, device="cuda")
            for _ in range(4)]
    del junk
    loop = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    for a, b in zip(loop, plain):
        assert torch.equal(a, b)
