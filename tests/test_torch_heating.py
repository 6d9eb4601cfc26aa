"""The port's photoheating channel (``do_heating``) in every sweep mode
against the JAX engine's: the unfused rate pass against the JAX XLA path,
``fuse_fold`` (K3h) against the JAX Pallas kernel in interpret mode and
against the XLA path, and the modes of the port against each other; in
float64 unless stated."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer
from pyc2ray_tpu.radiation import BlackBodySource
from pyc2ray_tpu.radiation.bins_compress import compress_bins
from pyc2ray_tpu.radiation.spectral_bins import (SpectralBins,
                                                 make_spectral_bins)

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer

SIG = 6.30e-18
DR = 6.7e20


def _grey_heat_bins():
    """One bin, as the grey test case, with a heating weight of 5 eV per
    ionization (the stock grey bins have none)."""
    return SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                        w_heat=np.array([8.0e-12]), num_bins=1)


def _bb_bins():
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    dense = make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                               fmin, fmax, panels=8, nodes=8)
    return compress_bins(dense, target_rel=1e-2, cache=False)


BINS = {"grey": _grey_heat_bins, "blackbody": _bb_bins}


def _inputs(N, seed, ns=3):
    rng = np.random.RandomState(seed)
    ndens = 10 ** rng.uniform(-4, -2, (N, N, N))
    xh = rng.uniform(0.0, 0.9, (N, N, N))
    src = rng.randint(0, N, (ns, 3))
    flux = rng.uniform(0.5, 2.0, ns)
    return ndens, xh, src, flux


def _jax(N, R, bins, **kw):
    return JRaytracer(N, R, SIG, bins, batch_size=2, dtype=jnp.float64,
                      accumulate="scan", do_heating=True, **kw)


def _port(N, R, bins, dtype=torch.float64, device="cpu", **kw):
    return ChebRaytracer(N, R, SIG, bins, batch_size=2, dtype=dtype,
                         device=device, do_heating=True, **kw)


# (16, 6): the box lies inside the mesh; (16, 8): the mesh clips it
@pytest.mark.parametrize("spectrum", ["grey", "blackbody"])
@pytest.mark.parametrize("N,R", [(16, 6.0), (16, 8.0)])
def test_rate_pass_heat_matches_jax_xla(N, R, spectrum):
    """_rates' (phi, heat) through trace, against the JAX XLA path."""
    bins = BINS[spectrum]()
    ndens, xh, src, flux = _inputs(N, seed=31)
    want = _jax(N, R, bins).trace(ndens, xh, src, flux, DR)
    got = _port(N, R, bins).trace(ndens, xh, src, flux, DR)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert w.max() > 0 and g.shape == (N, N, N)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=0)


@pytest.mark.parametrize("N,R", [(16, 6.0), (16, 8.0)])
def test_fuse_fold_heat_matches_jax_kernel(N, R):
    """fuse_fold + do_heating (K3h's plain version) against the JAX Pallas
    kernel in interpret mode: 1e-6, which covers its Taylor substitute for
    expm1 (rel err < 2e-8) with room for the sums over bins."""
    bins = _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=32)
    want = _jax(N, R, bins, use_pallas=True, fuse_fold=True).trace(
        ndens, xh, src, flux, DR)
    got = _port(N, R, bins, fuse_fold=True).trace(ndens, xh, src, flux, DR)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.all(np.isfinite(w)) and w.max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("N,R", [(16, 6.0), (16, 8.0), (12, 4.0)])
def test_fuse_fold_heat_matches_jax_xla(N, R):
    """fuse_fold + do_heating against the JAX XLA path: rtol 1e-9 above a
    floor of 1e-12 of the peak (the XLA path rebuilds cdin = cd - dcol,
    which cancels where dcol >> cdin)."""
    bins = _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=33, ns=4)
    want = _jax(N, R, bins).trace(ndens, xh, src, flux, DR)
    got = _port(N, R, bins, fuse_fold=True).trace(ndens, xh, src, flux, DR)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-12 * w.max())


@pytest.mark.parametrize("mode", ["default", "fuse_fold"])
def test_zero_density_cell_gives_zero_heat(mode):
    """A zero-density cell inside the rate sphere gets heat = 0 and
    Gamma = 0 (the JAX fused kernel divides 0 by 0 there)."""
    N, R = 12, 4.0
    ndens, xh, src, flux = _inputs(N, seed=34, ns=2)
    cell = tuple((src[0] + [1, 2, 0]) % N)
    ndens[cell] = 0.0
    kw = {} if mode == "default" else {mode: True}
    phi, heat = _port(N, R, _bb_bins(), **kw).trace(ndens, xh, src, flux, DR)
    assert bool(torch.isfinite(heat).all()) and bool(torch.isfinite(phi).all())
    assert float(heat[cell]) == 0.0 and float(phi[cell]) == 0.0
    assert float(heat.max()) > 0
    want = np.asarray(_jax(N, R, _bb_bins()).trace(ndens, xh, src, flux,
                                                   DR)[1])
    np.testing.assert_allclose(heat.numpy(), want, rtol=1e-9,
                               atol=1e-12 * want.max())


def test_fuse_rates_with_heating_takes_unfused_path():
    """As in the JAX engine, fuse_rates with do_heating runs the default
    mode: the results are the same bits, and K1f's plain version is not
    what computed them."""
    N, R = 12, 4.0
    bins = _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=35)
    want = _port(N, R, bins).trace(ndens, xh, src, flux, DR)
    got = _port(N, R, bins, fuse_rates=True).trace(ndens, xh, src, flux, DR)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # without heating the fused kernel's own rounding shows
    plain = ChebRaytracer(N, R, SIG, bins, batch_size=2, dtype=torch.float64,
                          device="cpu", fuse_rates=True)
    assert not torch.equal(plain.trace(ndens, xh, src, flux, DR), want[0])


def test_shell_segment_with_heating_equals_monolithic():
    N, R = 16, 8.0
    bins = _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=36)
    seg = _port(N, R, bins, shell_segment=3)
    assert seg.seg_S == 3 and seg.seg_K == 3
    want = _port(N, R, bins, shell_segment=0).trace(ndens, xh, src, flux, DR)
    got = seg.trace(ndens, xh, src, flux, DR)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("mode", ["default", "fuse_fold"])
def test_return_forms(mode):
    """trace: a tensor without and a pair with do_heating; trace_batches:
    always a pair, heat None without do_heating; config.do_heating set.
    phi does not depend on the heating channel."""
    N, R = 8, 3.0
    bins = _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=37, ns=2)
    kw = {} if mode == "default" else {mode: True}
    hot = _port(N, R, bins, **kw)
    cold = ChebRaytracer(N, R, SIG, bins, batch_size=2, dtype=torch.float64,
                         device="cpu", **kw)
    assert hot.config.do_heating and not cold.config.do_heating
    phi_c = cold.trace(ndens, xh, src, flux, DR)
    phi_h, heat = hot.trace(ndens, xh, src, flux, DR)
    assert isinstance(phi_c, torch.Tensor)
    assert torch.equal(phi_c, phi_h) and heat.shape == (N, N, N)
    nd = torch.from_numpy(ndens).reshape(-1)
    x = torch.from_numpy(xh).reshape(-1)
    out_c = cold.trace_batches(nd, x, *cold.prepare_sources(src, flux), DR)
    out_h = hot.trace_batches(nd, x, *hot.prepare_sources(src, flux), DR)
    assert out_c[1] is None and out_c[0].shape == (N ** 3,)
    assert torch.equal(out_h[1].reshape(N, N, N), heat)


def test_source_cell_heat_matches_jax():
    bins = _bb_bins()
    jr = _jax(12, 4.0, bins)
    tr = _port(12, 4.0, bins)
    Dc = tr.geom.Dc
    rng = np.random.RandomState(38)
    box = 10 ** rng.uniform(-4, -2, (2, Dc, Dc, Dc))
    flux = np.array([0.7, 1.9])
    want = np.asarray(jr._source_cell_rate(
        jnp.asarray(box), jnp.asarray(flux), jnp.asarray(DR),
        jr._bins_heat_static))
    c, tb = tr.geom.c, tr.tables
    got = sweep.source_cell_rate(torch.from_numpy(box)[:, c, c, c],
                                 torch.from_numpy(flux), DR, SIG, tb.bins_s,
                                 tb.bins_wh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("mode", ["default", "fuse_fold"])
def test_float32_heat_against_float64(mode):
    """float32: heat ~ 1e-11 x phi, and far cells go subnormal, so the
    comparison has an absolute floor at 1e-5 of the peak; above it the
    float32 field is within 2e-3 of the float64 one (the unfused path
    cancels in cd - dcol, the bins sum ~1e-7 relative terms)."""
    N, R = 16, 6.0
    bins = _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=39)
    kw = {} if mode == "default" else {mode: True}
    want = _port(N, R, bins, **kw).trace(ndens, xh, src, flux, DR)
    got = _port(N, R, bins, dtype=torch.float32, **kw).trace(
        ndens, xh, src, flux, DR)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy().astype(np.float64), w.numpy(),
                                   rtol=2e-3, atol=1e-5 * float(w.max()))


def test_heat_wrapper_dispatches_on_device():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; phi is the same bits with and without the heat output; any
    other device raises."""
    tr = _port(8, 3.0, _bb_bins())
    g, tb = tr.geom, tr.tables
    rng = np.random.RandomState(40)
    box = torch.from_numpy(10 ** rng.uniform(-4, -2, (2,) + (g.Dc,) * 3))
    flux = torch.tensor([1.0, 2.0], dtype=torch.float64)
    rates = (box, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p, tb.rt_tab,
             flux, DR, g.c, SIG, tb.bins_s, tb.bins_w)
    sweep.reset_launches()
    phi, heat = sweep.cheb_sweep_rates(*rates, bins_wh=tb.bins_wh)
    ref = sweep.cheb_sweep_rates_ref(*rates, bins_wh=tb.bins_wh)
    assert torch.equal(phi, ref[0]) and torch.equal(heat, ref[1])
    assert torch.equal(phi, sweep.cheb_sweep_rates(*rates))
    # the source cell holds its closed form with the heating weights
    src = sweep.source_cell_rate(box[:, g.c, g.c, g.c], flux, DR, SIG,
                                 tb.bins_s, tb.bins_wh)
    assert torch.equal(heat[:, g.c, g.c, g.c], src) and float(src.min()) > 0
    assert "cheb_sweep_rates_heat" in sweep.launches
    assert sum(sweep.launches.values()) == 0
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.cheb_sweep_rates(box.to("meta"), *rates[1:],
                               bins_wh=tb.bins_wh)


@pytest.mark.cuda
def test_heat_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    # float32: an absolute floor at 1e-6 of each field's peak, below which
    # the rates underflow toward denormals and the exp rounding dominates
    for dt, rtol, floor in ((torch.float32, 1e-4, 1e-6),
                            (torch.float64, 1e-10, 0.0)):
        tr = _port(16, 8.0, _bb_bins(), dtype=dt, device="cuda")
        g, tb = tr.geom, tr.tables
        rng = np.random.RandomState(41)
        box = torch.from_numpy(
            10 ** rng.uniform(-4, -2, (2,) + (g.Dc,) * 3)).to("cuda", dt)
        box[1, g.c, g.c + 1, g.c] = 0.0
        flux = torch.tensor([1.0, 2.0], dtype=dt, device="cuda")
        rates = (box, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p,
                 tb.rt_tab, flux, DR, g.c, SIG, tb.bins_s, tb.bins_w)
        n0 = dict(sweep.launches)
        got = sweep.cheb_sweep_rates(*rates, bins_wh=tb.bins_wh)
        assert sweep.launches["cheb_sweep_rates_heat"] \
            == n0["cheb_sweep_rates_heat"] + 1
        assert sweep.launches["cheb_sweep_rates"] == n0["cheb_sweep_rates"]
        want = sweep.cheb_sweep_rates_ref(*rates, bins_wh=tb.bins_wh)
        for g_, w_ in zip(got, want):
            assert bool(torch.isfinite(g_).all()) and float(w_.max()) > 0
            torch.testing.assert_close(g_, w_, rtol=rtol,
                                       atol=floor * float(w_.abs().max()))
        assert torch.equal(got[0], sweep.cheb_sweep_rates(*rates))
