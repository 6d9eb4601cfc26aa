"""The port's fused sweep modes (fuse_rates: K1f; fuse_fold: K3) against
the JAX engine's fused Pallas kernels (interpret mode) and against the
port's unfused path, in float64, and the reference faults the port does
not copy: the fused kernels' unguarded division (0/0 at a zero-density
cell) and K1f's d2 on a clipped box."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.raytrace_box import grey_bins
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer
from pyc2ray_tpu.radiation import BlackBodySource
from pyc2ray_tpu.radiation.bins_compress import compress_bins
from pyc2ray_tpu.radiation.spectral_bins import make_spectral_bins

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer

SIG = 6.30e-18
DR = 6.7e20
MODES = ("fuse_rates", "fuse_fold")


def _bb_bins():
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    dense = make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                               fmin, fmax, panels=8, nodes=8)
    return compress_bins(dense, target_rel=1e-2, cache=False)


def _inputs(N, seed, ns=3):
    rng = np.random.RandomState(seed)
    ndens = 10 ** rng.uniform(-4, -2, (N, N, N))
    xh = rng.uniform(0.0, 0.9, (N, N, N))
    src = rng.randint(0, N, (ns, 3))
    flux = rng.uniform(0.5, 2.0, ns)
    return ndens, xh, src, flux


def _jax(N, R, bins, **kw):
    return JRaytracer(N, R, SIG, bins, batch_size=2, dtype=jnp.float64,
                      use_pallas=True, accumulate="scan", **kw)


def _port(N, R, bins, dtype=torch.float64, device="cpu", **kw):
    return ChebRaytracer(N, R, SIG, bins, batch_size=2, dtype=dtype,
                         device=device, **kw)


# (16, 6): c + r_max stays inside the box (unclipped); the JAX fused
# kernels use a Taylor substitute for expm1 (rel err < 2e-8)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spectrum", ["grey", "blackbody"])
def test_fused_trace_matches_jax(mode, spectrum):
    N, R = 16, 6.0
    bins = grey_bins() if spectrum == "grey" else _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=21)
    jr = _jax(N, R, bins, **{mode: True})
    tr = _port(N, R, bins, **{mode: True})
    assert jr.geom.c + jr.geom.r_max <= jr.geom.Dc - 1
    want = np.asarray(jr.trace(ndens, xh, src, flux, DR))
    got = tr.trace(ndens, xh, src, flux, DR).numpy()
    assert want.max() > 0 and np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


# (16, 8): the mesh clips the box, so the minus face of the last shell
# sits at box plane c - r = 0 while c + r leaves the box
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("N,R", [(16, 6.0), (16, 8.0), (12, 4.0)])
def test_fused_trace_matches_unfused(mode, N, R):
    bins = _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=22, ns=4)
    want = _port(N, R, bins).trace(ndens, xh, src, flux, DR)
    got = _port(N, R, bins, **{mode: True}).trace(ndens, xh, src, flux, DR)
    assert float(want.max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-9, atol=0)


def test_fuse_rates_clipped_box_d2():
    """K1f's d2 on a clipped box. The JAX kernel reads d2 from the plane
    min(c+r, Dc-1) for both signs, so on the minus face of a shell with
    c + r > Dc - 1 it takes a smaller d2: larger Gamma, and cells outside
    the R^2 sphere get a rate. The port reads each cell's true squared
    distance and agrees with the JAX engine's unfused (XLA) path there."""
    N, R = 16, 8.0
    ndens, xh, src, flux = _inputs(N, seed=23, ns=2)
    xla = np.asarray(JRaytracer(N, R, SIG, grey_bins(), batch_size=2,
                                dtype=jnp.float64).trace(
                                    ndens, xh, src, flux, DR))
    jk1f = np.asarray(_jax(N, R, grey_bins(), fuse_rates=True).trace(
        ndens, xh, src, flux, DR))
    g = _port(N, R, grey_bins()).geom
    assert g.c + g.r_max > g.Dc - 1 and g.c - g.r_max >= 0
    wrong = ~np.isclose(jk1f, xla, rtol=1e-6, atol=0)
    assert wrong.sum() > 0 and np.all(jk1f[wrong & (xla == 0)] > 0)
    got = _port(N, R, grey_bins(), fuse_rates=True).trace(
        ndens, xh, src, flux, DR).numpy()
    np.testing.assert_allclose(got, xla, rtol=1e-9, atol=0)


def test_source_cell_rate_matches_jax():
    bins = _bb_bins()
    jr = JRaytracer(12, 4.0, SIG, bins, batch_size=2, dtype=jnp.float64)
    tr = _port(12, 4.0, bins)
    Dc = tr.geom.Dc
    rng = np.random.RandomState(24)
    box = 10 ** rng.uniform(-4, -2, (2, Dc, Dc, Dc))
    flux = np.array([0.7, 1.9])
    want = np.asarray(jr._source_cell_rate(jnp.asarray(box),
                                           jnp.asarray(flux),
                                           jnp.asarray(DR)))
    c, tb = tr.geom.c, tr.tables
    got = sweep.source_cell_rate(torch.from_numpy(box)[:, c, c, c],
                                 torch.from_numpy(flux), DR, SIG, tb.bins_s,
                                 tb.bins_w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_fused_box_holds_flux_and_source_cell(mode):
    """The fused wrappers return complete boxes: with distinct fluxes, one
    of them 0, each source's box is its unit-flux box times its flux (K1f's
    flux is applied inside the kernel), the source cell is the closed form,
    equal to the JAX engine's, and the box of the zero-flux source is 0."""
    bins = _bb_bins()
    tr = _port(12, 4.0, bins)
    jr = JRaytracer(12, 4.0, SIG, bins, batch_size=3, dtype=jnp.float64)
    g, tb = tr.geom, tr.tables
    c = g.c
    rng = np.random.RandomState(29)
    box = torch.from_numpy(10 ** rng.uniform(-4, -2, (3,) + (g.Dc,) * 3))
    flux = torch.tensor([0.7, 0.0, 1.9], dtype=torch.float64)
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)

    def call(fl):
        if mode == "fuse_rates":
            return sweep.cheb_sweep(box, *geo, DR, c, SIG,
                                    bins=(tb.bins_s, tb.bins_w),
                                    rt_tab=tb.rt_tab, R2=16.0, flux=fl)
        return sweep.cheb_sweep_rates(box, *geo, tb.rt_tab, fl, DR, c, SIG,
                                      tb.bins_s, tb.bins_w)
    got, unit = call(flux), call(torch.ones_like(flux))
    assert float(unit.min()) >= 0 and float(unit[1].max()) > 0
    torch.testing.assert_close(got, unit * flux[:, None, None, None],
                               rtol=1e-14, atol=0)
    assert bool((got[1] == 0).all())
    want = np.asarray(jr._source_cell_rate(
        jnp.asarray(box.numpy()), jnp.asarray(flux.numpy()), jnp.asarray(DR)))
    assert want[0] > 0
    np.testing.assert_allclose(got[:, c, c, c].numpy(), want, rtol=1e-12,
                               atol=0)
    if mode == "fuse_rates":
        with pytest.raises(ValueError, match="need the per-source flux"):
            sweep.cheb_sweep(box, *geo, DR, c, SIG,
                             bins=(tb.bins_s, tb.bins_w), rt_tab=tb.rt_tab,
                             R2=16.0)


@pytest.mark.parametrize("mode", MODES)
def test_zero_density_cell_gives_zero(mode):
    """A zero-density cell inside the rate sphere gets Gamma = 0 in the
    port, where the JAX fused kernels divide 0 by 0."""
    N, R = 12, 4.0
    ndens, xh, src, flux = _inputs(N, seed=25, ns=2)
    cell = tuple((src[0] + [1, 2, 0]) % N)
    ndens[cell] = 0.0
    want = _port(N, R, grey_bins()).trace(ndens, xh, src, flux, DR)
    got = _port(N, R, grey_bins(), **{mode: True}).trace(
        ndens, xh, src, flux, DR)
    assert bool(torch.isfinite(got).all()) and float(got[cell]) == 0.0
    torch.testing.assert_close(got, want, rtol=1e-9, atol=0)
    jax_phi = np.asarray(_jax(N, R, grey_bins(), **{mode: True}).trace(
        ndens, xh, src, flux, DR))
    assert np.isnan(jax_phi[cell])


def test_fused_with_heating_raises():
    """A fused mode with do_heating builds and traces (it raised
    NotImplementedError before the heating channel was ported): fuse_fold
    returns (phi, heat) with phi the bits of the heat-less trace. What
    still raises is an explicit shell_segment beside a fused mode."""
    N, R = 8, 3.0
    ndens, xh, src, flux = _inputs(N, seed=28, ns=2)
    for mode in MODES:
        tr = _port(N, R, _bb_bins(), do_heating=True, **{mode: True})
        assert tr.config.do_heating
        phi, heat = tr.trace(ndens, xh, src, flux, DR)
        assert bool(torch.isfinite(heat).all()) and float(heat.max()) > 0
        if mode == "fuse_fold":
            assert torch.equal(phi, _port(N, R, _bb_bins(), fuse_fold=True)
                               .trace(ndens, xh, src, flux, DR))
        with pytest.raises(ValueError, match="does not compose"):
            _port(N, R, _bb_bins(), do_heating=True, shell_segment=2,
                  **{mode: True})


def test_fused_wrappers_dispatch_on_device():
    tr = _port(8, 3.0, _bb_bins())
    g, tb = tr.geom, tr.tables
    rng = np.random.RandomState(26)
    box = torch.from_numpy(10 ** rng.uniform(-4, -2, (2,) + (g.Dc,) * 3))
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    flux = torch.tensor([1.0, 2.0], dtype=torch.float64)
    kw = dict(bins=(tb.bins_s, tb.bins_w), rt_tab=tb.rt_tab, R2=9.0,
              flux=flux)
    sweep.reset_launches()
    assert torch.equal(sweep.cheb_sweep(box, *geo, DR, g.c, SIG, **kw),
                       sweep.cheb_sweep_ref(box, *geo, DR, g.c, SIG, **kw))
    rates = (box, *geo, tb.rt_tab, flux, DR, g.c, SIG, tb.bins_s, tb.bins_w)
    assert torch.equal(sweep.cheb_sweep_rates(*rates),
                       sweep.cheb_sweep_rates_ref(*rates))
    assert sum(sweep.launches.values()) == 0
    meta = box.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.cheb_sweep(meta, *geo, DR, g.c, SIG, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.cheb_sweep_rates(meta, *rates[1:])


@pytest.mark.cuda
def test_fused_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    # float32: an absolute floor at 1e-6 of the peak, below which Gamma
    # underflows toward denormals and the exp rounding dominates
    for dt, rtol, floor in ((torch.float32, 1e-4, 1e-6),
                            (torch.float64, 1e-10, 0.0)):
        # K1f's and K3's boxes are complete: flux and source cell inside
        tr = _port(16, 8.0, _bb_bins(), dtype=dt, device="cuda")
        g, tb = tr.geom, tr.tables
        rng = np.random.RandomState(27)
        box = torch.from_numpy(
            10 ** rng.uniform(-4, -2, (2,) + (g.Dc,) * 3)).to("cuda", dt)
        box[1, g.c, g.c + 1, g.c] = 0.0
        geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
        flux = torch.tensor([1.0, 2.0], dtype=dt, device="cuda")
        kw = dict(bins=(tb.bins_s, tb.bins_w), rt_tab=tb.rt_tab, R2=64.0,
                  flux=flux)
        rates = (box, *geo, tb.rt_tab, flux, DR, g.c, SIG, tb.bins_s,
                 tb.bins_w)
        n0 = dict(sweep.launches)
        for got, want, name in (
                (sweep.cheb_sweep(box, *geo, DR, g.c, SIG, **kw),
                 sweep.cheb_sweep_ref(box, *geo, DR, g.c, SIG, **kw),
                 "cheb_sweep_fused_rates"),
                (sweep.cheb_sweep_rates(*rates),
                 sweep.cheb_sweep_rates_ref(*rates), "cheb_sweep_rates")):
            assert sweep.launches[name] == n0[name] + 1
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, want, rtol=rtol,
                                       atol=floor * float(want.abs().max()))
