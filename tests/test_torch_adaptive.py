"""The port's adaptive-radius engine (ops/adaptive.py) against the JAX
package's (XLA path, accumulate="scan"), in float64 on the CPU: the bucket
policy bit for bit, Gamma and heat at rtol 1e-10, and the cases of
tests/test_adaptive.py (top bucket, faint-source truncation, mixed-catalog
additivity, stats, engine: adaptive through C2Ray_Test with the subbox
keys)."""

import os
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyc2ray_tpu as jpc
from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.adaptive import (AdaptiveRaytracer as JAdaptive,
                                      stromgren_radius_cells as j_stromgren)
from pyc2ray_tpu.radiation import BlackBodySource
from pyc2ray_tpu.radiation.bins_compress import compress_bins
from pyc2ray_tpu.radiation.spectral_bins import make_spectral_bins

import pyc2ray_torch as tpc
from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.adaptive import (AdaptiveRaytracer,
                                        stromgren_radius_cells)
from pyc2ray_torch.ops.raytrace_box import grey_bins
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer

SIG = 6.30e-18
DR = 6.7e20
ND = 1.0e-3
ROOT = pathlib.Path(__file__).resolve().parents[1]
# fluxes in every bucket of the ladder [6, 12, 24] at ND and DR (4, 2, 2
# sources): the Stromgren radius of F = 1 is 14.5 cells, safety 2
MIXED_FLUX = np.array([1e3, 3e-3, 1e-4, 0.05, 1e-4, 1e3, 1e-3, 0.03])


def _bb_bins():
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    dense = make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                               fmin, fmax, panels=8, nodes=8)
    return compress_bins(dense, target_rel=1e-2, cache=False)


def _pair(N, R, bins=None, fuse_fold=False, **kw):
    """The JAX engine (XLA path, scan accumulate) and the port's, same
    arguments; ``fuse_fold`` selects the port's sweep mode."""
    bins = grey_bins() if bins is None else bins
    ja = JAdaptive(N, R, SIG, bins, batch_size=2, dtype=jnp.float64,
                   accumulate="scan", **kw)
    ta = AdaptiveRaytracer(N, R, SIG, bins, batch_size=2,
                           dtype=torch.float64, device="cpu",
                           fuse_fold=fuse_fold, **kw)
    return ja, ta


def _fields(N, seed, ns):
    rng = np.random.RandomState(seed)
    nd = ND * np.ones((N, N, N))
    xh = rng.uniform(0, 0.2, (N, N, N))
    return nd, xh, rng.randint(0, N, (ns, 3))


def test_stromgren_radius_equals_jax():
    flux = 10 ** np.linspace(-5, 4, 37)
    for avg in (1e-4, ND, 0.525, 2.0):
        got = stromgren_radius_cells(flux, DR, avg)
        want = j_stromgren(flux, DR, avg)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float64
    assert np.all(np.diff(stromgren_radius_cells(flux, DR, ND)) > 0)


@pytest.mark.parametrize("N,R,kw", [
    (32, 16.0, {}),                       # ladder 4, 8, 16
    (16, 40.0, {}),                       # R beyond the mesh: clipped to N
    (32, 3.0, {}),                        # below R_min: one bucket at R
    (32, 16.0, dict(radii=[5.0, 11.0], R_min=2.0, safety=3.0)),
])
def test_bucket_assignment_equals_jax(N, R, kw):
    """Radius ladder and bucket index per source bit for bit, brighter
    sources never in a smaller bucket."""
    ja, ta = _pair(N, R, **kw)
    assert ta.radii == ja.radii
    assert [e.geom.Dc for e in ta.engines] == [e.geom.Dc for e in ja.engines]
    assert ta.needs_flux_bucketing and ta.config.N == N
    flux = 10 ** np.random.RandomState(4).uniform(-5, 4, 200)
    for avg in (1e-4, ND, 0.525):
        got = ta.assign_buckets(flux, DR, avg)
        np.testing.assert_array_equal(got, ja.assign_buckets(flux, DR, avg))
        order = np.argsort(flux)
        assert np.all(np.diff(got[order]) >= 0)


def test_prepare_sources_needs_policy_inputs():
    _, ta = _pair(16, 6.0)
    with pytest.raises(ValueError, match="needs dr and avg_dens"):
        ta.prepare_sources(np.zeros((1, 3)), np.ones(1))
    batches, none = ta.prepare_sources(np.zeros((3, 3)), MIXED_FLUX[:3],
                                       dr=DR, avg_dens=ND)
    assert none is None and sum(batches.counts) == 3
    assert "Adaptive radii" in ta.describe_buckets(batches)
    assert "<n> = 1.000e-03" in ta.describe_buckets(batches)


@pytest.mark.parametrize("fuse_fold", [False, True])
def test_top_bucket_matches_single_engine(fuse_fold):
    """Sources bright enough for the top bucket give the single engine's
    result bit for bit, and the JAX engine's at rtol 1e-10."""
    N, R = 16, 6.0
    nd, xh, src = _fields(N, 1, 4)
    flux = 1e4 * np.ones(4)
    ja, ta = _pair(N, R, fuse_fold=fuse_fold)
    phi, st = ta.trace(nd, xh, src, flux, DR, stats=True)
    assert st["bucket_counts"][-1] == 4 and sum(st["bucket_counts"]) == 4
    single = ChebRaytracer(N, R, SIG, grey_bins(), batch_size=2,
                           dtype=torch.float64, device="cpu",
                           fuse_fold=fuse_fold)
    assert torch.equal(phi, single.trace(nd, xh, src, flux, DR))
    np.testing.assert_allclose(phi.numpy(),
                               np.asarray(ja.trace(nd, xh, src, flux, DR)),
                               rtol=1e-10, atol=0)


def test_faint_source_truncation_bounded():
    """A faint source in a small bucket loses less than loss_fraction of
    its photons against the full-radius engine, as in the JAX engine."""
    N, R = 32, 14.0
    nd = ND * np.ones((N, N, N))
    xh = np.zeros((N, N, N))
    src = np.array([[16, 16, 16]])
    flux = np.array([1e-2])
    ja, ta = _pair(N, R, safety=2.0)
    phi_a, st = ta.trace(nd, xh, src, flux, DR, stats=True)
    assert st["bucket_counts"][-1] == 0
    phi_j, st_j = ja.trace(nd, xh, src, flux, DR, stats=True)
    assert st == st_j
    np.testing.assert_allclose(phi_a.numpy(), np.asarray(phi_j), rtol=1e-10,
                               atol=0)
    full = ChebRaytracer(N, R, SIG, grey_bins(), batch_size=2,
                         dtype=torch.float64, device="cpu")
    phi_s = full.trace(nd, xh, src, flux, DR).numpy()
    deficit = float(((phi_s - phi_a.numpy()) * nd * (1 - xh)).sum()) \
        * DR ** 3
    assert -1e-40 <= deficit < 1e-2 * 1e48 * float(flux[0])


@pytest.mark.parametrize("fuse_fold", [False, True])
def test_mixed_catalog_additivity(fuse_fold):
    """Sources in every bucket: Gamma equals the sum of the per-bucket
    engines' traces bit for bit (same boxes, same order), and the JAX
    engine's at rtol 1e-10."""
    N, R = 24, 24.0
    nd, xh, src = _fields(N, 3, MIXED_FLUX.size)
    ja, ta = _pair(N, R, fuse_fold=fuse_fold)
    assert ta.radii == [6.0, 12.0, 24.0]
    phi, st = ta.trace(nd, xh, src, MIXED_FLUX, DR, stats=True)
    assert st["bucket_counts"] == [4, 2, 2]
    total = torch.zeros((N,) * 3, dtype=torch.float64)
    b = ta.assign_buckets(MIXED_FLUX, DR, ND)
    for k, eng in enumerate(ta.engines):
        sel = np.nonzero(b == k)[0]
        total = total + eng.trace(nd, xh, src[sel], MIXED_FLUX[sel], DR)
    assert torch.equal(phi, total)
    want = np.asarray(ja.trace(nd, xh, src, MIXED_FLUX, DR))
    np.testing.assert_allclose(phi.numpy(), want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("fuse_fold", [False, True])
def test_heating_matches_jax(fuse_fold):
    """With do_heating: (Gamma, heat) summed over the buckets, both at rtol
    1e-10 of the JAX engine; the K3h path (fuse_fold) included."""
    N, R = 16, 12.0
    nd, xh, src = _fields(N, 5, 5)
    flux = np.array([1e3, 1e-4, 0.05, 1e-4, 2e-3])
    bins = _bb_bins()
    ja, ta = _pair(N, R, bins=bins, do_heating=True, fuse_fold=fuse_fold)
    phi, heat = ta.trace(nd, xh, src, flux, DR)
    phi_j, heat_j = ja.trace(nd, xh, src, flux, DR)
    assert heat.numpy().max() > 0
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_j), rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(heat.numpy(), np.asarray(heat_j), rtol=1e-10,
                               atol=0)
    # stats drop the heat, as in the JAX engine
    phi_s, st = ta.trace(nd, xh, src, flux, DR, stats=True)
    assert torch.equal(phi_s, phi) and len(st["bucket_counts"]) == 2


def test_empty_catalog_and_tensor_fields():
    """No source: zeros of the grid's shape (and heat). Fields given as
    tensors are used without a numpy round trip by AdaptiveRaytracer.trace
    (avg_dens from their mean) and ChebRaytracer.trace."""
    N = 8
    ta = AdaptiveRaytracer(N, 6.0, SIG, _bb_bins(), dtype=torch.float64,
                           device="cpu", do_heating=True)
    batches, _ = ta.prepare_sources(np.zeros((0, 3)), np.zeros(0), dr=DR,
                                    avg_dens=ND)
    nd = torch.full((N ** 3,), ND, dtype=torch.float64)
    phi, heat = ta.trace_batches(nd, torch.zeros_like(nd), batches, None, DR)
    assert phi.shape == heat.shape == (N ** 3,)
    assert not phi.any() and not heat.any()

    nd3, xh3, src = _fields(N, 6, 3)
    single = ta.engines[0]
    want = (ta.trace(nd3, xh3, src, np.ones(3), DR),
            single.trace(nd3, xh3, src, np.ones(3), DR))
    tensors = (torch.from_numpy(nd3), torch.from_numpy(xh3))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.Tensor, "__array__", _no_numpy, raising=False)
        mp.setattr(torch.Tensor, "numpy", _no_numpy)
        got = (ta.trace(*tensors, src, np.ones(3), DR),
               single.trace(*tensors, src, np.ones(3), DR))
    finally:
        mp.undo()
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


def _no_numpy(*args, **kwargs):
    raise AssertionError("a field was converted through numpy")


# ---- engine: adaptive through the model layer --------------------------

def _adaptive_params(tmp, sub, replace=()):
    """tests/test_adaptive.py's parameters: the single-source example with
    NumTau 200 and engine: adaptive."""
    d = tmp / sub
    os.makedirs(d, exist_ok=True)
    p = (ROOT / "examples" / "single_source_test" / "parameters.yml"
         ).read_text().replace("NumTau: 2000", "NumTau: 200")
    p = p.replace("dtype: float64", "dtype: float64\n  engine: adaptive")
    p = p.replace("results_basename: ./results/", f"results_basename: {d}/")
    for a, b in replace:
        p = p.replace(a, b)
    f = d / "p.yml"
    f.write_text(p)
    return str(f)


def test_subbox_keys_steer_bucket_policy(tmp_path):
    """subboxsize -> minimum bucket radius, max_subbox -> radius cap, both
    clamped to R_max_LLS, with the JAX model layer's ladders."""
    cases = [("shipped", ()),
             ("floor", (("subboxsize: 150", "subboxsize: 2"),)),
             ("cap", (("subboxsize: 150", "subboxsize: 2"),
                      ("max_subbox: 1000", "max_subbox: 6")))]
    got = {}
    for name, rep in cases:
        sim = tpc.C2Ray_Test(_adaptive_params(tmp_path, "t" + name, rep), 8,
                             device="cpu")
        jsim = jpc.C2Ray_Test(_adaptive_params(tmp_path, "j" + name, rep), 8)
        rt = sim.raytracer
        assert type(rt) is AdaptiveRaytracer
        assert rt.radii == jsim.raytracer.radii
        assert (rt.R_min, rt.R_max) == (jsim.raytracer.R_min,
                                        jsim.raytracer.R_max)
        assert all(e.fuse_fold for e in rt.engines)
        got[name] = rt
    assert got["shipped"].radii == [min(8.0, float(sim.R_max_LLS))]
    assert len(got["floor"].radii) > 1 and got["floor"].R_min == 2.0
    assert max(got["cap"].radii) <= 6.0


def test_adaptive_model_matches_jax(tmp_path):
    """One evolve3D step of C2Ray_Test with engine: adaptive and a user
    subboxsize (two buckets), against the JAX model at the tolerance of
    tests/test_torch_models.py (rtol 1e-7); do_raytracing's stats carry the
    bucket assignment; the evolve log names the buckets."""
    rep = (("subboxsize: 150", "subboxsize: 2"),)
    sims = [tpc.C2Ray_Test(_adaptive_params(tmp_path, "t", rep), 8,
                           device="cpu"),
            jpc.C2Ray_Test(_adaptive_params(tmp_path, "j", rep), 8)]
    flux = np.array([1.0, 1e-3, 2.0])
    pos = np.array([[4.0, 2.0, 7.0], [4.0, 6.0, 1.0], [4.0, 3.0, 5.0]])
    out = []
    for sim in sims:
        sim.ndens = 1e-3 * np.ones((8, 8, 8))
        phi, st = sim.do_raytracing(flux, pos, stats=True)
        sim.evolve3D(1e13, flux, pos)
        out.append((phi, st, np.asarray(sim.xh), np.asarray(sim.phi_ion)))
    (phi, st, xh, gam), (jphi, jst, jxh, jgam) = out
    assert st["bucket_counts"] == jst["bucket_counts"]
    assert sum(st["bucket_counts"]) == 3 and len(st["bucket_counts"]) > 1
    assert st["loss_fraction"] == pytest.approx(jst["loss_fraction"],
                                                rel=1e-7, abs=1e-12)
    np.testing.assert_allclose(phi, jphi, rtol=1e-7, atol=0)
    np.testing.assert_allclose(xh, jxh, rtol=1e-7, atol=0)
    np.testing.assert_allclose(gam, jgam, rtol=1e-7, atol=0)
    assert xh.max() > 1.2e-3
    assert "Adaptive radii (Stromgren policy" in open(sims[0].logfile).read()


# ---- on the card ------------------------------------------------------

@pytest.mark.cuda
def test_adaptive_on_cuda_matches_buckets_and_cpu():
    """On the card: Gamma equals the sum of one fuse_fold engine per
    bucket bit for bit, each bucket launching K3 once per batch; the GPU
    against the CPU at rtol 1e-10 in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    N, R = 24, 24.0
    nd, xh, src = _fields(N, 3, MIXED_FLUX.size)
    bins = _bb_bins()
    ta = AdaptiveRaytracer(N, R, SIG, bins, batch_size=2,
                           dtype=torch.float64, device="cuda",
                           fuse_fold=True)
    nd_d = torch.from_numpy(nd).to("cuda").reshape(-1)
    xh_d = torch.from_numpy(xh).to("cuda").reshape(-1)
    batches, _ = ta.prepare_sources(src, MIXED_FLUX, dr=DR, avg_dens=ND)
    sweep.reset_launches()
    phi, _ = ta.trace_batches(nd_d, xh_d, batches, None, DR)
    assert sweep.launches["cheb_sweep_rates"] == sum(
        p.shape[0] for p in batches.pos if p is not None)
    total = None
    for eng, pos_b, flux_b in zip(ta.engines, batches.pos, batches.flux):
        p, _ = eng.trace_batches(nd_d, xh_d, pos_b, flux_b, DR)
        total = p if total is None else total + p
    assert torch.equal(phi, total)
    cpu = AdaptiveRaytracer(N, R, SIG, bins, batch_size=2,
                            dtype=torch.float64, device="cpu",
                            fuse_fold=True)
    want = cpu.trace(nd, xh, src, MIXED_FLUX, DR)
    got = ta.trace(nd_d, xh_d, src, MIXED_FLUX, DR)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-10, atol=0)
    # ChebRaytracer.trace takes the CUDA fields as they are
    top = ta.engines[-1]
    torch.testing.assert_close(
        top.trace(nd_d, xh_d, src, MIXED_FLUX, DR).cpu(),
        cpu.engines[-1].trace(nd, xh, src, MIXED_FLUX, DR), rtol=1e-10,
        atol=0)
