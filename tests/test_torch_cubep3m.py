"""The port's N-body-coupled models (C2Ray_CubeP3M, C2Ray_244Test) against
the JAX package's on the same synthetic inputs (make_synthetic_inputs of
examples/eor_simulation/run_test.py, N = 12, float64, NumTau 200): one
timestep within the tolerance of tests/test_torch_models.py (rtol 1e-7 in
xh and Gamma), outputs bit-equal, resume restoring xh and T to rtol 1e-12;
and chip_smoke.py's catalog reader against read_sources on the committed
catalogs."""

import os
import pathlib
import sys

import numpy as np
import pytest

import pyc2ray_tpu as jpc
import pyc2ray_torch as tpc
from pyc2ray_torch.io import read_cbin

ROOT = pathlib.Path(__file__).resolve().parents[1]
EOR = ROOT / "examples" / "eor_simulation"
N = 12
ZLIST = [21.062, 20.134]
RTOL = 1e-7            # tests/test_torch_models.py's model-level tolerance


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    sys.path.insert(0, str(EOR))
    try:
        from run_test import make_synthetic_inputs
    finally:
        sys.path.pop(0)
    d = str(tmp_path_factory.mktemp("eor_inputs")) + "/"
    make_synthetic_inputs(N, d, ZLIST)
    return d


def _params(tmp, sub, inputs, replace=()):
    """The EoR parameters of tests/test_models.py: results and inputs in
    the test's directories, NumTau 200, float64."""
    results = tmp / sub
    results.mkdir()
    p = (EOR / "parameters.yml").read_text()
    for a, b in (("results_basename: ./results/",
                  f"results_basename: {results}/"),
                 ("inputs_basename: ./inputs/", f"inputs_basename: {inputs}"),
                 ("NumTau: 2000", "NumTau: 200"),
                 ("dtype: float32", "dtype: float64")) + tuple(replace):
        p = p.replace(a, b)
    f = tmp / f"{sub}.yml"
    f.write_text(p)
    return str(f), p


def _slice(sim, inputs):
    """tests/test_models.py's slice: density, catalog, one cosmological
    timestep on the first four sources, outputs at the next redshift."""
    sim.read_density(ZLIST[0])
    srcpos, flux = sim.read_sources(os.path.join(
        inputs, "sources", f"{ZLIST[0]:.3f}-sources.hdf5"))
    dt = sim.set_timestep(ZLIST[0], ZLIST[1], 1)
    sim.cosmo_evolve(dt)
    sim.evolve3D(dt, flux[:4], srcpos[:, :4])
    sim.write_output(ZLIST[1])
    return srcpos, flux, dt


def _resume(tmp, sub, text, cls, **kw):
    f = tmp / f"{sub}_resume.yml"
    f.write_text(text.replace("resume: 0", "resume: 1"))
    return cls(str(f), N, **kw)


def _models(tmp, inputs, cls, replace=()):
    """The port's and the JAX package's model after one slice each, with
    their parameter texts."""
    out = []
    for sub, mod, kw in (("t", tpc, dict(device="cpu")), ("j", jpc, {})):
        pfile, text = _params(tmp, sub, inputs, replace)
        sim = getattr(mod, cls)(pfile, N, **kw)
        out.append((sim, text, _slice(sim, inputs)))
    return out


def _same_outputs(tsim, jsim):
    """Every output file of the port's slice reads back as its state, and
    equals the JAX package's within RTOL."""
    names = sorted(os.listdir(jsim.results_basename))
    assert sorted(os.listdir(tsim.results_basename)) == names
    for name in names:
        if not name.endswith(".dat"):
            continue
        bits = 32 if name.startswith("IonRates") else 64
        got = read_cbin(tsim.results_basename + name, bits=bits, order="F")
        want = read_cbin(jsim.results_basename + name, bits=bits, order="F")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                   err_msg=name)


def test_cubep3m_resume(tmp_path, inputs):
    """engine: adaptive, as the EoR example; catalog, density, dt, xh and
    Gamma against the JAX model; resume from the outputs."""
    (tsim, text, (pos, flux, dt)), (jsim, jtext, (jpos, jflux, jdt)) = \
        _models(tmp_path, inputs, "C2Ray_CubeP3M")
    assert type(tsim.raytracer) is tpc.AdaptiveRaytracer
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(flux, jflux)
    assert dt == jdt and tsim.zred == jsim.zred and tsim.dr == jsim.dr
    np.testing.assert_array_equal(tsim.ndens, jsim.ndens)
    np.testing.assert_allclose(tsim.xh, jsim.xh, rtol=RTOL, atol=0)
    np.testing.assert_allclose(tsim.phi_ion, jsim.phi_ion, rtol=RTOL,
                               atol=0)
    assert tsim.xh.max() > 1.2e-3 and np.all(np.isfinite(tsim.phi_ion))
    _same_outputs(tsim, jsim)
    np.testing.assert_array_equal(
        read_cbin(tsim.results_basename + f"xfrac_{ZLIST[1]:.3f}.dat",
                  bits=64, order="F"), tsim.xh)

    sim2 = _resume(tmp_path, "t", text, tpc.C2Ray_CubeP3M, device="cpu")
    jsim2 = _resume(tmp_path, "j", jtext, jpc.C2Ray_CubeP3M)
    assert abs(sim2.zred_0 - ZLIST[1]) < 1e-3
    assert (sim2.zred_0, sim2.age_0, sim2.time, sim2.prev_zdens) == \
        (jsim2.zred_0, jsim2.age_0, jsim2.time, jsim2.prev_zdens)
    np.testing.assert_array_equal(sim2.ndens, jsim2.ndens)
    np.testing.assert_allclose(sim2.xh, tsim.xh, rtol=1e-12)
    np.testing.assert_allclose(sim2.phi_ion, tsim.phi_ion, rtol=1e-6)
    assert "Resuming" in open(sim2.logfile).read()


def test_cubep3m_resume_thermal_channel(tmp_path, inputs):
    """Non-isothermal runs write Temper outputs, and resume reloads the
    temperature (rtol 1e-12); T after the step against the JAX model."""
    rep = (("  temp0: 1e4", "  temp0: 1e4\n  isothermal: 0"),
           ("compute_heating_rates: 0", "compute_heating_rates: 1"),
           ("engine: adaptive", "engine: cheb"))
    (tsim, text, _), (jsim, _, _) = _models(tmp_path, inputs,
                                            "C2Ray_CubeP3M", rep)
    assert tsim.thermal is not None and tsim.raytracer.fuse_fold
    temp = np.asarray(tsim.temp).copy()
    assert temp.std() > 0
    np.testing.assert_allclose(temp, np.asarray(jsim.temp), rtol=RTOL)
    np.testing.assert_allclose(tsim.xh, jsim.xh, rtol=RTOL, atol=0)
    _same_outputs(tsim, jsim)
    sim2 = _resume(tmp_path, "t", text, tpc.C2Ray_CubeP3M, device="cpu")
    np.testing.assert_allclose(sim2.temp, temp, rtol=1e-12)
    np.testing.assert_allclose(sim2.xh, tsim.xh, rtol=1e-12)


def test_cubep3m_box_engine(tmp_path, inputs):
    """C2Ray_CubeP3M with engine: box builds the port's BoxRaytracer; one
    slice against the JAX model on its BoxRaytracer."""
    from pyc2ray_torch.ops.raytrace_box import BoxRaytracer
    (tsim, _, _), (jsim, _, _) = _models(
        tmp_path, inputs, "C2Ray_CubeP3M", (("engine: adaptive",
                                             "engine: box"),))
    assert type(tsim.raytracer) is BoxRaytracer
    assert type(jsim.raytracer).__name__ == "BoxRaytracer"
    assert tsim.xh.max() > 1.2e-3 and np.all(np.isfinite(tsim.phi_ion))
    np.testing.assert_allclose(tsim.xh, jsim.xh, rtol=RTOL, atol=0)
    np.testing.assert_allclose(tsim.phi_ion, jsim.phi_ion, rtol=RTOL, atol=0)
    _same_outputs(tsim, jsim)


def test_paper244_model_end_to_end(tmp_path, inputs):
    """C2Ray_244Test: Mpc/h units, EdS analytic time<->z, incremental
    dilution, catch-up, outputs and resume, against the JAX model."""
    (tsim, text, _), (jsim, _, _) = _models(
        tmp_path, inputs, "C2Ray_244Test", (("engine: adaptive",
                                             "engine: cheb"),))
    z = 18.7
    assert abs(tsim.time2zred(tsim.zred2time(z)) - z) < 1e-8
    assert tsim.zred2time(z) == jsim.zred2time(z)
    assert tsim.R_max_LLS == jsim.R_max_LLS and tsim.dr == jsim.dr
    assert tsim.dr > tsim.dr_c / (1 + tsim.zred_0)   # grew with expansion
    np.testing.assert_allclose(tsim.xh, jsim.xh, rtol=RTOL, atol=0)
    np.testing.assert_allclose(tsim.phi_ion, jsim.phi_ion, rtol=RTOL, atol=0)
    assert tsim.xh.mean() > 1.2e-3
    for sim in (tsim, jsim):
        sim.cosmo_evolve_to_now()
        assert abs(sim.time2zred(sim.time) - sim.zred) < 1e-10
    assert tsim.zred == jsim.zred
    np.testing.assert_array_equal(tsim.ndens, jsim.ndens)
    _same_outputs(tsim, jsim)
    sim2 = _resume(tmp_path, "t", text, tpc.C2Ray_244Test, device="cpu")
    assert abs(sim2.zred_0 - ZLIST[1]) < 1e-3
    np.testing.assert_allclose(sim2.xh, tsim.xh, rtol=1e-12)


def test_chip_smoke_catalog_reader_equals_read_sources(tmp_path):
    """chip_smoke.py reads the committed catalogs without h5py (the card's
    machine has none); its positions and fluxes equal read_sources'."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    pfile, _ = _params(tmp_path, "c", str(EOR / "inputs") + "/")
    sim = tpc.C2Ray_CubeP3M(pfile, 8, device="cpu")
    for z in ZLIST:
        f = str(EOR / "inputs" / "sources" / f"{z:.3f}-sources.hdf5")
        pos, flux = chip_smoke.read_catalog(sim, f)
        want_pos, want_flux = sim.read_sources(f)
        assert pos.shape == (3, 20000) and flux.shape == (20000,)
        np.testing.assert_array_equal(pos, want_pos)
        np.testing.assert_array_equal(flux, want_flux)
    bad = tmp_path / "bad.hdf5"
    bad.write_bytes(b"\x00" * 600000)
    with pytest.raises(ValueError, match="HDF5"):
        chip_smoke.read_catalog(sim, str(bad))


@pytest.mark.cuda
def test_cubep3m_on_cuda_matches_cpu(tmp_path):
    """One slice of the EoR model at N = 32 (engine adaptive, float32 as
    parameters.yml) on the card against the CPU: xh and Gamma at rtol 1e-4
    (Gamma above 1e-6 of its peak). The card's machine has no h5py, so the
    catalog is made here and enters through the reader's conversion."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    n = 32
    inputs = tmp_path / "inputs"
    (inputs / "coarser_densities").mkdir(parents=True)
    (inputs / "sources").mkdir()
    rng = np.random.RandomState(1)
    rho = ((1.0 + 0.3 * rng.standard_normal((n, n, n))).clip(0.1)
           * 1.0e-28).astype(np.float32)
    with open(inputs / "coarser_densities" / f"{ZLIST[0]:.3f}n_all.dat",
              "wb") as f:
        np.asarray([n, n, n], dtype=np.int32).tofile(f)
        rho.flatten(order="F").tofile(f)
    positions = rng.randint(1, n + 1, size=(200, 3))
    masses = 10 ** rng.uniform(9, 11, 200)
    out = {}
    for device in ("cuda", "cpu"):
        pfile, _ = _params(tmp_path, device, str(inputs) + "/",
                           (("dtype: float64", "dtype: float32"),))
        sim = tpc.C2Ray_CubeP3M(pfile, n, device=device)
        sim.read_density(ZLIST[0])
        srcpos, flux = sim._sources_from_catalog(positions, masses, "test")
        dt = sim.set_timestep(ZLIST[0], ZLIST[1], 1)
        sim.cosmo_evolve(dt)
        sim.evolve3D(dt, flux, srcpos)
        out[device] = (np.asarray(sim.xh), np.asarray(sim.phi_ion))
    (xg, pg), (xc, pc) = out["cuda"], out["cpu"]
    assert np.all(np.isfinite(xg)) and xg.max() > 1.2e-3
    np.testing.assert_allclose(xg, xc, rtol=1e-4, atol=0)
    np.testing.assert_allclose(pg, pc, rtol=1e-4, atol=1e-6 * pc.max())
