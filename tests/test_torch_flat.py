"""The port's table-exact flat engine (ops/geometry.py, ops/raytrace.py and
the model layer's default engine) against the JAX package's, the sequential
oracles and the single-source golden, in float64 on the CPU."""

import pathlib
import sys
import tempfile

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops import geometry as j_geometry
from pyc2ray_tpu.ops.raytrace import RaytraceConfig as JConfig
from pyc2ray_tpu.ops.raytrace import Raytracer as JRaytracer
from pyc2ray_tpu.radiation import BlackBodySource, make_tau_table

import pyc2ray_torch as tpc
from pyc2ray_torch.ops import geometry
from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
from pyc2ray_torch.native_ext import oracle_sweep_native
from pyc2ray_torch.oracle import oracle_raytrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIG = 6.30e-18
DR = 6.7e20


def _tables(numtau=200):
    tau, dlogtau = make_tau_table(-20.0, 4.0, numtau)
    bb = BlackBodySource(5e4, False, ev2fr * 13.598, 2.8)
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    thin, thick = bb.make_photo_table(tau, fmin, fmax, 1e48)
    hthin, hthick = bb.make_heat_table(tau, fmin, fmax, 1e48)
    return thin, thick, hthin, hthick, -20.0, dlogtau


TABLES = _tables()


def _engines(N, R, B, grey=False, heating=False):
    kw = dict(N=N, R_max_LLS=R, sig=SIG, batch_size=B, grey_analytic=grey,
              do_heating=heating)
    tabs = (TABLES[0], TABLES[1], TABLES[4], TABLES[5], TABLES[2],
            TABLES[3])
    return (JRaytracer(JConfig(dtype=jnp.float64, **kw), *tabs),
            Raytracer(RaytraceConfig(dtype=torch.float64, **kw), *tabs,
                      device="cpu"))


def _fields(N, seed):
    rng = np.random.RandomState(seed)
    return (10 ** rng.uniform(-4, -2, (N,) * 3),
            rng.uniform(0.0, 0.9, (N,) * 3))


@pytest.mark.parametrize("N,max_q", [(8, 6), (16, 13), (17, 30)])
def test_geometry_equals_jax_numpy_builder(N, max_q):
    """Every field of the octahedral tables, bit for bit, against the JAX
    package's numpy builder; (17, 30) is an odd mesh with the full box."""
    want = j_geometry._build_geometry_numpy(N, max_q)
    for got in (geometry._build_geometry_numpy(N, max_q),
                geometry.build_geometry(N, max_q)):
        assert got._fields == want._fields
        for name, g, w in zip(want._fields, got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and np.array_equal(g, w), name
            else:
                assert g == w, name
    assert geometry.build_geometry(N, max_q) is \
        geometry.build_geometry(N, max_q)


# (N, R, sources): a source at a box corner in each, the octahedron
# clipped by the periodic box (R < N / 2) or not
CASES = {"N12_R4.5": (12, 4.5, [[0, 0, 0]]),
         "N13_R30": (13, 30.0, [[0, 0, 0], [5, 7, 2], [12, 12, 12]]),
         "N16_R6": (16, 6.0, [[15, 0, 15], [8, 8, 8], [3, 12, 1],
                              [0, 5, 9], [11, 2, 14]]),
         "N17_R7.5": (17, 7.5, [[16, 16, 0], [4, 9, 13]])}


@pytest.mark.parametrize("mode", ["grey", "tables", "heating"])
@pytest.mark.parametrize("case", list(CASES))
def test_flat_matches_jax(case, mode):
    """Gamma (and the heating rate) of the flat engine against the JAX
    Raytracer: rtol 1e-12. With tables both packages interpolate
    log10(tau); XLA's log10 differs from libm's in the last bit for ~17% of
    arguments, which the thick-cell difference L(tau_in) - L(tau_out)
    amplifies by up to 1/dtau, so there an absolute floor of 1e-12 of the
    peak stands beside it (the port's log10 is the oracle's:
    test_flat_matches_native_oracle)."""
    N, R, pos = CASES[case]
    pos = np.array(pos)
    flux = np.linspace(0.5, 2.0, len(pos))
    nd, xh = _fields(N, seed=N)
    jr, tr = _engines(N, R, B=2, grey=(mode == "grey"),
                      heating=(mode == "heating"))
    want = jr.trace(nd, xh, pos, flux, DR)
    got = tr.trace(nd, xh, pos, flux, DR)
    if mode != "heating":
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (N,) * 3 and g.dtype == torch.float64
        assert w.max() > 0
        atol = 0.0 if mode == "grey" else 1e-12 * w.max()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=atol)


def test_flat_matches_native_oracle():
    """Gamma and the heating rate against the sequential C++ oracle
    (C2Ray's loops cell by cell, libm's log10), at the tolerance of the JAX
    package's own oracle tests."""
    N, R, pos = CASES["N16_R6"]
    pos = np.array(pos)
    flux = np.linspace(0.5, 2.0, len(pos))
    nd, xh = _fields(N, seed=3)
    _, tr = _engines(N, R, B=3, heating=True)
    phi, heat = tr.trace(nd, xh, pos, flux, DR)
    phi_o, heat_o, _ = oracle_sweep_native(nd, xh, pos, flux, DR, SIG, R,
                                           tables=TABLES)
    np.testing.assert_allclose(phi.numpy(), phi_o, rtol=1e-11)
    np.testing.assert_allclose(heat.numpy(), heat_o, rtol=1e-11)


@pytest.mark.parametrize("N,src", [(8, [3, 4, 2]), (10, [0, 9, 5]),
                                   (11, [10, 10, 10])])
def test_sweep_coldens_matches_oracle(N, src):
    """The outgoing column density of one source over the full box against
    pyc2ray_torch.oracle.oracle_raytrace."""
    nd, xh = _fields(N, seed=N + 1)
    _, tr = _engines(N, 1e9, B=1, grey=True)
    cd = tr.sweep_coldens(nd, xh, np.array(src), DR)
    _, _, cd_o = oracle_raytrace(nd, xh, np.array([src]), np.array([1.0]),
                                 DR, SIG, 1e9, grey=True)
    np.testing.assert_allclose(cd, cd_o, rtol=1e-11)


def test_trace_batches_flat_io_and_padding_sources():
    """trace_batches takes and returns flat (N^3,) grids; the sources that
    pad the last batch (zero flux at the origin) add nothing, whatever the
    batch size."""
    N, R, pos = CASES["N16_R6"]
    pos = np.array(pos)
    flux = np.linspace(0.5, 2.0, len(pos))
    nd, xh = _fields(N, seed=4)
    out = []
    for B in (1, 2, 8):
        _, tr = _engines(N, R, B=B)
        pos_b, flux_b = tr.prepare_sources(pos, flux)
        assert pos_b.shape == (-(-len(pos) // B), B, 3)
        phi, heat = tr.trace_batches(torch.from_numpy(nd.ravel()),
                                     torch.from_numpy(xh.ravel()), pos_b,
                                     flux_b, DR)
        assert phi.shape == (N ** 3,) and heat is None
        out.append(phi)
    for phi in out[1:]:
        torch.testing.assert_close(phi, out[0], rtol=1e-14, atol=0)


def test_zero_density_cell_gives_zero():
    """A cell without gas absorbs nothing: its rate per atom is 0, not
    0/0."""
    N = 8
    nd, xh = _fields(N, seed=6)
    nd[3, 4, 4] = 0.0
    _, tr = _engines(N, 1e9, B=1)
    phi = tr.trace(nd, xh, np.array([[3, 3, 3]]), np.array([1.0]), DR)
    assert torch.isfinite(phi).all() and phi[3, 4, 4] == 0.0


def test_golden_single_source_at_N16():
    """examples/single_source_test through the port's default engine at
    N = 16, two slices of two timesteps, against the sequential C++
    oracle's evolve loop: the example's eight tolerances (relative max
    2e-5)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    with tempfile.TemporaryDirectory() as tmp:
        sim, stats, _, _ = chip_smoke.golden_run(16, 2, 2, "cpu", tmp + "/")
    assert type(sim.raytracer) is Raytracer
    assert sim.raytracer.config.dtype == torch.float64
    for name, (value, tol) in stats.items():
        assert np.isfinite(value) and abs(value) <= tol, name
    assert sim.xh.max() > 0.5


def test_flat_model_matches_jax(tmp_path):
    """C2Ray_Test on examples/single_source_test/parameters.yml (engine
    unset: flat) against the JAX model at N = 12, two timesteps, float64:
    xh and Gamma after each, and do_raytracing."""
    import pyc2ray_tpu as jpc
    yml = (ROOT / "examples" / "single_source_test"
           / "parameters.yml").read_text()
    assert "engine:" not in yml
    N = 12
    srcpos = np.array([[N // 2], [N // 2], [N // 2]], dtype=float)
    srcflux = np.array([10.0])
    res = {}
    for name, mod in (("jax", jpc), ("torch", tpc)):
        pfile = tmp_path / f"{name}.yml"
        pfile.write_text(yml.replace("results_basename: ./results/",
                                     f"results_basename: {tmp_path}/{name}_"))
        kw = {"device": "cpu"} if name == "torch" else {}
        sim = mod.C2Ray_Test(str(pfile), N, **kw)
        sim.ndens = 1e-3 * np.ones((N,) * 3)
        zreds = sim.generate_redshift_array(2, 1e6)
        dt = sim.set_timestep(zreds[0], zreds[1], 2)
        out = [np.array(sim.do_raytracing(srcflux, srcpos))]
        for _ in range(2):
            sim.evolve3D(dt, srcflux, srcpos)
            out += [np.array(sim.xh), np.array(sim.phi_ion)]
        res[name] = out
    for g, w in zip(res["torch"], res["jax"]):
        assert g.shape == (N,) * 3
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_flat_engine_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    N, R, pos = CASES["N16_R6"]
    pos = np.array(pos)
    flux = np.linspace(0.5, 2.0, len(pos))
    nd, xh = _fields(N, seed=5)
    cfg = RaytraceConfig(N=N, R_max_LLS=R, sig=SIG, batch_size=2,
                         dtype=torch.float64, do_heating=True)
    tabs = (TABLES[0], TABLES[1], TABLES[4], TABLES[5], TABLES[2],
            TABLES[3])
    got = Raytracer(cfg, *tabs, device="cuda").trace(nd, xh, pos, flux, DR)
    want = Raytracer(cfg, *tabs, device="cpu").trace(nd, xh, pos, flux, DR)
    # the card's log10 is not libm's: an absolute floor at 1e-12 of the
    # peak, as test_flat_matches_jax
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-12,
                                   atol=1e-12 * float(w.max()))
