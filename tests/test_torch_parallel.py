"""The port's source-parallel path (pyc2ray_torch/parallel/source_parallel.py)
on a world of 4 gloo ranks spawned on the CPU (tests/torch_ranks.py), in
float64, against the JAX package's sharded functions on 4 of
tests/conftest.py's 8 virtual CPU devices and against the port's single-rank
path: Gamma and heat at rtol 1e-12 above 1e-12 of the peak, xh and T after
an evolve at rtol 1e-10, helium y1 / y2 at rtol 1e-9, iteration counts
equal; each rank's batches are those of the JAX device of its index. A world
of one rank is bit-equal to the single-device port.

The window-accumulate case of tests/test_parallel.py
(test_trace_sharded_window_engine_matches_single) has no counterpart: the
port has no window accumulate."""

import os
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.ops.adaptive import AdaptiveRaytracer as JAdaptive
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.chemistry_he import HeChemistryParams as JHeParams
from pyc2ray_tpu.ops.raytrace import RaytraceConfig as JConfig
from pyc2ray_tpu.ops.raytrace import Raytracer as JRaytracer
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JCheb
from pyc2ray_tpu.ops.raytrace_he import HeRaytracer as JHe
from pyc2ray_tpu.ops.thermal import ThermalParams as JThermal
from pyc2ray_tpu.parallel import (evolve3D_he_sharded as j_evolve_he,
                                  evolve3D_sharded as j_evolve,
                                  make_mesh as j_make_mesh,
                                  trace_sharded as j_trace)
from pyc2ray_tpu.parallel.source_parallel import \
    prepare_sources_sharded as j_prepare
from pyc2ray_tpu.radiation.spectral_bins import SpectralBins as JBins

import pyc2ray_torch
from pyc2ray_torch.evolve import evolve3D, evolve3D_he
from pyc2ray_torch.ops.chemistry import global_pass
from pyc2ray_torch.parallel import evolve3D_sharded, make_mesh

import torch_ranks as R
from test_raytrace import TABLES

C = R.SOURCE
ROOT = pathlib.Path(__file__).resolve().parents[1]
EOR = ROOT / "examples" / "eor_simulation"
ZLIST = (21.062, 20.134)
GAMMA = dict(rtol=1e-12, floor=1e-12)
FIELD_RTOL = 1e-10
HE_RTOL = 1e-9


def _fields(seed, N, ns, nd=None, xh=None):
    rng = np.random.RandomState(seed)
    return dict(
        nd=10 ** rng.uniform(-4, -2, (N,) * 3) if nd is None
        else np.full((N,) * 3, nd),
        xh=rng.uniform(0, 0.5, (N,) * 3) if xh is None
        else np.full((N,) * 3, xh),
        src=rng.randint(0, N, size=(ns, 3)),
        flux=rng.uniform(0.5, 5.0, ns))


def _evolve_fields(N, src, flux, nd=2e-3, temp=1e4, xh=1.2e-3):
    return dict(nd=np.full((N,) * 3, nd), temp=np.full((N,) * 3, temp),
                xh=np.full((N,) * 3, xh), src=np.asarray(src),
                flux=np.asarray(flux, dtype=np.float64))


def _he_fields(N):
    return dict(nd=np.full((N,) * 3, 1e-3), temp=np.full((N,) * 3, 2e4),
                xh=np.full((N,) * 3, 1e-3), y1=np.full((N,) * 3, 1e-3),
                y2=np.zeros((N,) * 3), src=np.array([[4, 4, 4], [1, 6, 3]]),
                flux=np.array([20.0, 5.0]))


def _model_yml():
    """tests/test_torch_models.py's non-isothermal parameters (engine
    cheb, heating, 32 Gauss-Legendre bins), results under @RESULTS@."""
    p = (ROOT / "examples" / "single_source_test" / "parameters.yml") \
        .read_text()
    for a, b in (("NumTau: 2000", "NumTau: 300"),
                 ("compute_heating_rates: 0", "compute_heating_rates: 1"),
                 ("temp0: 1e4", "temp0: 1e2"),
                 ("Material:", "Material:\n  isothermal: false"),
                 ("results_basename: ./results/",
                  "results_basename: @RESULTS@"),
                 ("dtype: float64", "dtype: float64\n  engine: cheb\n"
                  "  bins_compress: 0\n  bins_panels: 2\n  bins_nodes: 4")):
        assert a in p
        p = p.replace(a, b)
    return p


def _model_he_yml():
    """The same parameters with engine he, 2 x 2 bins per band: the
    helium model of chip_smoke's phase 4g at a small size."""
    return _model_yml().replace("engine: cheb", "engine: he")


def _cubep3m_yml(inputs):
    """The EoR parameters of tests/test_torch_cubep3m.py: engine adaptive,
    NumTau 200, float64, inputs synthetic."""
    p = (EOR / "parameters.yml").read_text()
    for a, b in (("results_basename: ./results/",
                  "results_basename: @RESULTS@"),
                 ("inputs_basename: ./inputs/", f"inputs_basename: {inputs}"),
                 ("NumTau: 2000", "NumTau: 200"),
                 ("dtype: float32", "dtype: float64")):
        assert a in p
        p = p.replace(a, b)
    return p


def make_inputs(workdir, table):
    """The inputs of every case of a suite (``table``: torch_ranks.SOURCE
    or DOMAIN), by case."""
    sys.path.insert(0, str(EOR))
    try:
        from run_test import make_synthetic_inputs
    finally:
        sys.path.pop(0)
    eor = os.path.join(workdir, "eor_inputs") + "/"
    make_synthetic_inputs(table["model_cubep3m"]["N"], eor, list(ZLIST))
    tables = dict(zip(R.TABLE_KEYS, TABLES))
    out = {}
    for case, c in table.items():
        N = c["N"]
        if case == "model_test":
            out[case] = dict(yml=np.array(_model_yml()))
        elif case == "model_he":
            out[case] = dict(yml=np.array(_model_he_yml()))
        elif case == "model_cubep3m":
            out[case] = dict(yml=np.array(_cubep3m_yml(eor)),
                             zlist=np.array(ZLIST))
        elif case.startswith("helium"):
            out[case] = _he_fields(N)
        else:
            out[case] = {}
    return out, tables


def _source_inputs(workdir):
    out, tables = make_inputs(workdir, C)
    out["trace_flat"] = dict(_fields(5, 8, 13), **tables)
    out["trace_cheb"] = _fields(6, 8, 5)
    src3, flux3 = [[4, 4, 4], [1, 2, 3], [6, 1, 7]], [5.0, 2.0, 1.0]
    out["evolve_flat"] = dict(_evolve_fields(8, src3, flux3), **tables)
    out["thermal"] = _evolve_fields(8, src3, [1.0, 0.5, 2.0], nd=1e-3,
                                    temp=1e2)
    a = _fields(11, 12, 9, nd=1e-3)
    a["flux"] = np.array([1e3, 1e3, 1e-4, 1e-4, 1e-4, 1e3, 1e-4, 1e3, 1e-4])
    out["adaptive_trace"] = a
    out["adaptive_evolve"] = _evolve_fields(8, src3, [5.0, 2.0, 1.0])
    out["adaptive_empty"] = dict(_fields(12, 8, 2, nd=1e-3, xh=0.0),
                                 flux=np.full(2, 1e4))
    out["loss_warning"] = _evolve_fields(8, [[4, 4, 4]], [1e-4])
    rng = np.random.RandomState(7)
    n = 8 ** 3
    out["global_pass"] = dict(nd=10 ** rng.uniform(-4, -2, n),
                              temp=np.full(n, 1e4), xh=np.full(n, 1.2e-3),
                              phi=10 ** rng.uniform(-16, -8, n))
    return out


def start_world(tmp_path_factory, name, inputs, n_ranks, suite):
    """Write the inputs and start the suite on a world of ``n_ranks`` in
    the background (torch_ranks.World); the tests compute their references
    first and then read the ranks' outputs."""
    wd = tmp_path_factory.mktemp(name)
    np.savez(wd / "inputs.npz", **{f"{case}/{k}": v for case, d
                                   in inputs.items() for k, v in d.items()})
    return R.World(n_ranks, suite, str(wd))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's suite on a world of 4 ranks: (World, inputs by case)."""
    inputs = _source_inputs(str(tmp_path_factory.mktemp("source_inputs")))
    w = start_world(tmp_path_factory, "source_world", inputs,
                    R.SOURCE_WORLD, "source")
    yield w, inputs
    w.wait()


def check_ranks_import_no_jax(w, n_ranks):
    for r in range(n_ranks):
        with np.load(os.path.join(w.wait(), f"modules.r{r}.npz")) as f:
            assert not bool(f["jax"]), f"rank {r} imported jax"


def close(got, want, rtol, floor=0.0, name=""):
    """``got`` against ``want`` at ``rtol`` above ``floor`` x the peak."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * np.abs(want).max(),
                               err_msg=name)


def _jmesh(shape):
    return j_make_mesh(*shape, devices=jax.devices()[:R.SOURCE_WORLD])


def _jflat(c, I):
    cfg = JConfig(N=c["N"], R_max_LLS=1e9, sig=R.SIG, batch_size=c["batch"],
                  dtype=jnp.float64)
    return JRaytracer(cfg, I["photo_thin"], I["photo_thick"],
                      I["minlogtau"], I["dlogtau"])


def _jbins(heating):
    return JBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                 w_heat=np.array([3.0e-12 if heating else 0.0]), num_bins=1)


def _jcheb(c, heating=False):
    return JCheb(c["N"], c["R"], R.SIG, _jbins(heating),
                 batch_size=c["batch"], dtype=jnp.float64,
                 do_heating=heating, accumulate="scan")


def _jadaptive(c):
    return JAdaptive(c["N"], c["R"], R.SIG, _jbins(False),
                     radii=list(c["radii"]), batch_size=c["batch"],
                     dtype=jnp.float64, R_min=c["R_min"],
                     accumulate="scan")


def _jhe(c, heating=False):
    from pyc2ray_tpu.constants import ev2fr
    from pyc2ray_tpu.radiation import BlackBodySource
    from pyc2ray_tpu.radiation.helium import (HE_EDGES_EV,
                                              make_spectral_bins_he)
    bb = BlackBodySource(1e5, False, ev2fr * HE_EDGES_EV[0], 2.8)
    bins = make_spectral_bins_he(bb, panels_per_band=2, nodes=2)
    return JHe(c["N"], c["R"], bins, abu_he=R.ABU_HE, batch_size=c["batch"],
               dtype=jnp.float64, do_heating=heating, accumulate="scan")


def _jchem():
    return JChem(**R.CHEM)


def _jthermal():
    return JThermal(**R.CHEM, compton=False)


def _jhe_params():
    return JHeParams(chem=_jchem(), abu_he=R.ABU_HE)


def _jlog(tmp_path, name):
    return str(tmp_path / f"{name}.log")


def _iterations(path):
    with open(path) as f:
        return R.count_iterations(f.read())


@pytest.mark.parametrize("case", ["helium", "helium_thermal"])
def test_helium_source_parallel_matches_jax(world, tmp_path, case):
    """Capability cells "helium" and "helium + thermal", source parallel:
    two sources over four ranks (two sweep zero-flux padding)."""
    w, inputs = world
    c, I = C[case], inputs[case]
    heat = case == "helium_thermal"
    log = _jlog(tmp_path, "j")
    kw = dict(thermal=_jthermal(), zred=c["zred"]) if heat else {}
    want = j_evolve_he(c["dt"], R.DR_HE, I["flux"], I["src"],
                       _jhe(c, heating=heat), _jmesh(c["mesh"]),
                       _jhe_params(), I["temp"], I["nd"], I["xh"], I["y1"],
                       I["y2"], logfile=log, quiet=True, **kw)
    got = w.out(case)
    assert int(got["iterations"]) == _iterations(log) > 0
    names = R.HE_NAMES + (("temp",) if heat else ())
    assert len(want) == len(names)
    for name, ref in zip(names, want):
        if name.startswith("phi"):
            close(got[name], ref, **GAMMA, name=name)
        else:
            close(got[name], ref, HE_RTOL if name in ("y1", "y2")
                  else FIELD_RTOL, name=name)
    assert got["y1"].max() > 1e-3
    single = evolve3D_he(c["dt"], R.DR_HE, I["flux"], I["src"],
                         R.he_engine(c, heating=heat), R.he_params(),
                         I["temp"], I["nd"], I["xh"], I["y1"], I["y2"],
                         quiet=True, **(dict(thermal=R.thermal(),
                                             zred=c["zred"]) if heat else {}))
    for name, s in zip(names, single):
        close(got[name], s, HE_RTOL, 1e-12 if name.startswith("phi") else 0,
              name=name)


def test_thermal_source_parallel_matches_jax(world, tmp_path):
    """Capability cell "thermal", source parallel: the all-reduced heat
    feeds the post-convergence update (Chebyshev engine with a heating
    bin, T from 100 K)."""
    w, inputs = world
    c, I = C["thermal"], inputs["thermal"]
    log = _jlog(tmp_path, "j")
    jxh, jphi, jt = j_evolve(c["dt"], R.DR_THERMAL, I["flux"], I["src"],
                             _jcheb(c, heating=True), _jmesh(c["mesh"]),
                             _jchem(), I["temp"], I["nd"], I["xh"],
                             logfile=log, quiet=True, thermal=_jthermal(),
                             zred=c["zred"])
    got = w.out("thermal")
    assert int(got["iterations"]) == _iterations(log) > 0
    close(got["xh"], jxh, FIELD_RTOL)
    close(got["phi"], jphi, **GAMMA)
    close(got["temp"], jt, FIELD_RTOL)
    assert got["temp"].std() > 0 and got["temp"].max() > 1e2


def test_adaptive_evolve_sharded_matches_jax(world, tmp_path):
    """Capability cell "adaptive per-source radii", source parallel."""
    w, inputs = world
    c, I = C["adaptive_evolve"], inputs["adaptive_evolve"]
    log = _jlog(tmp_path, "j")
    jxh, jphi = j_evolve(c["dt"], R.DR, I["flux"], I["src"], _jadaptive(c),
                         _jmesh(c["mesh"]), _jchem(), I["temp"], I["nd"],
                         I["xh"], logfile=log, quiet=True)
    got = w.out("adaptive_evolve")
    assert int(got["iterations"]) == _iterations(log) > 0
    close(got["xh"], jxh, FIELD_RTOL)
    close(got["phi"], jphi, **GAMMA)


def test_trace_sharded_matches_jax_and_single(world):
    """Standalone trace, flat engine, 13 sources (padding over the ranks):
    Gamma against the JAX sharded trace and the port's single-rank trace;
    every rank's batches are the JAX device's of its index."""
    w, inputs = world
    c, I = C["trace_flat"], inputs["trace_flat"]
    jrt = _jflat(c, I)
    jmesh = _jmesh(c["mesh"])
    want = np.asarray(j_trace(jrt, jmesh, I["nd"], I["xh"], I["src"],
                              I["flux"], R.DR))
    single = R.flat_engine(c, I).trace(I["nd"], I["xh"], I["src"],
                                       I["flux"], R.DR).numpy()
    jpos, jflux = (np.asarray(a) for a in j_prepare(jrt, jmesh, I["src"],
                                                    I["flux"]))
    got = w.out("trace_flat")["phi"]
    close(got, want, **GAMMA)
    close(got, single, **GAMMA)
    k = jpos.shape[0] // R.SOURCE_WORLD
    for r in range(R.SOURCE_WORLD):
        o = w.out("trace_flat", r)
        np.testing.assert_array_equal(o["pos"], jpos[r * k:(r + 1) * k])
        np.testing.assert_array_equal(o["flux"], jflux[r * k:(r + 1) * k])
        np.testing.assert_array_equal(o["phi"], got)   # replicated


def test_trace_sharded_2d_mesh_cheb(world):
    """A (2, 2) source mesh and the Chebyshev engine: the port's
    single-rank trace."""
    w, inputs = world
    c, I = C["trace_cheb"], inputs["trace_cheb"]
    single = R.cheb_engine(c).trace(I["nd"], I["xh"], I["src"], I["flux"],
                                    R.DR).numpy()
    close(w.out("trace_cheb")["phi"], single, **GAMMA)


def test_evolve_sharded_matches_jax_and_single(world, tmp_path):
    """The hydrogen evolve (capability cell "H ionization", source
    parallel) with the flat engine on a (2, 2) mesh."""
    w, inputs = world
    c, I = C["evolve_flat"], inputs["evolve_flat"]
    log = _jlog(tmp_path, "j")
    jxh, jphi = j_evolve(c["dt"], R.DR, I["flux"], I["src"], _jflat(c, I),
                         _jmesh(c["mesh"]), _jchem(), I["temp"], I["nd"],
                         I["xh"], logfile=log, quiet=True)
    got = w.out("evolve_flat")
    assert int(got["iterations"]) == _iterations(log) > 0
    close(got["xh"], jxh, FIELD_RTOL)
    close(got["phi"], jphi, **GAMMA)
    sxh, sphi = evolve3D(c["dt"], R.DR, I["flux"], I["src"],
                         R.flat_engine(c, I), R.chem(), I["temp"], I["nd"],
                         I["xh"], quiet=True)
    close(got["xh"], sxh, FIELD_RTOL)
    close(got["phi"], sphi, **GAMMA)


def test_adaptive_sharded_matches_single_bucket_major(world):
    """The adaptive engine's bucket-major staging: per bucket, every
    rank's batches are the JAX device's of its index; Gamma against the
    port's single-rank trace."""
    w, inputs = world
    c, I = C["adaptive_trace"], inputs["adaptive_trace"]
    single, st = R.adaptive_engine(c).trace(I["nd"], I["xh"], I["src"],
                                            I["flux"], R.DR, stats=True)
    assert min(st["bucket_counts"]) > 0
    jpos, jflux = j_prepare(_jadaptive(c), _jmesh(c["mesh"]), I["src"],
                            I["flux"], dr=R.DR,
                            avg_dens=float(I["nd"].mean()))
    got = w.out("adaptive_trace")
    close(got["phi"], single.numpy(), **GAMMA)
    for b, (jp, jf) in enumerate(zip(jpos, jflux)):
        jp, jf = np.asarray(jp), np.asarray(jf)
        k = jp.shape[0] // R.SOURCE_WORLD
        for r in range(R.SOURCE_WORLD):
            o = w.out("adaptive_trace", r)
            np.testing.assert_array_equal(o[f"pos{b}"],
                                          jp[r * k:(r + 1) * k])
            np.testing.assert_array_equal(o[f"flux{b}"],
                                          jf[r * k:(r + 1) * k])


def test_adaptive_sharded_empty_bucket(world):
    """Every source in the top bucket: the empty bucket stages one
    zero-flux batch per rank and adds nothing."""
    w, inputs = world
    c, I = C["adaptive_empty"], inputs["adaptive_empty"]
    single, st = R.adaptive_engine(c).trace(I["nd"], I["xh"], I["src"],
                                            I["flux"], R.DR, stats=True)
    assert st["bucket_counts"][0] == 0
    for r in range(R.SOURCE_WORLD):
        o = w.out("adaptive_empty", r)
        assert list(o["shapes"]) == [1, 1]
        assert o["flux_max"][0] == 0.0
        close(o["phi"], single.numpy(), **GAMMA)


def test_sharded_loss_fraction_warning_fires(world):
    """The truncation-budget warning of a sharded run reaches the log,
    which only the mesh's first rank writes."""
    w, _ = world
    assert bool(w.out("loss_warning", 0)["warned"])
    for r in range(1, R.SOURCE_WORLD):
        assert not bool(w.out("loss_warning", r)["logged"])


def test_global_pass_sharded_equals_single(world):
    """The cell-split chemistry is elementwise: bit for bit the
    single-rank pass."""
    w, inputs = world
    c, I = C["global_pass"], inputs["global_pass"]
    t = {k: torch.from_numpy(I[k]) for k in ("nd", "temp", "xh", "phi")}
    xi, xa, cf = global_pass(c["dt"], t["nd"], t["temp"], t["xh"], t["xh"],
                             t["phi"], R.chem())
    got = w.out("global_pass")
    np.testing.assert_array_equal(got["xi"], xi.numpy())
    np.testing.assert_array_equal(got["xav"], xa.numpy())
    assert int(got["cf"]) == int(cf)


def test_uneven_cell_split_is_refused(world):
    """N^3 = 125 cells over 4 ranks: every rank raises before any
    collective (no cell left without chemistry)."""
    w, _ = world
    for r in range(R.SOURCE_WORLD):
        msg = str(w.out("uneven", r)["error"])
        assert "125 cells do not split evenly over the 4 ranks" in msg


def _model_single(inputs, case, tmp_path):
    from pyc2ray_torch.utils.paramutils import read_paramfile
    results = str(tmp_path / "single") + "/"
    os.makedirs(results)
    path = results + "parameters.yml"
    with open(path, "w") as f:
        f.write(str(inputs[case]["yml"]).replace("@RESULTS@", results))
    return read_paramfile(path)


def check_model(w, inputs, table, case, world_size, tmp_path):
    """The model under the mesh against mesh=None: xh, Gamma and T; the
    output files are the primary rank's only."""
    c = table[case]
    params = _model_single(inputs, case, tmp_path)
    if case == "model_cubep3m":
        sim = R.run_model_cubep3m(params, c["N"], ZLIST)
    else:
        sim = R.run_model_test(params, c["N"], c["steps"])
    got = w.out(case)
    close(got["xh"], sim.xh, FIELD_RTOL)
    close(got["phi"], sim.phi_ion, **GAMMA)
    close(got["temp"], sim.temp, FIELD_RTOL)
    if sim.multi_species:
        close(got["xhe1"], sim.xhe1, HE_RTOL)
        close(got["xhe2"], sim.xhe2, HE_RTOL)
    assert got["xh"].max() > 1.2e-3
    assert len(got["files"]) >= 2
    for r in range(1, world_size):
        assert len(w.out(case, r)["files"]) == 0


def test_model_c2ray_test_source_mesh(world, tmp_path):
    """C2Ray_Test(mesh=make_mesh()) against mesh=None (engine cheb with
    the heating rates, non-isothermal, two timesteps)."""
    w, inputs = world
    check_model(w, inputs, C, "model_test", R.SOURCE_WORLD, tmp_path)


def test_model_helium_source_mesh(world, tmp_path):
    """C2Ray_Test with engine he (heating, non-isothermal) under the
    source mesh against mesh=None: the model layer's helium branch."""
    w, inputs = world
    check_model(w, inputs, C, "model_he", R.SOURCE_WORLD, tmp_path)


def test_model_cubep3m_adaptive_source_mesh(world, tmp_path):
    """C2Ray_CubeP3M (engine adaptive, the EoR parameters, synthetic
    inputs) with a source mesh against mesh=None."""
    w, inputs = world
    check_model(w, inputs, C, "model_cubep3m", R.SOURCE_WORLD, tmp_path)


@pytest.mark.parametrize("engine", ["flat", "cheb", "adaptive"])
def test_one_rank_world_is_bit_equal(engine):
    """A mesh of one rank (no torch.distributed): evolve3D_sharded is the
    single-device evolve3D bit for bit."""
    c = dict(C["adaptive_evolve"] if engine == "adaptive"
             else C["evolve_flat"], R=3.0, batch=2)
    I = dict(_evolve_fields(8, [[4, 4, 4], [1, 2, 3], [6, 1, 7]],
                            [5.0, 2.0, 1.0]),
             **dict(zip(R.TABLE_KEYS, TABLES)))

    def mk():
        return {"flat": lambda: R.flat_engine(c, I),
                "cheb": lambda: R.cheb_engine(c),
                "adaptive": lambda: R.adaptive_engine(c)}[engine]()
    args = (R.chem(), I["temp"], I["nd"], I["xh"])
    want = evolve3D(1e13, R.DR, I["flux"], I["src"], mk(), *args,
                    quiet=True)
    mesh = make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.member
    got = evolve3D_sharded(1e13, R.DR, I["flux"], I["src"], mk(), mesh,
                           *args, quiet=True)
    for g, ref in zip(got, want):
        np.testing.assert_array_equal(g, ref)


def test_multihost_helpers_single_process():
    """multihost in one process: initialize() is a no-op, the meshes span
    the one rank, the backend rule."""
    from pyc2ray_torch.parallel import multihost
    assert multihost.initialize() is False
    assert multihost.is_primary()
    dmesh = multihost.global_domain_mesh(device="cpu")
    assert dmesh.axis_names == ("di", "dj", "dk") and dmesh.size == 1
    smesh = multihost.global_source_mesh(device="cpu")
    assert smesh.axis_names == ("src", "space") and smesh.shape == (1, 1)
    assert multihost.choose_backend(1) == (
        "nccl" if torch.cuda.is_available() else "gloo")
    assert multihost.choose_backend(torch.cuda.device_count() + 1) == "gloo"
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        make_mesh(2, 1, device="cpu")


def test_port_imports_no_jax_package():
    """No module of pyc2ray_torch (parallel/ included) imports jax or
    pyc2ray_tpu."""
    import re
    root = pathlib.Path(pyc2ray_torch.__file__).parent
    pattern = re.compile(r"^\s*(import|from)\s+(jax|pyc2ray_tpu)\b", re.M)
    for f in list(root.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          pathlib.Path(R.__file__)]:
        assert not pattern.search(f.read_text()), f


def test_ranks_import_no_jax(world):
    w, _ = world
    check_ranks_import_no_jax(w, R.SOURCE_WORLD)
