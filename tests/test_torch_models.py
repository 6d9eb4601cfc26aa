"""The port's model layer (C2Ray_Test, cosmology, utils, hydrogenODE,
photon_budget) against the JAX package's, in float64 on the CPU."""

import copy
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import pyc2ray_tpu as jpc
from pyc2ray_tpu import utils as j_utils
from pyc2ray_tpu.diagnostics import photon_budget as j_photon_budget
from pyc2ray_tpu.utils.paramutils import Params as JParams

import pyc2ray_torch as tpc
from pyc2ray_torch import utils as t_utils
from pyc2ray_torch.diagnostics import photon_budget, stage_timer
from pyc2ray_torch.utils.paramutils import Params, read_paramfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE_YML = ROOT / "examples" / "single_source_test" / "parameters.yml"
N = 12


def _params_text(results, cosmological=0, engine="cheb", extra=""):
    """The non-isothermal parameters of the JAX package's thermal model
    test, with the engine named (the YAML default is flat) and the 32
    Gauss-Legendre bins (the compression is not the subject here)."""
    p = BASE_YML.read_text()
    p = p.replace("NumTau: 2000", "NumTau: 300")
    p = p.replace("compute_heating_rates: 0", "compute_heating_rates: 1")
    p = p.replace("temp0: 1e4", "temp0: 1e2")
    p = p.replace("Material:", "Material:\n  isothermal: false")
    p = p.replace("cosmological: 0", f"cosmological: {cosmological}")
    p = p.replace("results_basename: ./results/",
                  f"results_basename: {results}/")
    return p.replace("dtype: float64", f"dtype: float64\n  engine: {engine}"
                     f"\n  bins_compress: 0{extra}")


def _write(tmp, name, **kw):
    d = tmp / name
    d.mkdir()
    f = d / "parameters.yml"
    f.write_text(_params_text(d, **kw))
    return str(f)


SRCPOS = np.array([[N // 2], [N // 2], [N // 2]], dtype=float)
SRCFLUX = np.array([10.0])
FIELDS = ("xh", "phi_ion", "temp", "ndens", "dr", "zred", "time")


def _snap(sim):
    return {k: np.array(getattr(sim, k), dtype=np.float64) for k in FIELDS}


def _drive(mod, pfile, cosmological, **kw):
    """do_raytracing on the initial state, then two timesteps; returns the
    standalone (phi, stats) and the state after each step."""
    sim = mod.C2Ray_Test(pfile, N, **kw)
    assert sim.thermal is not None and sim.raytracer.config.do_heating
    sim.ndens = 1e-3 * np.ones((N, N, N))
    zreds = sim.generate_redshift_array(2, 1e6)
    dt = sim.set_timestep(zreds[0], zreds[1], 2)
    phi0, stats = sim.do_raytracing(SRCFLUX, SRCPOS, stats=True)
    out = {"dt": dt, "zreds": zreds, "phi0": np.array(phi0), "stats": stats,
           "heat0": np.array(sim.phi_heat), "steps": []}
    for _ in range(2):
        if cosmological:
            sim.cosmo_evolve(dt)
        sim.evolve3D(dt, SRCFLUX, SRCPOS)
        out["steps"].append(_snap(sim))
    return out


@pytest.fixture(scope="module", params=[0, 1], ids=["static", "cosmological"])
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"models{request.param}")
    want = _drive(jpc, _write(tmp, "jax", cosmological=request.param),
                  request.param)
    got = _drive(tpc, _write(tmp, "torch", cosmological=request.param),
                 request.param, device="cpu")
    return request.param, got, want


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_steps"])
def test_c2ray_test_matches_jax(runs, step):
    """xh, phi_ion and temp after one and two non-isothermal timesteps
    (with cosmo_evolve before each when cosmological), float64: rtol 1e-7
    (two converged raytrace/chemistry loops and a 16-substep thermal
    solve on top of each package's own libm); dr, zred, ndens and time
    are host float64 arithmetic: 1e-13."""
    cosmological, got, want = runs
    assert got["dt"] == pytest.approx(want["dt"], rel=1e-13)
    np.testing.assert_allclose(got["zreds"], want["zreds"], rtol=1e-12)
    g, w = got["steps"][step], want["steps"][step]
    for k in ("xh", "phi_ion", "temp"):
        assert g[k].shape == (N, N, N) and np.all(np.isfinite(g[k]))
        np.testing.assert_allclose(g[k], w[k], rtol=1e-7, atol=0, err_msg=k)
    for k in ("ndens", "dr", "zred", "time"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-13, err_msg=k)
    c = N // 2 - 1
    assert g["temp"][c, c, c] > 1e3 and g["temp"].std() > 0
    if cosmological:        # proper cells are 10x smaller: all of it heats
        assert g["zred"] < 9.0 and g["ndens"].max() < 1e-3
    else:
        assert g["temp"].min() < 150.0


def test_do_raytracing_stats_match_jax(runs):
    """Both return forms of do_raytracing with the heating channel, and
    the photon budget against the JAX package's."""
    _, got, want = runs
    np.testing.assert_allclose(got["phi0"], want["phi0"], rtol=1e-9)
    np.testing.assert_allclose(got["heat0"], want["heat0"], rtol=1e-9)
    assert got["heat0"].max() > 0
    assert set(got["stats"]) == set(want["stats"])
    for k, v in want["stats"].items():
        assert got["stats"][k] == pytest.approx(v, rel=1e-9)


def test_photon_budget_matches_jax():
    rng = np.random.RandomState(60)
    phi = 10 ** rng.uniform(-16, -11, (6, 6, 6))
    nd = 10 ** rng.uniform(-4, -2, (6, 6, 6))
    xh = rng.uniform(0, 1, (6, 6, 6))
    flux = np.array([1.0, 2.5])
    want = j_photon_budget(phi, nd, xh, flux, 6.7e20)
    got = photon_budget(torch.from_numpy(phi), nd, torch.from_numpy(xh),
                        flux, 6.7e20)
    assert got == want
    assert photon_budget(phi, nd, xh, np.zeros(2), 1.0)["loss_fraction"] == 0.0


def test_stage_timer_logs(tmp_path):
    log = str(tmp_path / "t.log")
    with stage_timer("Stage A", log, quiet=True) as st:
        st["sync"] = torch.ones(3)
    with stage_timer("Stage B", log, quiet=True):
        pass
    text = open(log).read()
    assert st["seconds"] >= 0.0 and "Stage A took" in text
    assert "Stage B took" in text and "dispatch only" in text


def test_hydrogenODE_matches_jax():
    rng = np.random.RandomState(61)
    shape = (6, 6, 6)
    nd = 10 ** rng.uniform(-3, -1, shape)
    temp = rng.uniform(5e3, 3e4, shape)
    xh = rng.uniform(1e-4, 0.9, shape)
    phi = 10 ** rng.uniform(-14, -10, shape)
    # the assertion counts cells whose <x> moved over the step: all do here
    want = jpc.hydrogenODE(1e13, nd, temp, xh, phi,
                           max_nonconverged_fraction=1.01)
    got = tpc.hydrogenODE(1e13, nd, temp, xh, phi, device="cpu",
                          max_nonconverged_fraction=1.01)
    assert isinstance(got, np.ndarray) and got.shape == shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)
    with pytest.raises(AssertionError, match="did not converge"):
        tpc.hydrogenODE(1e13, nd, temp, xh, phi, device="cpu")


def test_cosmology_equals_jax():
    a = tpc.FlatLambdaCDM(100.0, 0.27, Tcmb0=2.726, Ob0=0.044)
    b = jpc.FlatLambdaCDM(100.0, 0.27, Tcmb0=2.726, Ob0=0.044)
    for z in (0.0, 0.5, 9.0, 20.134):
        assert a.age(z) == b.age(z)
        assert a.lookback_time(z) == b.lookback_time(z)
        assert a.scale_factor(z) == b.scale_factor(z)
        assert a.efunc(z) == b.efunc(z)
    t = b.age(9.0)
    assert a.z_at_age(t) == b.z_at_age(t)
    assert (a.Ogamma0, a.Onu0, a.Ode0) == (b.Ogamma0, b.Onu0, b.Ode0)
    from pyc2ray_torch import cosmology as tc
    from pyc2ray_tpu import cosmology as jc
    assert tc.matter_dominated_age(12.0, 21.0, 70.0, 0.27) \
        == jc.matter_dominated_age(12.0, 21.0, 70.0, 0.27)
    assert tc.matter_dominated_zred(2e15, 21.0, 1e15) \
        == jc.matter_dominated_zred(2e15, 21.0, 1e15)


def test_source_utils_equal_jax(tmp_path):
    ft, fj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    t_utils.generate_test_sourcefile(ft, 32, 7, 5e48, seed=3)
    j_utils.generate_test_sourcefile(fj, 32, 7, 5e48, seed=3)
    assert open(ft).read() == open(fj).read()
    pt, flt = t_utils.read_test_sources(ft, 5)
    pj, flj = j_utils.read_test_sources(fj, 5)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(flt, flj)
    with pytest.raises(ValueError, match="larger than that of the file"):
        t_utils.read_test_sources(ft, 8)
    for got, want in zip(t_utils.format_sources(pt, flt),
                         j_utils.format_sources(pj, flj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_other_utils_equal_jax(tmp_path):
    for z in (9.0, 8.5, 10.25):
        (tmp_path / f"xfrac_{z:.3f}.pkl").write_text("")
        (tmp_path / f"{z:.3f}-coarsest_wsubgrid_sources.dat").write_text("")
    (tmp_path / "xfrac_bad.pkl").write_text("")
    np.testing.assert_array_equal(
        t_utils.get_redshifts_from_output(str(tmp_path)),
        j_utils.get_redshifts_from_output(str(tmp_path)))
    np.testing.assert_array_equal(
        t_utils.get_source_redshifts(str(tmp_path)),
        j_utils.get_source_redshifts(str(tmp_path)))
    assert len(t_utils.get_redshifts_from_output(str(tmp_path))) == 3
    bins = [3.0, 1.0, 2.0]
    for v in (0.5, 1.5, 3.5):
        assert t_utils.find_bins(v, bins) == j_utils.find_bins(v, bins)
    for got, want in zip(t_utils.find_bins([1.5, 2.5], bins),
                         j_utils.find_bins([1.5, 2.5], bins)):
        np.testing.assert_array_equal(got, want)


def test_source_converter_roundtrip(tmp_path):
    h5py = pytest.importorskip("h5py")
    from pyc2ray_torch.utils.source_converter import convert_source_file
    src = tmp_path / "9.000-coarsest_wsubgrid_sources.dat"
    src.write_text("3\n1 2 3 5.0 0.1\n4 5 6 9.0 0.2\n7 8 9 7.0 0.3\n")
    out = str(tmp_path / "s.hdf5")
    assert convert_source_file(str(src), out, sort=True) == 3
    with h5py.File(out) as f:
        np.testing.assert_array_equal(f["sources_mass"][:], [9.0, 7.0, 5.0])
        np.testing.assert_array_equal(f["sources_positions"][0], [4, 5, 6])


def test_params_class_equals_jax(tmp_path):
    pfile = _write(tmp_path, "p")
    a, b = Params(pfile, Nmesh=N), JParams(pfile, Nmesh=N)
    assert a.raw == b.raw and a["Grid"] == b["Grid"]
    for k in ("eth0", "temph0", "ion_freq_HI", "ion_freq_HeII", "bh00",
              "albpow", "colh0", "sig", "abu_c", "mean_molecular", "zred_0",
              "age_0", "boxsize_c", "dr_c", "R_max_LLS"):
        assert getattr(a, k) == getattr(b, k), k
    assert Params(a.raw).raw == a.raw          # a parsed mapping works too


def test_dict_paramfile_equals_yaml(tmp_path):
    """A parsed mapping gives the same simulation as the YAML file, is not
    modified (the defaults layer works on a copy), and the parser is the
    JAX package's (scientific-notation floats)."""
    pfile = _write(tmp_path, "y")
    ld = read_paramfile(pfile)
    assert isinstance(ld["CGS"]["bh00"], float)
    assert ld["Material"]["temp0"] == 100.0
    frozen = copy.deepcopy(ld)
    a = tpc.C2Ray_Test(pfile, 8, device="cpu")
    b = tpc.C2Ray_Test(ld, 8, device="cpu")
    assert ld == frozen and "resume" in b._ld["Grid"]
    assert a._ld == b._ld and a._user_keys == b._user_keys
    assert a.thermal == b.thermal and a.chem == b.chem
    assert a.R_max_LLS == b.R_max_LLS and a.dr == b.dr
    for ta, tb in zip(a.raytracer.tables, b.raytracer.tables):
        assert torch.equal(ta, tb)
    assert "one implementation" in open(b.logfile).read()


def test_chip_smoke_heating_dict_equals_example_yaml(tmp_path):
    """The parameters that chip_smoke.py passes as a dict (the heating
    driver's heating_params) are the ones the JAX heating example builds
    from the single-source parameter file."""
    from pyc2ray_torch.examples.heating_test import heating_params
    results = str(tmp_path / "results") + "/"
    base = BASE_YML.read_text()
    # examples/heating_test/run_test.py, the replacements in order
    base = base.replace("NumTau: 2000", "NumTau: 500")
    base = base.replace("compute_heating_rates: 0",
                        "compute_heating_rates: 1")
    base = base.replace("temp0: 1e4", "temp0: 1e2")
    base = base.replace("Material:", "Material:\n  isothermal: false")
    base = base.replace("results_basename: ./results/",
                        "results_basename: " + results)
    base = base.replace("dtype: float64", "dtype: float64\n  engine: cheb")
    pfile = tmp_path / "parameters_heating.yml"
    pfile.write_text(base)
    want = read_paramfile(str(pfile))
    got = heating_params(results)
    assert got == want
    for sec in want:
        for k, v in want[sec].items():
            assert type(got[sec][k]) is type(v), (sec, k)


@pytest.mark.parametrize("engine,item", [("flat", "item 7"),
                                         ("he", "item 9"),
                                         ("box", "item 12")])
def test_unported_engines_raise(tmp_path, engine, item):
    """The engines of ROADMAP.md section 1 items 7 (flat), 9 (he) and 12
    (box) are ported: each builds its engine, and the model layer has no
    table of engines left to port."""
    from pyc2ray_torch.models import base
    from pyc2ray_torch.ops.raytrace import Raytracer
    from pyc2ray_torch.ops.raytrace_box import BoxRaytracer
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    pfile = _write(tmp_path, engine, engine=engine)
    built = {"flat": Raytracer, "he": HeRaytracer, "box": BoxRaytracer}
    rt = tpc.C2Ray_Test(pfile, 8, device="cpu").raytracer
    assert type(rt) is built[engine], f"ROADMAP.md section 1 {item}"
    assert not hasattr(base, "_ENGINES_TO_PORT")


def test_box_engine_evolves_as_jax(tmp_path):
    """C2Ray_Test with engine: box, as tests/test_models.py's
    test_c2ray_test_sim_evolves[box] drives the JAX package (N = 16, one
    source, one timestep, compressed bins, float64), against that run:
    xh and Gamma at rtol 1e-8; the outputs are written."""
    from pyc2ray_torch.ops.raytrace_box import BoxRaytracer
    n = 16
    text = BASE_YML.read_text().replace("NumTau: 2000", "NumTau: 300")
    text = text.replace("dtype: float64", "dtype: float64\n  engine: box")
    sims = []
    for mod, name, kw in ((tpc, "torch", dict(device="cpu")),
                          (jpc, "jax", {})):
        d = tmp_path / name
        d.mkdir()
        (d / "parameters.yml").write_text(text.replace(
            "results_basename: ./results/", f"results_basename: {d}/"))
        sim = mod.C2Ray_Test(str(d / "parameters.yml"), n, **kw)
        sim.ndens = 1e-3 * np.ones((n, n, n))
        srcpos = np.array([[n // 2], [n // 2], [n // 2]], dtype=float)
        zreds = sim.generate_redshift_array(2, 1e6)
        xh0_mean = sim.xh.mean()
        sim.evolve3D(sim.set_timestep(zreds[0], zreds[1], 2),
                     np.array([10.0]), srcpos)
        assert sim.xh.mean() > xh0_mean
        sim.write_output(sim.zred)
        assert any(f.startswith("xfrac") for f in os.listdir(d))
        sims.append(sim)
    got, want = sims
    assert type(got.raytracer) is BoxRaytracer
    assert got.raytracer.num_bins == want.raytracer.num_bins
    assert np.all(np.isfinite(got.phi_ion)) and got.phi_ion.max() > 0
    np.testing.assert_allclose(got.xh, np.asarray(want.xh), rtol=1e-8)
    np.testing.assert_allclose(got.phi_ion, np.asarray(want.phi_ion),
                               rtol=1e-8,
                               atol=1e-12 * float(np.max(want.phi_ion)))


@pytest.mark.parametrize("kind", ["source", "domain"])
def test_box_engine_refused_under_a_mesh(tmp_path, kind):
    """The box engine has no shard_trace and no trace_extended: under a
    source mesh evolve3D raises NotImplementedError, under a domain mesh
    TypeError, each with the JAX package's message (a mesh of one rank
    here, of one device there)."""
    import jax
    from pyc2ray_tpu import parallel as jpar
    from pyc2ray_torch import parallel as tpar
    pfile = _write(tmp_path, "box", engine="box")
    if kind == "source":
        meshes = (tpar.make_mesh(device="cpu"),
                  jpar.make_mesh(devices=jax.devices()[:1]))
        exc = NotImplementedError
    else:
        meshes = (tpar.make_domain_mesh(device="cpu"),
                  jpar.make_domain_mesh(1, devices=jax.devices()[:1]))
        exc = TypeError
    msgs = []
    for mod, mesh, kw in zip((tpc, jpc), meshes, (dict(device="cpu"), {})):
        sim = mod.C2Ray_Test(pfile, 8, mesh=mesh, **kw)
        with pytest.raises(exc) as err:
            sim.evolve3D(1e13, SRCFLUX, np.array([[4.0], [4.0], [4.0]]))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "BoxRaytracer" in msgs[0]


def test_default_engine_is_not_remapped(tmp_path):
    """Without Raytracing.engine the schema's default is flat, and the port
    builds the flat engine itself, not another engine in its place."""
    from pyc2ray_torch.ops.raytrace import Raytracer
    ld = read_paramfile(_write(tmp_path, "d"))
    del ld["Raytracing"]["engine"]
    sim = tpc.C2Ray_Test(ld, 8, device="cpu")
    assert type(sim.raytracer) is Raytracer
    assert sim.raytracer.config.dtype == torch.float64


@pytest.mark.parametrize("extra", ["\n  accumulate: window",
                                   "\n  window_size: 48"])
def test_window_accumulate_raises(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="item 3"):
        tpc.C2Ray_Test(_write(tmp_path, "w", extra=extra), 8, device="cpu")
    # "scan" names what the port does
    sim = tpc.C2Ray_Test(_write(tmp_path, "s", extra="\n  accumulate: scan"),
                         8, device="cpu")
    assert sim.raytracer is not None


def test_mesh_and_bad_engine_and_photo_checks(tmp_path):
    """A mesh of parallel/ is taken (a world of one rank here); under a
    source mesh an engine without shard_trace is refused with the JAX
    model layer's message; unknown engines and he-only options raise."""
    from pyc2ray_torch.parallel import make_mesh
    pfile = _write(tmp_path, "m")
    mesh = make_mesh(device="cpu")
    sim = tpc.C2Ray_Test(pfile, 8, mesh=mesh, device="cpu")
    assert sim.mesh is mesh and sim.primary and sim.rank == 0

    class NoShardTrace:
        config = sim.raytracer.config
    sim.raytracer = NoShardTrace()
    with pytest.raises(NotImplementedError,
                       match="does not support the source-parallel mesh"):
        sim.evolve3D(1e13, SRCFLUX, SRCPOS)
    ld = read_paramfile(pfile)
    ld["Raytracing"]["engine"] = "octa"
    with pytest.raises(ValueError, match="Unknown Raytracing.engine"):
        tpc.C2Ray_Test(ld, 8, device="cpu")
    for key in ("secondary_ionization", "recombination_photons"):
        ld = read_paramfile(pfile)
        ld["Photo"][key] = 1
        with pytest.raises(ValueError, match="requires Raytracing.engine: he"):
            tpc.C2Ray_Test(ld, 8, device="cpu")


@pytest.mark.parametrize("engine", ["cheb", "pallas"])
def test_cheb_and_pallas_build_the_same_engine(tmp_path, engine):
    """Both names build the port's ChebRaytracer with the YAML knobs of
    the JAX package: batch, dtype, compressed bins by default, GL bins
    with bins_compress 0 (bins_panels x bins_nodes)."""
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    ld = read_paramfile(_write(tmp_path, engine, engine=engine))
    ld["Raytracing"].update(source_batch_size=4, dtype="float32",
                            bins_panels=2, bins_nodes=4)
    sim = tpc.C2Ray_Test(ld, 8, device="cpu", use_gpu=False, use_mpi=True)
    rt = sim.raytracer
    assert type(rt) is ChebRaytracer and rt.device.type == "cpu"
    assert rt.batch_size == 4 and rt.dtype == torch.float32
    assert rt.num_bins == 8 and rt.do_heating
    assert rt.fuse_fold and not rt.fuse_rates
    jsim = jpc.C2Ray_Test(_write(tmp_path, engine + "j", engine="cheb"), 8)
    assert sim.R_max_LLS == jsim.R_max_LLS and sim.thermal == tuple(jsim.thermal)
    assert sim.chem == tuple(jsim.chem)
    np.testing.assert_array_equal(sim.photo_thin_table, jsim.photo_thin_table)
    np.testing.assert_array_equal(sim.heat_thick_table, jsim.heat_thick_table)


def test_isothermal_model_and_outputs(tmp_path):
    """Material.isothermal left at its default: evolve3D keeps temp, the
    pair return form; pickled outputs and printlog work."""
    ld = read_paramfile(_write(tmp_path, "iso"))
    del ld["Material"]["isothermal"]
    ld["Photo"]["compute_heating_rates"] = 0
    sim = tpc.C2Ray_Test(ld, 8, device="cpu")
    assert sim.thermal is None and not sim.raytracer.config.do_heating
    sim.density_init(9.0)
    assert sim.ndens[0, 0, 0] == pytest.approx(1e-6 * 1e3)
    sim.ndens = 1e-3 * np.ones((8, 8, 8))
    t0 = sim.temp.copy()
    phi = sim.do_raytracing(SRCFLUX, np.array([[4.0], [4.0], [4.0]]))
    assert isinstance(phi, np.ndarray) and phi.max() > 0
    sim.evolve3D(1e12, SRCFLUX, np.array([[4.0], [4.0], [4.0]]))
    np.testing.assert_array_equal(sim.temp, t0)
    assert sim.xh.max() > 1.2e-3
    sim.write_output(9.0)
    sim.write_output_numbered(1)
    assert os.path.exists(sim.results_basename + "xfrac_9.000.pkl")
    assert os.path.exists(sim.results_basename + "IonRates_1.pkl")
    assert sim.zred2time(9.0, unit="yr") == pytest.approx(
        sim.zred2time(9.0) / tpc.constants.YEAR)


def test_import_and_dict_run_without_yaml(tmp_path):
    """import pyc2ray_torch must not need PyYAML, and neither must a
    simulation built from a parsed mapping."""
    ld = read_paramfile(_write(tmp_path, "noyaml"))
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import pyc2ray_torch as tpc\n"
        f"sim = tpc.C2Ray_Test({ld!r}, 8, device='cpu')\n"
        "assert sim.raytracer.config.do_heating\n"
        "try:\n"
        f"    tpc.C2Ray_Test({str(tmp_path / 'noyaml' / 'parameters.yml')!r},"
        " 8, device='cpu')\n"
        "except ImportError:\n"
        "    print('file needs yaml')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "file needs yaml" in res.stdout


def test_package_exports():
    want = set(jpc.__all__)
    assert want <= set(tpc.__all__)
    for name in tpc.__all__:
        assert hasattr(tpc, name), name


def test_adaptive_engine_is_built(tmp_path):
    """engine: adaptive (ROADMAP item 6) builds the port's AdaptiveRaytracer
    on the model's device, every bucket's engine in fuse_fold with the heat
    channel; the log names the buckets."""
    from pyc2ray_torch.ops.adaptive import AdaptiveRaytracer
    ld = read_paramfile(_write(tmp_path, "a", engine="adaptive"))
    ld["Raytracing"]["subboxsize"] = 2
    sim = tpc.C2Ray_Test(ld, 12, device="cpu")
    rt = sim.raytracer
    assert type(rt) is AdaptiveRaytracer and rt.device.type == "cpu"
    assert len(rt.radii) > 1 and rt.R_min == 2.0 and rt.do_heating
    assert all(e.fuse_fold and e.do_heating for e in rt.engines)
    assert "adaptive-radius raytracing" in open(sim.logfile).read()


def test_fuse_fold_model_matches_default_mode(tmp_path, monkeypatch):
    """The model layer's engines run fuse_fold (K3h here); two heating
    timesteps through C2Ray_Test hold against the port's default mode (the
    sweep, then the rate pass) in float64 at rtol 1e-9."""
    from pyc2ray_torch.ops import raytrace_cheb
    got = _drive(tpc, _write(tmp_path, "fused"), 0, device="cpu")

    class DefaultMode(raytrace_cheb.ChebRaytracer):
        def __init__(self, *args, fuse_fold=False, **kw):
            super().__init__(*args, fuse_fold=False, **kw)

    monkeypatch.setattr(raytrace_cheb, "ChebRaytracer", DefaultMode)
    want = _drive(tpc, _write(tmp_path, "default"), 0, device="cpu")
    assert not np.array_equal(got["phi0"], want["phi0"])   # two paths ran
    np.testing.assert_allclose(got["phi0"], want["phi0"], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got["heat0"], want["heat0"], rtol=1e-9,
                               atol=0)
    for g, w in zip(got["steps"], want["steps"]):
        for k in ("xh", "phi_ion", "temp"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-9, atol=0,
                                       err_msg=k)
