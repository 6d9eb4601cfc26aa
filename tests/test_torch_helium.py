"""The port's helium path (radiation/helium.py, ops/raytrace_he.py,
evolve.evolve3D_he, engine: he in the model layer, the CubeP3M helium
outputs) against the JAX package's, in float64 on the CPU. The JAX
HeRaytracer is built with accumulate="scan": its window accumulate carries
the stale-window fault (ROADMAP.md section 3)."""

import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pyc2ray_tpu as jpc
from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.chemistry_he import HeChemistryParams as JHeParams
from pyc2ray_tpu.ops.raytrace_he import HeRaytracer as JHeRaytracer
from pyc2ray_tpu.radiation import BlackBodySource as JBlackBody
from pyc2ray_tpu.radiation import helium as j_helium

import pyc2ray_torch as tpc
from pyc2ray_torch.evolve import evolve3D_he
from pyc2ray_torch.io import read_cbin
from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.chemistry import ChemistryParams
from pyc2ray_torch.ops.chemistry_he import HeChemistryParams
from pyc2ray_torch.ops.raytrace_he import HeRaytracer
from pyc2ray_torch.radiation import BlackBodySource
from pyc2ray_torch.radiation import helium

from test_torch_cubep3m import (ZLIST, _models, _resume,  # noqa: F401
                                _same_outputs, inputs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DR = 6.7e20
CHEM = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598 ** 2,
            temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
ABU_HE = 0.074


def _bins(mod, bb, **kw):
    return mod.make_spectral_bins_he(bb(5e4, False, ev2fr * 13.598, 2.8),
                                     **kw)


@pytest.mark.parametrize("kw", [{}, {"panels_per_band": 2, "nodes": 4},
                                {"cross_section_model": "verner"},
                                {"pl": (2.5, 1.7, 2.8), "freq_max": 3e16}],
                         ids=["defaults", "2x4", "verner", "pl_fmax"])
def test_bins_equal_jax(kw):
    """make_spectral_bins_he and secondary_ramps, bit for bit."""
    want = _bins(j_helium, JBlackBody, **kw)
    got = _bins(helium, BlackBodySource, **kw)
    assert got._fields == want._fields and got.num_bins == want.num_bins
    for name in ("s", "w_photo", "w_heat", "nu"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert tuple(got.sigma_th) == tuple(want.sigma_th)
    for abu in (0.0, ABU_HE):
        assert helium.secondary_ramps(got, abu) == \
            j_helium.secondary_ramps(want, abu)


def test_cross_sections_and_constants_equal_jax():
    nu = ev2fr * np.logspace(np.log10(10.0), np.log10(600.0), 257)
    for sp in range(3):
        assert np.array_equal(helium.cross_section(nu, sp),
                              j_helium.cross_section(nu, sp))
        assert np.array_equal(helium.cross_section(nu, sp, pl=2.0),
                              j_helium.cross_section(nu, sp, pl=2.0))
        assert np.array_equal(helium.verner_cross_section(nu, sp),
                              j_helium.verner_cross_section(nu, sp))
    for name in ("HE_EDGES_EV", "SIGMA_TH", "DEFAULT_PL", "VERNER_PARAMS"):
        assert getattr(helium, name) == getattr(j_helium, name), name
    with pytest.raises(ValueError, match="cross_section_model"):
        _bins(helium, BlackBodySource, cross_section_model="other")


def _fields(N, seed):
    rng = np.random.RandomState(seed)
    return (10 ** rng.uniform(-4, -2, (N,) * 3),
            rng.uniform(0.0, 0.9, (N,) * 3),
            rng.uniform(0.0, 0.4, (N,) * 3),
            rng.uniform(0.0, 0.4, (N,) * 3))


HE_CASES = {"N12_R4.5_heat": (12, 4.5, True),
            "N12_R9": (12, 9.0, False),
            "N13_R30_heat": (13, 30.0, True)}


@pytest.mark.parametrize("case", list(HE_CASES))
def test_he_raytracer_matches_jax(case):
    """Gamma_HI, Gamma_HeI, Gamma_HeII (and the per-HI-atom heating)
    against the JAX HeRaytracer(accumulate="scan"), sources at a box corner
    and inside, the box clipped (R < N/2) or not: rtol 1e-10."""
    N, R, heat = HE_CASES[case]
    pos = np.array([[0, 0, 0], [5, 7, 2], [N - 1, N - 1, N - 1]])
    flux = np.array([1.0, 2.0, 0.5])
    fields = _fields(N, seed=N)
    jb = _bins(j_helium, JBlackBody, panels_per_band=2, nodes=4)
    tb = _bins(helium, BlackBodySource, panels_per_band=2, nodes=4)
    jr = JHeRaytracer(N, R, jb, ABU_HE, batch_size=2, dtype=jnp.float64,
                      accumulate="scan", do_heating=heat)
    tr = HeRaytracer(N, R, tb, ABU_HE, batch_size=2, dtype=torch.float64,
                     device="cpu", do_heating=heat)
    want = jr.trace(*fields, pos, flux, DR)
    got = tr.trace(*fields, pos, flux, DR)
    assert len(got) == len(want) == (4 if heat else 3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (N,) * 3 and w.max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=0)


def test_he_raytracer_segmented_sweep_matches_monolithic():
    """Where the host engine segments its sweep (K2), each species' sweep
    is segmented at its own cross section and gives the monolithic
    Gamma."""
    N, R = 12, 9.0
    fields = _fields(N, seed=2)
    tb = _bins(helium, BlackBodySource, panels_per_band=2, nodes=4)
    pos, flux = np.array([[3, 4, 5], [0, 11, 6]]), np.array([1.0, 3.0])
    tr = HeRaytracer(N, R, tb, ABU_HE, batch_size=2, dtype=torch.float64,
                     device="cpu")
    want = tr.trace(*fields, pos, flux, DR)
    tr.eng.seg_S, tr.eng.seg_K = 3, -(-tr.geom.r_max // 3)
    got = tr.trace(*fields, pos, flux, DR)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-13, atol=0)


def _evolve_setup(N=12):
    rng = np.random.RandomState(5)
    pos = rng.randint(0, N, size=(4, 3))
    flux = rng.uniform(1.0, 5.0, 4)
    nd = 10 ** rng.uniform(-3.5, -2.5, (N,) * 3)
    return pos, flux, nd, np.full((N,) * 3, 1e4), np.full((N,) * 3, 1.2e-3), \
        np.full((N,) * 3, 1e-3), np.zeros((N,) * 3)


@pytest.mark.parametrize("options", ["plain", "secondary_recombination"])
def test_evolve3D_he_one_step_matches_jax(options):
    """One coupled H+He timestep to convergence (rtol 1e-8: the helium
    chemistry's conditioning, tests/test_torch_chemistry_he.py, through
    the converged raytrace/chemistry loop); with secondary ionizations and
    the recombination photons also the thermal update."""
    from pyc2ray_tpu.evolve import evolve3D_he as j_evolve3D_he
    from pyc2ray_tpu.ops.thermal import ThermalParams as JThermal
    from pyc2ray_torch.ops.thermal import ThermalParams
    N = 12
    pos, flux, nd, temp, xh, y1, y2 = _evolve_setup(N)
    full = options != "plain"
    kw_p = dict(secondary=full, recombination_photons=full)
    jb = _bins(j_helium, JBlackBody, panels_per_band=2, nodes=4)
    tb = _bins(helium, BlackBodySource, panels_per_band=2, nodes=4)
    jr = JHeRaytracer(N, 5.0, jb, ABU_HE, batch_size=2, dtype=jnp.float64,
                      accumulate="scan", do_heating=full)
    tr = HeRaytracer(N, 5.0, tb, ABU_HE, batch_size=2, dtype=torch.float64,
                     device="cpu", do_heating=full)
    th = {} if not full else dict(thermal=ThermalParams(**CHEM), zred=9.0)
    jth = {} if not full else dict(thermal=JThermal(**CHEM), zred=9.0)
    args = (temp, nd, xh, y1, y2)
    want = j_evolve3D_he(3.15e13, DR, flux, pos, jr,
                         JHeParams(chem=JChem(**CHEM), abu_he=ABU_HE,
                                   **kw_p), *args, quiet=True, **jth)
    got = evolve3D_he(3.15e13, DR, flux, pos, tr,
                      HeChemistryParams(chem=ChemistryParams(**CHEM),
                                        abu_he=ABU_HE, **kw_p),
                      *args, quiet=True, **th)
    assert len(got) == len(want) == (7 if full else 6)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (N,) * 3
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8, atol=0)
    assert got[0].max() > 1.2e-3 and got[2].max() > 1e-3


def test_evolve3D_he_reads_scalars_in_one_transfer(tmp_path, monkeypatch):
    """As evolve3D: each iteration reads its four scalars (conv_flag, the
    two sums, the absorbed rate) back in one transfer, ``_host_scalars``,
    and evolve.py reads no other tensor into a Python number."""
    import sys
    import pyc2ray_torch.evolve as ev
    sizes, direct = [], []
    host_scalars = ev._host_scalars

    def counting(*scalars):
        sizes.append(len(scalars))
        return host_scalars(*scalars)

    def watch(name):
        base = getattr(torch.Tensor, name)

        def method(self, *a, **kw):
            caller = sys._getframe(1).f_code
            if (caller.co_filename == ev.__file__
                    and caller.co_name != "_host_scalars"):
                direct.append((caller.co_name, name))
            return base(self, *a, **kw)
        return method

    monkeypatch.setattr(ev, "_host_scalars", counting)
    for name in ("__float__", "__int__", "__bool__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, watch(name))
    N = 8
    tb = _bins(helium, BlackBodySource, panels_per_band=2, nodes=4)
    rt = HeRaytracer(N, 4.0, tb, ABU_HE, batch_size=2, dtype=torch.float64,
                     device="cpu")
    one = np.ones((N,) * 3)
    log = str(tmp_path / "evolve_he.log")
    out = evolve3D_he(1e13, DR, np.array([1.0, 2.0]),
                      np.array([[4, 4, 4], [1, 2, 3]]), rt,
                      HeChemistryParams(chem=ChemistryParams(**CHEM),
                                        abu_he=ABU_HE),
                      1e4 * one, 1e-3 * one, 1.2e-3 * one, 1e-3 * one,
                      0 * one, logfile=log, quiet=True)
    with open(log) as f:
        n_iter = sum("Raytracing (3 species) took" in line for line in f)
    assert n_iter >= 2 and sizes == [4] * n_iter and direct == []
    assert out[0].max() > 1.2e-3


def _he_yml(tmp_path, name, extra=""):
    """tests/test_models.py's parameters with engine: he (NumTau 300), the
    accumulate named "scan", results in the test's directory."""
    p = (ROOT / "examples" / "single_source_test" / "parameters.yml"
         ).read_text()
    p = p.replace("NumTau: 2000", "NumTau: 300")
    p = p.replace("results_basename: ./results/",
                  f"results_basename: {tmp_path}/{name}_")
    p = p.replace("dtype: float64", "dtype: float64\n  engine: he\n"
                  "  accumulate: scan\n  bins_panels: 2\n  bins_nodes: 4"
                  + extra)
    f = tmp_path / f"{name}.yml"
    f.write_text(p)
    return str(f)


def test_helium_engine_through_model_matches_jax(tmp_path):
    """engine: he through C2Ray_Test, as tests/test_models.py drives it:
    one timestep of the coupled H+He evolve at N = 12 against the JAX
    model (xh, xhe1, xhe2, Gamma_HI, Gamma_HeI, Gamma_HeII: rtol 1e-8), the
    structure that test asserts, and do_raytracing."""
    N = 12
    srcpos = np.array([[N // 2], [N // 2], [N // 2]], dtype=float)
    srcflux = np.array([20.0])
    res = {}
    for name, mod, kw in (("jax", jpc, {}), ("torch", tpc,
                                             {"device": "cpu"})):
        sim = mod.C2Ray_Test(_he_yml(tmp_path, name), N, **kw)
        assert sim.multi_species
        sim.ndens = 1e-3 * np.ones((N, N, N))
        zreds = sim.generate_redshift_array(2, 1e6)
        dt = sim.set_timestep(zreds[0], zreds[1], 2)
        sim.evolve3D(dt, srcflux, srcpos)
        out = [np.asarray(getattr(sim, k)) for k in
               ("xh", "xhe1", "xhe2", "phi_ion", "phi_he1", "phi_he2")]
        phi = sim.do_raytracing(srcflux, srcpos)
        out += [np.asarray(phi), np.asarray(sim.phi_he1)]
        res[name] = (sim, out)
    sim, got = res["torch"]
    assert type(sim.raytracer) is HeRaytracer
    assert sim.raytracer.bins.num_bins == 24
    assert tuple(sim.chem_he)[1:] == tuple(res["jax"][0].chem_he)[1:]
    for g, w in zip(got, res["jax"][1]):
        assert g.shape == (N, N, N)
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=0)
    xh, y1, y2 = got[:3]
    c = N // 2
    assert xh[c, c, c] > 20 * 1.2e-3
    assert y1[c, c, c] + y2[c, c, c] > 20 * 1e-3
    assert xh[c, c, c] > xh[0, 0, 0] * 5
    assert np.all(y1 + y2 <= 1 + 1e-12)
    assert got[7].max() > 0


def test_helium_model_parameters_equal_jax(tmp_path):
    """The He chemistry parameters the model derives (recycling cross
    sections, SvS ramps) equal the JAX model's, with secondary
    ionizations, the ramps and verner cross sections; and the model's
    ValueErrors."""
    extra = "\n  cross_sections: verner"
    text = dict(secondary_ionization=1, secondary_ramp=1,
                recombination_photons=1, compute_heating_rates=1)
    for name, mod, kw in (("jax", jpc, {}), ("torch", tpc,
                                             {"device": "cpu"})):
        f = _he_yml(tmp_path, name, extra)
        p = pathlib.Path(f).read_text().replace(
            "compute_heating_rates: 0", "\n  ".join(
                f"{k}: {v}" for k, v in text.items()))
        pathlib.Path(f).write_text(p)
        text[name] = mod.C2Ray_Test(f, 8, **kw).chem_he
    assert tuple(text["torch"])[1:] == tuple(text["jax"])[1:]
    assert tuple(text["torch"].chem) == tuple(text["jax"].chem)
    assert text["torch"].sec_ramp_hi < 1.0 and text["torch"].secondary
    from pyc2ray_torch.utils.paramutils import read_paramfile
    base = read_paramfile(_he_yml(tmp_path, "err"))
    for change, match in (
            ({"Photo": {"secondary_ionization": 1}}, "compute_heating"),
            ({"Photo": {"secondary_ramp": 1, "compute_heating_rates": 1}},
             "secondary_ionization: 1 too"),
            ({"Material": {"isothermal": False}}, "compute_heating_rates"),
            ({"Raytracing": {"cross_sections": "verner"},
              "BlackBodySource": {"cross_section_pl_index": 2.5}},
             "conflicts")):
        ld = read_paramfile(_he_yml(tmp_path, "err"))
        for sec, kv in change.items():
            ld[sec].update(kv)
        with pytest.raises(ValueError, match=match):
            tpc.C2Ray_Test(ld, 8, device="cpu")
    assert base["Raytracing"]["engine"] == "he"


def test_cubep3m_helium_outputs_and_resume(tmp_path, inputs):
    """engine: he in C2Ray_CubeP3M: xfracHe1/xfracHe2 are written beside
    the hydrogen outputs, equal to the JAX model's, and a resume reloads
    them; one file of the pair alone raises."""
    rep = (("engine: adaptive", "engine: he\n  accumulate: scan\n"
            "  bins_panels: 2\n  bins_nodes: 4"),)
    (tsim, text, _), (jsim, _, _) = _models(tmp_path, inputs,
                                            "C2Ray_CubeP3M", rep)
    assert tsim.multi_species and type(tsim.raytracer) is HeRaytracer
    suffix = f"_{ZLIST[1]:.3f}.dat"
    for name, field in (("xfracHe1", tsim.xhe1), ("xfracHe2", tsim.xhe2)):
        back = read_cbin(tsim.results_basename + name + suffix, bits=64,
                         order="F")
        np.testing.assert_array_equal(back, field)
    assert tsim.xhe1.std() > 0          # evolved from its uniform start
    np.testing.assert_allclose(tsim.xhe1, jsim.xhe1, rtol=1e-8)
    _same_outputs(tsim, jsim)
    sim2 = _resume(tmp_path, "t", text, tpc.C2Ray_CubeP3M, device="cpu")
    np.testing.assert_array_equal(sim2.xhe1, tsim.xhe1)
    np.testing.assert_array_equal(sim2.xhe2, tsim.xhe2)
    (tmp_path / "t" / f"xfracHe2{suffix}").unlink()
    with pytest.raises(FileNotFoundError, match="incomplete helium"):
        _resume(tmp_path, "t", text, tpc.C2Ray_CubeP3M, device="cpu")


@pytest.mark.cuda
def test_k1_at_helium_cross_sections_on_cuda():
    """K1 at each species' threshold cross section against its plain
    version, bit for bit, on a clipped box in both dtypes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tb = _bins(helium, BlackBodySource)
    for dt in (torch.float32, torch.float64):
        tr = HeRaytracer(16, 8.0, tb, ABU_HE, batch_size=2, dtype=dt)
        g, t = tr.geom, tr.eng.tables
        rng = np.random.RandomState(29)
        nhi = torch.from_numpy(
            10 ** rng.uniform(-4, -2, (2,) + (g.Dc,) * 3)).to("cuda", dt)
        for sig in tr.sigma_th:
            args = (nhi, t.sw, t.path, t.diag, t.mask_m, t.mask_p, DR, g.c,
                    sig)
            assert torch.equal(sweep.cheb_sweep(*args),
                               sweep.cheb_sweep_ref(*args))
