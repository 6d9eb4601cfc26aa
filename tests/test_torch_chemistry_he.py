"""The port's coupled H+He chemistry (ops/chemistry_he.py) against the JAX
package's, in float64 on the CPU, on the same seeded numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyc2ray_tpu.ops import chemistry_he as jhe
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem

from pyc2ray_torch.ops import chemistry_he as the
from pyc2ray_torch.ops.chemistry import ChemistryParams

PARAMS = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598 ** 2,
              temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
# the recycling cross sections of the power-law family at the HeI edge
# and at HeII Ly-alpha, as models/base.py derives them
SIGS = dict(sig_h_he1=1.18e-18, sig_he1_he1=7.42e-18, sig_h_lya2=3.4e-19,
            sig_he1_lya2=3.0e-18)


def _params(abu_he=0.074, **kw):
    return (jhe.HeChemistryParams(chem=JChem(**PARAMS), abu_he=abu_he, **kw),
            the.HeChemistryParams(chem=ChemistryParams(**PARAMS),
                                  abu_he=abu_he, **kw))


def _fields(seed, n=12 ** 3):
    """Cells from neutral to nearly ionized, in both helium stages."""
    rng = np.random.RandomState(seed)
    xh = rng.uniform(1e-4, 0.99, n)
    y1 = rng.uniform(1e-4, 0.6, n)
    y2 = rng.uniform(0.0, 0.35, n)
    return dict(ndens=10 ** rng.uniform(-4, -1, n),
                temp=rng.uniform(5e3, 3e4, n),
                xh=xh, xh_av=np.clip(xh * rng.uniform(0.8, 1.2, n), 0, 0.999),
                y1=y1, y1_av=y1 * rng.uniform(0.8, 1.2, n),
                y2=y2, y2_av=y2 * rng.uniform(0.8, 1.2, n),
                phi_h=10 ** rng.uniform(-18, -10, n),
                phi_he1=10 ** rng.uniform(-18, -10, n),
                phi_he2=10 ** rng.uniform(-19, -11, n),
                heat=10 ** rng.uniform(-30, -20, n),
                mask=rng.uniform(size=n) > 0.3)


ORDER = ("ndens", "temp", "xh", "xh_av", "y1", "y1_av", "y2", "y2_av",
         "phi_h", "phi_he1", "phi_he2")


@pytest.mark.parametrize("option", ["plain", "mask", "secondary",
                                    "secondary_ramp", "recombination",
                                    "all", "no_helium"])
def test_global_pass_he_matches_jax(option):
    """Every output of global_pass_he, and the non-convergence count, in
    each option (mask=, heat= with and without the SvS ramps,
    recombination_photons, all together, abu_he = 0): rtol 1e-9. The pass
    is only so well conditioned: near eigenvalue confluence the 2x2 divided
    differences lose up to 1/sqrt(eps) of relative precision, and the
    coupled iteration carries it on, so the JAX function itself moves by up
    to 8e-11 on these fields when Gamma_HI and Gamma_HeI change by one ulp
    (test_global_pass_he_one_ulp_sensitivity); the last-bit differences
    between XLA's and libm's exp, expm1 and pow are several such ulps."""
    f = _fields(1)
    kw_p = dict(SIGS)
    if option in ("secondary_ramp", "all"):
        kw_p.update(sec_ramp_hi=0.62, sec_ramp_hei=0.31)
    jp, tp = _params(abu_he=0.0 if option == "no_helium" else 0.074, **kw_p)
    kw = {}
    if option in ("mask", "all"):
        kw["mask"] = f["mask"]
    if option in ("secondary", "secondary_ramp", "all"):
        kw["heat"] = f["heat"]
    rec = option in ("recombination", "all")
    dt = 3.15e13
    want = jhe.global_pass_he(dt, *(jnp.asarray(f[k]) for k in ORDER), jp,
                              **{k: jnp.asarray(v) for k, v in kw.items()},
                              recombination_photons=rec)
    got = the.global_pass_he(dt, *(torch.from_numpy(f[k]) for k in ORDER),
                             tp, **{k: torch.from_numpy(v)
                                    for k, v in kw.items()},
                             recombination_photons=rec)
    assert len(got) == len(want) == 7
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9)
    assert int(got[6]) == int(want[6])


def test_global_pass_he_one_ulp_sensitivity():
    """The conditioning that sets test_global_pass_he_matches_jax's
    tolerance: the JAX pass on these fields, with every option on, moves by
    more than 1e-12 and less than 1e-9 when Gamma_HI and Gamma_HeI change by
    one ulp."""
    f = _fields(1)
    jp, _ = _params(**SIGS)

    def run(eps):
        g = dict(f, phi_h=f["phi_h"] * (1 + eps),
                 phi_he1=f["phi_he1"] * (1 - eps))
        return jhe.global_pass_he(3.15e13, *(jnp.asarray(g[k])
                                             for k in ORDER), jp,
                                  mask=jnp.asarray(f["mask"]),
                                  heat=jnp.asarray(f["heat"]),
                                  recombination_photons=True)
    rel = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                           / np.abs(np.asarray(a))))
              for a, b in zip(run(0.0)[:6], run(2.2e-16)[:6]))
    assert 1e-12 < rel < 1e-9


def test_he_update_and_expm2_match_jax():
    """One frozen-rate helium update (the 2x2 closed form, its small-z
    series and the clamping), including a zero electron density (singular
    A) and a very long timestep: rtol 1e-9 beside an absolute 1e-15, for
    the divided differences' conditioning (test_global_pass_he_matches_jax)."""
    f = _fields(2, n=4096)
    ne = f["ndens"] * f["xh"]
    ne[:16] = 0.0
    jp, tp = _params()
    for dt in (3.15e9, 3.15e13, 1e25):
        want = jhe.he_update(*(jnp.asarray(f[k]) for k in ("y1", "y2")), dt,
                             jnp.asarray(f["temp"]), jnp.asarray(ne),
                             jnp.asarray(f["phi_he1"]),
                             jnp.asarray(f["phi_he2"]), jp)
        got = the.he_update(*(torch.from_numpy(f[k]) for k in ("y1", "y2")),
                            dt, torch.from_numpy(f["temp"]),
                            torch.from_numpy(ne),
                            torch.from_numpy(f["phi_he1"]),
                            torch.from_numpy(f["phi_he2"]), tp)
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all())
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-15)


def test_expm2_float32_discriminant_floor():
    """The eigenvalue-separation floor is per dtype (sqrt of its eps): in
    float32 the port's _expm2 agrees with the JAX one on float32 inputs
    near confluence to float32 rounding."""
    rng = np.random.RandomState(3)
    n = 512
    G1, G2, R2, R3 = (10 ** rng.uniform(-14, -10, n) for _ in range(4))
    R3 = G1 + G2 + R2 - R3 * 1e-6            # nearly equal eigenvalues
    A = [-(G1 + G2 + R2), -G1 + R3, G2, -R3]
    args = A + [G1, np.zeros(n), rng.uniform(0, 0.5, n),
                rng.uniform(0, 0.5, n)]
    want = jhe._expm2(*(jnp.asarray(a, jnp.float32) for a in args),
                      jnp.float32(3.15e13))
    got = the._expm2(*(torch.from_numpy(a).float() for a in args),
                     torch.tensor(3.15e13, dtype=torch.float32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-6)


def test_secondary_functions_match_jax():
    x = np.concatenate([[0.0, 1.0, -0.1, 1.1], np.logspace(-6, 0, 64)])
    for jf, tf in ((jhe.secondary_ionization_fractions,
                    the.secondary_ionization_fractions),
                   (jhe.secondary_heating_fraction,
                    the.secondary_heating_fraction)):
        want = jf(jnp.asarray(x))
        got = tf(torch.from_numpy(x))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13)
    heat = torch.from_numpy(10 ** np.linspace(-30, -20, x.size))
    jp, tp = _params(secondary=True)
    assert the.thermal_heat_rate(tp, heat, torch.from_numpy(x), False) \
        is heat
    np.testing.assert_allclose(
        the.thermal_heat_rate(tp, heat, torch.from_numpy(x), True).numpy(),
        np.asarray(jhe.thermal_heat_rate(jp, jnp.asarray(heat.numpy()),
                                         jnp.asarray(x), True)), rtol=1e-13)
    assert the.secondary_enabled(tp, True)
    assert not the.secondary_enabled(_params()[1], False)
    with pytest.raises(ValueError, match="do_heating"):
        the.secondary_enabled(tp, False)


def test_params_defaults_equal_jax():
    jp, tp = _params()
    assert tp._fields == jp._fields
    assert tuple(tp)[1:] == tuple(jp)[1:] and tuple(tp.chem) == tuple(jp.chem)


def _helium_front_fields(n=8192):
    """An ionizing helium front from a neutral start (y2 = 0): the cells
    where <y2> stays orders of magnitude below <y1>."""
    rng = np.random.RandomState(9)
    phi_h = 10 ** rng.uniform(-15, -11, n)
    return dict(ndens=np.full(n, 1e-3), temp=np.full(n, 1e4),
                xh=np.full(n, 1.2e-3), xh_av=np.full(n, 1.2e-3),
                y1=np.full(n, 1e-3), y1_av=np.full(n, 1e-3),
                y2=np.zeros(n), y2_av=np.zeros(n), phi_h=phi_h,
                phi_he1=phi_h * 10 ** rng.uniform(-2.5, -1, n),
                phi_he2=phi_h * 10 ** rng.uniform(-5, -3, n))


def test_global_pass_he_float32_converges_as_float64(monkeypatch):
    """In float32 the pass converges within the iterations float64 takes
    (its outputs with a cap of 8 inner iterations equal those with 400),
    and agrees with float64 to float32 precision. The 2x2 solve in float32
    left <y2> << <y1> with percents of noise, and cells ran to the cap."""
    f = _helium_front_fields()
    _, tp = _params()
    dt = 3.15e13
    out = {}
    for dtype in (torch.float64, torch.float32):
        args = [torch.from_numpy(f[k]).to(dtype) for k in ORDER]
        for cap in (400, 8):
            monkeypatch.setattr(the, "MAX_INNER_ITER", cap)
            out[dtype, cap] = the.global_pass_he(dt, *args, tp)
    for dtype in (torch.float64, torch.float32):
        for a, b in zip(out[dtype, 400], out[dtype, 8]):
            assert torch.equal(a, b), dtype
    y1, y2 = out[torch.float64, 400][3], out[torch.float64, 400][5]
    assert int((y2 < 1e-3 * y1).sum()) > y1.numel() // 10
    for a, b in zip(out[torch.float32, 400][:6], out[torch.float64, 400][:6]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-12)
