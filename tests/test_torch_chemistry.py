"""The port's chemistry (doric, global_pass) against the JAX package's, in
float64, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import torch

from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.chemistry import doric as j_doric
from pyc2ray_tpu.ops.chemistry import global_pass as j_global_pass

from pyc2ray_torch.ops.chemistry import ChemistryParams, doric, global_pass

PARAMS = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598**2,
              temph0=13.598 / 8.617e-05, abu_c=7.1e-7)


def _fields(seed, n=16 ** 3, log_phi=(-18, -10), log_ndens=(-4, -1)):
    rng = np.random.RandomState(seed)
    return dict(ndens=10 ** rng.uniform(*log_ndens, n),
                temp=rng.uniform(5e3, 3e4, n),
                xh=rng.uniform(1e-4, 0.99, n),
                xh_av=rng.uniform(1e-4, 0.99, n),
                phi=10 ** rng.uniform(*log_phi, n))


def test_doric_matches_jax():
    f = _fields(0)
    dt = 3.15e13
    rhe = f["ndens"] * (f["xh_av"] + PARAMS["abu_c"])
    want = j_doric(jnp.asarray(f["xh"]), dt, jnp.asarray(f["temp"]),
                   jnp.asarray(rhe), jnp.asarray(f["phi"]), JChem(**PARAMS))
    got = doric(torch.from_numpy(f["xh"]), dt, torch.from_numpy(f["temp"]),
                torch.from_numpy(rhe), torch.from_numpy(f["phi"]),
                ChemistryParams(**PARAMS))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_global_pass_matches_jax():
    """Cells near sources (Gamma dt >= 0.1). There the closed form is well
    conditioned; where delta_t = (Gamma + n_e(A_col + alpha_B)) dt << 1 the
    time average (1 - e^-delta_t) / delta_t cancels and amplifies the last
    bits of exp, in which XLA's CPU exp and glibc's (used by torch) differ
    by up to ~4e-15 relative. That regime is held by the evolve3D test."""
    f = _fields(1, log_phi=(-14, -10), log_ndens=(-3, -1))
    dt = 1e13
    want = j_global_pass(jnp.asarray(dt), jnp.asarray(f["ndens"]),
                         jnp.asarray(f["temp"]), jnp.asarray(f["xh"]),
                         jnp.asarray(f["xh_av"]), jnp.asarray(f["phi"]),
                         JChem(**PARAMS))
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    got = global_pass(torch.tensor(dt, dtype=torch.float64), t["ndens"],
                      t["temp"], t["xh"], t["xh_av"], t["phi"],
                      ChemistryParams(**PARAMS))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-12)
    assert int(got[2]) == int(want[2]) > 0


def test_global_pass_conv_flag_matches_jax_far_from_sources():
    """Over the full range of rates (down to Gamma dt = 1e-5) the
    non-convergence count and the converged fractions agree; the
    tolerance covers the cancellation described above."""
    f = _fields(2)
    dt = 1e13
    want = j_global_pass(jnp.asarray(dt), jnp.asarray(f["ndens"]),
                         jnp.asarray(f["temp"]), jnp.asarray(f["xh"]),
                         jnp.asarray(f["xh_av"]), jnp.asarray(f["phi"]),
                         JChem(**PARAMS))
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    got = global_pass(torch.tensor(dt, dtype=torch.float64), t["ndens"],
                      t["temp"], t["xh"], t["xh_av"], t["phi"],
                      ChemistryParams(**PARAMS))
    assert int(got[2]) == int(want[2]) > 0
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8)


def test_global_pass_mask_matches_jax():
    """The optional cell mask only removes cells from the non-convergence
    count: the fields are those of the unmasked pass."""
    f = _fields(3, log_phi=(-14, -10), log_ndens=(-3, -1))
    dt = 1e13
    mask = np.random.RandomState(4).uniform(size=f["xh"].shape) > 0.4
    want = j_global_pass(jnp.asarray(dt), jnp.asarray(f["ndens"]),
                         jnp.asarray(f["temp"]), jnp.asarray(f["xh"]),
                         jnp.asarray(f["xh_av"]), jnp.asarray(f["phi"]),
                         JChem(**PARAMS), mask=jnp.asarray(mask))
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    args = (torch.tensor(dt, dtype=torch.float64), t["ndens"], t["temp"],
            t["xh"], t["xh_av"], t["phi"], ChemistryParams(**PARAMS))
    got = global_pass(*args, mask=torch.from_numpy(mask))
    full = global_pass(*args)
    assert 0 < int(got[2]) == int(want[2]) < int(full[2])
    assert int(global_pass(*args, mask=torch.zeros_like(t["xh"],
                                                        dtype=torch.bool))[2]) == 0
    for g, u, w in zip(got[:2], full[:2], want[:2]):
        assert torch.equal(g, u)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_doric_float32_time_average_is_not_cancelled():
    """Where delta_t = (Gamma + n_e(A_col + alpha_B)) dt is small, the time
    average (1 - e^-delta_t) / delta_t cancels; in float32 doric evaluates
    it without the cancellation, so <x> stays within float32 rounding of
    the float64 result (1 - e^-delta_t in float32 put it 1e-2 off here,
    and up to 100% off at delta_t ~ 1e-7)."""
    f = _fields(2, log_phi=(-20, -16), log_ndens=(-4, -3))
    dt = 3.15e13
    rhe = f["ndens"] * (f["xh_av"] + PARAMS["abu_c"])
    temp = np.random.RandomState(3).uniform(5e3, 1.2e4, rhe.size)
    delth = (f["phi"] + rhe * PARAMS["colh0"] * np.sqrt(temp)
             * np.exp(-PARAMS["temph0"] / temp)
             + rhe * PARAMS["bh00"] * (temp / 1e4) ** PARAMS["albpow"])
    assert 1e-8 < (delth * dt).min() and (delth * dt).max() < 0.05
    p = ChemistryParams(**PARAMS)
    arrays = (f["xh"], temp, rhe, f["phi"])
    x64, av64 = doric(*(torch.from_numpy(a) for a in arrays[:1]), dt,
                      *(torch.from_numpy(a) for a in arrays[1:]), p)
    x32, av32 = doric(*(torch.from_numpy(a).float() for a in arrays[:1]), dt,
                      *(torch.from_numpy(a).float() for a in arrays[1:]), p)
    assert av32.dtype == torch.float32
    # float32 rounding: a few ulps relative, and ~2 ulps of 1 absolute
    # where xh = eqxh + (x0 - eqxh) ... is small beside its terms
    np.testing.assert_allclose(av32.numpy(), av64.numpy(), rtol=2e-6,
                               atol=1.2e-7)
    np.testing.assert_allclose(x32.numpy(), x64.numpy(), rtol=2e-6,
                               atol=1.2e-7)


# float32 rounding unit (one ulp of a number in [1, 2))
_ULP32 = 2.0 ** -24


def _doric_grid():
    """float32 (deltht, x0, eqxh) over deltht in [1e-10, 1e3], x0 in
    [1e-8, 1 - 1e-6] and eqxh on both sides of x0, with the exact values of
    the reference's closed form (chemistry.f90:285-306, its guard included)
    at 40 digits: x(t) = eqxh + (x0 - eqxh) e^-z and <x> = eqxh + (x0 -
    eqxh) (1 - e^-z)/z, the average factor 1 below z = 1e-8 (the guard's
    threshold as float32 compares it)."""
    import mpmath
    mpmath.mp.dps = 40
    z = np.logspace(-10, 3, 40).astype(np.float32)
    x0 = np.concatenate([np.logspace(-8, -1, 12),
                         1 - np.logspace(-1, -6, 8)]).astype(np.float32)
    rows = [(zi, xi, e) for zi in z for xi in x0
            for e in np.concatenate([xi * np.logspace(-6, -0.01, 6),
                                     xi + (1 - xi) * np.logspace(-6, -1e-4,
                                                                 7)])]
    grid = np.array(rows, dtype=np.float32)
    guard = mpmath.mpf(float(np.float32(1e-8)))

    def exact(z, x, e):
        z, x, e = (mpmath.mpf(float(v)) for v in (z, x, e))
        ee = mpmath.exp(-z)
        avg = 1 if z < guard else (1 - ee) / z
        return float(e + (x - e) * ee), float(e + (x - e) * avg)
    return grid, np.array([exact(*r) for r in grid])


def _parent_float32_form(x0, eqxh, z):
    """doric's float32 closed form before it was rewritten: the
    reference's x(t) and <x>, with -expm1(-z) in the average factor."""
    x = (x0 - eqxh) * torch.exp(-z) + eqxh
    avg = torch.where(z < 1.0e-8, torch.ones_like(z), -torch.expm1(-z) / z)
    return x, eqxh + (x0 - eqxh) * avg


def test_doric_float32_closed_form_within_ulps_of_exact():
    """doric's float32 closed form (x0 + (eqxh - x0)(-expm1(-z)) and x0 +
    (eqxh - x0) g(z)) is within 4 float32 ulps, relative, of the exact
    values over the whole grid, both outputs. The parent's float32 form
    cancels where x0 << eqxh and fails the same bound there by orders of
    magnitude (the card and the CPU parted by 4.6e-5 in xh through it)."""
    from pyc2ray_torch.ops.chemistry import _closed_form_float32
    grid, want = _doric_grid()
    z, x0, eqxh = (torch.from_numpy(grid[:, k].copy()) for k in (0, 1, 2))
    bound = 4 * _ULP32
    for form in (_closed_form_float32, _parent_float32_form):
        got = form(x0, eqxh, z)
        rel = [np.abs(g.double().numpy() - w) / np.abs(w)
               for g, w in zip(got, want.T)]
        if form is _closed_form_float32:
            assert got[0].dtype == torch.float32
            for r in rel:
                assert r.max() <= bound, r.max() / _ULP32
        else:
            small = (grid[:, 1] < 1e-3 * grid[:, 2])
            for r in rel:
                assert r[small].max() > 100 * bound


def test_doric_float64_is_the_reference_expression():
    """In float64 doric evaluates the reference's expression itself, bit
    for bit (so global_pass's float64 results do not move)."""
    f = _fields(5)
    dt = 3.15e13
    p = ChemistryParams(**PARAMS)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    rhe = t["ndens"] * (t["xh_av"] + p.abu_c)
    brech0 = p.clumping * p.bh00 * (t["temp"] / 1e4) ** p.albpow
    acolh0 = p.colh0 * torch.sqrt(t["temp"]) * torch.exp(-p.temph0
                                                          / t["temp"])
    aih0 = t["phi"] + rhe * acolh0
    delth = aih0 + rhe * brech0
    eqxh = aih0 / delth
    z = delth * dt
    ee = torch.exp(-z)
    x_ref = torch.clamp((t["xh"] - eqxh) * ee + eqxh, min=1e-14)
    avg = torch.where(z < 1e-8, torch.ones_like(z), (1.0 - ee) / z)
    av_ref = torch.clamp(eqxh + (t["xh"] - eqxh) * avg, min=1e-14)
    x, av = doric(t["xh"], dt, t["temp"], rhe, t["phi"], p)
    assert torch.equal(x, x_ref) and torch.equal(av, av_ref)
