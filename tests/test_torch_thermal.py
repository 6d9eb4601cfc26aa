"""The port's thermal solver (ops/thermal.py) and the non-isothermal
evolve3D against the JAX package's, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.evolve import evolve3D as j_evolve3D
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer
from pyc2ray_tpu.ops.thermal import ThermalParams as JThermal
from pyc2ray_tpu.ops.thermal import cooling_rate as j_cooling_rate
from pyc2ray_tpu.ops.thermal import update_temperature as j_update
from pyc2ray_tpu.ops import thermal as j_thermal
from pyc2ray_tpu.radiation.spectral_bins import SpectralBins

from pyc2ray_torch.convert import thermal_from_jax
from pyc2ray_torch.evolve import evolve3D
from pyc2ray_torch.evolve_loop import IterationResult, run_convergence_loop
from pyc2ray_torch.ops import thermal
from pyc2ray_torch.ops.chemistry import ChemistryParams
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.ops.thermal import cooling_rate, update_temperature

JP = JThermal(bh00=2.59e-13, albpow=-0.7,
              colh0=1.3e-8 * 0.83 / (13.598 ** 2),
              temph0=13.598 / 8.617e-05, abu_c=7.1e-7, compton=False)
P = thermal_from_jax(JP._asdict())


def test_params_and_constants_carry_over():
    assert P == thermal.ThermalParams(**JP._asdict())
    assert isinstance(P.compton, bool) and P._fields == JP._fields
    for name in ("KB", "EV2ERG", "E_HI_ERG", "T_CMB0"):
        assert getattr(thermal, name) == getattr(j_thermal, name)


@pytest.mark.parametrize("compton", [False, True])
def test_cooling_rate_matches_jax(compton):
    rng = np.random.RandomState(50)
    n = 4096
    T = 10 ** rng.uniform(0.5, 8.0, n)
    nd = 10 ** rng.uniform(-6, -1, n)
    xh = rng.uniform(1e-5, 1.0, n)
    want = np.asarray(j_cooling_rate(jnp.asarray(T), jnp.asarray(nd),
                                     jnp.asarray(xh),
                                     JP._replace(compton=compton), 9.0))
    got = cooling_rate(torch.from_numpy(T), torch.from_numpy(nd),
                       torch.from_numpy(xh), P._replace(compton=compton),
                       9.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _regime(name):
    """The four regimes of the JAX package's thermal tests, as
    (dt, T0, ndens, xh, heat, compton, z, nsub), and a seeded random
    field from 100 K to 1e5 K with heating on and off."""
    if name == "pure_heating":
        return (1e10, np.full(100, 10.0), np.full(100, 1e-3),
                np.full(100, 1e-5), np.full(100, 1e-26), False, 0.0, 64)
    if name == "equilibrium":
        nd, xh, T = np.full(4, 1e-3), np.full(4, 0.5), np.full(4, 2.0e4)
        lam = np.asarray(j_cooling_rate(jnp.asarray(T), jnp.asarray(nd),
                                        jnp.asarray(xh), JP))
        return (3e13, T, nd, xh, lam / (nd * (1.0 - xh)), False, 0.0, 32)
    if name == "stiff_cooling":        # case 2: ~283 cooling times per step
        return (3.0e13, np.array([3e4, 1e5, 5e4]),
                np.array([1e-3, 1e-2, 1e-4]), np.array([0.9, 0.5, 0.99]),
                np.zeros(3), False, 0.0, 64)
    if name == "compton":
        return (1e17, np.array([1e3, 10.0]), np.full(2, 1e-7),
                np.full(2, 1.0), np.zeros(2), True, 20.0, 64)
    rng = np.random.RandomState(51)
    n = 2048
    heat = 10 ** rng.uniform(-28, -23, n) * (rng.uniform(size=n) > 0.3)
    return (3e13, 10 ** rng.uniform(2, 5, n), 10 ** rng.uniform(-5, -2, n),
            rng.uniform(1e-4, 1.0, n), heat, True, 9.0, 16)


REGIMES = ["pure_heating", "equilibrium", "stiff_cooling", "compton",
           "random"]


def _both(name, npdt):
    dt, T0, nd, xh, heat, compton, z, nsub = _regime(name)
    arrs = [a.astype(npdt) for a in (T0, nd, xh, heat)]
    want = np.asarray(j_update(dt, *[jnp.asarray(a) for a in arrs],
                               JP._replace(compton=compton), z=z,
                               nsub=nsub))
    got = update_temperature(dt, *[torch.from_numpy(a) for a in arrs],
                             P._replace(compton=compton), z=z, nsub=nsub)
    assert want.dtype == npdt and bool(torch.isfinite(got).all())
    assert float(got.min()) >= P.t_floor and float(got.max()) <= P.t_cap
    return got, want


@pytest.mark.parametrize("name", REGIMES)
def test_update_temperature_matches_jax(name):
    """float64, rtol 1e-10."""
    got, want = _both(name, np.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("name", REGIMES)
def test_update_temperature_float32_matches_jax(name):
    """float32 against the JAX package in float32, rtol 1e-4, and against
    it in float64, rtol 1e-4 too. The Compton regime relaxes onto T_cmb,
    where Lambda ~ (T - T_cmb) cancels: there the JAX float32 result
    itself spreads by 2.7e-4 between two cells whose float64 answers are
    equal, so its tolerance is 3e-4, while the port's float32 result stays
    within 1e-6 of the float64 answer."""
    got, want32 = _both(name, np.float32)
    _, want64 = _both(name, np.float64)
    assert got.dtype == torch.float32
    rtol32, rtol64 = (3e-4, 1e-6) if name == "compton" else (1e-4, 1e-4)
    np.testing.assert_allclose(got.numpy(), want32, rtol=rtol32, atol=0)
    np.testing.assert_allclose(got.numpy().astype(np.float64), want64,
                               rtol=rtol64, atol=0)


@pytest.mark.parametrize("name", REGIMES)
def test_update_temperature_on_cpu_is_the_plain_version(name):
    """On CPU fields update_temperature is update_temperature_ref, bit for
    bit in both types, and launches no kernel."""
    from pyc2ray_torch.ops import sweep
    dt, T0, nd, xh, heat, compton, z, nsub = _regime(name)
    for npdt in (np.float64, np.float32):
        args = [torch.from_numpy(a.astype(npdt)) for a in (T0, nd, xh, heat)]
        sweep.reset_launches()
        got = update_temperature(dt, *args, P._replace(compton=compton),
                                 z=z, nsub=nsub)
        assert sum(sweep.launches.values()) == 0
        want = thermal.update_temperature_ref(
            dt, *args, P._replace(compton=compton), z=z, nsub=nsub)
        assert torch.equal(got, want)


def test_update_temperature_raises_on_other_devices():
    """No silent fallback: fields on neither the CPU nor a CUDA card (the
    meta device) make the update raise."""
    t = [torch.ones(8, dtype=torch.float64, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="unsupported device"):
        update_temperature(3e13, *t, P)


def test_update_temperature_cold_start_float32():
    """From 100 K in float32, exp(-temph0/T) and exp(-118348/T) underflow
    to 0 and their derivatives must be 0, not NaN: the gas heats up where
    there is heat and stays put (to rounding) where there is none."""
    n = 64
    T0 = torch.full((n,), 100.0, dtype=torch.float32)
    nd = torch.full((n,), 1e-3, dtype=torch.float32)
    xh = torch.full((n,), 1.2e-3, dtype=torch.float32)
    heat = torch.zeros(n, dtype=torch.float32)
    heat[: n // 2] = 1e-24
    T1 = update_temperature(3e13, T0, nd, xh, heat, P, z=9.0)
    assert bool(torch.isfinite(T1).all())
    assert float(T1[: n // 2].min()) > 1e3
    assert float((T1[n // 2:] - 100.0).abs().max()) < 1.0


def _heat_bins():
    return SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                        w_heat=np.array([8.0e-12]), num_bins=1)


# the configuration of the JAX package's sharded thermal tests (N = 8, two
# sources, R beyond the mesh), with one bin that carries a heating weight
N, SIG, DR, DT = 8, 6.30e-18, 2.0e21, 3.0e13
CHEM = dict(bh00=JP.bh00, albpow=JP.albpow, colh0=JP.colh0,
            temph0=JP.temph0, abu_c=JP.abu_c)
SRC = np.array([[4, 4, 4], [1, 6, 2]])
FLUX = np.array([1.0, 0.5])


def _grids():
    return (1e2 * np.ones(N ** 3), 1e-3 * np.ones(N ** 3),
            1.2e-3 * np.ones(N ** 3))


@pytest.mark.parametrize("fuse_fold", [False, True])
def test_evolve3D_thermal_matches_jax(fuse_fold, tmp_path):
    """One non-isothermal timestep (xh, phi, temp) against the JAX
    package's XLA path in float64: rtol 1e-8 for the default mode; the
    fused mode differs from the XLA path by the cd - dcol cancellation
    (1e-7 on the fields that go through the chemistry)."""
    temp, ndens, xh = _grids()
    jr = JRaytracer(N, 1e9, SIG, _heat_bins(), batch_size=2,
                    dtype=jnp.float64, do_heating=True)
    want = j_evolve3D(DT, DR, FLUX, SRC, jr, JChem(**CHEM), temp, ndens, xh,
                      quiet=True, thermal=JP, zred=9.0)
    tr = ChebRaytracer(N, 1e9, SIG, _heat_bins(), batch_size=2,
                       dtype=torch.float64, device="cpu", do_heating=True,
                       fuse_fold=fuse_fold)
    log = str(tmp_path / "torch.log")
    got = evolve3D(DT, DR, FLUX, SRC, tr, ChemistryParams(**CHEM), temp,
                   ndens, xh, quiet=True, thermal=P, zred=9.0, logfile=log)
    assert len(got) == 3 and len(want) == 3
    rtol = 1e-7 if fuse_fold else 1e-8
    for g, w in zip(got, want):
        assert g.shape == (N, N, N) and np.all(np.isfinite(g))
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=0)
    assert got[2].std() > 0 and got[2].max() > 1e3     # photoheated
    assert "Thermal update took" in open(log).read()


def test_evolve3D_thermal_needs_do_heating():
    temp, ndens, xh = _grids()
    tr = ChebRaytracer(N, 1e9, SIG, _heat_bins(), batch_size=2,
                       dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="do_heating=True"):
        evolve3D(DT, DR, FLUX, SRC, tr, ChemistryParams(**CHEM), temp, ndens,
                 xh, quiet=True, thermal=P)
    # without thermal the same raytracer gives the isothermal pair
    out = evolve3D(DT, DR, FLUX, SRC, tr, ChemistryParams(**CHEM), temp,
                   ndens, xh, quiet=True)
    assert len(out) == 2


@pytest.mark.parametrize("loss,bound,warns", [(0.05, 1e-2, True),
                                              (0.05, 0.1, False),
                                              (0.05, None, False)])
def test_loss_fraction_warning(loss, bound, warns, tmp_path):
    log = str(tmp_path / "loop.log")

    def iteration(niter):
        return IterationResult(0, 1.0, 9.0, photon_loss=loss)
    run_convergence_loop(iteration, 10, 1, logfile=log, quiet=True,
                         loss_fraction=bound)
    text = open(log).read()
    assert ("exceeds Raytracing.loss_fraction" in text) == warns
    assert "photon loss fraction: 5.000e-02" in text


# ---- on the card: the kernel against its plain version --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", REGIMES)
def test_update_temperature_kernel_equals_plain_on_cuda(dtype, name):
    """One launch (csrc/thermal.cu), bit for bit against
    update_temperature_ref on the card, in every regime, with dt a device
    tensor and a Python number, with the regime's substeps, 16 (the fixed
    kernels), 5 (a reciprocal of nsub that is not a power of two) and 1, on
    the fields from their element 1 (an unaligned start, an odd count of
    cells where the regime's is even) and on a grid in Fortran order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the thermal kernel has no CPU mode)")
    from pyc2ray_torch.ops import sweep
    dt, T0, nd, xh, heat, compton, z, nsub = _regime(name)
    args = [torch.from_numpy(a).to(device="cuda", dtype=dtype)
            for a in (T0, nd, xh, heat)]
    p = P._replace(compton=compton)
    for dt_arg, ns in ((torch.tensor(dt, dtype=dtype, device="cuda"), nsub),
                       (dt, nsub), (dt, 16), (dt, 5), (dt, 1)):
        sweep.reset_launches()
        got = update_temperature(dt_arg, *args, p, z=z, nsub=ns)
        assert sweep.launches["thermal_update"] == 1
        want = thermal.update_temperature_ref(dt_arg, *args, p, z=z, nsub=ns)
        assert torch.equal(got, want), (dt_arg, ns)
    if T0.size > 1:
        tail = [a[1:] for a in args]
        assert tail[0].data_ptr() % 16 != 0
        for ns in (nsub, 16):
            got = update_temperature(dt, *tail, p, z=z, nsub=ns)
            want = thermal.update_temperature_ref(dt, *tail, p, z=z, nsub=ns)
            assert torch.equal(got, want), ("from element 1", ns)
    n = T0.size
    if n % 4 == 0:
        f3 = [a.reshape(n // 4, 2, 2).permute(2, 1, 0) for a in args]
        assert not f3[0].is_contiguous()
        got = update_temperature(dt, *f3, p, z=z, nsub=nsub)
        want = thermal.update_temperature_ref(dt, *f3, p, z=z, nsub=nsub)
        assert torch.equal(got, want)


# exponents that ATen's CUDA pow with a scalar exponent does not send to
# pow: 0 and 1 never reach a kernel (fill, copy), 0.5, -0.5 and -1 go to
# sqrt, rsqrt and the reciprocal, 2, 3 and -2 to products; the derivative
# takes albpow - 1 the same way (1.5 -> sqrt, 4 -> the cube)
ALBPOW = [-0.7, 0.0, 0.5, 1.5, -0.5, -1.0, 2.0, 3.0, 4.0, -2.0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("albpow", ALBPOW)
def test_update_temperature_kernel_equals_plain_at_every_exponent(dtype,
                                                                  albpow):
    """The recombination's exponent (and the derivative's albpow - 1) at
    ATen's special values: one launch, bit for bit against
    update_temperature_ref on the card, on the random regime's fields with
    Compton on and off and with 16 and 5 substeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the thermal kernel has no CPU mode)")
    from pyc2ray_torch.ops import sweep
    dt, T0, nd, xh, heat, _, z, _ = _regime("random")
    args = [torch.from_numpy(a).to(device="cuda", dtype=dtype)
            for a in (T0, nd, xh, heat)]
    for compton, nsub in ((True, 16), (False, 16), (True, 5)):
        p = P._replace(albpow=albpow, compton=compton)
        sweep.reset_launches()
        got = update_temperature(dt, *args, p, z=z, nsub=nsub)
        assert sweep.launches["thermal_update"] == 1
        want = thermal.update_temperature_ref(dt, *args, p, z=z, nsub=nsub)
        assert torch.equal(got, want), (compton, nsub, int(
            (got != want).sum()))


@pytest.mark.cuda
def test_pow_pair_equals_pow_on_cuda():
    """csrc/thermal.cuh's pow_pair (the pow of x^p and x^(p - 1) from one
    log stage) bit for bit against powf and pow on the card: every float32
    base in [1e-4, 1e5] and 10^8 float64 bases, at (p, p - 1) for the
    default exponent and ATen's special ones (chip_smoke's
    thermal_pair_check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pow pair has no CPU mode)")
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_pair", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    got = cs.thermal_pair_check()
    assert got["f32"][0] > 2.5e8 and got["f64"][0] == 10 ** 8
    assert got["f32"][1] == 0 and got["f64"][1] == 0, got
