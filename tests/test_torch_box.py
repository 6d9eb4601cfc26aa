"""The port's octahedral sheet engine (ops/raytrace_box.py, engine: box)
against the JAX package's BoxRaytracer in float64, against the port's own
oracle and flat engine (grey), and in float32 against float64, on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.evolve import evolve3D as j_evolve3D
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.raytrace_box import BoxRaytracer as JBox
from pyc2ray_tpu.ops.sheet_geometry import (
    build_sheet_geometry as j_build_sheet_geometry)

from pyc2ray_torch.constants import ev2fr
from pyc2ray_torch.evolve import evolve3D
from pyc2ray_torch.ops.chemistry import ChemistryParams
from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
from pyc2ray_torch.ops.raytrace_box import BoxRaytracer, grey_bins
from pyc2ray_torch.ops.sheet_geometry import build_sheet_geometry
from pyc2ray_torch.oracle import oracle_raytrace
from pyc2ray_torch.radiation import BlackBodySource
from pyc2ray_torch.radiation.spectral_bins import make_spectral_bins

SIG = 6.30e-18
DR = 6.7e20
CHEM = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598**2,
            temph0=13.598 / 8.617e-05, abu_c=7.1e-7)


def _bb_bins():
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    return make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                              fmin, fmax, panels=2, nodes=4)


def _fields(N, seed):
    rng = np.random.RandomState(seed)
    return 10 ** rng.uniform(-4, -2, (N,) * 3), rng.uniform(0.0, 0.9, (N,) * 3)


def _port(N, R, bins=None, dtype=torch.float64, heating=False, batch=2):
    return BoxRaytracer(N, R, SIG, grey_bins() if bins is None else bins,
                        batch_size=batch, dtype=dtype, do_heating=heating,
                        device="cpu")


def _jax(N, R, bins=None, dtype=jnp.float64, heating=False, batch=2):
    return JBox(N, R, SIG, grey_bins() if bins is None else bins,
                batch_size=batch, dtype=dtype, do_heating=heating)


def _close(got, want, rtol=1e-12, floor=1e-12):
    """rtol above ``floor`` of the peak (an absolute floor below it)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * np.abs(want).max())


@pytest.mark.parametrize("N,max_q", [(8, 3), (8, 12), (9, 4), (9, 14),
                                     (16, 6), (21, 9)],
                         ids=["even", "even-clipped", "odd", "odd-clipped",
                              "aligned", "odd-aligned"])
def test_sheet_geometry_bit_equal(N, max_q):
    """Every field of SheetGeometry equals the JAX package's, bit for bit
    and dtype for dtype (Dc's alignment to 8 included)."""
    got = build_sheet_geometry(N, max_q)
    want = j_build_sheet_geometry(N, max_q)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


CASES = [("grey", 10, 1e9, 1), ("grey", 9, 1e9, 2), ("grey", 16, 3.0, 3),
         ("bb", 9, 1e9, 4), ("bb", 16, 3.5, 5)]


@pytest.mark.parametrize("spectrum,N,R,seed", CASES,
                         ids=[f"{s}-N{n}-R{r:g}" for s, n, r, _ in CASES])
def test_box_matches_jax(spectrum, N, R, seed):
    """Gamma (and, with the black-body bins, the heat) of three sources in
    two batches: rtol 1e-12 above 1e-12 of the peak. R = 1e9 clips the box
    at the mesh (odd and even N)."""
    nd, xh = _fields(N, seed)
    src = np.array([[0, N - 1, N // 2], [N // 2, N // 2, N // 2],
                    [N - 1, 0, 1]])
    flux = np.array([1.0, 2.0, 0.5])
    bins = _bb_bins() if spectrum == "bb" else None
    heating = spectrum == "bb"
    got = _port(N, R, bins, heating=heating).trace(nd, xh, src, flux, DR)
    want = _jax(N, R, bins, heating=heating).trace(nd, xh, src, flux, DR)
    if heating:
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


@pytest.mark.parametrize("N,R", [(8, 1e9), (9, 1e9), (16, 3.0)])
def test_grey_matches_oracle_and_flat_engine(N, R):
    """The grey case against the port's sequential oracle and the port's
    flat engine with its analytic grey rates, at the JAX tests' 2e-7."""
    nd, xh = _fields(N, 7)
    src = np.array([[1, N - 2, 3], [N // 2, N // 2, N // 2]])
    flux = np.array([3.0, 1.0])
    got = _port(N, R).trace(nd, xh, src, flux, DR).numpy()
    phi_o, _, _ = oracle_raytrace(nd, xh, src, flux, DR, SIG, R, grey=True)
    np.testing.assert_allclose(got, phi_o, rtol=2e-7)
    cfg = RaytraceConfig(N=N, R_max_LLS=R, sig=SIG, batch_size=2,
                         dtype=torch.float64, grey_analytic=True)
    flat = Raytracer(cfg, device="cpu").trace(nd, xh, src, flux, DR)
    np.testing.assert_allclose(got, flat.numpy(), rtol=2e-7)


def test_zero_density_cell_gives_zero():
    """A zero-density cell next to the source: the JAX engine divides 0/0
    there (exactly one NaN), the port floors nHI and gives 0; every other
    cell at the parity tolerance."""
    N = 12
    nd = np.full((N,) * 3, 1e-3)
    xh = np.full((N,) * 3, 1e-3)
    nd[6, 6, 7] = 0.0
    src, flux = np.array([[6, 6, 6]]), np.array([5.0])
    got = _port(N, 4.0).trace(nd, xh, src, flux, DR).numpy()
    want = np.array(_jax(N, 4.0).trace(nd, xh, src, flux, DR))
    assert np.argwhere(np.isnan(want)).tolist() == [[6, 6, 7]]
    assert np.all(np.isfinite(got)) and got[6, 6, 7] == 0.0
    want[6, 6, 7] = 0.0
    _close(got, want)


def test_float32_close_to_float64():
    """The JAX test's bounds: median relative error below 1e-4, 99th
    percentile below 1e-2."""
    N = 12
    nd, xh = np.full((N,) * 3, 1e-3), np.full((N,) * 3, 1e-3)
    src, flux = np.array([[6, 6, 6]]), np.array([5.0])
    phi64 = _port(N, 1e9).trace(nd, xh, src, flux, DR).numpy()
    phi32 = _port(N, 1e9, dtype=torch.float32).trace(
        nd, xh, src, flux, DR).numpy()
    assert np.all(np.isfinite(phi32))
    rel = np.abs(phi32 - phi64) / np.maximum(np.abs(phi64), 1e-30)
    assert np.median(rel) < 1e-4
    assert np.percentile(rel, 99) < 1e-2


def test_float32_thick_cell_keeps_the_sweep_column():
    """A very thick cell behind a thin column: its incoming column density
    rebuilt as coldensh_out - nHI path dr (the JAX engine) loses it to one
    float32 ulp of the thick cell's own column, 16% of its Gamma; the
    port keeps the sweep's value and stays at float32's error elsewhere
    (its prefactor S*/dr^3 is evaluated in float32: ~1e-5)."""
    N = 12
    nd, xh = np.full((N,) * 3, 1e-4), np.full((N,) * 3, 1e-3)
    nd[6, 6, 9] = 1e3
    src, flux = np.array([[6, 6, 6]]), np.array([5.0])
    ref = _port(N, 1e9, batch=1).trace(nd, xh, src, flux, DR).numpy()
    port = _port(N, 1e9, dtype=torch.float32, batch=1).trace(
        nd, xh, src, flux, DR).numpy()
    jax32 = np.asarray(_jax(N, 1e9, dtype=jnp.float32, batch=1).trace(
        nd, xh, src, flux, DR))
    cell = (6, 6, 9)
    err_jax = abs(jax32[cell] - ref[cell]) / ref[cell]
    err_port = abs(port[cell] - ref[cell]) / ref[cell]
    assert err_jax > 0.1 and err_port < 2e-5, (err_jax, err_port)
    rated = ref > 1e-12 * ref.max()
    assert np.max(np.abs(port - ref)[rated] / ref[rated]) < 2e-5


def test_evolve3D_box_matches_jax(tmp_path):
    """One evolve3D timestep on the box engine (grey) against the JAX
    evolve3D on the JAX BoxRaytracer: the same iterations, xh and Gamma at
    rtol 1e-8."""
    N, R = 10, 4.0
    rng = np.random.RandomState(11)
    ndens = 10 ** rng.uniform(-3.5, -2.5, (N, N, N))
    temp = np.full((N, N, N), 1e4)
    xh0 = np.full((N, N, N), 1.2e-3)
    src = rng.randint(0, N, (3, 3))
    flux = rng.uniform(1.0, 5.0, 3)
    logs = [str(tmp_path / f"{n}.log") for n in ("jax", "torch")]
    xh_j, phi_j = j_evolve3D(1e13, DR, flux, src, _jax(N, R), JChem(**CHEM),
                             temp, ndens, xh0, logfile=logs[0], quiet=True)
    xh_t, phi_t = evolve3D(1e13, DR, flux, src, _port(N, R),
                           ChemistryParams(**CHEM), temp, ndens, xh0,
                           logfile=logs[1], quiet=True)
    iters = [open(f).read().count("Raytracing took") for f in logs]
    assert iters[0] == iters[1] >= 2
    np.testing.assert_allclose(xh_t, np.asarray(xh_j), rtol=1e-8)
    np.testing.assert_allclose(phi_t, np.asarray(phi_j), rtol=1e-8)
