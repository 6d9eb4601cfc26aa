"""One evolve3D timestep (raytrace <-> chemistry to convergence) of the port
against the JAX package's, in float64, with the port running on the JAX
engine's own tables (state_from_jax)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.evolve import evolve3D as j_evolve3D
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.raytrace_box import grey_bins
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer

from pyc2ray_torch.convert import state_from_jax
from pyc2ray_torch.evolve import evolve3D
from pyc2ray_torch.ops.chemistry import ChemistryParams
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.ops.thermal import ThermalParams

SIG = 6.30e-18
DR = 6.7e20
CHEM = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598**2,
            temph0=13.598 / 8.617e-05, abu_c=7.1e-7)


def _iterations(log):
    with open(log) as f:
        return sum(line.startswith("Raytracing took") for line in f)


def test_evolve3D_matches_jax(tmp_path):
    N, R = 12, 5.0
    rng = np.random.RandomState(11)
    ndens = 10 ** rng.uniform(-3.5, -2.5, (N, N, N))
    temp = np.full((N, N, N), 1e4)
    xh0 = np.full((N, N, N), 1.2e-3)
    src = rng.randint(0, N, (3, 3))
    flux = rng.uniform(1.0, 5.0, 3)
    dt = 1e13
    bins = grey_bins()

    jr = JRaytracer(N, R, SIG, bins, batch_size=2, dtype=jnp.float64,
                    use_pallas=True, accumulate="scan")
    jlog = str(tmp_path / "jax.log")
    xh_j, phi_j = j_evolve3D(dt, DR, flux, src, jr, JChem(**CHEM), temp,
                             ndens, xh0, logfile=jlog, quiet=True)

    tables, tbins, chem = state_from_jax(
        {k: np.asarray(v) for k, v in jr.tables._asdict().items()},
        bins._asdict(), CHEM)
    tr = ChebRaytracer(N, R, SIG, tbins, batch_size=2, dtype=torch.float64,
                       device="cpu")
    tr.tables = tables.to(tr.device, tr.dtype)
    tlog = str(tmp_path / "torch.log")
    xh_t, phi_t = evolve3D(dt, DR, flux, src, tr, chem, temp, ndens, xh0,
                           logfile=tlog, quiet=True)

    assert _iterations(tlog) == _iterations(jlog) >= 2
    assert xh_t.shape == (N, N, N) and np.all(np.isfinite(xh_t))
    np.testing.assert_allclose(xh_t, np.asarray(xh_j), rtol=1e-8)
    np.testing.assert_allclose(phi_t, np.asarray(phi_j), rtol=1e-8)


def test_evolve3D_thermal_not_ported():
    """``thermal`` is ported (it raised NotImplementedError before): with
    a do_heating raytracer evolve3D returns (xh, phi, temp); what is left
    of the refusal is the ValueError without do_heating."""
    thermal, chem = ThermalParams(**CHEM), ChemistryParams(**CHEM)
    one = np.ones((8, 8, 8))
    args = (1e13, DR, np.ones(1), np.array([[4, 4, 4]]))
    grids = (100.0 * one, 1e-3 * one, 1.2e-3 * one)
    tr = ChebRaytracer(8, 3.0, SIG, grey_bins(), batch_size=2,
                       dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="do_heating=True"):
        evolve3D(*args, tr, chem, *grids, quiet=True, thermal=thermal)
    tr = ChebRaytracer(8, 3.0, SIG, grey_bins(), batch_size=2,
                       dtype=torch.float64, device="cpu", do_heating=True)
    xh, phi, temp = evolve3D(*args, tr, chem, *grids, quiet=True,
                             thermal=thermal, zred=9.0)
    assert temp.shape == (8, 8, 8) and np.all(np.isfinite(temp))
    assert xh.max() > 1.2e-3 and phi.max() > 0
