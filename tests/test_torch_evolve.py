"""One evolve3D timestep (raytrace <-> chemistry to convergence) of the port
against the JAX package's, in float64, with the port running on the JAX
engine's own tables (state_from_jax)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.evolve import evolve3D as j_evolve3D
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer

from pyc2ray_torch.convert import state_from_jax
from pyc2ray_torch.evolve import evolve3D
from pyc2ray_torch.ops.chemistry import ChemistryParams
from pyc2ray_torch.ops.raytrace_box import grey_bins
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


def test_evolve3D_reads_scalars_in_one_transfer(tmp_path, monkeypatch):
    """Each iteration reads its four scalars (conv_flag, the two sums, the
    absorbed rate) back in one transfer, ``_host_scalars``; evolve.py reads
    no other tensor into a Python number but the mean density that the
    adaptive engine's bucketing takes once per timestep."""
    import sys
    import pyc2ray_torch.evolve as ev
    from pyc2ray_torch.ops.adaptive import AdaptiveRaytracer
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
    rt = AdaptiveRaytracer(N, 6.0, SIG, grey_bins(), batch_size=2,
                           dtype=torch.float64, device="cpu")
    one = np.ones((N, N, N))
    log = str(tmp_path / "evolve.log")
    xh, phi = evolve3D(1e13, DR, np.array([1.0, 1e-3]),
                       np.array([[4, 4, 4], [1, 2, 3]]), rt,
                       ChemistryParams(**CHEM), 1e4 * one, 1e-3 * one,
                       1.2e-3 * one, logfile=log, quiet=True)
    n_iter = _iterations(log)
    assert n_iter >= 2 and sizes == [4] * n_iter
    assert direct == [("prepare_for_engine", "__float__")]
    assert xh.max() > 1.2e-3 and phi.max() > 0
    assert "Adaptive radii (Stromgren policy" in open(log).read()
