"""Standalone chemistry API.

Equivalent of the reference's pyc2ray/chemistry.py:43-95 (``hydrogenODE``):
apply the chemistry solver for a single timestep given precomputed
photoionization rates, without raytracing. Useful for testing and notebook
use (reference tutorials/chemistry_solver.ipynb).
"""

import numpy as np
import torch

from .device import resolve_device
from .ops.chemistry import ChemistryParams, global_pass

__all__ = ["hydrogenODE"]


def hydrogenODE(dt, ndens, temp, xh, phi_ion,
                bh00=2.59e-13, albpow=-0.7,
                colh0=1.3e-8 * 0.83 / (13.598 ** 2),
                temph0=13.598 * 1.0 / 8.617e-05,
                abu_c=7.1e-7, max_nonconverged_fraction=0.01,
                device="cuda"):
    """Evolve the ionized fraction over dt with fixed Gamma, in float64 on
    ``device``; returns a numpy array.

    Defaults match the standard C2Ray parameter file values
    (reference chemistry.py:43-95). Asserts that less than
    ``max_nonconverged_fraction`` of the cells failed to converge
    (chemistry.py:91-94).
    """
    p = ChemistryParams(bh00=bh00, albpow=albpow, colh0=colh0,
                        temph0=temph0, abu_c=abu_c)
    dev = resolve_device(device)
    shape = np.asarray(xh).shape

    def grid(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
    xh_d = grid(xh)
    xh_int, _, conv_flag = global_pass(
        torch.tensor(dt, dtype=torch.float64).to(dev), grid(ndens),
        grid(temp), xh_d, xh_d, grid(phi_ion), p)
    frac = float(conv_flag) / np.prod(shape)
    assert frac < max_nonconverged_fraction, (
        f"{frac*100:.2f}% of cells did not converge")
    return xh_int.cpu().numpy()
