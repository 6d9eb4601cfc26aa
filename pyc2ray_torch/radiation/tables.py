"""Optical-depth table grid.

Equivalent of the reference's radiation/common.py:13-37: the tau table has
NumTau+1 points, tau[0] = 0 and tau[1:] log-spaced from 10^minlogtau to
10^(maxlogtau - dlogtau)."""

import numpy as np

__all__ = ["make_tau_table"]


def make_tau_table(minlogtau, maxlogtau, NumTau):
    """Create the optical depth grid for the radiation tables.

    Returns
    -------
    tau : (NumTau+1,) float64 array, tau[0] = 0, rest log-spaced
    dlogtau : float, log10 step
    """
    dlogtau = (maxlogtau - minlogtau) / NumTau
    tau = np.empty(NumTau + 1, dtype=np.float64)
    tau[0] = 0.0
    tau[1:] = 10.0 ** (minlogtau + np.arange(NumTau) * dlogtau)
    return tau, dlogtau
