"""Ionization chemistry: analytic single-zone solution + global grid pass.

PyTorch twin of pyc2ray_tpu/ops/chemistry.py, itself the equivalent of the
reference's Fortran chemistry module (src/c2ray/chemistry.f90):

* ``doric`` (chemistry.f90:221-316) is the closed-form solution of the
  hydrogen ionization ODE with constant rates over the timestep:
      x(t)   = (x0 - xeq) exp(-dt*delth) + xeq
      <x>    = xeq + (x0 - xeq) (1 - exp(-dt*delth)) / (dt*delth)
  with ionization rate aih0 = Gamma + ne*A_col(T) and
  delth = aih0 + ne*alpha_B(T)*clumping.

* ``global_pass`` (chemistry.f90:13-110) iterates doric per cell on the
  time-averaged electron density ne = n_H (<x> + abu_c) until <x> converges
  (rel. change < 1e-3), up to 400 iterations, and counts cells whose <x>
  changed significantly since entry (the non-convergence flag used by the
  outer evolve loop).

The whole grid is updated as masked dense tensor operations: converged
cells freeze (their values stop updating), which reproduces the per-cell
iteration semantics exactly. The loop runs on the tensors' device; its
exit test reads one flag per iteration back to the host.
"""

import math
from typing import NamedTuple

import torch

from ..constants import EPSILON

__all__ = ["ChemistryParams", "doric", "global_pass"]

# Convergence constants (chemistry.f90:9-10)
MIN_FRACTIONAL_CHANGE = 1.0e-3
MIN_FRACTION_OF_ATOMS = 1.0e-8
MAX_INNER_ITER = 400


class ChemistryParams(NamedTuple):
    """Scalar chemistry parameters (see c2ray_base.py:329-352)."""
    bh00: float       # case-B recombination coefficient at 1e4 K
    albpow: float     # recombination temperature power-law index
    colh0: float      # collisional ionization coefficient
    temph0: float     # HI ionization energy in K
    abu_c: float      # carbon abundance (electron contribution)
    clumping: float = 1.0


def doric(xh_old, dt, temp, rhe, phi, p: ChemistryParams):
    """Analytic ionization update for one timestep (elementwise).

    Parameters mirror chemistry.f90:221-316. ``rhe`` is the (time-averaged)
    electron density; ``phi`` the photoionization rate Gamma.

    Returns
    -------
    xh : ionized fraction at end of timestep
    xh_av : time-averaged ionized fraction over the timestep
    """
    brech0 = p.clumping * p.bh00 * (temp / 1e4) ** p.albpow
    sqrtt0 = torch.sqrt(temp)
    acolh0 = p.colh0 * sqrtt0 * torch.exp(-p.temph0 / temp)

    aih0 = phi + rhe * acolh0
    delth = aih0 + rhe * brech0
    eqxh = aih0 / delth
    deltht = delth * dt
    if deltht.dtype == torch.float64:
        xh, xh_av = _closed_form_reference(xh_old, eqxh, deltht)
    else:
        xh, xh_av = _closed_form_float32(xh_old, eqxh, deltht)
    return torch.clamp(xh, min=EPSILON), torch.clamp(xh_av, min=EPSILON)


def _closed_form_reference(x0, eqxh, deltht):
    """x(t) and <x> as the reference writes them (chemistry.f90:285-306),
    with its guard: (1 - ee)/deltht -> 1 below deltht = 1e-8."""
    ee = torch.exp(-deltht)
    xh = (x0 - eqxh) * ee + eqxh
    avg_factor = torch.where(deltht < 1.0e-8, torch.ones_like(deltht),
                             (1.0 - ee) / deltht)
    return xh, eqxh + (x0 - eqxh) * avg_factor


# g(z) = 1 - (1 - e^-z)/z = sum_{k>=1} (-1)^(k+1) z^k / (k+1)!; below
# _G_SERIES_BELOW its first ten terms are exact to float32 rounding (the
# eleventh is below 2e-10 of the sum at z = 0.5).
_G_SERIES_BELOW = 0.5
_G_COEFFS = tuple((-1.0) ** (k + 1) / math.factorial(k + 1)
                  for k in range(1, 11))


def _closed_form_float32(x0, eqxh, deltht):
    """The reference's closed form rewritten so that, in float32, each
    result is a sum of two non-negative terms: no cancellation.

    The reference's x(t) = eqxh + (x0 - eqxh) e^-z and <x> = eqxh +
    (x0 - eqxh) (1 - e^-z)/z cancel where x0 << eqxh (an ionizing cell):
    the result is then much smaller than eqxh and keeps only ~6e-8 eqxh/x
    of relative precision, so a one-ulp difference of exp between two
    libraries moved x by 5e-5 at x = 1e-3. Where x0 <= eqxh this writes
        x(t) = x0 + (eqxh - x0) (-expm1(-z)),
        <x>  = x0 + (eqxh - x0) g(z),  g(z) = 1 - (1 - e^-z)/z,
    with g by its series below z = 0.5 (1 - (1 - e^-z)/z cancels there)
    and from -expm1(-z) above; where x0 > eqxh (a recombining cell) the
    reference's form is already a sum of non-negative terms, with
    (1 - e^-z)/z taken as -expm1(-z)/z. The reference's guard stays: below
    z = 1e-8 the average factor is 1 (g = 0), as in float64."""
    one_minus_ee = -torch.expm1(-deltht)
    tiny = deltht < 1.0e-8
    avg_factor = torch.where(tiny, torch.ones_like(deltht),
                             one_minus_ee / deltht)
    g = torch.full_like(deltht, _G_COEFFS[-1])
    for coeff in reversed(_G_COEFFS[:-1]):
        g = coeff + deltht * g
    g = torch.where(deltht < _G_SERIES_BELOW, deltht * g, 1.0 - avg_factor)
    g = torch.where(tiny, torch.zeros_like(g), g)
    d = eqxh - x0
    up = d >= 0
    xh = torch.where(up, x0 + d * one_minus_ee,
                     eqxh - d * torch.exp(-deltht))
    xh_av = torch.where(up, x0 + d * g, eqxh - d * avg_factor)
    return xh, xh_av


def global_pass(dt, ndens, temp, xh, xh_av, phi_ion, p: ChemistryParams,
                mask=None):
    """Chemistry pass over the whole grid (chemistry.f90:13-110).

    All tensor arguments are same-shape (treated elementwise); ``dt`` is a
    float or a 0-dim tensor. ``mask`` (optional bool tensor, same shape)
    excludes cells from the non-convergence count (the dead padding rows
    of a non-divisible domain shard).

    Returns
    -------
    xh_intermed : ionized fraction at end of timestep (x(t), latest iterate)
    xh_av_new : converged time-averaged ionized fraction
    conv_flag : int64 0-dim tensor, count of cells that changed
        significantly since entry
    """
    xh_av_entry = xh_av
    xh_av_cur, xh_int = xh_av, xh
    # the first iteration always runs (Fortran do-loop bottom test)
    active = torch.ones(xh.shape, dtype=torch.bool, device=xh.device)
    nit = 0
    while nit < MAX_INNER_ITER and bool(active.any()):
        de = ndens * (xh_av_cur + p.abu_c)  # chemistry.f90:162
        xh_new, xh_av_new = doric(xh, dt, temp, de, phi_ion, p)
        # per-cell convergence (chemistry.f90:182-189)
        rel = torch.abs((xh_av_new - xh_av_cur) / (1.0 - xh_av_new))
        done = (rel < MIN_FRACTIONAL_CHANGE) | \
            ((1.0 - xh_av_new) < MIN_FRACTION_OF_ATOMS)
        # freeze converged cells: only active cells update
        xh_av_cur = torch.where(active, xh_av_new, xh_av_cur)
        xh_int = torch.where(active, xh_new, xh_int)
        active = active & ~done
        nit += 1

    # global non-convergence count (chemistry.f90:99-104): compare against
    # the value at entry of the pass
    yh_entry = 1.0 - xh_av_entry
    delta = xh_av_cur - xh_av_entry
    not_conv = ((torch.abs(delta) > MIN_FRACTIONAL_CHANGE)
                & (torch.abs(delta / yh_entry) > MIN_FRACTIONAL_CHANGE)
                & (yh_entry > MIN_FRACTION_OF_ATOMS))
    if mask is not None:
        not_conv = not_conv & mask
    return xh_int, xh_av_cur, not_conv.sum()
