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
    ee = torch.exp(-deltht)
    xh = (xh_old - eqxh) * ee + eqxh
    xh = torch.clamp(xh, min=EPSILON)

    # (1-ee)/deltht -> 1 for small deltht; guard precision (chemistry.f90:299-306).
    # 1 - ee cancels where deltht is small. The reference computes it in
    # float64; in float32 it keeps only ~6e-8/deltht of relative precision,
    # so a 1-ulp difference of exp between two libraries moved <x> by up
    # to 100% (the card against the CPU), and there -expm1(-deltht), exact
    # to an ulp at every deltht, takes its place.
    if deltht.dtype == torch.float64:
        one_minus_ee = 1.0 - ee
    else:
        one_minus_ee = -torch.expm1(-deltht)
    avg_factor = torch.where(deltht < 1.0e-8, torch.ones_like(deltht),
                             one_minus_ee / deltht)
    xh_av = eqxh + (xh_old - eqxh) * avg_factor
    xh_av = torch.clamp(xh_av, min=EPSILON)
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
