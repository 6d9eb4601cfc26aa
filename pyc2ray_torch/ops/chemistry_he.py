"""Coupled hydrogen + helium ionization chemistry — the helium extension.

PyTorch twin of pyc2ray_tpu/ops/chemistry_he.py (helium chemistry is
declared TODO in the reference, README.md:81-87). It extends the C2Ray
chemistry pattern (ops/chemistry.py) to the three-species system

    x   = n_HII / n_H                  (doric's closed form, reused)
    y1  = n_HeII / n_He,  y2 = n_HeIII / n_He

With the rates frozen per iteration the helium pair obeys the linear
system d/dt (y1, y2) = A (y1, y2)^T + b,

    A = [[-(G1 + G2 + R2),  -G1 + R3],
         [ G2,              -R3     ]],      b = (G1, 0)
    G1 = Gamma_HeI + ne C_HeI(T),  G2 = Gamma_HeII + ne C_HeII(T),
    R2 = ne alpha_HeII(T),         R3 = ne alpha_HeIII(T),

solved exactly over the timestep, with its exact time average, by the 2x2
matrix functions of ``_expm2``. The outer iteration updates
ne = n_H (x + abu_c) + n_He (y1 + 2 y2) and re-solves both species until
the time-averaged fractions converge, as ``global_pass`` does; the grid is
updated by masked dense tensor operations, and the loop reads its stop
flag back to the host once per inner iteration.

Rate coefficients: alpha_HeIII(T) = 2 alpha_B(T/4) from the hydrogen
coefficients (bh00, albpow), alpha_HeII a power law (2.72e-13
(T/1e4)^-0.789), collisional ionization the Cen (1992) forms. Opt-in
channels, as in the JAX module (whose docstring states their physics and
scope limits): secondary ionizations by fast photoelectrons
(``global_pass_he(..., heat=)``, Shull & van Steenberg 1985, scaled by the
SED-averaged ramps of radiation.helium.secondary_ramps where configured)
and on-the-spot recycling of helium recombination photons
(``recombination_photons=True``).
"""

import math
from typing import NamedTuple

import torch

from ..constants import EPSILON, hplanck, ev2fr
from ..radiation.helium import HE_EDGES_EV
from .chemistry import (ChemistryParams, doric, MIN_FRACTIONAL_CHANGE,
                        MIN_FRACTION_OF_ATOMS, MAX_INNER_ITER)

__all__ = ["HeChemistryParams", "he_update", "global_pass_he",
           "secondary_ionization_fractions",
           "secondary_heating_fraction", "secondary_enabled",
           "thermal_heat_rate"]

# ionization thresholds in erg (E = h nu_th)
_ETH_ERG = tuple(hplanck * ev2fr * e for e in HE_EDGES_EV)


def secondary_ionization_fractions(x):
    """Shull & van Steenberg (1985) energy fractions of a fast
    photoelectron going into collisional ionization of HI and HeI at
    hydrogen ionized fraction x: f = C (1 - x^a)^b with (C, a, b) =
    (0.3908, 0.4092, 1.7592) for HI and (0.0554, 0.4614, 1.6660) for HeI.
    Returns (f_HI, f_HeI)."""
    xc = torch.clamp(x, 0.0, 1.0)
    f_hi = 0.3908 * (1.0 - xc ** 0.4092) ** 1.7592
    f_hei = 0.0554 * (1.0 - xc ** 0.4614) ** 1.6660
    return f_hi, f_hei


def secondary_heating_fraction(x):
    """Shull & van Steenberg (1985) heat fraction 0.9971
    (1 - (1 - x^0.2663)^1.3163): the share of the heat channel left to the
    thermal update when secondary ionizations are on."""
    xc = torch.clamp(x, 0.0, 1.0)
    return 0.9971 * (1.0 - (1.0 - xc ** 0.2663) ** 1.3163)


def secondary_enabled(phe, do_heating):
    """True iff secondary ionizations are configured; raises if they are
    configured without the heat channel that carries the energy being
    redistributed."""
    sec = bool(getattr(phe, "secondary", False))
    if sec and not do_heating:
        raise ValueError(
            "secondary ionizations require HeRaytracer(do_heating=True) "
            "(Photo.compute_heating_rates: the heat channel carries the "
            "photoelectron energy being redistributed)")
    return sec


def thermal_heat_rate(phe, heat, xh_av, secondary):
    """The heat rate the thermal update consumes: the raytracer's channel,
    scaled by f_heat(x) when the chemistry consumed f_ion of the same
    deposition (an energy split, not a double count)."""
    if not secondary:
        return heat
    return heat * secondary_heating_fraction(xh_av)


class HeChemistryParams(NamedTuple):
    """Helium chemistry parameters (the JAX module's, same defaults)."""
    chem: ChemistryParams          # hydrogen coefficients (doric)
    abu_he: float                  # n_He / n_H
    bhe00: float = 2.72e-13        # alpha_HeII at 1e4 K
    alhepow: float = -0.789        # its T power law
    colhe0: float = 2.38e-11       # C_HeI prefactor (Cen 1992)
    temphe0: float = 285335.4      # HeI ionization energy / k_B
    colhe1: float = 5.68e-12       # C_HeII prefactor (Cen 1992)
    temphe1: float = 631515.0      # HeII ionization energy / k_B
    # secondary ionizations (host-level flag: the evolve loop passes the
    # heat channel to global_pass_he when it is set)
    secondary: bool = False
    # on-the-spot recycling of He recombination photons (host-level flag,
    # forwarded as global_pass_he's recombination_photons)
    recombination_photons: bool = False
    # (sigma_HI, sigma_HeI) at the HeI edge (24.59 eV) and at HeII
    # Ly-alpha (40.8 eV), for the recycling's absorption-competition
    # fractions; models/base.py takes them from the configured
    # cross-section model
    sig_h_he1: float = 1.2e-18     # sigma_HI(24.59 eV)
    sig_he1_he1: float = 7.43e-18  # sigma_HeI(24.59 eV)
    sig_h_lya2: float = 2.9e-19    # sigma_HI(40.8 eV)
    sig_he1_lya2: float = 2.95e-18  # sigma_HeI(40.8 eV)
    # SED-averaged ramps in [0, 1] on the SvS f_ion fractions
    # (Photo.secondary_ramp); 1.0 = plain band-wide SvS
    sec_ramp_hi: float = 1.0
    sec_ramp_hei: float = 1.0


def _expm2(A11, A12, A21, A22, b1, b2, u1, u2, dt):
    """Exact solution and time average of du/dt = A u + b over dt for a
    batch of 2x2 systems with real eigenvalues, without inverting A:

        u(t) = exp(At) u0 + t phi1(At) b,   <u> = phi1(At) u0 + t phi2(At) b

    with phi1(z) = (e^z - 1)/z and phi2(z) = (e^z - 1 - z)/z^2 (by their
    series for small z). Each matrix function f(At) is evaluated in
    divided-difference form f(l2 t) I + [f(l1 t) - f(l2 t)]/(l1 - l2)
    (At - l2 t I); the eigenvalue separation is floored at sqrt(eps) of
    the matrix's scale, eps of the dtype. Returns (u1(dt), u2(dt), <u1>,
    <u2>)."""
    dtype = torch.result_type(A11, u1)
    eps = torch.finfo(dtype).eps
    tr = A11 + A22
    det = A11 * A22 - A12 * A21
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    # floor the separation so divided differences stay well-conditioned
    scale = (torch.abs(tr) + torch.abs(A12) + torch.abs(A21)
             + (1e-30 if dtype == torch.float32 else 1e-290))
    disc = torch.maximum(disc, math.sqrt(eps) * scale)
    # the compartmental system is dissipative: eigenvalues <= 0; the floor
    # can push l1 marginally positive, so clamp it
    l1 = torch.clamp(0.5 * (tr + disc), max=0.0)
    l2 = 0.5 * (tr - disc)

    def phi1(z):
        small = torch.abs(z) < 1e-6
        zs = torch.where(small, torch.ones_like(z), z)
        return torch.where(small, 1.0 + 0.5 * z + z * z / 6.0,
                           torch.expm1(zs) / zs)

    def phi2(z):
        small = torch.abs(z) < 1e-4
        zs = torch.where(small, torch.ones_like(z), z)
        return torch.where(small, 0.5 + z / 6.0 + z * z / 24.0,
                           (torch.expm1(zs) - zs) / (zs * zs))

    z1 = l1 * dt
    z2 = l2 * dt
    inv_sep = 1.0 / ((l1 - l2) * dt)

    def apply_f(f1v, f2v, v1, v2):
        """f(At) v by f(z2) I + [f(z1) - f(z2)]/(z1 - z2) (At - z2 I)."""
        dd = (f1v - f2v) * inv_sep
        w1 = (A11 * dt - z2) * v1 + A12 * dt * v2
        w2 = A21 * dt * v1 + (A22 * dt - z2) * v2
        return f2v * v1 + dd * w1, f2v * v2 + dd * w2

    e1v, e2v = torch.exp(z1), torch.exp(z2)
    p1v, p2v = phi1(z1), phi1(z2)
    q1v, q2v = phi2(z1), phi2(z2)

    eu1, eu2 = apply_f(e1v, e2v, u1, u2)
    pb1, pb2 = apply_f(p1v, p2v, b1, b2)
    ut1 = eu1 + dt * pb1
    ut2 = eu2 + dt * pb2

    pu1, pu2 = apply_f(p1v, p2v, u1, u2)
    qb1, qb2 = apply_f(q1v, q2v, b1, b2)
    ua1 = pu1 + dt * qb1
    ua2 = pu2 + dt * qb2
    return ut1, ut2, ua1, ua2


def _clamp_pair(y1, y2):
    """y1 into [EPSILON, 1], y2 into [0, 1], and the pair scaled to a sum
    of at most 1 - EPSILON where it exceeds 1."""
    y1 = torch.clamp(y1, EPSILON, 1.0)
    y2 = torch.clamp(y2, 0.0, 1.0)
    tot = y1 + y2
    over = tot > 1.0
    scale = torch.where(over, (1.0 - EPSILON)
                        / torch.where(over, tot, torch.ones_like(tot)),
                        torch.ones_like(tot))
    return y1 * scale, y2 * scale


def he_update(y1, y2, dt, temp, ne, g_he1, g_he2, p: HeChemistryParams):
    """One frozen-rate helium update: returns (y1_t, y2_t, y1_av, y2_av)."""
    sq = torch.sqrt(temp)
    damp = 1.0 / (1.0 + torch.sqrt(temp / 1.0e5))      # Cen 1992 damping
    c1 = p.colhe0 * sq * torch.exp(-p.temphe0 / temp) * damp
    c2 = p.colhe1 * sq * torch.exp(-p.temphe1 / temp) * damp
    a2 = p.bhe00 * (temp / 1.0e4) ** p.alhepow
    # hydrogenic scaling for HeIII -> HeII case-B recombination
    a3 = 2.0 * p.chem.bh00 * (temp / 4.0e4) ** p.chem.albpow
    a3 = a3 * p.chem.clumping
    a2 = a2 * p.chem.clumping

    G1 = g_he1 + ne * c1
    G2 = g_he2 + ne * c2
    R2 = ne * a2
    R3 = ne * a3

    A11 = -(G1 + G2 + R2)
    A12 = -G1 + R3
    A21 = G2
    A22 = -R3
    # In float32 the divided differences keep ~sqrt(eps) of relative
    # precision beside y1, which is percents of a y2 << y1: such a cell's
    # <y2> moved by more than the 1e-3 convergence test between iterations
    # and ran global_pass_he to its 400-iteration cap. The 2x2 solve runs
    # in float64 there (the rates stay in float32); float64 is unchanged.
    dtype = torch.result_type(y1, temp)
    wide = torch.float64 if dtype == torch.float32 else dtype
    out = _expm2(*(t.to(wide) for t in (A11, A12, A21, A22, G1)),
                 torch.zeros_like(G1, dtype=wide), y1.to(wide), y2.to(wide),
                 torch.as_tensor(dt, dtype=wide))
    y1t, y2t, y1a, y2a = (t.to(dtype) for t in out)
    y1t, y2t = _clamp_pair(y1t, y2t)
    y1a, y2a = _clamp_pair(y1a, y2a)
    return y1t, y2t, y1a, y2a


def global_pass_he(dt, ndens, temp, xh, xh_av, y1, y1_av, y2, y2_av,
                   phi_h, phi_he1, phi_he2, p: HeChemistryParams,
                   mask=None, heat=None, recombination_photons=False):
    """Coupled H+He chemistry pass (elementwise over same-shape tensors).

    ndens is the hydrogen number density; n_He = abu_he * ndens.
    ``mask`` (optional bool tensor) excludes cells from the
    non-convergence count. ``heat`` (optional): the raytracer's per-HI-atom
    photoelectron energy deposition rate (erg/s); passing it turns on
    secondary ionizations at the iterated time-averaged x, and the caller
    then scales its thermal use of the channel by
    secondary_heating_fraction. ``recombination_photons``: on-the-spot
    recycling of the case-B HeII/HeIII recombination photons into HI/HeI
    ionizations by local absorption competition, at the current iterated
    state (photon conserving; dropped where both absorbers vanish).

    Returns (xh_t, xh_av, y1_t, y1_av, y2_t, y2_av, conv_flag)."""
    chem = p.chem
    nhe = p.abu_he * ndens
    xh_av_entry = xh_av
    # the floor of the divisions (the JAX module's values)
    tiny = 1e-30 if torch.result_type(xh, temp) == torch.float32 else 1e-280
    if heat is not None:
        # volumetric deposition / n_HeI, outside the loop; zero where there
        # is no HeI, and the per-atom rate capped at 1e12/s (rate*dt
        # saturates long before; an uncapped ratio overflows tr^2 in the
        # 2x2 eigensolve)
        nhi = ndens * (1.0 - xh_av_entry)
        nhei = nhe * (1.0 - y1_av - y2_av)
        dep_over_nhei = torch.where(
            nhei > tiny, heat * nhi / torch.clamp(nhei, min=tiny),
            torch.zeros_like(heat))
        dep_over_nhei = torch.clamp(dep_over_nhei, max=1e12 * _ETH_ERG[1])

    xav, xint = xh_av, xh
    y1av, y1int, y2av, y2int = y1_av, y1, y2_av, y2
    # the first iteration always runs
    active = torch.ones(xh.shape, dtype=torch.bool, device=xh.device)
    nit = 0
    while nit < MAX_INNER_ITER and bool(active.any()):
        ne = ndens * (xav + chem.abu_c) + nhe * (y1av + 2.0 * y2av)
        ph, phe1 = phi_h, phi_he1
        if heat is not None:
            f_hi, f_hei = secondary_ionization_fractions(xav)
            ph = phi_h + p.sec_ramp_hi * f_hi * heat / _ETH_ERG[0]
            phe1 = phi_he1 + p.sec_ramp_hei * f_hei \
                * dep_over_nhei / _ETH_ERG[1]
        if recombination_photons:
            nhi_c = ndens * (1.0 - xav)
            nhei_c = nhe * (1.0 - y1av - y2av)
            a2 = p.bhe00 * (temp / 1.0e4) ** p.alhepow * chem.clumping
            a3 = 2.0 * chem.bh00 * (temp / 4.0e4) ** chem.albpow \
                * chem.clumping
            rec2 = ne * a2 * nhe * y1av       # HeII -> HeI photons/vol
            rec3 = ne * a3 * nhe * y2av       # HeIII -> HeII photons/vol
            wh = nhi_c * p.sig_h_he1
            whe = nhei_c * p.sig_he1_he1
            y_f = wh / torch.clamp(wh + whe, min=tiny)
            wh2 = nhi_c * p.sig_h_lya2
            whe2 = nhei_c * p.sig_he1_lya2
            z_f = wh2 / torch.clamp(wh2 + whe2, min=tiny)
            # per-atom rates, capped like the secondary channel
            add_h = (y_f * rec2 + z_f * rec3) / torch.clamp(nhi_c, min=tiny)
            add_he = ((1.0 - y_f) * rec2 + (1.0 - z_f) * rec3) \
                / torch.clamp(nhei_c, min=tiny)
            zero = torch.zeros_like(add_h)
            ph = ph + torch.clamp(torch.where(nhi_c > tiny, add_h, zero),
                                  max=1e12)
            phe1 = phe1 + torch.clamp(
                torch.where(nhei_c > tiny, add_he, zero), max=1e12)
        xh_new, xh_av_new = doric(xh, dt, temp, ne, ph, chem)
        y1t, y2t, y1a, y2a = he_update(y1, y2, dt, temp, ne,
                                       phe1, phi_he2, p)
        relx = torch.abs((xh_av_new - xav) / (1.0 - xh_av_new))
        rel1 = torch.abs(y1a - y1av) / torch.clamp(y1a, min=1e-10)
        rel2 = torch.abs(y2a - y2av) / torch.clamp(y2a, min=1e-10)
        done = (relx < MIN_FRACTIONAL_CHANGE) | \
            ((1.0 - xh_av_new) < MIN_FRACTION_OF_ATOMS)
        # with no helium the He fractions do not gate the iteration (the
        # exact reduction to the hydrogen-only global_pass)
        if p.abu_he > 0.0:
            done = done & (rel1 < MIN_FRACTIONAL_CHANGE) \
                & (rel2 < MIN_FRACTIONAL_CHANGE)
        xav = torch.where(active, xh_av_new, xav)
        xint = torch.where(active, xh_new, xint)
        y1av = torch.where(active, y1a, y1av)
        y1int = torch.where(active, y1t, y1int)
        y2av = torch.where(active, y2a, y2av)
        y2int = torch.where(active, y2t, y2int)
        active = active & ~done
        nit += 1

    yh_entry = 1.0 - xh_av_entry
    delta = xav - xh_av_entry
    not_conv = ((torch.abs(delta) > MIN_FRACTIONAL_CHANGE)
                & (torch.abs(delta / yh_entry) > MIN_FRACTIONAL_CHANGE)
                & (yh_entry > MIN_FRACTION_OF_ATOMS))
    if mask is not None:
        not_conv = not_conv & mask
    return xint, xav, y1int, y1av, y2int, y2av, not_conv.sum()
