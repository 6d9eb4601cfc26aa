"""Multi-species (H + He) spectral bins — the helium extension.

Numpy copy of pyc2ray_tpu/radiation/helium.py (held bit-equal to it in
tests/test_torch_helium.py).

Helium radiative transfer is declared TODO in the reference
(README.md:81-87: "multi-frequency", "helium"); the reference's surface
is hydrogen-only with a single band. The spectral-bin formulation
(spectral_bins.py) generalizes naturally: the band [nu_HI, 10 nu_HeII]
splits at the HeI (24.587 eV) and HeII (54.416 eV) ionization edges
into three sub-bands, each discretized with Gauss-Legendre nodes, and
every node carries the cross sections of ALL species present at that
frequency. Per cell and bin e the composite optical depth is

    tau_e = N_HI sig_HI(nu_e) + N_HeI sig_HeI(nu_e) + N_HeII sig_HeII(nu_e)

and the photons absorbed in a cell are shared between species by their
opacity fraction dtau_s/dtau (the standard photon-conserving
multi-species treatment, e.g. Friedrich et al. 2012 for C2Ray-He).

Cross sections use the same power-law family the reference applies to
hydrogen (sigma(nu) = sigma_th (nu/nu_th)^-pl, blackbody.py:46-50,
parameters.yml cross_section_pl_index), with species thresholds and
slopes configurable; defaults are threshold values sigma_th(HI, HeI,
HeII) = (6.30e-18, 7.42e-18, 1.58e-18) cm^2 and slopes (2.8, 1.7, 2.8)
— the HeI slope is shallower near threshold. The Verner, Ferland,
Korista & Yakovlev (1996, ApJ 465, 487) analytic fits are available as
``cross_section_model="verner"`` (verner_cross_section below) — only
the bin construction changes; every consumer (sweep weights, rate
einsums) sees the same (s, sigma_th) contract.
"""

from typing import NamedTuple

import numpy as np

from ..constants import hplanck, ev2fr, S_STAR_REF

__all__ = ["HE_EDGES_EV", "SIGMA_TH", "HeSpectralBins",
           "make_spectral_bins_he", "secondary_ramps", "cross_section",
           "verner_cross_section"]

# ionization thresholds (eV) and threshold cross sections (cm^2)
HE_EDGES_EV = (13.598, 24.587, 54.416)
SIGMA_TH = (6.30e-18, 7.42e-18, 1.58e-18)
DEFAULT_PL = (2.8, 1.7, 2.8)

# Verner et al. (1996) Table 1 fit parameters for the ground states of
# H I, He I, He II: (E_0 [eV], sigma_0 [Mb], y_a, P, y_w, y_0, y_1).
# The fit: x = E/E_0 - y_0, y = sqrt(x^2 + y_1^2),
#   sigma = sigma_0 [(x-1)^2 + y_w^2] y^(P/2 - 5.5) (1 + sqrt(y/y_a))^-P
# Threshold values recovered: 6.35, 7.42, 1.59 Mb (vs the power-law
# family's 6.30/7.42/1.58 anchors).
VERNER_PARAMS = (
    (4.298e-1, 5.475e4, 3.288e1, 2.963, 0.0, 0.0, 0.0),        # H I
    (1.361e1, 9.492e2, 1.469, 3.188, 2.039, 4.434e-1, 2.136),  # He I
    (1.720, 1.369e4, 3.288e1, 2.963, 0.0, 0.0, 0.0),           # He II
)


def cross_section(nu, species, pl=None):
    """sigma_s(nu) in cm^2 (0 below threshold)."""
    pl = DEFAULT_PL[species] if pl is None else pl
    nu_th = ev2fr * HE_EDGES_EV[species]
    nu = np.asarray(nu, dtype=np.float64)
    return np.where(nu >= nu_th,
                    SIGMA_TH[species] * (nu / nu_th) ** (-pl), 0.0)


def verner_cross_section(nu, species):
    """Verner et al. (1996) analytic fit, sigma_s(nu) in cm^2.

    Valid over the full band used here (threshold to ~544 eV; the fits
    hold to E_max = 5e4 eV). Zero below the species threshold."""
    E0, sig0, ya, P, yw, y0, y1 = VERNER_PARAMS[species]
    nu = np.asarray(nu, dtype=np.float64)
    E = nu / ev2fr                     # eV
    x = E / E0 - y0
    y = np.sqrt(x * x + y1 * y1)
    F = (((x - 1.0) ** 2 + yw * yw)
         * np.power(y, 0.5 * P - 5.5)
         * np.power(1.0 + np.sqrt(y / ya), -P))
    return np.where(E >= HE_EDGES_EV[species], sig0 * 1e-18 * F, 0.0)


class HeSpectralBins(NamedTuple):
    """(E,) arrays over all bins of the three sub-bands."""
    s: np.ndarray          # (3, E) sigma_s(nu_e)/sigma_th_s  (0 below edge)
    w_photo: np.ndarray    # (E,) photon weights / S_star
    w_heat: np.ndarray     # (3, E) heating weights (erg)/S_star per species
    num_bins: int
    sigma_th: tuple        # (3,) threshold cross sections (cm^2)
    nu: np.ndarray = None  # (E,) bin frequencies (Hz); None in dummies


def secondary_ramps(bins: HeSpectralBins, abu_he):
    """SED-averaged energy ramps for the secondary-ionization channel.

    The Shull & van Steenberg (1985) fractions are asymptotic (valid
    for photoelectrons >~ 100 eV); applied band-wide they overestimate
    secondary ionization for soft SEDs whose photoelectrons carry only
    a few eV (ops/chemistry_he.py scope limit #2). This computes, per
    TARGET species i in (HI, HeI), the deposition-weighted average of
    the threshold ramp

        r_i(E_e) = max(0, 1 - E_th,i / E_e)

    over the source spectrum's photoelectron energies E_e = h(nu -
    nu_th,s) of each absorbing species s, weighted by the neutral
    primordial absorption shares n_s sigma_s(nu) (n = (1, abu_he, 0))
    times the heating weights. r_i is the energy-conservation
    interpolation — exactly zero below the target's ionization
    threshold (such an electron CANNOT ionize), monotone, -> 1
    asymptotically where the SvS fits were calibrated; the Ricotti,
    Gnedin & Shull (2002) fitted ramps are the refinement of the same
    limit. Evaluated on the UNATTENUATED spectrum: with depth the
    spectrum hardens, so the true per-cell factor lies in
    [ramp_i, 1] — the average is conservative at depth.

    Returns (ramp_HI, ramp_HeI) floats in [0, 1]."""
    if bins.nu is None:
        raise ValueError("bins carry no frequencies (nu=None)")
    edges_nu = np.array([ev2fr * e for e in HE_EDGES_EV])
    eth_erg = hplanck * edges_nu
    n0 = np.array([1.0, float(abu_he), 0.0])
    # absorption share of species s at each bin
    sig = bins.s * np.asarray(bins.sigma_th)[:, None]     # (3, E)
    share = n0[:, None] * sig
    share = share / np.maximum(share.sum(0, keepdims=True), 1e-300)
    e_e = hplanck * np.maximum(bins.nu[None, :] - edges_nu[:, None],
                               0.0)                       # (3, E)
    w = share * bins.w_heat                               # (3, E)
    out = []
    for i in range(2):
        r = np.where(e_e > eth_erg[i], 1.0 - eth_erg[i]
                     / np.maximum(e_e, 1e-300), 0.0)
        tot = w.sum()
        out.append(float((w * r).sum() / tot) if tot > 0 else 1.0)
    return tuple(out)


def make_spectral_bins_he(source, S_star_ref=S_STAR_REF,
                          panels_per_band=3, nodes=8, pl=DEFAULT_PL,
                          freq_max=None, cross_section_model="powerlaw"):
    """Three-band multi-species bins for a normalized source.

    ``source`` follows radiation.BlackBodySource's interface; its SED is
    normalized so the FULL band [nu_HI, freq_max] integrates to
    S_star_ref photons/s (same convention as the H-only bins).
    ``cross_section_model``: "powerlaw" (the reference's family) or
    "verner" (Verner et al. 1996 fits). sigma_th is always taken at the
    species threshold of the chosen model so s = sigma/sigma_th stays
    normalized for the sweep weights."""
    edges_nu = [ev2fr * e for e in HE_EDGES_EV]
    if freq_max is None:
        freq_max = 10 * edges_nu[2]
    source.normalize_SED(edges_nu[0], freq_max, S_star_ref)
    xg, wg = np.polynomial.legendre.leggauss(nodes)

    nu, W = [], []
    band_edges = edges_nu + [freq_max]
    for b in range(3):
        lo, hi = np.log(band_edges[b]), np.log(band_edges[b + 1])
        sub = np.linspace(lo, hi, panels_per_band + 1)
        for p in range(panels_per_band):
            a, c = sub[p], sub[p + 1]
            xm = 0.5 * (a + c) + 0.5 * (c - a) * xg
            nu_p = np.exp(xm)
            nu.append(nu_p)
            W.append(0.5 * (c - a) * wg * nu_p)
    nu = np.concatenate(nu)
    W = np.concatenate(W)

    sed = np.array([source.SED(f) for f in nu])
    w_photo = W * sed / S_star_ref
    s = np.zeros((3, nu.shape[0]))
    w_heat = np.zeros((3, nu.shape[0]))
    if cross_section_model == "powerlaw":
        sigma_fn = lambda f, sp: cross_section(f, sp, pl[sp])
        sigma_th = SIGMA_TH
    elif cross_section_model == "verner":
        sigma_fn = verner_cross_section
        sigma_th = tuple(float(verner_cross_section(
            ev2fr * HE_EDGES_EV[sp] * (1 + 1e-12), sp)) for sp in range(3))
    else:
        raise ValueError(
            f"unknown cross_section_model {cross_section_model!r} "
            f"(valid: powerlaw, verner)")
    for sp in range(3):
        sig = sigma_fn(nu, sp)
        s[sp] = sig / sigma_th[sp]
        w_heat[sp] = w_photo * hplanck * np.maximum(
            nu - edges_nu[sp], 0.0)
    return HeSpectralBins(s=s, w_photo=w_photo, w_heat=w_heat,
                          num_bins=nu.shape[0], sigma_th=sigma_th, nu=nu)
