"""Spectral-bin (exponential-sum) representation of the radiation tables.

The reference computes photoionization rates from precalculated tables of
the band integrals

    L_thick(tau) = int SED(nu) exp(-tau s(nu)) dnu,
    L_thin(tau)  = int SED(nu) s(nu) exp(-tau s(nu)) dnu,

with s(nu) = sigma(nu)/sigma0, via log-linear interpolation per cell
(photorates.f90:130-147). Table lookups are a poor fit for dense vector
units; instead we discretize the band integral itself with Gauss-Legendre
panels in log(nu):

    L_thick(tau) ~= sum_e w_e exp(-tau s_e),      w_e = W_e SED(nu_e)
    L_thin(tau)  =  sum_e w_e s_e exp(-tau s_e)   (same nodes!)

This is exactly the multi-frequency sub-bin treatment of C2Ray
generalized: each quadrature node is a frequency bin with its own grey
optical depth. Rates become pure element-wise math. Two bonus properties:

* The thin/thick switch (photorates.f90:114-125), which exists only to
  dodge catastrophic cancellation in L(tau_in)-L(tau_out), is
  unnecessary: per bin,
      exp(-ti s) - exp(-to s) = exp(-ti s) * (-expm1(-dtau s))
  is cancellation-free even in float32.
* Photo and heating rates share the same exponentials
  (w_heat_e = w_e * h (nu_e - nu0)).

Weights are stored normalized by S_star so they are O(1) in float32.
"""

from typing import NamedTuple

import numpy as np

from ..constants import hplanck, S_STAR_REF

__all__ = ["SpectralBins", "make_spectral_bins"]


class SpectralBins(NamedTuple):
    s: np.ndarray         # (E,) cross sections / sigma0
    w_photo: np.ndarray   # (E,) photon-rate weights, normalized by S_star
    w_heat: np.ndarray    # (E,) heating weights (erg) normalized by S_star
    num_bins: int


def make_spectral_bins(source, freq_min, freq_max, S_star_ref=S_STAR_REF,
                       panels=8, nodes=8):
    """Build spectral bins for a radiation source.

    Parameters
    ----------
    source : an object with SED(nu), cross_section_freq_dependence(nu) and
        normalize_SED (e.g. radiation.BlackBodySource). The SED must
        already be normalized (or normalize here) so the band integral is
        S_star_ref photons/s.
    panels, nodes : Gauss-Legendre panels in log(nu) and nodes per panel.
        E = panels * nodes total bins. 8x8 gives ~1e-6 relative accuracy
        on L_thick over tau in [0, 1e4] for a 5e4 K black body.
    """
    source.normalize_SED(freq_min, freq_max, S_star_ref)
    x_lo, x_hi = np.log(freq_min), np.log(freq_max)
    edges = np.linspace(x_lo, x_hi, panels + 1)
    xg, wg = np.polynomial.legendre.leggauss(nodes)

    nu, W = [], []
    for p in range(panels):
        a, b = edges[p], edges[p + 1]
        xm = 0.5 * (a + b) + 0.5 * (b - a) * xg
        nu_p = np.exp(xm)
        # d nu = nu d(log nu)
        W_p = 0.5 * (b - a) * wg * nu_p
        nu.append(nu_p)
        W.append(W_p)
    nu = np.concatenate(nu)
    W = np.concatenate(W)

    sed = np.array([source.SED(f) for f in nu])
    s = np.asarray(source.cross_section_freq_dependence(nu), dtype=np.float64)
    s = np.broadcast_to(s, nu.shape).astype(np.float64)
    w_photo = W * sed / S_star_ref
    from ..constants import ion_freq_HI
    w_heat = w_photo * hplanck * (nu - ion_freq_HI)
    return SpectralBins(s=s, w_photo=w_photo, w_heat=w_heat,
                        num_bins=nu.shape[0])


def bins_thick(bins: SpectralBins, tau):
    """L_thick(tau)/S_star via the bin sum (numpy, for validation)."""
    tau = np.asarray(tau)[..., None]
    return (bins.w_photo * np.exp(-tau * bins.s)).sum(-1)


def bins_thin(bins: SpectralBins, tau):
    tau = np.asarray(tau)[..., None]
    return (bins.w_photo * bins.s * np.exp(-tau * bins.s)).sum(-1)
