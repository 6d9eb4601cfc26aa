"""Black-body radiation source and photoionization/heating table integration.

Equivalent of the reference's radiation/blackbody.py (BlackBodySource,
make_photo_table/make_heat_table at blackbody.py:20-85). The physics:

* SED(nu) = 4 pi R*^2 * (2 pi / c^2) nu^2 / (exp(h nu / k T) - 1), normalized
  so the band-integrated ionizing photon rate equals S_star_ref (1e48/s).
* sigma(nu) = sigma0 * (nu/nu0)^(-pl_index) (or grey).
* thick table:  integral SED(nu) exp(-tau sigma(nu)/sigma0) dnu
* thin table:   integral SED(nu) (sigma(nu)/sigma0) exp(-tau sigma(nu)/sigma0) dnu
* heating variants carry an extra h (nu - nu_HI) factor.

Integration uses scipy quad_vec over the whole tau table at once, as the
reference does (epsrel 1e-12). Tables are built once at init time on the host;
this is not a hot path.
"""

import numpy as np
from scipy.integrate import quad, quad_vec

from ..constants import h_over_k, two_pi_over_c_square, hplanck, ion_freq_HI

__all__ = ["BlackBodySource"]

_EXP_OVERFLOW = 700.0


class BlackBodySource:
    """A point source emitting a black-body spectrum.

    Parameters
    ----------
    temp : float
        Effective temperature in K.
    grey : bool
        If true, the cross section is frequency independent.
    freq0 : float
        Ionization threshold frequency nu0 (Hz).
    pl_index : float
        Power-law index of the cross-section frequency dependence.
    """

    def __init__(self, temp, grey, freq0, pl_index):
        self.temp = float(temp)
        self.grey = bool(grey)
        self.freq0 = float(freq0)
        self.pl_index = float(pl_index)
        self.R_star = 1.0

    # -- spectrum ------------------------------------------------------
    def SED(self, freq):
        """Photon-number SED (photons / s / Hz) before normalization."""
        x = freq * h_over_k / self.temp
        if np.isscalar(x):
            if x >= _EXP_OVERFLOW:
                return 0.0
            return (4.0 * np.pi * self.R_star**2 * two_pi_over_c_square
                    * freq**2 / (np.exp(x) - 1.0))
        x = np.asarray(x)
        safe = np.where(x < _EXP_OVERFLOW, x, 1.0)
        sed = (4.0 * np.pi * self.R_star**2 * two_pi_over_c_square
               * np.asarray(freq)**2 / (np.exp(safe) - 1.0))
        return np.where(x < _EXP_OVERFLOW, sed, 0.0)

    def integrate_SED(self, f1, f2):
        return quad(self.SED, f1, f2)[0]

    def normalize_SED(self, f1, f2, S_star_ref):
        """Scale R_star so the band [f1,f2] emits S_star_ref photons/s."""
        S_unscaled = self.integrate_SED(f1, f2)
        self.R_star = np.sqrt(S_star_ref / S_unscaled) * self.R_star

    def cross_section_freq_dependence(self, freq):
        if self.grey:
            return 1.0
        return (np.asarray(freq) / self.freq0) ** (-self.pl_index)

    # -- integrands (vectorized over the tau table) --------------------
    def _photo_thick_integrand(self, freq, tau):
        s = self.cross_section_freq_dependence(freq)
        arg = tau * s
        itg = self.SED(freq) * np.exp(np.where(arg < _EXP_OVERFLOW, arg, 0.0) * -1.0)
        return np.where(arg < _EXP_OVERFLOW, itg, 0.0)

    def _photo_thin_integrand(self, freq, tau):
        s = self.cross_section_freq_dependence(freq)
        arg = tau * s
        itg = self.SED(freq) * s * np.exp(np.where(arg < _EXP_OVERFLOW, arg, 0.0) * -1.0)
        return np.where(arg < _EXP_OVERFLOW, itg, 0.0)

    def _heat_thick_integrand(self, freq, tau):
        return hplanck * (freq - ion_freq_HI) * self._photo_thick_integrand(freq, tau)

    def _heat_thin_integrand(self, freq, tau):
        return hplanck * (freq - ion_freq_HI) * self._photo_thin_integrand(freq, tau)

    # -- table builders ------------------------------------------------
    def make_photo_table(self, tau, freq_min, freq_max, S_star_ref):
        """Integrate the thin/thick photoionization tables over the band."""
        self.normalize_SED(freq_min, freq_max, S_star_ref)
        thin = quad_vec(lambda f: self._photo_thin_integrand(f, tau),
                        freq_min, freq_max, epsrel=1e-12)[0]
        thick = quad_vec(lambda f: self._photo_thick_integrand(f, tau),
                         freq_min, freq_max, epsrel=1e-12)[0]
        return thin, thick

    def make_heat_table(self, tau, freq_min, freq_max, S_star_ref):
        """Integrate the thin/thick photoheating tables over the band."""
        self.normalize_SED(freq_min, freq_max, S_star_ref)
        thin = quad_vec(lambda f: self._heat_thin_integrand(f, tau),
                        freq_min, freq_max, epsrel=1e-12)[0]
        thick = quad_vec(lambda f: self._heat_thick_integrand(f, tau),
                         freq_min, freq_max, epsrel=1e-12)[0]
        return thin, thick
