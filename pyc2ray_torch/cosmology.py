"""Minimal flat-LambdaCDM cosmology (astropy-free).

The reference code uses ``astropy.cosmology.FlatLambdaCDM`` for ages,
lookback times and ``z_at_value`` (reference: pyc2ray/c2ray_base.py:354-373,
:283-298). The port keeps its own copy of the JAX package's
small, accurate, astropy-free replacement: flat LCDM with photon + massless-neutrino
radiation (same composition astropy assumes when ``Tcmb0`` is given with
default ``Neff=3.04``), ages via Gauss-Legendre quadrature in scale factor
and redshift inversion via Brent root finding.

Also provides the matter-dominated analytic relations used by the
C2Ray_244Test variant (reference: pyc2ray/c2ray_244paper.py:130-151).
"""

import numpy as np

from .constants import G_GRAV, C_EXACT, A_RAD, KM, Mpc as MPC_C2RAY

# astropy uses the IAU-exact parsec; keep it for H0 conversion so ages agree
# with the reference's astropy-based ages to ~1e-10.
_MPC_EXACT = 3.0856775814913673e24

__all__ = ["FlatLambdaCDM", "matter_dominated_age", "matter_dominated_zred"]


class FlatLambdaCDM:
    """Flat Lambda-CDM cosmology with optional radiation.

    Parameters
    ----------
    H0 : float
        Hubble constant in km/s/Mpc.
    Om0 : float
        Matter density parameter today (excludes radiation).
    Tcmb0 : float
        CMB temperature today in K. Set to 0 to ignore radiation.
    Ob0 : float, optional
        Baryon density parameter today (bookkeeping only).
    Neff : float
        Effective number of massless neutrino species (astropy default 3.04).
    """

    def __init__(self, H0, Om0, Tcmb0=0.0, Ob0=None, Neff=3.04):
        self.H0 = float(H0)
        self.Om0 = float(Om0)
        self.Ob0 = Ob0
        self.Tcmb0 = float(Tcmb0)
        self.Neff = float(Neff)

        self._H0_s = self.H0 * KM / _MPC_EXACT     # H0 in 1/s
        # Critical density and radiation densities
        rho_crit = 3.0 * self._H0_s**2 / (8.0 * np.pi * G_GRAV)
        if Tcmb0 > 0:
            rho_gamma = A_RAD * Tcmb0**4 / C_EXACT**2
            self.Ogamma0 = rho_gamma / rho_crit
            self.Onu0 = self.Neff * (7.0 / 8.0) * (4.0 / 11.0) ** (4.0 / 3.0) * self.Ogamma0
        else:
            self.Ogamma0 = 0.0
            self.Onu0 = 0.0
        self.Or0 = self.Ogamma0 + self.Onu0
        self.Ode0 = 1.0 - self.Om0 - self.Or0

    # ------------------------------------------------------------------
    def efunc(self, z):
        """E(z) = H(z)/H0."""
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return np.sqrt(self.Or0 * zp1**4 + self.Om0 * zp1**3 + self.Ode0)

    def scale_factor(self, z):
        return 1.0 / (1.0 + np.asarray(z, dtype=np.float64))

    def hubble_time_s(self):
        return 1.0 / self._H0_s

    # ------------------------------------------------------------------
    def age(self, z):
        """Age of the universe at redshift z, in seconds.

        t(z) = 1/H0 * int_0^{a(z)} da / (a E(a)).
        """
        from scipy.integrate import quad
        z = float(z)
        a_max = 1.0 / (1.0 + z)

        def integrand(a):
            zp1 = 1.0 / a
            return 1.0 / (a * np.sqrt(self.Or0 * zp1**4 + self.Om0 * zp1**3 + self.Ode0))

        val, _ = quad(integrand, 0.0, a_max, epsabs=0.0, epsrel=1e-12, limit=200)
        return val / self._H0_s

    def lookback_time(self, z):
        """Lookback time to redshift z, in seconds."""
        return self.age(0.0) - self.age(z)

    def z_at_age(self, t_s, zmin=-0.99, zmax=1e4):
        """Invert age(z) = t_s for z (replacement for astropy z_at_value)."""
        from scipy.optimize import brentq
        f = lambda z: self.age(z) - t_s
        return brentq(f, zmin, zmax, xtol=1e-12, rtol=1e-14, maxiter=200)


def matter_dominated_age(z, zred_0, H0_kms, Om0):
    """Analytic Einstein-de-Sitter age used by the 244Mpc-paper variant.

    age_0 = 2 (1+z0)^(-3/2) / (3 H0 sqrt(Om0)); t(z) = age_0 ((1+z0)/(1+z))^1.5.
    (reference: c2ray_244paper.py:151,175 -- note it uses the C2Ray Mpc value.)
    """
    H0_s = H0_kms * KM / MPC_C2RAY
    age_0 = 2.0 * (1.0 + zred_0) ** (-1.5) / (3.0 * H0_s * np.sqrt(Om0))
    return age_0 * ((1.0 + zred_0) / (1.0 + z)) ** 1.5


def matter_dominated_zred(t, zred_0, age_0):
    """Inverse of matter_dominated_age (reference: c2ray_244paper.py:136)."""
    return -1.0 + (1.0 + zred_0) * (age_0 / t) ** (2.0 / 3.0)
