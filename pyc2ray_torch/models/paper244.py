"""244 Mpc/h EoR paper simulation variant.

PyTorch twin of pyc2ray_tpu/models/paper244.py, the equivalent of the
reference's ``C2Ray_244Test`` (pyc2ray/c2ray_244paper.py:
29-387): Mpc/h box units, matter-dominated analytic time<->redshift
relations matching original C2Ray, incremental cell-size evolution, and a
half-step catch-up between slices.
"""

import numpy as np

from ..constants import Mpc, msun2g
from ..io.catalog import read_halo_catalog
from ..io.cbin import save_cbin, read_cbin, DensityFile
from ..utils.other_utils import get_redshifts_from_output, find_bins
from .base import C2RaySimulation
from .cubep3m import M_P, MYR, get_dens_redshifts

__all__ = ["C2Ray_244Test"]


class C2Ray_244Test(C2RaySimulation):
    """Paper-configuration simulation in Mpc/h units
    (c2ray_244paper.py:29). ``device`` as in ``C2RaySimulation``."""

    def __init__(self, paramfile, Nmesh, use_gpu=True, mesh=None,
                 device=None):
        super().__init__(paramfile, Nmesh, use_gpu, mesh=mesh, device=device)
        self.printlog('Running: "C2Ray 244Mpc paper test"')

    # -- time evolution (matter-dominated conventions) -------------------
    def set_timestep(self, z1, z2, num_timesteps):
        """dt from analytic ages (c2ray_244paper.py:44-69)."""
        t2 = self.zred2time(z2)
        t1 = self.zred2time(z1)
        return (t2 - t1) / num_timesteps

    def cosmo_evolve(self, dt):
        """Incremental dilution variant (c2ray_244paper.py:71-103)."""
        t_now = self.time
        t_half = t_now + 0.5 * dt
        t_after = t_now + dt
        z_half = self.time2zred(t_half)
        if self.cosmological:
            dilution = (1 + z_half) / (1 + self.zred)
            self.ndens = self.ndens * dilution ** 3
            self.dr = self.dr / dilution
        self.zred = z_half
        self.time = t_after

    def cosmo_evolve_to_now(self):
        """Half-step catch-up between slices (c2ray_244paper.py:104-125)."""
        z_now = self.time2zred(self.time)
        if self.cosmological:
            dilution = (1 + z_now) / (1 + self.zred)
            self.ndens = self.ndens * dilution ** 3
            self.dr = self.dr / dilution
        self.zred = z_now

    def time2zred(self, t):
        """Analytic EdS inverse (c2ray_244paper.py:130-136)."""
        return -1.0 + (1.0 + self.zred_0) * (self.age_0 / t) ** (2.0 / 3.0)

    def zred2time(self, z, unit="s"):
        """Analytic EdS age (c2ray_244paper.py:138-151)."""
        return self.age_0 * (((1.0 + self.zred_0) / (1.0 + z)) ** 1.5)

    # -- init hooks -----------------------------------------------------
    def _cosmology_init(self):
        """Analytic matter-dominated age (c2ray_244paper.py:158-189)."""
        from ..cosmology import FlatLambdaCDM
        ld = self._ld
        h = ld["Cosmology"]["h"]
        Om0 = ld["Cosmology"]["Omega0"]
        self.cosmology = FlatLambdaCDM(
            100 * h, Om0, Tcmb0=ld["Cosmology"]["cmbtemp"],
            Ob0=ld["Cosmology"]["Omega_B"])
        self.cosmological = bool(ld["Cosmology"]["cosmological"])
        self.zred_0 = ld["Cosmology"]["zred_0"]
        # EdS age with C2Ray Mpc value (c2ray_244paper.py:175)
        H0_s = 100 * h * 1e5 / Mpc
        self.age_0 = (2.0 * (1.0 + self.zred_0) ** (-1.5)
                      / (3.0 * H0_s * np.sqrt(Om0)))
        if self.cosmological:
            self.printlog(
                f"Cosmology is on (matter-dominated analytic), z0 = "
                f"{self.zred_0:.3f}")
            self.dr = self.dr_c / (1 + self.zred_0)
        else:
            self.printlog("Cosmology is off.")

    def _grid_init(self):
        """Mpc/h box units (c2ray_244paper.py:370-386)."""
        ld = self._ld
        h = ld["Cosmology"]["h"]
        self.boxsize_c = ld["Grid"]["boxsize"] * Mpc / h
        self.dr_c = self.boxsize_c / self.N
        self.printlog(f"Welcome! Mesh size is N = {self.N:n}.")
        self.printlog(f"Simulation box size (comoving Mpc/h): "
                      f"{ld['Grid']['boxsize']:.3e}")
        self.dr = self.dr_c
        self.R_max_LLS = (ld["Photo"]["R_max_cMpc"] * h * self.N
                          / ld["Grid"]["boxsize"])
        self.printlog(f"Maximum comoving distance for photons from source "
                      f"(type 3 LLS): {ld['Photo']['R_max_cMpc']:.3e} cMpc "
                      f"= {self.R_max_LLS:.3f} grid cells.")
        self.resume = ld["Grid"]["resume"]

    def _sources_init(self):
        """Bare-m_p mass->photon conversion (c2ray_244paper.py:196-239)."""
        self.fgamma_hm = self._ld["Sources"]["fgamma_hm"]
        self.ts = self._ld["Sources"]["ts"] * MYR

    def read_sources(self, file, mass="hm"):
        """Halo catalog -> normalized fluxes using bare m_p
        (c2ray_244paper.py:196-239); the catalog is read as
        C2Ray_CubeP3M.read_sources reads it."""
        S_star_ref = 1e48
        mass2phot = (msun2g * self.fgamma_hm * self.cosmology.Ob0
                     / (M_P * self.ts * self.cosmology.Om0))
        positions, masses = read_halo_catalog(file)
        return positions.T, masses * mass2phot / S_star_ref

    def read_density(self, z):
        """As CubeP3M (c2ray_244paper.py uses the same mechanism)."""
        redshift = z if self.cosmological else self.zred_0
        above = self.zred_density[self.zred_density >= redshift]
        high_z = above[np.argmin(np.abs(above - redshift))]
        if high_z != self.prev_zdens:
            file = "%scoarser_densities/%.3fn_all.dat" % (
                self.inputs_basename, high_z)
            self.ndens = (DensityFile(file).cgs_density
                          / (self.mean_molecular * M_P)
                          * (1 + redshift) ** 3)
            self.prev_zdens = high_z

    def write_output(self, z):
        if not self.primary:
            return
        suffix = f"_{z:.3f}.dat"
        save_cbin(self.results_basename + "xfrac" + suffix, self.xh,
                  bits=64, order="F")
        save_cbin(self.results_basename + "IonRates" + suffix, self.phi_ion,
                  bits=32, order="F")

    def _redshift_init(self):
        """Resume support (c2ray_244paper.py:300-341)."""
        try:
            self.zred_density = get_dens_redshifts(
                self.inputs_basename + "coarser_densities/")[::-1]
        except Exception:
            self.zred_density = np.array([])
        if self.resume:
            self.zred_0 = np.min(
                get_redshifts_from_output(self.results_basename))
            H0_s = 100 * self._ld["Cosmology"]["h"] * 1e5 / Mpc
            self.age_0 = (2.0 * (1.0 + self.zred_0) ** (-1.5)
                          / (3.0 * H0_s * np.sqrt(self.cosmology.Om0)))
            if len(self.zred_density):
                _, self.prev_zdens = find_bins(self.zred_0,
                                               self.zred_density)
            else:
                self.prev_zdens = -1
        else:
            self.prev_zdens = -1
        self.time = self.age_0
        self.zred = self.zred_0

    def _material_init(self):
        temp0 = self._ld["Material"]["temp0"]
        if self.resume:
            self.xh = read_cbin(
                "%sxfrac_%.3f.dat" % (self.results_basename, self.zred),
                bits=64, order="F")
            self.phi_ion = read_cbin(
                "%sIonRates_%.3f.dat" % (self.results_basename, self.zred),
                bits=32, order="F")
            self.ndens = (self._ld["Material"]["avg_dens"]
                          * np.ones(self.shape) * (1 + self.zred) ** 3)
            self.temp = temp0 * np.ones(self.shape)
        else:
            xh0 = self._ld["Material"]["xh0"]
            avg_dens = self._ld["Material"]["avg_dens"]
            self.ndens = avg_dens * np.ones(self.shape)
            self.xh = xh0 * np.ones(self.shape)
            self.temp = temp0 * np.ones(self.shape)
            self.phi_ion = np.zeros(self.shape)

    def _output_init(self):
        self.results_basename = self._ld["Output"]["results_basename"]
        self.inputs_basename = self._ld["Output"].get("inputs_basename", "./")
        self.logfile = self.results_basename + self._ld["Output"]["logfile"]
        mode = "a" if self._ld["Grid"]["resume"] else "w"
        if self.primary:
            with open(self.logfile, mode) as f:
                f.write("\nLog file for pyC2Ray (torch, 244Mpc paper "
                        "variant)\n\n")
