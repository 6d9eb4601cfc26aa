"""CubeP3M-coupled simulation class.

PyTorch twin of pyc2ray_tpu/models/cubep3m.py, the equivalent of the
reference's ``C2Ray_CubeP3M`` (pyc2ray/c2ray_cubep3m.py:17-226): reads
N-body halo catalogs (HDF5) and coarse density fields, converts halo mass to
ionizing flux, writes C2Ray-compatible binary outputs, and resumes from the
latest output redshift. tools21cm is replaced by the readers of io/cbin.py;
h5py is imported only to read a catalog. Beyond the reference, a
non-isothermal run also writes and reloads its temperature (Temper), and a
helium run (engine: he) its helium fractions (xfracHe1, xfracHe2).
"""

import glob
import os

import numpy as np

from ..constants import msun2g
from ..io.cbin import save_cbin, read_cbin, DensityFile
from ..utils.other_utils import (get_redshifts_from_output, find_bins,
                                 get_source_redshifts)
from .base import C2RaySimulation

__all__ = ["C2Ray_CubeP3M", "get_dens_redshifts"]

M_P = 1.67262192369e-24      # proton mass, g (CODATA value astropy uses)
MYR = 3.15576e13             # megayear in seconds (astropy u.Myr cgs)


def get_dens_redshifts(dens_dir):
    """Scan coarser_densities/ for '<z>n_all.dat' files
    (tools21cm get_dens_redshifts equivalent)."""
    zs = []
    for f in glob.glob(os.path.join(dens_dir, "*n_all.dat")):
        base = os.path.basename(f).replace("n_all.dat", "")
        try:
            zs.append(float(base))
        except ValueError:
            continue
    return np.sort(np.array(zs))[::-1]


class C2Ray_CubeP3M(C2RaySimulation):
    """A C2Ray CubeP3M N-body-coupled simulation (c2ray_cubep3m.py:17).
    ``device`` as in ``C2RaySimulation``."""

    def __init__(self, paramfile, Nmesh, use_gpu=True, mesh=None,
                 device=None):
        super().__init__(paramfile, Nmesh, use_gpu, mesh=mesh, device=device)
        self.printlog('Running: "C2Ray CubeP3M"')

    # ------------------------------------------------------------------
    def read_sources(self, file, mass="hm"):
        """Read an HDF5 halo catalog and convert masses to normalized
        fluxes (c2ray_cubep3m.py:33-87); returns ((3, NumSrc) positions,
        (NumSrc,) fluxes)."""
        import h5py
        with h5py.File(file, "r") as f:
            positions = f["sources_positions"][:]
            masses = f["sources_mass"][:]
        return self._sources_from_catalog(positions, masses, file)

    def _sources_from_catalog(self, positions, masses, file):
        """A catalog's (NumSrc, 3) positions and (NumSrc,) halo masses
        [Msun] as read_sources returns them, with its log lines:

        mass2phot = msun2g * fgamma_hm * Ob0 / (mu * m_p * ts * Om0)
        """
        S_star_ref = 1e48
        mass2phot = (msun2g * self.fgamma_hm * self.cosmology.Ob0
                     / (self.mean_molecular * M_P * self.ts
                        * self.cosmology.Om0))
        srcpos = positions.T
        if srcpos.shape[0] != 3:
            raise ValueError(f"{file}: sources_positions is "
                             f"{positions.shape}, expected (NumSrc, 3)")
        normflux = masses * mass2phot / S_star_ref
        self.printlog(
            f"\n---- Reading source file with total of {normflux.size} "
            f"ionizing source:\n{file}")
        self.printlog(
            " min, max source mass : %.3e  %.3e [Msun]; min, mean, max "
            "ionizing flux : %.3e  %.3e  %.3e [1/s]"
            % (normflux.min() / mass2phot * S_star_ref,
               normflux.max() / mass2phot * S_star_ref,
               normflux.min() * S_star_ref, normflux.mean() * S_star_ref,
               normflux.max() * S_star_ref))
        return srcpos, normflux

    def read_density(self, z):
        """Read the nearest-above-z coarse density file, scaled to proper
        density (c2ray_cubep3m.py:89-126)."""
        redshift = z if self.cosmological else self.zred_0
        above = self.zred_density[self.zred_density >= redshift]
        high_z = above[np.argmin(np.abs(above - redshift))]
        if high_z != self.prev_zdens:
            file = "%scoarser_densities/%.3fn_all.dat" % (
                self.inputs_basename, high_z)
            self.printlog("\n---- Reading density file:\n " + file)
            self.ndens = (DensityFile(file).cgs_density
                          / (self.mean_molecular * M_P)
                          * (1 + redshift) ** 3)
            self.printlog(" min, mean and max density : %.3e  %.3e  %.3e "
                          "[1/cm3]" % (self.ndens.min(), self.ndens.mean(),
                                       self.ndens.max()))
            self.prev_zdens = high_z

    def write_output(self, z):
        """C2Ray-compatible binary outputs (c2ray_cubep3m.py:128-143).
        Non-isothermal runs also write Temper, so that they resume with
        their temperature (the reference resets it, SURVEY.md section 5),
        and helium runs xfracHe1/xfracHe2. The primary rank's only."""
        if not self.primary:
            return
        suffix = f"_{z:.3f}.dat"
        save_cbin(self.results_basename + "xfrac" + suffix, self.xh,
                  bits=64, order="F")
        save_cbin(self.results_basename + "IonRates" + suffix, self.phi_ion,
                  bits=32, order="F")
        if not self.isothermal:
            save_cbin(self.results_basename + "Temper" + suffix, self.temp,
                      bits=64, order="F")
        if self.multi_species:
            save_cbin(self.results_basename + "xfracHe1" + suffix,
                      self.xhe1, bits=64, order="F")
            save_cbin(self.results_basename + "xfracHe2" + suffix,
                      self.xhe2, bits=64, order="F")
        self.printlog("\n--- Reionization History ----")
        self.printlog(" min, mean, max xHII : %.3e  %.3e  %.3e"
                      % (self.xh.min(), self.xh.mean(), self.xh.max()))
        self.printlog(" min, mean, max Irate : %.3e  %.3e  %.3e [1/s]"
                      % (self.phi_ion.min(), self.phi_ion.mean(),
                         self.phi_ion.max()))

    # -- init hooks -----------------------------------------------------
    def _redshift_init(self):
        """(c2ray_cubep3m.py:150-168)"""
        self.zred_density = get_dens_redshifts(
            self.inputs_basename + "coarser_densities/")[::-1]
        self.zred_sources = get_source_redshifts(
            self.inputs_basename + "sources/")[::-1]
        if self.resume:
            self.zred_0 = np.min(
                get_redshifts_from_output(self.results_basename))
            self.age_0 = self.zred2time(self.zred_0)
            _, self.prev_zdens = find_bins(self.zred_0, self.zred_density)
            _, self.prev_zsourc = find_bins(self.zred_0, self.zred_sources)
        else:
            self.prev_zdens = -1
            self.prev_zsourc = -1
        self.time = self.age_0
        self.zred = self.zred_0

    def _material_init(self):
        """(c2ray_cubep3m.py:170-190); a non-isothermal run's Temper output
        and a helium run's xfracHe1/xfracHe2 are reloaded where they
        exist."""
        temp0 = self._ld["Material"]["temp0"]
        if self.resume:
            self.ndens = (DensityFile(
                "%scoarser_densities/%.3fn_all.dat"
                % (self.inputs_basename, float(self.prev_zdens))).cgs_density
                / (self.mean_molecular * M_P) * (1 + self.zred) ** 3)
            self.xh = read_cbin(
                "%sxfrac_%.3f.dat" % (self.results_basename, self.zred),
                bits=64, order="F")
            tfile = "%sTemper_%.3f.dat" % (self.results_basename, self.zred)
            if os.path.exists(tfile):
                self.temp = read_cbin(tfile, bits=64, order="F")
            else:
                self.temp = temp0 * np.ones(self.shape)
            h1 = "%sxfracHe1_%.3f.dat" % (self.results_basename, self.zred)
            h2 = "%sxfracHe2_%.3f.dat" % (self.results_basename, self.zred)
            if os.path.exists(h1) and os.path.exists(h2):
                self.xhe1 = read_cbin(h1, bits=64, order="F")
                self.xhe2 = read_cbin(h2, bits=64, order="F")
            elif os.path.exists(h1) != os.path.exists(h2):
                raise FileNotFoundError(
                    "incomplete helium checkpoint: exactly one of "
                    f"{h1} / {h2} exists (run interrupted mid-output?); "
                    "remove the stray file to resume with default He "
                    "fractions or restore the pair")
            self.phi_ion = read_cbin(
                "%sIonRates_%.3f.dat" % (self.results_basename, self.zred),
                bits=32, order="F")
        else:
            xh0 = self._ld["Material"]["xh0"]
            avg_dens = self._ld["Material"]["avg_dens"]
            self.ndens = avg_dens * np.ones(self.shape)
            self.xh = xh0 * np.ones(self.shape)
            self.temp = temp0 * np.ones(self.shape)
            self.phi_ion = np.zeros(self.shape)

    def _output_init(self):
        """(c2ray_cubep3m.py:192-209)"""
        self.results_basename = self._ld["Output"]["results_basename"]
        self.inputs_basename = self._ld["Output"]["inputs_basename"]
        self.logfile = self.results_basename + self._ld["Output"]["logfile"]
        if not self.primary:
            return
        if self._ld["Grid"]["resume"]:
            with open(self.logfile, "a") as f:
                f.write("\n\nResuming pyC2Ray (torch) run\n\n")
        else:
            with open(self.logfile, "w") as f:
                f.write("\nLog file for pyC2Ray (torch).\n\n")

    def _sources_init(self):
        """(c2ray_cubep3m.py:211-216)"""
        self.fgamma_hm = self._ld["Sources"]["fgamma_hm"]
        self.fgamma_lm = self._ld["Sources"]["fgamma_lm"]
        self.ts = self._ld["Sources"]["ts"] * MYR

    def _grid_init(self):
        super()._grid_init()
        self.resume = self._ld["Grid"]["resume"]
