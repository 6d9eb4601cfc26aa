"""Test-case simulation class.

PyTorch twin of pyc2ray_tpu/models/test_sim.py, the equivalent of the
reference's ``C2Ray_Test`` (pyc2ray/c2ray_test.py:14-182): text source
files, constant average density, pickle outputs.
"""

import pickle as pkl

import numpy as np

from ..constants import YEAR
from ..utils.sourceutils import read_test_sources
from .base import C2RaySimulation

__all__ = ["C2Ray_Test"]

_BANNER = (
    "                 _________   ____\n"
    "    ____  __  __/ ____/__ \\ / __ \\____ ___  __\n"
    "   / __ \\/ / / / /    __/ // /_/ / __ `/ / / /\n"
    "  / /_/ / /_/ / /___ / __// _, _/ /_/ / /_/ /\n"
    " / .___/\\__, /\\____//____/_/ |_|\\__,_/\\__, /  (torch)\n"
    "/_/    /____/                        /____/\n")


class C2Ray_Test(C2RaySimulation):
    """A C2Ray test-case simulation (c2ray_test.py:14)."""

    def __init__(self, paramfile, Nmesh, use_gpu=True, use_mpi=None,
                 mesh=None, device=None):
        super().__init__(paramfile, Nmesh, use_gpu, use_mpi, mesh=mesh,
                         device=device)
        self.printlog('Running: "C2Ray Test"')

    def read_sources(self, file, numsrc, S_star_ref=1e48):
        """Read a C2Ray-format source file (c2ray_test.py:30-60)."""
        return read_test_sources(file, numsrc, S_star_ref)

    def density_init(self, z):
        self.set_constant_average_density(self.avg_dens, z)

    def write_output(self, z):
        """Pickle outputs (c2ray_test.py:77-89); the primary rank's."""
        if not self.primary:
            return
        suffix = f"_{z:.3f}.pkl"
        with open(self.results_basename + "xfrac" + suffix, "wb") as f:
            pkl.dump(self.xh, f)
        with open(self.results_basename + "IonRates" + suffix, "wb") as f:
            pkl.dump(self.phi_ion, f)

    def write_output_numbered(self, n):
        if not self.primary:
            return
        suffix = f"_{n:n}.pkl"
        with open(self.results_basename + "xfrac" + suffix, "wb") as f:
            pkl.dump(self.xh, f)
        with open(self.results_basename + "IonRates" + suffix, "wb") as f:
            pkl.dump(self.phi_ion, f)

    def set_constant_average_density(self, ndens, z):
        """Constant density scaled to (1+z)^3 (c2ray_test.py:105-124)."""
        redshift = z if self.cosmological else self.zred_0
        self.ndens = ndens * np.ones(self.shape) * (1 + redshift) ** 3

    def generate_redshift_array(self, num_zred, delta_t):
        """Equal-time-spaced redshifts, delta_t in years
        (c2ray_test.py:126-149)."""
        step = delta_t * YEAR
        return np.array([self.time2zred(self.age_0 + i * step)
                         for i in range(num_zred)])

    # -- init hooks -----------------------------------------------------
    def _redshift_init(self):
        self.time = self.age_0
        self.zred = self.zred_0

    def _material_init(self):
        xh0 = self._ld["Material"]["xh0"]
        temp0 = self._ld["Material"]["temp0"]
        self.ndens = np.empty(self.shape)
        self.xh = xh0 * np.ones(self.shape)
        self.temp = temp0 * np.ones(self.shape)
        self.phi_ion = np.zeros(self.shape)
        self.avg_dens = self._ld["Material"]["avg_dens"]

    def _output_init(self):
        self.results_basename = self._ld["Output"]["results_basename"]
        self.logfile = self.results_basename + self._ld["Output"]["logfile"]
        if self.primary:
            with open(self.logfile, "w") as f:
                f.write("\nLog file for pyC2Ray (PyTorch)\n\n")
        self.printlog(_BANNER)
