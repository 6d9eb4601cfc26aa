"""Parameter files and a standalone parameter container.

``read_paramfile`` parses a pyc2ray YAML parameter file (the reference's
schema, with its scientific-notation float resolver,
c2ray_base.py:490-507); the model layer (models/base.py) and ``Params``
share it. PyYAML is imported inside the function, so importing the package
does not need it: a caller without PyYAML passes an already-parsed mapping
instead of a path.

``Params`` is the equivalent of the reference's utils/paramutils.py:11-266:
it reads the file and precomputes derived atomic/cosmology/SED quantities,
for scripts and notebooks that want them without building a simulation.
"""

import copy
import re

from ..constants import Mpc, ev2fr, ev2k
from ..cosmology import FlatLambdaCDM

__all__ = ["Params", "read_paramfile"]

_FLOAT = re.compile(r"""^(?:
 [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
|[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
|\.[0-9_]+(?:[eE][-+][0-9]+)?
|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
|[-+]?\.(?:inf|Inf|INF)
|\.(?:nan|NaN|NAN))$""", re.X)


def read_paramfile(paramfile):
    """The parameters as a nested dict: ``paramfile`` is the path of a YAML
    file, or a mapping of the same layout (deep-copied, so the caller's
    stays as it was)."""
    if not isinstance(paramfile, (str, bytes)) and hasattr(paramfile, "keys"):
        return copy.deepcopy(dict(paramfile))
    import yaml
    try:
        from yaml import CSafeLoader as SafeLoader
    except ImportError:
        from yaml import SafeLoader
    loader = SafeLoader
    loader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT,
                                 list("-+0123456789."))
    with open(paramfile, "r") as f:
        return yaml.load(f, loader)


class Params:
    """Read a pyc2ray YAML parameter file (or take its parsed mapping) and
    derive physical quantities."""

    def __init__(self, paramfile, Nmesh=None):
        self.raw = read_paramfile(paramfile)
        ld = self.raw

        # atomic physics
        self.eth0 = ld["CGS"]["eth0"]
        self.temph0 = self.eth0 * ev2k
        self.ion_freq_HI = ev2fr * self.eth0
        self.ion_freq_HeII = ev2fr * ld["CGS"]["ethe1"]
        self.bh00 = ld["CGS"]["bh00"]
        self.albpow = ld["CGS"]["albpow"]
        self.colh0 = (ld["CGS"]["colh0_fact"] * ld["CGS"]["fh0"]
                      * ld["CGS"]["xih0"] / self.eth0 ** 2)
        self.sig = ld["Photo"]["sigma_HI_at_ion_freq"]
        self.abu_h = ld["Abundances"]["abu_h"]
        self.abu_he = ld["Abundances"]["abu_he"]
        self.abu_c = ld["Abundances"]["abu_c"]
        self.mean_molecular = self.abu_h + 4.0 * self.abu_he

        # cosmology
        cz = ld["Cosmology"]
        self.cosmology = FlatLambdaCDM(100 * cz["h"], cz["Omega0"],
                                       Tcmb0=cz["cmbtemp"],
                                       Ob0=cz["Omega_B"])
        self.zred_0 = cz["zred_0"]
        self.age_0 = self.cosmology.age(self.zred_0)

        # grid
        self.boxsize_c = ld["Grid"]["boxsize"] * Mpc
        if Nmesh is not None:
            self.N = Nmesh
            self.dr_c = self.boxsize_c / Nmesh
            self.R_max_LLS = (ld["Photo"]["R_max_cMpc"] * Nmesh
                              / ld["Grid"]["boxsize"])

    def __getitem__(self, key):
        return self.raw[key]
