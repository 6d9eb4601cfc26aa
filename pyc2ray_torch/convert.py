"""Carry the JAX engine's state into the port.

The inputs are plain dicts of numpy arrays and floats, so this module
needs neither JAX nor the JAX package: the caller converts (for example
``{k: np.asarray(v) for k, v in rt.tables._asdict().items()}``).
"""

import numpy as np
import torch

from .ops.chemistry import ChemistryParams
from .ops.raytrace_cheb import ChebTables
from .ops.thermal import ThermalParams
from .radiation.spectral_bins import SpectralBins

__all__ = ["state_from_jax", "thermal_from_jax"]


def state_from_jax(tables_np, bins_np, chem_dict):
    """Build the port's state from the JAX engine's.

    tables_np : dict of the JAX ``ChebTables`` fields (numpy arrays),
        including the fused modes' rates table ``rt_tab``; the fields the
        port has no use for (the packed kernel geometry ``geom_*``, the
        dense ``path3``/``dist2``/``rate_valid``) are ignored.
    bins_np : dict with ``s``, ``w_photo`` and ``w_heat``.
    chem_dict : dict of the ``ChemistryParams`` fields.

    Returns (tables, bins, chem): a port ``ChebTables`` of CPU tensors in
    the arrays' own dtypes (move it with ``ChebTables.to``), a
    ``SpectralBins`` and a ``ChemistryParams``.
    """
    tables = ChebTables(*[torch.from_numpy(np.array(tables_np[f]))
                          for f in ChebTables._fields])
    s = np.asarray(bins_np["s"], np.float64)
    bins = SpectralBins(s=s,
                        w_photo=np.asarray(bins_np["w_photo"], np.float64),
                        w_heat=np.asarray(bins_np["w_heat"], np.float64),
                        num_bins=len(s))
    chem = ChemistryParams(**{k: float(v) for k, v in chem_dict.items()})
    return tables, bins, chem


def thermal_from_jax(thermal_dict):
    """The port's ``ThermalParams`` from the fields of the JAX package's
    (``ThermalParams._asdict()``): floats, and ``compton`` a bool."""
    kw = {k: (bool(v) if k == "compton" else float(v))
          for k, v in thermal_dict.items()}
    return ThermalParams(**kw)
