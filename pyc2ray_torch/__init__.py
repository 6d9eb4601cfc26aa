"""pyc2ray_torch: the PyTorch/CUDA port of pyc2ray-tpu for NVIDIA Hopper.

This first slice runs the single-device, hydrogen-only, isothermal
timestep: the Chebyshev-face raytracer (``ops.raytrace_cheb``) whose
cube-shell sweep is a hand-written CUDA kernel (``ops/csrc``), the
time-averaged chemistry pass (``ops.chemistry``) and the convergence loop
(``evolve.evolve3D``). The package imports torch, numpy and scipy only.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, which selects the plain PyTorch versions of every kernel.
"""

from . import constants
from .device import resolve_device
from .evolve import evolve3D
from .ops import ChebRaytracer, ChemistryParams, doric, global_pass
from .radiation import BlackBodySource, make_tau_table

__version__ = "0.1.0"

__all__ = [
    "constants", "resolve_device", "evolve3D", "ChebRaytracer",
    "ChemistryParams", "doric", "global_pass",
    "BlackBodySource", "make_tau_table",
]
