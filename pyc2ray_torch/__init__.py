"""pyc2ray_torch: the PyTorch/CUDA port of pyc2ray-tpu for NVIDIA Hopper.

A run starts as in the JAX package: ``C2Ray_Test(paramfile, N)`` builds the
simulation from a YAML parameter file (or its parsed mapping) and
``sim.evolve3D(dt, srcflux, srcpos)`` advances it by one timestep; the
production EoR run is ``C2Ray_CubeP3M`` (or ``C2Ray_244Test``) on N-body
density fields and halo catalogs, as examples/eor_simulation/run_test.py
drives the JAX package. It holds the single-device hydrogen path,
isothermal or with the photoheating channel and the thermal update
(``Material.isothermal: false``), on the Chebyshev-face raytracer
(``ops.raytrace_cheb``, ``Raytracing.engine: cheb``) whose sweep modes are
hand-written CUDA kernels (``ops/csrc``), on the flux-bucketed adaptive
engine (``ops.adaptive``, ``engine: adaptive``) built from it, on the
table-exact octahedral engine (``ops.raytrace``, ``engine: flat``, the
YAML default) and on the octahedral sheet engine (``ops.raytrace_box``,
``engine: box``, a loop of hand-written kernels on the card); the
three-species helium path
(``ops.raytrace_he``, ``ops.chemistry_he``, ``evolve.evolve3D_he``,
``engine: he``); the time-averaged chemistry pass (``ops.chemistry``), the
convergence loop (``evolve.evolve3D``), the C2Ray binary and checkpoint IO
(``io``), the profiler helpers (``diagnostics``), multi-GPU execution
(``parallel``), the sequential NumPy oracle (``oracle``), the plot helpers
(``visualization``) and a loader of the sequential C++ oracle
(``native_ext``): everything the JAX package has. The package imports
torch, numpy and scipy only (PyYAML only to read a parameter file, h5py
only to read a halo catalog, matplotlib only when a plot helper draws).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, which selects the plain PyTorch versions of every kernel.
"""

from . import constants
from .chemistry_api import hydrogenODE
from .cosmology import FlatLambdaCDM
from .device import resolve_device
from .evolve import evolve3D, evolve3D_he
from .models import (C2RaySimulation, C2Ray_Test, C2Ray_CubeP3M,
                     C2Ray_244Test)
from .ops import (AdaptiveRaytracer, BoxRaytracer, ChebRaytracer,
                  ChemistryParams, HeRaytracer, RaytraceConfig, Raytracer,
                  doric, global_pass)
from .ops.geometry import OctaGeometry, build_geometry
from .radiation import BlackBodySource, make_tau_table
from .utils import (printlog, format_sources, read_test_sources,
                    generate_test_sourcefile)

__version__ = "0.1.0"

__all__ = [
    "constants", "hydrogenODE", "FlatLambdaCDM", "resolve_device",
    "evolve3D", "evolve3D_he", "C2RaySimulation", "C2Ray_Test",
    "C2Ray_CubeP3M", "C2Ray_244Test", "AdaptiveRaytracer", "BoxRaytracer",
    "ChebRaytracer",
    "ChemistryParams", "HeRaytracer", "RaytraceConfig", "Raytracer",
    "doric", "global_pass", "OctaGeometry", "build_geometry",
    "BlackBodySource", "make_tau_table",
    "printlog", "format_sources", "read_test_sources",
    "generate_test_sourcefile",
]
