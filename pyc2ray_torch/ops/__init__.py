from .adaptive import AdaptiveRaytracer
from .chemistry import global_pass, doric, ChemistryParams
from .raytrace import RaytraceConfig
from .raytrace_cheb import ChebRaytracer, ChebTables

__all__ = [
    "AdaptiveRaytracer", "global_pass", "doric", "ChemistryParams",
    "RaytraceConfig", "ChebRaytracer", "ChebTables",
]
