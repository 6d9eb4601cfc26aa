from .adaptive import AdaptiveRaytracer
from .chemistry import global_pass, doric, ChemistryParams
from .chemistry_he import HeChemistryParams, global_pass_he
from .raytrace import RaytraceConfig, Raytracer
from .raytrace_box import BoxRaytracer, grey_bins
from .raytrace_cheb import ChebRaytracer, ChebTables
from .raytrace_he import HeRaytracer

__all__ = [
    "AdaptiveRaytracer", "global_pass", "doric", "ChemistryParams",
    "HeChemistryParams", "global_pass_he", "RaytraceConfig", "Raytracer",
    "ChebRaytracer", "ChebTables", "HeRaytracer", "BoxRaytracer",
    "grey_bins",
]
