from .base import C2RaySimulation
from .test_sim import C2Ray_Test

__all__ = ["C2RaySimulation", "C2Ray_Test"]
