from .base import C2RaySimulation
from .test_sim import C2Ray_Test
from .cubep3m import C2Ray_CubeP3M
from .paper244 import C2Ray_244Test

__all__ = ["C2RaySimulation", "C2Ray_Test", "C2Ray_CubeP3M", "C2Ray_244Test"]
