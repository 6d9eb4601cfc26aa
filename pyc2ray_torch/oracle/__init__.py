"""The sequential NumPy oracle of the C2Ray algorithm (no torch)."""

from .c2ray_ref import (oracle_raytrace, oracle_chemistry_global,
                        oracle_doric, oracle_photoion_rate)

__all__ = ["oracle_raytrace", "oracle_chemistry_global", "oracle_doric",
           "oracle_photoion_rate"]
