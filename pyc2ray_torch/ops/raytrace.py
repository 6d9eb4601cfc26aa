"""Static raytracer configuration shared by the engines."""

from typing import NamedTuple

import torch

__all__ = ["RaytraceConfig"]


class RaytraceConfig(NamedTuple):
    """Static raytracer configuration.

    Attributes
    ----------
    N : mesh size (N^3 periodic grid)
    R_max_LLS : maximum photon travel distance in cell units (type-3 LLS,
        c2ray_base.py:460-462); also sets the octahedron size.
    sig : HI photoionization cross section at the threshold (cm^2)
    batch_size : number of sources swept concurrently (ASORA's
        ``source_batch_size``)
    dtype : working dtype for grid fields (torch.float64 or torch.float32)
    grey_analytic : the spectrum is a single grey bin
    do_heating : also accumulate photo-heating rates
    """
    N: int
    R_max_LLS: float
    sig: float
    batch_size: int = 8
    dtype: object = torch.float64
    grey_analytic: bool = False
    do_heating: bool = False
