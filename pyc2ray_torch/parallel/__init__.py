"""Multi-GPU execution on torch.distributed (twin of pyc2ray_tpu/parallel):
the source-parallel path (every rank traces its batches of the catalog, one
all-reduce of Gamma, the chemistry split over the cells) and the
domain-decomposed path (every rank holds a block of the grid, halo
exchange), for the hydrogen engines (flat, cheb, adaptive), the thermal
update and the helium engine."""

from .mesh import Mesh, make_mesh, device_count
from .source_parallel import (trace_sharded, global_pass_sharded,
                              evolve3D_sharded, evolve3D_he_sharded,
                              prepare_sources_sharded)
from .domain import (make_domain_mesh, DomainDecomposition,
                     evolve3D_domain, evolve3D_he_domain)
from . import multihost

__all__ = ["Mesh", "make_mesh", "device_count", "trace_sharded",
           "global_pass_sharded", "evolve3D_sharded",
           "prepare_sources_sharded", "make_domain_mesh",
           "DomainDecomposition", "evolve3D_domain", "evolve3D_he_domain",
           "evolve3D_he_sharded", "multihost"]
