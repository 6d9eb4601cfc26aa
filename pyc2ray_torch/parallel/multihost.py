"""Starting a world of ranks, on one host or several.

PyTorch twin of pyc2ray_tpu/parallel/multihost.py. The reference's
multi-node story is user-supplied mpi4py (its test script passes
MPI.COMM_WORLD into the sim); here every rank runs the same program over
torch.distributed, and the meshes of parallel/mesh.py and
parallel/domain.py span the world's ranks.

Typical run, one rank per card::

    torchrun --nproc_per_node=K run.py

    import pyc2ray_torch as pc2r
    from pyc2ray_torch.parallel import multihost
    multihost.initialize()                  # no-op in a single process
    mesh = multihost.global_domain_mesh()   # every rank of the job
    sim = pc2r.C2Ray_Test("parameters.yml", N, mesh=mesh)

Outputs are written by the primary rank only (``is_primary``; the model
layer gates its log and output files on it).
"""

import datetime
import os

import torch
import torch.distributed as dist

from . import mesh as _mesh
from .domain import make_domain_mesh
from .mesh import make_mesh, world

__all__ = ["initialize", "is_primary", "global_domain_mesh",
           "global_source_mesh", "choose_backend"]


def choose_backend(local_world_size):
    """nccl when every rank on the host has a card of its own, gloo when
    ranks share a card or there is none (NCCL refuses two ranks on one
    device)."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               local_rank=None, timeout_s=600):
    """Join this process to its world; a no-op (returns False) in a single
    process.

    Under torchrun everything comes from its environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/MASTER_PORT);
    elsewhere pass ``init_method`` (e.g. "tcp://localhost:<port>" or
    "file://<path>"), ``world_size`` and ``rank``. ``backend`` is the
    caller's, else ``choose_backend``'s; it is printed, and never changed
    after a failure. Returns True once the process group is up."""
    if dist.is_initialized():
        return True
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world_size is None:
        world_size = env_world
    if init_method is None and world_size <= 1:
        return False                      # single-process run
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if backend is None:
        backend = choose_backend(local_world)
    _mesh._LOCAL_RANK = int(local_rank)
    if torch.cuda.is_available():
        # the rank's card is the current device (nccl's, and every
        # synchronize without a device)
        torch.cuda.set_device(int(local_rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=int(world_size), rank=int(rank),
                            timeout=datetime.timedelta(seconds=timeout_s))
    print(f"pyc2ray_torch.parallel: rank {rank} of {world_size} (local "
          f"rank {local_rank}), backend {backend}", flush=True)
    return True


def is_primary():
    """True on the process that writes outputs and logs (the reference's
    ``if rank == 0``)."""
    return world()[0] == 0


def global_domain_mesh(pi=None, pj=None, pk=None, device=None):
    """("di", "dj", "dk") domain mesh over every rank of the job.

    Defaults to the most-cubic factorization of the world's size, so halo
    surfaces are smallest."""
    n = world()[1]
    if pi is None and pj is None and pk is None:
        pk = 1
        for f in range(int(round(n ** (1.0 / 3.0))), 0, -1):
            if n % f == 0:
                pk = f
                break
        m = n // pk
        pj = 1
        for f in range(int(m ** 0.5), 0, -1):
            if m % f == 0:
                pj = f
                break
        pi = m // pj
    else:
        # partially specified: missing minor axes default to 1, a missing
        # pi absorbs the remaining ranks
        pj = 1 if pj is None else pj
        pk = 1 if pk is None else pk
        pi = n // (pj * pk) if pi is None else pi
    return make_domain_mesh(pi, pj, pk, device=device)


def global_source_mesh(device=None):
    """("src", "space") source-parallel mesh over every rank (the
    reference's MPI mode)."""
    return make_mesh(device=device)
