"""Meshes of ranks for multi-GPU execution, on torch.distributed.

PyTorch twin of pyc2ray_tpu/parallel/mesh.py. The JAX package runs one
process with ``shard_map`` over a ``jax.sharding.Mesh`` of devices; the port
runs one process per rank (``torchrun``, or ``torch.multiprocessing`` spawn)
and a ``Mesh`` here is an arrangement of those ranks:

* ("src", "space"), ``make_mesh``: the source-parallel path
  (parallel/source_parallel.py) spreads the batches of sources and the cells
  of the chemistry over all the mesh's ranks; the two sizes only shape it.
* ("di", "dj", "dk"), ``parallel.domain.make_domain_mesh``: the grid's
  (i, j, k) axes split over the ranks (parallel/domain.py); every axis of
  more than one rank has a process group per line of ranks along it.

A mesh covers the first ``size`` ranks of the world, in row-major order of
its coordinates (as the JAX meshes take the first devices); a rank outside
it has ``member`` False and takes no part in its collectives. In a process
without torch.distributed the world is that process: a mesh of one rank,
whose collectives are the identity.

The mesh also moves the tensors (``all_reduce``, ``all_gather``,
``exchange``): with nccl from the card, with gloo through host memory
(``_host_staged``: every CUDA tensor is copied to the host and back; the
rule is the backend's, never a retry after a failure). It counts the bytes
a rank sends and the seconds spent per kind of traffic in ``traffic``.
"""

import itertools
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "device_count", "world", "local_rank"]

# set by multihost.initialize: the rank of this process on its host
_LOCAL_RANK = None


def world():
    """(rank, world size) of this process; (0, 1) without
    torch.distributed."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def device_count():
    """The number of ranks a mesh can span: the world's size (the JAX
    package's ``len(jax.devices())``)."""
    return world()[1]


def local_rank():
    """This process's rank on its host: as ``multihost.initialize`` set
    it, else torchrun's LOCAL_RANK, else the global rank."""
    if _LOCAL_RANK is not None:
        return _LOCAL_RANK
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return world()[0]


def rank_device(device=None):
    """The device of this rank: ``device`` where the caller gives one
    ("cpu" for the plain PyTorch path), else the card
    cuda:(local_rank % cards on the host)."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        return resolve_device("cuda")       # raises: no silent CPU run
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def _host_staged(backend, tensors):
    """What the backend reads and writes: gloo moves host memory, so a
    CUDA tensor goes as a host copy; nccl takes the tensors as they are."""
    if backend == "gloo":
        return [t.cpu() if t.is_cuda else t for t in tensors]
    return tensors


class Mesh:
    """An arrangement of the first ``prod(shape)`` ranks of the world.

    ``axis_names`` name the axes (``shape`` their sizes); ``device`` is
    this rank's device (see ``rank_device``). ``line_groups`` makes a
    process group for every line of ranks along every axis of size > 1
    (the domain mesh's non-divisible axes gather over them). Every rank of
    the world must build the same meshes in the same order (process groups
    are made collectively)."""

    def __init__(self, shape, axis_names, device=None, line_groups=False):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match the "
                             f"axis names {self.axis_names}")
        self.size = int(np.prod(self.shape))
        self.rank, n_world = world()
        if self.size > n_world:
            raise ValueError(f"mesh {'x'.join(map(str, self.shape))} needs "
                             f"{self.size} ranks; the world has {n_world}")
        self.member = self.rank < self.size
        self.index = self.rank if self.member else None
        self.coords = (tuple(int(c) for c in
                             np.unravel_index(self.rank, self.shape))
                       if self.member else None)
        self.device = rank_device(device)
        self.backend = dist.get_backend() if n_world > 1 else None
        self.group = None           # the world's group
        self._lines = {}
        if n_world > 1 and self.size < n_world:
            self.group = dist.new_group(list(range(self.size)))
        if n_world > 1 and line_groups:
            for ax, name in enumerate(self.axis_names):
                if self.shape[ax] == 1:
                    continue
                others = [range(s) for a, s in enumerate(self.shape)
                          if a != ax]
                for fixed in itertools.product(*others):
                    ranks = []
                    for d in range(self.shape[ax]):
                        c = list(fixed)
                        c.insert(ax, d)
                        ranks.append(int(np.ravel_multi_index(c,
                                                              self.shape)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._lines[name] = g
        self.traffic = {}

    # -- layout -----------------------------------------------------------
    def axis_size(self, name):
        """Ranks along axis ``name``; 1 for an axis the mesh lacks."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    def axis_coord(self, name):
        """This rank's coordinate along ``name`` (0 where it is absent)."""
        if name not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(name)]

    def shifted(self, name, s):
        """The mesh rank ``s`` steps along axis ``name`` from this one,
        periodic."""
        ax = self.axis_names.index(name)
        c = list(self.coords)
        c[ax] = (c[ax] + s) % self.shape[ax]
        return int(np.ravel_multi_index(c, self.shape))

    def describe(self):
        return dict(zip(self.axis_names, self.shape))

    def require_member(self):
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not in the mesh "
                               f"{self.describe()}")

    # -- traffic ----------------------------------------------------------
    def reset_traffic(self):
        self.traffic = {}

    def _count(self, kind, nbytes, seconds):
        rec = self.traffic.setdefault(kind, {"bytes": 0, "seconds": 0.0,
                                             "calls": 0})
        rec["bytes"] += int(nbytes)
        rec["seconds"] += seconds
        rec["calls"] += 1

    def _start(self, t):
        # the clock starts once the device has produced the operand, so
        # the seconds are the transfer's, not the kernels' before it
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def _stop(self, t, kind, nbytes, t0):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self._count(kind, nbytes, time.perf_counter() - t0)

    # -- collectives ------------------------------------------------------
    def all_reduce(self, t, kind="reduce", axis=None):
        """Sum of ``t`` over the mesh's ranks, or over the line of ranks
        along ``axis`` where one is given (in place where ``t`` is
        contiguous; returns the sum)."""
        n = self.size if axis is None else self.axis_size(axis)
        if n == 1:
            return t
        group = self.group if axis is None else self._lines[axis]
        t = t.contiguous()
        t0 = self._start(t)
        (buf,) = _host_staged(self.backend, [t])
        dist.all_reduce(buf, group=group)
        if buf is not t:
            t.copy_(buf)
        self._stop(t, kind, t.numel() * t.element_size(), t0)
        return t

    def sum_scalars(self, *values):
        """0-dim tensors summed over the mesh in one float64 all-reduce,
        as Python floats."""
        t = torch.stack([v.to(torch.float64) for v in values])
        return self.all_reduce(t, "scalars").tolist()

    def log_args(self, logfile, quiet):
        """(logfile, quiet) for a loop's printlog: only the mesh's first
        rank logs."""
        if self.index == 0:
            return logfile, quiet
        return None, True

    def all_gather(self, t, dim=0, axis=None, kind="gather"):
        """The ranks' ``t`` concatenated along ``dim`` in mesh order (the
        JAX package's tiled all_gather); over the line of ranks along
        ``axis`` where one is given."""
        n = self.size if axis is None else self.axis_size(axis)
        if n == 1:
            return t
        group = self.group if axis is None else self._lines[axis]
        t = t.contiguous()
        t0 = self._start(t)
        (buf,) = _host_staged(self.backend, [t])
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
        out = torch.cat(parts, dim=dim).to(t.device)
        self._stop(t, kind, t.numel() * t.element_size(), t0)
        return out

    def exchange(self, items, kind="halo"):
        """Point-to-point: for each (tensor, dst, src) of ``items`` send the
        tensor to mesh rank ``dst`` and receive one of its shape from mesh
        rank ``src``; every rank posts the same list. Returns the received
        tensors in order."""
        if not items:
            return []
        sends = [t.contiguous() for t, _, _ in items]
        t0 = self._start(sends[0])
        staged = _host_staged(self.backend, sends)
        recvs = [torch.empty_like(t) for t in staged]
        if self.backend == "nccl":
            ops = []
            for buf, rbuf, (_, dst, src) in zip(staged, recvs, items):
                ops.append(dist.P2POp(dist.isend, buf, dst))
                ops.append(dist.P2POp(dist.irecv, rbuf, src))
            works = dist.batch_isend_irecv(ops)
        else:
            works = []
            for tag, (buf, rbuf, (_, dst, src)) in enumerate(
                    zip(staged, recvs, items)):
                works.append(dist.isend(buf, dst, tag=tag))
                works.append(dist.irecv(rbuf, src, tag=tag))
        for w in works:
            w.wait()
        out = [r.to(t.device) for r, t in zip(recvs, sends)]
        self._stop(sends[0], kind,
                   sum(t.numel() * t.element_size() for t in sends), t0)
        return out


def make_mesh(n_src=None, n_space=1, device=None):
    """A ("src", "space") mesh over the world's ranks (the JAX package's
    make_mesh over its devices). By default every rank is on the source
    axis (the reference's source-decomposition parallelism)."""
    n_dev = device_count()
    if n_src is None:
        n_src = n_dev // n_space
    if n_src * n_space != n_dev:
        raise ValueError(f"mesh {n_src}x{n_space} != {n_dev} ranks")
    return Mesh((n_src, n_space), ("src", "space"), device=device)
