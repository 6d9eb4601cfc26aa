"""The flat engine's kernels of csrc/flat_sweep.cu, bound to PyTorch.

The counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
raytrace.py::Raytracer._trace_jit: jit, a lax.fori_loop per shell bucket and
the lax.scan over batches). ops/raytrace.py's ``Raytracer`` owns the batch,
its plain functions and its tables; on CUDA tensors it calls the bindings
here, which take the tables it hands them (``KernelTables``, made by
``pack_tables``) and launch:

* ``flat_trace_sweep``: one call of the loop in C, which zeroes its rate
  scratch once and issues per device batch (consecutive sources, as many
  as the card holds the clusters of) the gather of nHI from the flat grid
  (staged through shared memory, reads and writes contiguous), the sweep
  kernel (one thread-block cluster per source, a cluster barrier per
  shell, the column densities of the last shells in a ring in the
  cluster's distributed shared memory or in global memory) and the rate
  pass over the rated cells (from the gathered nHI), then the ordered
  accumulate a batch at a time, on the current stream with nothing
  synchronizing with the host;
* ``flat_gather``, ``flat_rates`` and ``flat_accumulate``: one kernel each;
  ``flat_sweep``: the gather and the sweep, a launch each.

Every binding refuses tensors that are not on a CUDA device, and a failure
to build or launch raises; nothing falls back. Launches are counted in
``sweep.launches`` ("flat_trace_sweep" once per trace, each kernel once per
launch). ``flat_plan`` picks the sweep's cluster size and the placement of
its column densities, ``loop_plan`` the loop's device batch.
"""

import ctypes
from typing import NamedTuple

import torch

from . import sweep
from .sweep import CLUSTERS, SMEM_MAX

__all__ = ["flat_trace_sweep", "flat_gather", "flat_sweep", "flat_rates",
           "flat_accumulate", "flat_plan", "loop_plan", "pack_tables",
           "stage_positions", "KernelTables"]

_plans = {}        # (B, device, dtype, ring's sizes) -> (cluster, shared,
                   # clusters held at once)
CHUNKS = 16        # chunks of a shell (csrc/flat_sweep.cuh's kChunks)
KMAX_BATCH = 4096  # most sources a launch (csrc/flat_sweep.cuh's kMaxBatch)


class KernelTables(NamedTuple):
    """A flat engine's tables as csrc/flat_sweep.cuh's make_geom takes
    them."""
    tensors: tuple     # the tensors the pointers point into
    tabs: object       # ctypes array of their 20 pointers
    dims: object       # ctypes array of the 13 ints
    sizes: dict        # the same ints by name
    consts: tuple      # sig, minlogtau, dlogtau: make_geom's doubles after dr
    dtype: object      # the engine's dtype
    heat: bool         # the engine has the heat channel


def pack_tables(tensors, sizes, consts, dtype, heat):
    """KernelTables of the 20 ``tensors`` (made contiguous; the pointers
    stay valid while the result lives), the 13 ints ``sizes`` in
    make_geom's order (C, n_shells, N, max_q, lo, side, num_tau, grey,
    depth, max_u, n_blk, g_cells, n_rated) and the three doubles
    ``consts``."""
    tensors = tuple(t.contiguous() for t in tensors)
    return KernelTables(
        tensors,
        (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors]),
        (ctypes.c_int * len(sizes))(*sizes.values()), dict(sizes),
        tuple(float(c) for c in consts), dtype, bool(heat))


def stage_positions(pos, N, device):
    """Source positions as the kernels take them: int32 in [0, N) on
    ``device``, contiguous (torch.remainder, as the plain gather wraps
    them)."""
    pos = torch.as_tensor(pos).to(device=device, dtype=torch.int64)
    return torch.remainder(pos, N).to(torch.int32).contiguous()


def _vals(kt, dr):
    """make_geom's doubles: dr, sig, minlogtau, dlogtau."""
    return (ctypes.c_double * 4)(float(dr), *kt.consts)


def _lib():
    from ._build import load
    return load("flat_sweep")


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _index(device):
    """The index of a CUDA device, the current one where it has none."""
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _check(name, kt, device, **tensors):
    """Every tensor contiguous on one CUDA device, the tables' too, in the
    engine's dtype (the positions int32). Returns the function suffix."""
    dt = kt.dtype
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported dtype {dt}")
    on = kt.tensors[0].device
    if on.type != "cuda" or _index(on) != _index(device):
        raise ValueError(f"{name}: the tables are on {on}, the tensors on "
                         f"{device}")
    for key, t in tensors.items():
        if t is None:
            continue
        want = torch.int32 if key == "pos" else dt
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device} "
                             f"(contiguous: {t.is_contiguous()}), expected "
                             f"contiguous {want} on {device}")
    if kt.sizes["grey"] and kt.heat:
        raise ValueError(f"{name}: the grey analytic rates have no heat "
                         "channel")
    return "f32" if dt == torch.float32 else "f64"


def _raise_on(lib, name, err, detail=""):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.error_string(err)!r}){detail}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ring_bytes(kt, cluster):
    """Bytes of a block's ring of the sweep in a cluster of ``cluster``
    blocks: depth slots of CHUNKS / cluster chunks of max_u values."""
    sz = kt.sizes
    return sz["depth"] * (CHUNKS // cluster) * sz["max_u"] * \
        torch.finfo(kt.dtype).bits // 8



def flat_plan(kt, n, device):
    """(cluster, shared, held): the plan of a sweep of n sources at once
    (blocks of the kernel's 1024 threads, one block per SM). For each
    cluster size of CLUSTERS and each placement of the column densities
    that fits (the ring in distributed shared memory where a block's ring
    fits SMEM_MAX bytes, global memory always), the card holds ``held``
    clusters at once (cudaOccupancyMaxActiveClusters); the plan keeps the
    most sources in flight, min(n, held), then the ring over global memory,
    then the larger cluster. Made once per (n, device, dtype, ring's
    sizes)."""
    key = (n, device, kt.dtype, kt.sizes["depth"], kt.sizes["max_u"])
    if key not in _plans:
        lib = _lib()
        fn = getattr(lib, f"flat_sweep_{_check('flat_plan', kt, device)}")
        best = None
        for C in CLUSTERS:
            for shared in (True, False):
                if shared and ring_bytes(kt, C) > SMEM_MAX:
                    continue
                held = ctypes.c_int(0)
                err = fn(kt.tabs, kt.dims, _vals(kt, 1.0), None, None, None,
                         None, max(1, min(n, KMAX_BATCH)), C, int(shared),
                         ctypes.byref(held), _stream(device))
                _raise_on(lib, "flat_sweep (occupancy)", err,
                          f" at cluster {C}")
                rank = (min(n, held.value), shared, C)
                if best is None or rank > best[0]:
                    best = (rank, (C, shared, held.value))
        _plans[key] = best[1]
    return _plans[key]


def loop_plan(kt, nb, B, device):
    """The loop's plan of nb batches of B sources: (cluster, shared,
    dev_batch, launches). The loop sweeps ``dev_batch`` consecutive sources
    at once (flat_plan's clusters held at once, at most one GiB of scratch a
    buffer) and accumulates them B at a time; ``launches`` counts each
    kernel's launches over the trace."""
    ns = nb * B
    cluster, shared, held = flat_plan(kt, ns, device)
    cap = (1 << 30) // (kt.sizes["C"] * torch.finfo(kt.dtype).bits // 8)
    dev_batch = max(1, min(ns, held, cap, KMAX_BATCH))
    n_dev = -(-ns // dev_batch)
    last = ns - (n_dev - 1) * dev_batch
    n_acc = (n_dev - 1) * -(-dev_batch // B) + -(-last // B)
    launches = dict(flat_gather=n_dev, flat_sweep=n_dev, flat_rates=n_dev,
                    flat_accumulate=n_acc)
    return cluster, shared, dev_batch, launches


def flat_gather(kt, nhi_flat, pos):
    """The gather kernel, one launch: the (B, C) HI density in the
    octahedral layout of the sources at ``pos`` (B, 3) over the flat HI
    density grid ``nhi_flat`` (N^3,), a block per gather block of the
    tables and source."""
    dev = nhi_flat.device
    pos = stage_positions(pos, kt.sizes["N"], dev)
    sfx = _check("flat_gather", kt, dev, nhi=nhi_flat, pos=pos)
    out = torch.empty((pos.shape[0], kt.sizes["C"]), dtype=kt.dtype,
                      device=dev)
    lib = _lib()
    err = getattr(lib, f"flat_gather_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, 1.0), _ptr(nhi_flat), _ptr(pos),
        _ptr(out), pos.shape[0], _stream(dev))
    _raise_on(lib, "flat_gather", err)
    sweep.launches["flat_gather"] += 1
    return out


def flat_sweep(kt, nhi_flat, pos, dr, cluster=None, shared=None):
    """The gather and the sweep kernel, a launch each: the (B, C) outgoing
    column density of the sources at ``pos`` (B, 3) over the flat HI
    density grid ``nhi_flat`` (N^3,), in clusters of ``cluster`` blocks with
    the column densities in the shared ring (``shared``) or global memory
    (``flat_plan``'s where None)."""
    dev = nhi_flat.device
    pos = stage_positions(pos, kt.sizes["N"], dev)
    sfx = _check("flat_sweep", kt, dev, nhi=nhi_flat, pos=pos)
    B = pos.shape[0]
    plan = flat_plan(kt, B, dev)
    cluster = cluster or plan[0]
    shared = plan[1] if shared is None else bool(shared)
    cd, nhi_octa = (torch.empty((B, kt.sizes["C"]), dtype=kt.dtype,
                                device=dev) for _ in range(2))
    lib = _lib()
    err = getattr(lib, f"flat_sweep_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi_flat), _ptr(pos),
        _ptr(nhi_octa), _ptr(cd), B, cluster, int(shared), None,
        _stream(dev))
    _raise_on(lib, "flat_sweep", err, f" (cluster {cluster}, "
              f"{'shared' if shared else 'global'} column densities)")
    sweep.launches["flat_gather"] += 1
    sweep.launches["flat_sweep"] += 1
    return cd


def flat_rates(kt, cdo, nhi_octa, flux, sdr3, dr):
    """The rate kernel, one launch: (phi, heat), the (B, C) rates per HI
    atom of B sources with fluxes ``flux`` (B,) from their column densities
    ``cdo`` and their gathered HI densities ``nhi_octa`` (B, C), S*/dr^3
    the 0-dim ``sdr3`` on the device; heat None without the heat channel.
    The outputs start as zeros (one contiguous store each), and the kernel
    writes the rated cells, a thread a cell for several sources."""
    dev = cdo.device
    sfx = _check("flat_rates", kt, dev, cdo=cdo, nhi_octa=nhi_octa,
                 flux=flux, sdr3=sdr3)
    if nhi_octa.shape != cdo.shape or cdo.dim() != 2 or \
            cdo.shape[1] != kt.sizes["C"] or flux.shape != cdo.shape[:1]:
        raise ValueError(f"flat_rates: column densities {tuple(cdo.shape)}, "
                         f"nHI {tuple(nhi_octa.shape)} and fluxes "
                         f"{tuple(flux.shape)}, expected (B, "
                         f"{kt.sizes['C']}) twice and (B,)")
    phi = torch.zeros_like(cdo)
    heat = torch.zeros_like(cdo) if kt.heat else None
    lib = _lib()
    err = getattr(lib, f"flat_rates_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi_octa), _ptr(flux),
        _ptr(sdr3), _ptr(cdo), _ptr(phi), _ptr(heat), cdo.shape[0],
        _stream(dev))
    _raise_on(lib, "flat_rates", err)
    sweep.launches["flat_rates"] += 1
    return phi, heat


def flat_accumulate(kt, phi_grid, heat_grid, pos, phi, heat):
    """Kernel (c), one launch: adds the (B, C) rates ``phi`` (and ``heat``)
    of the sources at ``pos`` (B, 3) into the flat grids ``phi_grid`` (and
    ``heat_grid``) in place, source after source."""
    dev = phi_grid.device
    pos = stage_positions(pos, kt.sizes["N"], dev)
    sfx = _check("flat_accumulate", kt, dev, phi_grid=phi_grid,
                 heat_grid=heat_grid, pos=pos, phi=phi, heat=heat)
    lib = _lib()
    err = getattr(lib, f"flat_accumulate_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, 1.0), _ptr(pos), _ptr(phi), _ptr(heat),
        _ptr(phi_grid), _ptr(heat_grid), pos.shape[0], _stream(dev))
    _raise_on(lib, "flat_accumulate", err)
    sweep.launches["flat_accumulate"] += 1


def flat_trace_sweep(kt, nhi_flat, pos_b, flux_b, sdr3, dr):
    """The trace of the batches ``pos_b`` (nb, B, 3), ``flux_b`` (nb, B)
    over the flat HI density grid ``nhi_flat`` (N^3,), S*/dr^3 the 0-dim
    ``sdr3`` on the device: one call of the loop of csrc/flat_sweep.cu, the
    positions and fluxes on the device once, on the current stream the rate
    scratch zeroed, then per device batch of consecutive sources
    (``loop_plan``: as many as the card holds the clusters of) the gather,
    the sweep and the rate pass, then the ordered accumulate a batch of B
    at a time. Returns (phi, heat) as
    (N^3,) tensors, heat None without the heat channel."""
    dev = nhi_flat.device
    pos = stage_positions(pos_b, kt.sizes["N"], dev)
    flux = torch.as_tensor(flux_b).to(device=dev, dtype=kt.dtype)
    flux = flux.contiguous()
    sfx = _check("flat_trace_sweep", kt, dev, nhi=nhi_flat, pos=pos,
                 flux=flux, sdr3=sdr3)
    if pos.dim() != 3 or pos.shape[-1] != 3 or \
            flux.shape != pos.shape[:2]:
        raise ValueError(f"flat_trace_sweep: positions {tuple(pos.shape)} "
                         f"and fluxes {tuple(flux.shape)}, expected "
                         "(nb, B, 3) and (nb, B)")
    if nhi_flat.numel() != kt.sizes["N"] ** 3:
        raise ValueError(f"flat_trace_sweep: {nhi_flat.numel()} cells, "
                         f"expected {kt.sizes['N'] ** 3}")
    phi_grid = torch.zeros_like(nhi_flat)
    heat_grid = torch.zeros_like(nhi_flat) if kt.heat else None
    nb, B = pos.shape[:2]
    if nb == 0:
        return phi_grid, heat_grid
    cluster, shared, dev_batch, launches = loop_plan(kt, nb, B, dev)
    nhi_octa, cd, phi = (torch.empty((dev_batch, kt.sizes["C"]),
                                     dtype=kt.dtype, device=dev)
                         for _ in range(3))
    heat = torch.empty_like(phi) if kt.heat else None
    lib = _lib()
    err = getattr(lib, f"flat_trace_sweep_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi_flat), _ptr(pos),
        _ptr(flux), _ptr(sdr3), _ptr(nhi_octa), _ptr(cd), _ptr(phi),
        _ptr(heat), _ptr(phi_grid), _ptr(heat_grid), nb * B, dev_batch, B,
        cluster, int(shared), _stream(dev))
    _raise_on(lib, "flat_trace_sweep", err, f" (cluster {cluster}, "
              f"{'shared' if shared else 'global'} column densities)")
    sweep.launches["flat_trace_sweep"] += 1
    for k, v in launches.items():
        sweep.launches[k] += v
    return phi_grid, heat_grid
