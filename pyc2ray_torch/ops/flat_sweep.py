"""The flat engine's kernels of csrc/flat_sweep.cu, bound to PyTorch.

The counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
raytrace.py::Raytracer._trace_jit: jit, a lax.fori_loop per shell bucket and
the lax.scan over batches). ops/raytrace.py's ``Raytracer`` owns the batch,
its plain functions and its tables; on CUDA tensors it calls the bindings
here, which take the tables it hands them (``KernelTables``, made by
``pack_tables``) and launch:

* ``flat_trace_sweep``: one call of the loop in C, which issues per batch
  the sweep kernel (one thread-block cluster per source, a cluster barrier
  per shell, nHI read from the flat grid), the rate pass and the ordered
  accumulate on the current stream with nothing synchronizing with the
  host: three launches a batch;
* ``flat_sweep``, ``flat_rates`` and ``flat_accumulate``: one kernel each.

Every binding refuses tensors that are not on a CUDA device, and a failure
to build or launch raises; nothing falls back. Launches are counted in
``sweep.launches`` ("flat_trace_sweep" once per trace, each kernel once per
batch). ``flat_plan`` picks the sweep's cluster size.
"""

import ctypes
from typing import NamedTuple

import torch

from . import sweep
from .sweep import CLUSTERS

__all__ = ["flat_trace_sweep", "flat_sweep", "flat_rates", "flat_accumulate",
           "flat_plan", "pack_tables", "stage_positions", "KernelTables"]

_plans = {}        # (B, device, dtype) -> cluster size


class KernelTables(NamedTuple):
    """A flat engine's tables as csrc/flat_sweep.cu's make_geom takes them."""
    tensors: tuple     # the tensors the pointers point into
    tabs: object       # ctypes array of their 13 pointers
    dims: object       # ctypes array of the 8 ints
    sizes: dict        # the same ints by name
    consts: tuple      # sig, minlogtau, dlogtau: make_geom's doubles after dr
    dtype: object      # the engine's dtype
    heat: bool         # the engine has the heat channel


def pack_tables(tensors, sizes, consts, dtype, heat):
    """KernelTables of the 13 ``tensors`` (made contiguous; the pointers
    stay valid while the result lives), the 8 ints ``sizes`` in make_geom's
    order (C, n_shells, N, max_q, lo, side, num_tau, grey) and the three
    doubles ``consts``."""
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


def flat_plan(kt, B, device):
    """The cluster size of the sweep of B sources (blocks of the kernel's
    1024 threads, one block per SM): the largest of CLUSTERS of which all B
    are resident on the card at once (cudaOccupancyMaxActiveClusters), else
    1. Made once per (B, device, dtype)."""
    key = (B, device, kt.dtype)
    if key not in _plans:
        lib = _lib()
        fn = getattr(lib, f"flat_sweep_{_check('flat_plan', kt, device)}")
        _plans[key] = 1
        for C in CLUSTERS:
            n = ctypes.c_int(0)
            err = fn(kt.tabs, kt.dims, _vals(kt, 1.0), None, None, None, B, C,
                     ctypes.byref(n), _stream(device))
            _raise_on(lib, "flat_sweep (occupancy)", err, f" at cluster {C}")
            if n.value >= B:
                _plans[key] = C
                break
    return _plans[key]


def flat_sweep(kt, nhi_flat, pos, dr, cluster=None):
    """Kernel (a), one launch: the (B, C) outgoing column density of the
    sources at ``pos`` (B, 3) over the flat HI density grid ``nhi_flat``
    (N^3,), in clusters of ``cluster`` blocks (``flat_plan``'s where
    None)."""
    dev = nhi_flat.device
    pos = stage_positions(pos, kt.sizes["N"], dev)
    sfx = _check("flat_sweep", kt, dev, nhi=nhi_flat, pos=pos)
    B = pos.shape[0]
    cluster = cluster or flat_plan(kt, B, dev)
    cd = torch.empty((B, kt.sizes["C"]), dtype=kt.dtype, device=dev)
    lib = _lib()
    err = getattr(lib, f"flat_sweep_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi_flat), _ptr(pos), _ptr(cd),
        B, cluster, None, _stream(dev))
    _raise_on(lib, "flat_sweep", err, f" (cluster {cluster})")
    sweep.launches["flat_sweep"] += 1
    return cd


def flat_rates(kt, cdo, nhi_flat, pos, flux, sdr3, dr):
    """Kernel (b), one launch: (phi, heat), the (B, C) rates per HI atom of
    the sources at ``pos`` (B, 3) with fluxes ``flux`` (B,) from their
    column densities ``cdo``, S*/dr^3 the 0-dim ``sdr3`` on the device;
    heat None without the heat channel."""
    dev = cdo.device
    pos = stage_positions(pos, kt.sizes["N"], dev)
    sfx = _check("flat_rates", kt, dev, cdo=cdo, nhi=nhi_flat, pos=pos,
                 flux=flux, sdr3=sdr3)
    phi = torch.empty_like(cdo)
    heat = torch.empty_like(cdo) if kt.heat else None
    lib = _lib()
    err = getattr(lib, f"flat_rates_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi_flat), _ptr(pos),
        _ptr(flux), _ptr(sdr3), _ptr(cdo), _ptr(phi), _ptr(heat),
        pos.shape[0], _stream(dev))
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
    positions and fluxes on the device once, three kernel launches a batch
    on the current stream. Returns (phi, heat) as (N^3,) tensors, heat None
    without the heat channel."""
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
    cluster = flat_plan(kt, B, dev)
    cd, phi = (torch.empty((B, kt.sizes["C"]), dtype=kt.dtype, device=dev)
               for _ in range(2))
    heat = torch.empty_like(phi) if kt.heat else None
    lib = _lib()
    err = getattr(lib, f"flat_trace_sweep_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi_flat), _ptr(pos),
        _ptr(flux), _ptr(sdr3), _ptr(cd), _ptr(phi), _ptr(heat),
        _ptr(phi_grid), _ptr(heat_grid), nb, B, cluster, _stream(dev))
    _raise_on(lib, "flat_trace_sweep", err, f" (cluster {cluster})")
    sweep.launches["flat_trace_sweep"] += 1
    for k in ("flat_sweep", "flat_rates", "flat_accumulate"):
        sweep.launches[k] += nb
    return phi_grid, heat_grid
