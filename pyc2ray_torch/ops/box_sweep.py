"""The box engine's kernels of csrc/box_sweep.cuh, bound to PyTorch.

The counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
raytrace_box.py::BoxRaytracer._trace_jit: jit, the shell lax.fori_loop and
the lax.scan over batches). ops/raytrace_box.py's ``BoxRaytracer`` owns the
batch, its plain functions and its tables; on CUDA tensors it calls the
bindings here, which take the tables it hands them (``BoxKernelTables``,
made by ``pack_tables``) and launch, on the current stream:

* ``box_trace_sweep``: one call of the loop in C (csrc/trace_loop.cu),
  which zeroes its rate boxes once and issues per device batch
  (consecutive sources, as many as the card holds the sweep's blocks of)
  the gather of nHI at the octahedron's valid sheet cells and the sweep (a
  block a source, a barrier a shell, the column densities of the last four
  shells in a ring in shared memory or in global memory), then per batch
  of B the rate pass
  (the rated cells straight into the batch's rate boxes) and the ordered
  accumulate over the rated cells, with nothing synchronizing with the
  host;
* ``box_gather``, ``box_sweep`` and ``box_rates``: one kernel each.

Every binding refuses tensors that are not on a CUDA device, and a failure
to build or launch raises; nothing falls back. Launches are counted in
``sweep.launches`` ("box_trace_sweep" once per trace, each kernel once per
launch, inside the loop by the loop where it issues them, the accumulate as
"accumulate_boxes"). ``box_plan`` picks the
sweep's block size, the placement of its column densities and the sources
of a device batch.
"""

import ctypes
from typing import NamedTuple

import torch

from . import sweep
from .sweep import SMEM_MAX
from .trace_loop import stage_positions

__all__ = ["box_trace_sweep", "box_gather", "box_sweep", "box_rates",
           "box_plan", "pack_tables", "BoxKernelTables", "SWEEP_THREADS"]

SWEEP_THREADS = (128, 256, 512, 1024)   # the sweep's blocks box_plan weighs
RING_SLOTS = 4          # shells in the ring (csrc/box_sweep.cuh's kRingSlots)
LOOP_KERNELS = ("box_gather", "box_sweep", "box_rates", "accumulate_boxes")
                        # the loop's kernels, in the order it counts them
MAX_BATCH = 65535       # most sources a launch (the grid's second extent)
SCRATCH_BYTES = 1 << 30   # most bytes of one (sources, n_v) scratch buffer
_held = {}              # (threads, ring, device, dtype, max_shell) -> the
                        # sweep's blocks held at once


class BoxKernelTables(NamedTuple):
    """A box engine's tables as csrc/box_sweep.cuh's make_geom takes
    them."""
    tensors: tuple     # the tensors the pointers point into
    tabs: object       # ctypes array of their 13 pointers
    dims: object       # ctypes array of the 6 ints
    sizes: dict        # the same ints by name
    sig: float
    dtype: object      # the engine's dtype
    heat: bool         # the engine has the heat channel


def pack_tables(ints, floats, sizes, sig, dtype, heat):
    """BoxKernelTables of the int32 tensors ``ints`` (shell, voff, corner,
    rv, rcell), the tensors ``floats`` of the engine's dtype (sw, path,
    diag, geominv, visit, bins_s, bins_w, bins_wh), all made contiguous (the
    pointers stay valid while the result lives), and the ints ``sizes``
    (n_v, Q, Dc, n_r, E, P, max_shell) in make_geom's order."""
    tensors = tuple(t.contiguous() for t in (*ints, *floats))
    return BoxKernelTables(
        tensors,
        (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors]),
        (ctypes.c_int * len(sizes))(*sizes.values()), dict(sizes),
        float(sig), dtype, bool(heat))


def _vals(kt, dr):
    """make_geom's doubles: dr, sig."""
    return (ctypes.c_double * 2)(float(dr), kt.sig)


def _lib():
    from ._build import load
    return load("trace_loop")


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _index(device):
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _check(name, kt, device, **tensors):
    """Every tensor contiguous on one CUDA device, the tables' too, in the
    engine's dtype (the positions int32) and of its shape (name: (tensor,
    shape)). Returns the function suffix."""
    dt = kt.dtype
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if dt not in sweep._SUFFIX:
        raise ValueError(f"{name}: unsupported dtype {dt}")
    on = kt.tensors[0].device
    if on.type != "cuda" or _index(on) != _index(device):
        raise ValueError(f"{name}: the tables are on {on}, the tensors on "
                         f"{device}")
    for key, spec in tensors.items():
        if spec is None or spec[0] is None:
            continue
        t, shape = spec
        want = torch.int32 if key == "pos" else dt
        if (t.device != device or t.dtype != want or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device} (contiguous: "
                             f"{t.is_contiguous()}), expected contiguous "
                             f"{tuple(shape)} {want} on {device}")
    return sweep._SUFFIX[dt]


def _raise_on(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.error_string(err)!r})")


def _frame_shape(kt):
    return (kt.sizes["P"],) * 3


def ring_bytes(kt):
    """Bytes of the sweep's ring: RING_SLOTS shells of the largest."""
    return RING_SLOTS * kt.sizes["max_shell"] * kt.dtype.itemsize


def sweep_threads(kt):
    """The sweep's blocks box_plan weighs: SWEEP_THREADS, none larger than
    the largest shell's cells in whole warps."""
    top = -(-kt.sizes["max_shell"] // 32) * 32
    return sorted({min(t, top) for t in SWEEP_THREADS})


def _resident(kt, threads, ring, device):
    """The sweep's blocks of ``threads`` threads in placement ``ring`` the
    card holds at once (asked once)."""
    key = (threads, ring, device, kt.dtype, kt.sizes["max_shell"])
    if key not in _held:
        sfx = _check("box_plan", kt, device)
        lib = _lib()
        held = ctypes.c_int(0)
        err = getattr(lib, f"box_resident_{sfx}")(
            kt.tabs, kt.dims, _vals(kt, 1.0), threads, int(ring),
            ctypes.byref(held))
        _raise_on(lib, "box_sweep (occupancy)", err)
        _held[key] = held.value
    return _held[key]


def box_plan(kt, ns, B, device, threads=None, ring=None):
    """(threads, ring, dev_batch, launches) of a trace of ns sources in
    batches of B. For each placement of the sweep's column densities that
    fits (the ring where ``ring_bytes`` fits SMEM_MAX, global memory
    always; ``ring`` forces one) and each block of ``sweep_threads`` (or
    ``threads``), the card holds some number of blocks at once; the plan
    keeps the most threads busy (sources in flight times their block),
    then the ring, then the smaller block (chip_smoke 3f and 4h measure
    the forms at the bench's 2048 sources and at one). The device batch:
    as many sources as the card holds, a multiple of B, at most ns (rounded
    up to B) and SCRATCH_BYTES a scratch buffer. ``launches``: each
    kernel's launches over the trace."""
    cap = SCRATCH_BYTES // (kt.sizes["n_v"] * kt.dtype.itemsize)
    want = -(-ns // B) * B
    best = None
    for r in (False, True) if ring is None else (bool(ring),):
        if r and ring_bytes(kt) > SMEM_MAX:
            continue
        for t in [int(threads)] if threads else sweep_threads(kt):
            held = min(_resident(kt, t, r, device), cap, MAX_BATCH)
            rank = (min(want, held) * t, r, -t)
            if best is None or rank > best[0]:
                best = (rank, t, r, held)
    if best is None:
        raise ValueError(f"box_plan: a ring of {ring_bytes(kt)} bytes does "
                         f"not fit a block's {SMEM_MAX}")
    _, threads, ring, held = best
    dev_batch = min(max(B, held // B * B), want)
    n_dev = -(-ns // dev_batch)
    nb = -(-ns // B)
    return threads, ring, dev_batch, dict(box_gather=n_dev, box_sweep=n_dev,
                                          box_rates=nb, accumulate_boxes=nb)


def box_gather(kt, frame, pos):
    """The gather kernel, one launch: the (n, n_v) nHI at the valid sheet
    cells of the sources whose boxes start at ``pos`` (n, 3) in the padded
    frame ``frame`` (P, P, P)."""
    dev = frame.device
    pos = stage_positions(torch.as_tensor(pos).reshape(1, -1, 3),
                          _frame_shape(kt), kt.sizes["Dc"], dev)[0]
    n = pos.shape[0]
    sfx = _check("box_gather", kt, dev, frame=(frame, _frame_shape(kt)),
                 pos=(pos, (n, 3)))
    out = torch.empty((n, kt.sizes["n_v"]), dtype=kt.dtype, device=dev)
    lib = _lib()
    err = getattr(lib, f"box_gather_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, 1.0), _ptr(frame), _ptr(pos), _ptr(out),
        n, _stream(dev))
    _raise_on(lib, "box_gather", err)
    sweep.launches["box_gather"] += 1
    return out


def box_sweep(kt, nhi, dr, threads=None, ring=None, out=None):
    """The sweep kernel, one launch, a block a source: (cdin, cdout), the
    (n, n_v) incoming and outgoing column densities of the sources whose
    valid sheet cells hold the nHI ``nhi`` (n, n_v), in blocks of
    ``threads`` threads, the last shells' column densities in the ring in
    shared memory (``ring``) or in global memory (``box_plan``'s for n
    sources where None); ``out`` the pair to write into."""
    dev = nhi.device
    n, n_v = nhi.shape[0], kt.sizes["n_v"]
    cdin, cd = out if out is not None else (torch.empty_like(nhi)
                                            for _ in range(2))
    sfx = _check("box_sweep", kt, dev, nhi=(nhi, (n, n_v)),
                 cdin=(cdin, (n, n_v)), cd=(cd, (n, n_v)))
    threads, ring = box_plan(kt, n, 1, dev, threads, ring)[:2]
    lib = _lib()
    err = getattr(lib, f"box_sweep_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi), _ptr(cd), _ptr(cdin), n,
        threads, int(ring), _stream(dev))
    _raise_on(lib, "box_sweep", err)
    sweep.launches["box_sweep"] += 1
    return cdin, cd


def box_rates(kt, cdin, nhi, flux, sdr3, dr, out=None):
    """The rate kernel, one launch: (phi, heat), the (n, Dc, Dc, Dc) rate
    boxes per HI atom of n sources with fluxes ``flux`` (n,) from their
    incoming column densities ``cdin`` and nHI ``nhi`` (n, n_v), S*/dr^3
    the 0-dim ``sdr3`` on the device; heat None without the heat channel.
    The boxes start as zeros (``out``: the pair to write into instead), and
    the kernel writes the rated cells, a thread a cell and source."""
    dev = cdin.device
    n, n_v, Dc = cdin.shape[0], kt.sizes["n_v"], kt.sizes["Dc"]
    if out is None:
        out = (torch.zeros((n, Dc, Dc, Dc), dtype=kt.dtype, device=dev),
               torch.zeros((n, Dc, Dc, Dc), dtype=kt.dtype, device=dev)
               if kt.heat else None)
    phi, heat = out
    box = (n, Dc, Dc, Dc)
    sfx = _check("box_rates", kt, dev, cdin=(cdin, (n, n_v)),
                 nhi=(nhi, (n, n_v)), flux=(flux, (n,)), sdr3=(sdr3, ()),
                 phi=(phi, box), heat=(heat, box))
    if (heat is None) == kt.heat:
        raise ValueError("box_rates: a heat box goes with the heat channel")
    lib = _lib()
    err = getattr(lib, f"box_rates_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi), _ptr(cdin), _ptr(flux),
        _ptr(sdr3), _ptr(phi), _ptr(heat), n, _stream(dev))
    _raise_on(lib, "box_rates", err)
    sweep.launches["box_rates"] += 1
    return phi, heat


def box_trace_sweep(kt, frame, pos_b, flux_b, sdr3, dr):
    """The trace of the batches ``pos_b`` (nb, B, 3) (box corners in the
    padded frame), ``flux_b`` (nb, B) over the padded nHI frame ``frame``
    (P, P, P), S*/dr^3 the 0-dim ``sdr3`` on the device: one call of the
    loop of csrc/trace_loop.cu, the positions and fluxes on the device
    once, on the current stream the rate boxes zeroed, then per device
    batch (``box_plan``'s, with its block and placement of the sweep) the
    gather and the sweep, and per batch of B the rate pass and the ordered
    accumulate over the rated cells. Each kernel's launches are those the
    loop reports it issued. Returns the padded (phi, heat) frames, heat
    None without the heat channel."""
    dev = frame.device
    pos = stage_positions(pos_b, _frame_shape(kt), kt.sizes["Dc"], dev)
    nb, B = pos.shape[:2]
    flux = torch.as_tensor(flux_b).to(device=dev, dtype=kt.dtype)
    flux = flux.contiguous()
    sfx = _check("box_trace_sweep", kt, dev, frame=(frame, _frame_shape(kt)),
                 pos=(pos, (nb, B, 3)), flux=(flux, (nb, B)),
                 sdr3=(sdr3, ()))
    frames = [torch.zeros_like(frame),
              torch.zeros_like(frame) if kt.heat else None]
    if nb == 0:
        return frames
    threads, ring, dev_batch, _ = box_plan(kt, nb * B, B, dev)
    n_v, Dc = kt.sizes["n_v"], kt.sizes["Dc"]
    nhi, cd, cdin = (torch.empty((dev_batch, n_v), dtype=kt.dtype,
                                 device=dev) for _ in range(3))
    phi = torch.empty((B, Dc, Dc, Dc), dtype=kt.dtype, device=dev)
    heat = torch.empty_like(phi) if kt.heat else None
    issued = (ctypes.c_int * len(LOOP_KERNELS))()
    lib = _lib()
    err = getattr(lib, f"box_trace_sweep_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(frame), _ptr(pos), _ptr(flux),
        _ptr(sdr3), _ptr(nhi), _ptr(cd), _ptr(cdin), _ptr(phi), _ptr(heat),
        _ptr(frames[0]), _ptr(frames[1]), nb, B, dev_batch, threads,
        int(ring), issued, _stream(dev))
    for k, v in zip(LOOP_KERNELS, issued):
        sweep.launches[k] += v
    _raise_on(lib, "box_trace_sweep", err)
    sweep.launches["box_trace_sweep"] += 1
    return frames
