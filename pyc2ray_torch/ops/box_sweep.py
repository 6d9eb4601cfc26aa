"""The box engine's kernels of csrc/box_sweep.cuh, bound to PyTorch.

The counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
raytrace_box.py::BoxRaytracer._trace_jit: jit, the shell lax.fori_loop and
the lax.scan over batches). ops/raytrace_box.py's ``BoxRaytracer`` owns the
batch, its plain functions and its tables; on CUDA tensors it calls the
bindings here, which take the tables it hands them (``BoxKernelTables``,
made by ``pack_tables``) and launch, on the current stream:

* ``box_trace_sweep``: one call of the loop in C (csrc/trace_loop.cu),
  which zeroes a chunk's rate boxes once and issues per device batch
  (consecutive sources, as many as the card holds the sweep's blocks of)
  the gather of nHI at the octahedron's valid sheet cells and the sweep (a
  block a source, a barrier a shell, the column densities of the last four
  shells in a ring of the block's own in global memory, read through L1, or
  in shared memory), then per chunk of RATE_CHUNK batches of B the rate
  pass (a thread a rated cell and source, the bins as kernel parameters,
  straight into the chunk's rate boxes) and per batch the ordered
  accumulate over the rated cells, with nothing synchronizing with the
  host;
* ``box_gather``, ``box_sweep`` (cdin alone, as the plain ``_sweep``) and
  ``box_rates``: one kernel each.

``box_plan`` picks the sweep's block, the placement of its ring, the
sources of a device batch and the rate pass's chunk; the forms that lost
live in csrc/box_probe.cu, which only chip_smoke.py's design steps build.
Every binding refuses tensors that are not on a CUDA device, and a
failure to build or launch raises; nothing falls back. Launches are counted
in ``sweep.launches`` ("box_trace_sweep" once per trace, each kernel once
per launch, inside the loop by the loop where it issues them, the
accumulate as "accumulate_boxes").
"""

import ctypes
from typing import NamedTuple

import torch

from . import sweep
from .sweep import SMEM_MAX
from .trace_loop import stage_positions

__all__ = ["box_trace_sweep", "box_gather", "box_sweep", "box_rates",
           "box_plan", "pack_tables", "BoxKernelTables", "BoxPlan",
           "SWEEP_THREADS"]

SWEEP_THREADS = (128, 256, 512, 1024)   # the sweep's blocks box_plan weighs
RING_SLOTS = 4          # shells in the ring (csrc/box_sweep.cuh's kRingSlots)
LOOP_KERNELS = ("box_gather", "box_sweep", "box_rates", "accumulate_boxes")
                        # the loop's kernels, in the order it counts them
MAX_BATCH = 65535       # most sources a launch (the grid's second extent)
SCRATCH_BYTES = 1 << 30   # most bytes of one scratch buffer: (sources, n_v)
                          # values, the sweep's rings, a chunk's rate boxes
RATE_CHUNK = 8          # batches a rate launch covers (chip_smoke 3f's (d))
_held = {}              # (threads, shared, device, dtype, max_shell) -> the
                        # sweep's blocks held at once


class BoxKernelTables(NamedTuple):
    """A box engine's tables as csrc/box_sweep.cuh's make_geom takes
    them."""
    tensors: tuple     # the tensors the pointers point into
    tabs: object       # ctypes array of their 13 pointers
    dims: object       # ctypes array of the 7 ints
    sizes: dict        # the same ints by name
    sig: float
    dtype: object      # the engine's dtype
    heat: bool         # the engine has the heat channel
    bins: object       # ctypes array of the 3 E bins (s, w, wh) as doubles,
                       # each exact in the engine's dtype


class BoxPlan(NamedTuple):
    """The box loop's plan (``box_plan``)."""
    threads: int       # the sweep's block
    shared: bool       # the sweep's ring in shared memory (else global)
    blocks: int        # the sweep's blocks a launch: at most the card holds
                       # and the global rings' scratch allows
    dev_batch: int     # sources a device batch (a multiple of B)
    chunk: int         # batches of B a rate launch
    launches: dict     # each kernel's launches over the trace


def pack_tables(ints, floats, sizes, sig, dtype, heat):
    """BoxKernelTables of the int32 tensors ``ints`` (shell, voff, corner,
    rv, rcell), the tensors ``floats`` of the engine's dtype (sw, path,
    diag, geominv, visit, bins_s, bins_w, bins_wh), all made contiguous (the
    pointers stay valid while the result lives), and the ints ``sizes``
    (n_v, Q, Dc, n_r, E, P, max_shell) in make_geom's order. The bins are
    also kept on the host for the rate pass's parameters."""
    tensors = tuple(t.contiguous() for t in (*ints, *floats))
    bins = torch.cat([t.reshape(-1) for t in floats[-3:]]).cpu().double()
    return BoxKernelTables(
        tensors,
        (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors]),
        (ctypes.c_int * len(sizes))(*sizes.values()), dict(sizes),
        float(sig), dtype, bool(heat),
        (ctypes.c_double * bins.numel())(*bins.tolist()))


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
    """Bytes of one block's ring: RING_SLOTS shells of the largest."""
    return RING_SLOTS * kt.sizes["max_shell"] * kt.dtype.itemsize


def sweep_threads(kt):
    """The sweep's blocks box_plan weighs: SWEEP_THREADS, none larger than
    the largest shell's cells in whole warps."""
    top = -(-kt.sizes["max_shell"] // 32) * 32
    return sorted({min(t, top) for t in SWEEP_THREADS})


def _resident(kt, threads, shared, device):
    """The sweep's blocks of ``threads`` threads, the ring in shared memory
    (``shared``) or global, the card holds at once (asked once)."""
    key = (threads, shared, device, kt.dtype, kt.sizes["max_shell"])
    if key not in _held:
        sfx = _check("box_plan", kt, device)
        lib = _lib()
        held = ctypes.c_int(0)
        err = getattr(lib, f"box_resident_{sfx}")(
            kt.tabs, kt.dims, _vals(kt, 1.0), threads, int(shared),
            ctypes.byref(held))
        _raise_on(lib, "box_sweep (occupancy)", err)
        _held[key] = held.value
    return _held[key]


def _dev_batch(kt, ns, B, held):
    """Sources a device batch: the trace's ns sources (rounded up to B) in
    as few device batches as allow at most ``held`` sources a batch (at
    least B), a (sources, n_v) scratch within SCRATCH_BYTES and MAX_BATCH,
    of equal size rounded up to B."""
    cap = min(SCRATCH_BYTES // (kt.sizes["n_v"] * kt.dtype.itemsize),
              MAX_BATCH, max(held, B)) // B * B
    if cap < B:
        raise ValueError(f"box_plan: {B} sources of {kt.sizes['n_v']} "
                         f"valid cells exceed {SCRATCH_BYTES} bytes")
    want = -(-ns // B) * B
    per = -(-want // -(-want // cap))
    return -(-per // B) * B


def box_plan(kt, ns, B, device, threads=None, ring=None):
    """BoxPlan of a trace of ns sources in batches of B.

    The sweep: a block a source, the ring in shared memory where it fits a
    block or in global memory (``ring`` forces one), a block of
    ``sweep_threads`` (or ``threads``); the card holds some number of
    blocks of each at once. The device batch (``_dev_batch``): as many
    sources as those blocks hold, the trace's sources split into as few
    device batches as that and the scratch allow, of equal size. The plan
    keeps the most threads busy over the device batch's sources, then the
    shared ring, then the smaller block (the forms chip_smoke 3f and 4h
    time; the ring at 1024 threads wins for 4h's one source; several
    sources a thread or a block and a persistent grid lost at both). Its
    blocks: at most the card holds and, in the global placement, as many
    rings as SCRATCH_BYTES holds (fewer than the sources: each block
    sweeps source after source in its own ring). The rate pass: one
    launch a chunk of RATE_CHUNK batches (fewer where a device batch or the
    trace holds fewer), its rate boxes within SCRATCH_BYTES. ``launches``:
    each kernel's launches over the trace. ``threads`` and ``ring`` serve
    the design steps alone."""
    best = None
    for sh in (False, True) if ring is None else (bool(ring),):
        if sh and ring_bytes(kt) > SMEM_MAX:
            continue
        for t in [int(threads)] if threads else sweep_threads(kt):
            held = _resident(kt, t, sh, device)
            dev_batch = _dev_batch(kt, ns, B, held)
            busy = min(dev_batch, held)
            if not sh:
                busy = min(busy, SCRATCH_BYTES // ring_bytes(kt))
            if busy < 1:
                continue
            rank = (busy * t, sh, -t)
            if best is None or rank > best[0]:
                best = (rank, t, sh, busy, dev_batch)
    if best is None:
        raise ValueError(f"box_plan: no form of the sweep fits (ring "
                         f"{ring}, threads {threads})")
    _, threads, shared, busy, dev_batch = best
    nb = -(-ns // B)
    box_bytes = B * kt.sizes["Dc"] ** 3 * kt.dtype.itemsize
    chunk = max(1, min(RATE_CHUNK, nb, dev_batch // B,
                       SCRATCH_BYTES // box_bytes))
    n_dev = -(-nb * B // dev_batch)
    rates = sum(-(-min(dev_batch, nb * B - k * dev_batch) // (chunk * B))
                for k in range(n_dev))
    return BoxPlan(threads, shared, busy, dev_batch, chunk,
                   dict(box_gather=n_dev, box_sweep=n_dev, box_rates=rates,
                        accumulate_boxes=nb))


def _ring(kt, plan, device):
    """The sweep's rings in global memory (``plan``'s blocks), None in the
    shared placement."""
    if plan.shared:
        return None
    n = plan.blocks * ring_bytes(kt) // kt.dtype.itemsize
    return torch.empty((n,), dtype=kt.dtype, device=device)


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
    """The sweep kernel, one launch: cdin, the (n, n_v) incoming column
    densities of the sources whose valid sheet cells hold the nHI ``nhi``
    (n, n_v), in ``box_plan``'s form for n sources (``threads`` and
    ``ring`` override its choice, for the design steps); ``out`` the tensor
    to write into."""
    dev = nhi.device
    n, n_v = nhi.shape[0], kt.sizes["n_v"]
    cdin = torch.empty_like(nhi) if out is None else out
    sfx = _check("box_sweep", kt, dev, nhi=(nhi, (n, n_v)),
                 cdin=(cdin, (n, n_v)))
    plan = box_plan(kt, n, 1, dev, threads, ring)
    rings = _ring(kt, plan, dev)
    lib = _lib()
    err = getattr(lib, f"box_sweep_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), _ptr(nhi), _ptr(cdin), _ptr(rings),
        n, plan.threads, int(plan.shared), plan.blocks, _stream(dev))
    _raise_on(lib, "box_sweep", err)
    sweep.launches["box_sweep"] += 1
    return cdin


def box_rates(kt, cdin, nhi, flux, sdr3, dr, out=None):
    """The rate kernel, one launch: (phi, heat), the (n, Dc, Dc, Dc) rate
    boxes per HI atom of n sources with fluxes ``flux`` (n,) from their
    incoming column densities ``cdin`` and nHI ``nhi`` (n, n_v), S*/dr^3
    the 0-dim ``sdr3`` on the device; heat None without the heat channel.
    The boxes start as zeros (``out``: the pair to write into instead), and
    the kernel writes the rated cells, a thread a pair of a source and a
    rated cell."""
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
        kt.tabs, kt.dims, _vals(kt, dr), kt.bins, _ptr(nhi), _ptr(cdin),
        _ptr(flux), _ptr(sdr3), _ptr(phi), _ptr(heat), n, _stream(dev))
    _raise_on(lib, "box_rates", err)
    sweep.launches["box_rates"] += 1
    return phi, heat


def box_trace_sweep(kt, frame, pos_b, flux_b, sdr3, dr):
    """The trace of the batches ``pos_b`` (nb, B, 3) (box corners in the
    padded frame), ``flux_b`` (nb, B) over the padded nHI frame ``frame``
    (P, P, P), S*/dr^3 the 0-dim ``sdr3`` on the device: one call of the
    loop of csrc/trace_loop.cu, the positions and fluxes on the device
    once, on the current stream a chunk's rate boxes zeroed, then per device
    batch the gather and the sweep, per chunk of batches the rate pass and
    per batch of B the ordered accumulate over the rated cells, in
    ``box_plan``'s plan. Each kernel's launches are those the loop reports
    it issued. Returns the padded (phi, heat) frames, heat None without the
    heat channel."""
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
    plan = box_plan(kt, nb * B, B, dev)
    n_v, Dc = kt.sizes["n_v"], kt.sizes["Dc"]
    nhi, cdin = (torch.empty((plan.dev_batch, n_v), dtype=kt.dtype,
                             device=dev) for _ in range(2))
    rings = _ring(kt, plan, dev)
    phi = torch.empty((plan.chunk * B, Dc, Dc, Dc), dtype=kt.dtype,
                      device=dev)
    heat = torch.empty_like(phi) if kt.heat else None
    issued = (ctypes.c_int * len(LOOP_KERNELS))()
    lib = _lib()
    err = getattr(lib, f"box_trace_sweep_{sfx}")(
        kt.tabs, kt.dims, _vals(kt, dr), kt.bins, _ptr(frame), _ptr(pos),
        _ptr(flux), _ptr(sdr3), _ptr(nhi), _ptr(cdin), _ptr(rings),
        _ptr(phi), _ptr(heat), _ptr(frames[0]), _ptr(frames[1]), nb, B,
        plan.dev_batch, plan.chunk, plan.threads, int(plan.shared),
        plan.blocks, issued, _stream(dev))
    for k, v in zip(LOOP_KERNELS, issued):
        sweep.launches[k] += v
    _raise_on(lib, "box_trace_sweep", err)
    sweep.launches["box_trace_sweep"] += 1
    return frames
