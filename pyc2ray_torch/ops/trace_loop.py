"""The extended frame of the box engines and the batch loop of a trace.

Every source's (Dc)^3 box starts at its position in the (N, N, N) grid
wrap-padded by c cells below and Dc - 1 - c above on every axis (c: the
source's index in its box): the extended frame (``wrap_pad``,
``fold_padding``). The Chebyshev, helium and octahedral sheet engines trace
batch after batch in it: cut each source's box out of the frame, compute
its rate box, add the rate boxes back in batch order.

The port's own kernels for the two ends of a batch (csrc/trace_loop.cu):

  ``extract_chunk``     the (k, B, D, D, D) boxes of up to four frames at
                        the box corners of k consecutive batches (a chunk),
                        one launch; plain version ``extract_chunk_ref``, a
                        stack of PyTorch gathers (``extract_boxes_ref``).
                        ``extract_boxes`` is its chunk of one batch.
  ``accumulate_boxes``  adds a batch's boxes into up to four frames at corner
                        + shift, source by source in batch order, bit for bit
                        as the plain version ``add_boxes`` (one slice add per
                        source): each frame cell has one owner thread
                        that adds the covering boxes in ascending order, so
                        no atomicAdd reorders the adds where boxes overlap;
                        the rate boxes of the unfused modes, 0 outside the
                        rated cells, only at those (the adds of 0 left
                        out).
  ``cheb_trace_sweep``  the whole trace of any sweep mode as one call: a
                        loop in C issues, per batch, extract -> K1 -> the
                        dense rate pass (ops/cheb_rates.py, over the
                        engine's rated cells) -> accumulate at shift rb0
                        (the default mode, with do_heating the
                        heat beside Gamma), extract -> the segmented sweep's
                        start -> K2 x seg_K -> the rate pass -> accumulate
                        (shell_segment), extract -> K1f -> accumulate
                        (fuse_rates) or extract -> K3's two phases ->
                        accumulate (fuse_fold, K3h with the heat channel),
                        the extract once per chunk of ``chunk_size``
                        batches, on the current stream, with the plan, the
                        checks and the scratch made once per trace; the port's
                        counterpart of the JAX engine's jit + lax.scan over
                        batches. Plain version ``cheb_trace_sweep_ref``.
  ``he_trace_sweep``    the helium engine's trace as one call: per chunk
                        one extract of the three species' boxes, per batch
                        three sweeps (K1, or the segmented sweep's start and
                        K2 x seg_K, one per species at its threshold cross
                        section), the three-species rate pass (``rates_he``
                        of ops/cheb_rates.py, over the engine's rated cells)
                        and one accumulate of its 3-4 channels at rb0; the
                        counterpart of the JAX HeRaytracer's jit +
                        lax.fori_loop over batches. Plain version
                        ``he_trace_sweep_ref``.

Both kernels read the positions of the whole trace, (nb, B, 3) int32 on
the device, staged once per trace by ``stage_positions``, which also checks
that every box lies inside the frame (the kernels do not). Each wrapper runs
the plain version for a CPU tensor and the kernel for a CUDA tensor, or
raises; the launches are counted in ``sweep.launches``.

The octahedral sheet engine's trace (ops/box_sweep.py::box_trace_sweep) is a
loop of the same library too, over the kernels of csrc/box_sweep.cuh and the
accumulate over the rated cells.
"""

import ctypes

import torch

from . import sweep
from .cheb_rates import _check_bands, rates_dense_ref, rates_he_ref
from .sweep import (RATE_THREADS, THREADS_RATES, cheb_sweep,
                    cheb_sweep_rates, cheb_sweep_segmented, init_segments_ref,
                    launches, rate_consts)

__all__ = ["wrap_pad", "fold_padding", "add_boxes", "extract_boxes_ref",
           "extract_chunk_ref", "stage_positions", "extract_boxes",
           "extract_chunk", "accumulate_boxes", "chunk_size",
           "cheb_trace_sweep", "cheb_trace_sweep_ref", "he_trace_sweep",
           "he_trace_sweep_ref", "MAX_CHANNELS"]

MAX_CHANNELS = 4       # frames one launch moves (kMaxChannels of the source)
# the trace loop's extract cuts the boxes of up to MAX_CHUNK batches, of at
# most CHUNK_BYTES together, in one launch (chunk_size)
MAX_CHUNK = 32
CHUNK_BYTES = 128 << 20
# the fused modes of cheb_trace_sweep: K1f, and K3 (K3h with the heat
# channel), each with its complete (Dc)^3 rate boxes
FUSE_MODES = (None, "rates", "fold")


def wrap_pad(field3, c, Dc):
    """The (N, N, N) field wrap-padded to the extended frame."""
    N = field3.shape[0]
    wrap = torch.arange(-c, N + Dc - 1 - c, device=field3.device) % N
    return field3[wrap][:, wrap][:, :, wrap]


def fold_padding(padded, c, Dc):
    """Fold the padding of the extended frame back onto the periodic
    (N, N, N) grid (low pad onto the top, high pad onto the bottom, one
    axis after the other)."""
    N = padded.shape[0] - (Dc - 1)
    padL, padR = c, Dc - 1 - c
    out = padded
    for axis in range(3):
        core = out.narrow(axis, padL, N).clone()
        if padR > 0:
            core.narrow(axis, 0, padR).add_(out.narrow(axis, padL + N, padR))
        if padL > 0:
            core.narrow(axis, N - padL, padL).add_(out.narrow(axis, 0, padL))
        out = core
    return out


def add_boxes(pad, boxes, pos, shift=0):
    """Add each source's box of ``boxes`` (B, D, D, D) into the extended
    grid ``pad`` at its box corner ``pos`` (B, 3) plus ``shift`` on every
    axis, source by source in batch order (a fixed order of the adds on
    either device)."""
    D = boxes.shape[-1]
    for (p0, p1, p2), box in zip(pos.tolist(), boxes):
        p0, p1, p2 = p0 + shift, p1 + shift, p2 + shift
        pad[p0:p0 + D, p1:p1 + D, p2:p2 + D] += box


def extract_boxes_ref(frame, pos, D):
    """(B, D, D, D) boxes of ``frame`` starting at the corners ``pos``
    (B, 3) on the frame's device."""
    ar = torch.arange(D, device=frame.device)
    i, j, k = (pos[:, ax, None] + ar for ax in range(3))
    return frame[i[:, :, None, None], j[:, None, :, None],
                 k[:, None, None, :]]


def extract_chunk_ref(frame, pos, k0, k, D):
    """(k, B, D, D, D): the boxes of batches k0 .. k0 + k - 1 of ``frame``
    at the corners ``pos`` (nb, B, 3), each batch's as ``extract_boxes_ref``
    cuts them."""
    return torch.stack([extract_boxes_ref(frame, pos[b].to(frame.device), D)
                        for b in range(k0, k0 + k)])


def chunk_size(nb, B, D, itemsize, channels=1):
    """The batches of a trace of ``nb`` batches of B boxes of side D whose
    boxes the trace loop cuts in one launch: as many as CHUNK_BYTES hold
    of the boxes of all ``channels`` frames (the helium loop's three
    species), 1 to MAX_CHUNK."""
    k = CHUNK_BYTES // (channels * B * D ** 3 * itemsize)
    return int(max(1, min(k, MAX_CHUNK, nb)))


def stage_positions(pos_b, shape, D, device):
    """The box corners (nb, B, 3) of a trace as one contiguous int32 tensor
    on ``device``, copied once. Raises where a box of side D at a corner
    leaves a frame of extents ``shape``."""
    pos = torch.as_tensor(pos_b)
    if pos.dim() != 3 or pos.shape[-1] != 3:
        raise ValueError(f"positions {tuple(pos.shape)}, expected (nb, B, 3)")
    if pos.numel():
        flat = pos.reshape(-1, 3)
        lo, hi = flat.amin(0).tolist(), flat.amax(0).tolist()
        if min(lo) < 0 or any(h + D > s for h, s in zip(hi, shape)):
            raise ValueError(f"boxes of side {D} at corners {lo}..{hi} "
                             f"leave the frame {tuple(shape)}")
    return pos.to(device=device, dtype=torch.int32).contiguous()


def _channels(x):
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _check_boxes(name, frames, boxes, pos, k, D, chunk=None):
    """Validate a launch of the box kernels: 1..MAX_CHANNELS frames of one
    3-D shape, their (B, D, D, D) boxes (the extract's (chunk, B, D, D, D)
    of batches k .. k + chunk - 1), the staged positions (nb, B, 3) int32,
    all contiguous on one CUDA device in one float type (the extract's
    frames may be views of unit inner stride, of one layout), and the batch
    index. Returns the function suffix."""
    f0 = frames[0]
    dt, dev = f0.dtype, f0.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if dt not in sweep._SUFFIX:
        raise TypeError(f"{name}: dtype {dt} (float32 or float64)")
    if not 1 <= len(frames) == len(boxes) <= MAX_CHANNELS:
        raise ValueError(f"{name}: {len(frames)} frames and {len(boxes)} "
                         f"boxes (1 to {MAX_CHANNELS} pairs)")
    if pos.dim() != 3 or pos.shape[-1] != 3:
        raise ValueError(f"{name}: positions {tuple(pos.shape)}")
    nb, B = pos.shape[:2]
    n = 1 if chunk is None else chunk
    if not (0 <= k and 1 <= n and k + n <= nb):
        raise ValueError(f"{name}: batches {k}..{k + n - 1} of {nb}")
    want = [(f, tuple(f0.shape), dt, chunk is not None) for f in frames]
    shape = (B, D, D, D) if chunk is None else (chunk, B, D, D, D)
    want += [(b, shape, dt, False) for b in boxes]
    want.append((pos, (nb, B, 3), torch.int32, False))
    for t, shape, tdt, view in want:
        laid = (t.stride() == f0.stride() and t.stride(-1) == 1 if view
                else t.is_contiguous())
        if (tuple(t.shape) != shape or t.dtype != tdt or t.device != dev
                or not laid):
            raise ValueError(
                f"{name}: a {tuple(t.shape)} {t.dtype} tensor on {t.device} "
                f"(contiguous {t.is_contiguous()}), expected {shape} {tdt} "
                f"contiguous on {dev}")
    if f0.dim() != 3:
        raise ValueError(f"{name}: frame {tuple(f0.shape)} is not 3-D")
    return sweep._SUFFIX[dt]


def _accumulate_launch(frames, boxes, pos, k, D, shift, cells=None,
                       valid=None):
    name = "accumulate_boxes"
    sfx = _check_boxes(name, frames, boxes, pos, k, D)
    if (cells is None) != (valid is None):
        raise ValueError(f"{name}: cells and valid go together")
    if cells is not None:
        sweep._check(name, boxes[0], {
            "cells": (cells, (cells.numel(),), torch.int32),
            "valid": (valid, (D, D, D), frames[0].dtype)})
        if cells.numel() > D ** 3:
            raise ValueError(f"{name}: {cells.numel()} cells of a box of "
                             f"{D ** 3}")
    from ._build import load
    lib = load("trace_loop")
    ptrs = ctypes.c_void_p * MAX_CHANNELS
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    listed = [None, None, 0] if cells is None else [
        sweep._ptr(cells), sweep._ptr(valid), cells.numel()]
    err = getattr(lib, f"accumulate_boxes_{sfx}")(
        ptrs(*[f.data_ptr() for f in frames]),
        ptrs(*[b.data_ptr() for b in boxes]), len(frames), sweep._ptr(pos),
        k, pos.shape[1], D, shift, *frames[0].shape, *listed,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.error_string(err)!r})")
    launches[name] += 1


def extract_chunk(frames, pos, k0, k, D):
    """The (k, B, D, D, D) boxes of batches k0 .. k0 + k - 1 of the staged
    positions ``pos`` (nb, B, 3) out of ``frames``: one frame or a sequence
    of up to MAX_CHANNELS frames of one shape and layout (views of unit
    inner stride too), with a tensor or a list of tensors returned alike.
    The plain version (``extract_chunk_ref``) for a CPU frame, one kernel
    launch for all the frames of a CUDA one, counted as one
    "extract_boxes"."""
    chans = _channels(frames)
    if chans[0].device.type == "cpu":
        out = [extract_chunk_ref(f, pos, k0, k, D) for f in chans]
    else:
        B = pos.shape[1]
        out = [torch.empty((k, B, D, D, D), dtype=f.dtype, device=f.device)
               for f in chans]
        name = "extract_boxes"
        sfx = _check_boxes(name, chans, out, pos, k0, D, chunk=k)
        from ._build import load
        lib = load("trace_loop")
        ptrs = ctypes.c_void_p * MAX_CHANNELS
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        f0 = chans[0]
        err = getattr(lib, f"extract_chunk_{sfx}")(
            ptrs(*[f.data_ptr() for f in chans]),
            ptrs(*[o.data_ptr() for o in out]), len(chans), sweep._ptr(pos),
            k0, k, B, D, f0.stride(0), f0.stride(1), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err} ({lib.error_string(err)!r})")
        launches[name] += 1
    return out[0] if isinstance(frames, torch.Tensor) else out


def extract_boxes(frames, pos, k, D):
    """The (B, D, D, D) boxes of batch ``k`` of the staged positions ``pos``
    (nb, B, 3) out of ``frames`` (as ``extract_chunk``'s): the plain version
    for a CPU frame, one kernel launch for all the frames of a CUDA one (a
    chunk of one batch)."""
    chans = _channels(frames)
    if chans[0].device.type == "cpu":
        out = [extract_boxes_ref(f, pos[k], D) for f in chans]
    else:
        out = [c[0] for c in extract_chunk(list(chans), pos, k, 1, D)]
    return out[0] if isinstance(frames, torch.Tensor) else out


def accumulate_boxes(frames, boxes, pos, k, shift=0, cells=None,
                     valid=None):
    """Add the boxes (B, D, D, D) of batch ``k`` into ``frames`` at the
    staged corners ``pos[k]`` + ``shift``, frame by frame with its boxes
    (one tensor each, or equal sequences of up to MAX_CHANNELS), source by
    source in batch order. The plain version (``add_boxes``) for a CPU
    frame, one kernel launch for all the frames of a CUDA one, bit for bit
    the same. Rate boxes of the unfused modes, which are 0 outside the rated
    cells ``cells`` of the rates table (``cheb_rates.rated_cells``; where
    ``valid``, its (D, D, D) valid channel, exceeds 0.5), may give both: the
    kernel then visits those cells only and leaves out the adds of 0,
    which change no frame that holds no -0 (a frame of rates)."""
    chans, bx = _channels(frames), _channels(boxes)
    if chans[0].device.type == "cpu":
        for f, b in zip(chans, bx, strict=True):
            add_boxes(f, b, pos[k], shift)
        return
    _accumulate_launch(chans, bx, pos, k, bx[0].shape[-1], shift, cells,
                       valid)


def cheb_trace_sweep_ref(frame, pos, flux, tb, dr, c, sig, R2=0.0,
                         seg=(0, 0), rb0=0, fuse=None, heat=False):
    """Plain version of ``cheb_trace_sweep``, the batch loop as the engine
    issued it before the loop in C: per batch the positions ``pos[k]`` to
    the frame's device, the gather, the sweep mode and one slice add per
    source. The sweep kernels go through their wrappers (the plain versions
    on a CPU frame, the kernels on a CUDA one); the start of a segmented
    sweep and the rate pass are the plain versions on either device.
    ``pos`` may lie on the host (int64, as ``prepare_sources`` returns it)
    or be staged."""
    Dc = tb.sw.shape[-1]
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    bins_wh = tb.bins_wh if heat else None
    _, sdr3 = rate_consts(dr, frame.dtype)
    frames = [torch.zeros_like(frame) for _ in range(1 + bool(heat))]
    for k in range(pos.shape[0]):
        boxes = extract_boxes_ref(frame, pos[k].to(frame.device), Dc)
        shift = 0
        if fuse == "fold":
            out = cheb_sweep_rates(boxes, *geo, tb.rt_tab, flux[k], dr, c,
                                   sig, tb.bins_s, tb.bins_w, bins_wh=bins_wh)
        elif fuse == "rates":
            out = cheb_sweep(boxes, *geo, dr, c, sig,
                             bins=(tb.bins_s, tb.bins_w), rt_tab=tb.rt_tab,
                             R2=R2, flux=flux[k])
        else:
            cd = (cheb_sweep_segmented(boxes, *geo, dr, c, sig, *seg,
                                       init=init_segments_ref)
                  if seg[0] else cheb_sweep(boxes, *geo, dr, c, sig))
            out, shift = rates_dense_ref(
                cd, boxes, tb.rt_sub, flux[k], tb.bins_s, tb.bins_w, dr, sig,
                sdr3, rb0, bins_wh=bins_wh), rb0
        for f, box in zip(frames, _channels(out)):
            add_boxes(f, box, pos[k], shift)
    return frames[0], (frames[1] if heat else None)


def cheb_trace_sweep(frame, pos, flux, tb, dr, c, sig, R2=0.0, seg=(0, 0),
                     rb0=0, fuse=None, heat=False, cells=None):
    """The trace of the frame ``frame`` (F0, F1, F2) in a sweep mode: the
    sources of batch k have their box corners at ``pos[k]`` (staged, (nb,
    B, 3) int32) and their fluxes in ``flux[k]`` ((nb, B)); ``tb`` holds the
    engine's tables (ChebTables). The mode, by ``fuse`` (FUSE_MODES): None,
    K1 then the dense rate pass over the (Ds)^3 rates subbox at ``rb0``
    (``rt_sub``), accumulated at rb0, with ``seg`` = (S, K), S > 0, K2 over
    K segments of S shells in place of K1; "rates", K1f (R2: the squared
    radius); "fold", K3. The fused modes accumulate their (Dc)^3 Gamma
    boxes at 0. ``heat`` adds the photoheating channel (the rate pass's, or
    K3h; not with "rates"). Returns the (phi, heat) frames, heat None
    without ``heat``.

    The plain version for a CPU frame; for a CUDA frame one call of the loop
    of csrc/trace_loop.cu, which issues every batch's kernels on the current
    stream and does not synchronize. Counted as one "cheb_trace_sweep" and
    nb launches of each kernel it issues (nb K for K2), but the extract's:
    one per chunk of ``chunk_size`` batches, ceil(nb / chunk) in all. The
    unfused modes' rate pass evaluates the rated
    cells ``cells`` of ``rt_sub`` (``cheb_rates.rated_cells``, int32 on the
    card; the engine's ``rated_cells``), which the card needs and the plain
    version ignores."""
    S, K = (int(v) for v in seg)
    if fuse not in FUSE_MODES:
        raise ValueError(f"cheb_trace_sweep: fuse={fuse!r}, one of "
                         f"{FUSE_MODES}")
    if fuse and S or fuse == "rates" and heat:
        raise ValueError("cheb_trace_sweep: the fused modes take no "
                         "segments, fuse_rates no heat channel")
    if frame.device.type == "cpu":
        return cheb_trace_sweep_ref(frame, pos, flux, tb, dr, c, sig, R2,
                                    (S, K), rb0, fuse, heat)
    if fuse:
        cells = None            # the fused modes rate inside their kernels
    dt, dev = frame.dtype, frame.device
    nb, B = pos.shape[:2]
    Dc, Ds = tb.sw.shape[-1], tb.rt_sub.shape[-1]
    k = chunk_size(nb, B, Dc, dt.itemsize)
    chunk = torch.empty((k, B, Dc, Dc, Dc), dtype=dt, device=dev)
    boxes = chunk[0]
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    (B, Dc, R1), spec = sweep._geom(boxes, *geo, c)
    E, more = sweep._bins_spec(Dc, tb.bins_s, tb.bins_w, tb.rt_tab, dt)
    spec.update(more)
    spec.update(rt_sub=(tb.rt_sub, (3, Ds, Ds, Ds), dt),
                flux=(flux, (nb, B), dt),
                pos=(pos, (nb, B, 3), torch.int32),
                frame=(frame, tuple(frame.shape), dt))
    if heat:
        spec["bins_wh"] = (tb.bins_wh, (E,), dt)
    if cells is not None:
        spec["cells"] = (cells, (cells.numel(),), torch.int32)
    sfx = sweep._check("cheb_trace_sweep", boxes, spec)
    if frame.dim() != 3:
        raise ValueError(f"cheb_trace_sweep: frame {tuple(frame.shape)}")
    if not fuse and (cells is None or cells.numel() > Ds ** 3
                     or not 0 <= rb0 <= Dc - Ds):
        raise ValueError(f"cheb_trace_sweep: the rate pass needs the rated "
                         f"cells of rt_sub (cheb_rates.rated_cells) and its "
                         f"subbox of {Ds} at {rb0} inside the box {Dc}")
    mode = {None: int(S > 0), "rates": 2, "fold": 3}[fuse]
    from ._build import load
    lib = load("trace_loop")
    frames = [torch.zeros_like(frame) for _ in range(1 + bool(heat))]
    # the rate pass writes its rated cells only: its boxes start at 0 once
    # per trace and keep 0 everywhere else over all the batches
    phi = torch.empty_like(boxes) if fuse else torch.zeros(
        (B, Ds, Ds, Ds), dtype=dt, device=dev)
    heat_b = None if not heat else (torch.empty_like(phi) if fuse
                                    else torch.zeros_like(phi))
    work = [torch.empty_like(boxes) if fuse != "rates" else None,
            torch.empty_like(boxes) if fuse == "fold" else None]
    planes = [torch.empty((B, 3, 2, Dc, Dc), dtype=dt, device=dev)
              if mode == 1 else None for _ in range(2)]
    name = ("cheb_sweep", "cheb_sweep_seg", "cheb_sweep_fused_rates",
            "cheb_sweep_rates_heat" if heat else "cheb_sweep_rates")[mode]
    s_fac, sdr3 = rate_consts(dr, dt)
    sweep._launch(lib, f"cheb_trace_sweep_{sfx}", name, boxes, R1, c, dr, sig,
                  (frame, pos, flux, *geo, tb.rt_tab, tb.rt_sub, cells,
                   tb.bins_s, tb.bins_w, tb.bins_wh if heat else None,
                   frames[0], frames[1] if heat else None, chunk, *work,
                   phi, heat_b, *planes),
                  (mode, E, float(R2), sdr3, s_fac, THREADS_RATES, rb0, Ds,
                   0 if fuse else cells.numel(), S, K, *frame.shape, nb, k),
                  head=2 * E if mode == 2 else 0,
                  rate_threads=RATE_THREADS if mode == 2 else 0,
                  count=nb * (K if mode == 1 else 1), variant=mode)
    launches["extract_boxes"] += -(-nb // k)
    launches["accumulate_boxes"] += nb
    if not fuse:
        launches["rates_dense"] += nb
    if mode == 1:
        launches["init_segments"] += nb
    launches["cheb_trace_sweep"] += 1
    return frames[0], (frames[1] if heat else None)


def he_trace_sweep_ref(frames, pos, flux, tb, he_tables, dr, c, sigmas,
                       seg=(0, 0), rb0=0, heat=False, *, cells):
    """Plain version of ``he_trace_sweep``, the helium batch loop as the
    engine issued it before the loop in C: per batch the positions
    ``pos[k]`` to the frames' device, the gather of each species' boxes,
    three sweeps (the sweep kernels through their wrappers: the plain
    versions on CPU frames, the kernels on CUDA ones; the start of a
    segmented sweep the plain version), the plain rate pass
    (``rates_he_ref``) at the rated cells ``cells`` and one slice add per
    source and channel. ``pos`` may lie on the host (int64, as
    ``prepare_sources`` returns it) or be staged."""
    frames = tuple(frames)
    S, K = (int(v) for v in seg)
    Dc = tb.sw.shape[-1]
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    _, sdr3 = rate_consts(dr, frames[0].dtype)
    outs = [torch.zeros_like(frames[0]) for _ in range(3 + bool(heat))]
    for k in range(pos.shape[0]):
        corners = pos[k].to(frames[0].device)
        boxes = [extract_boxes_ref(f, corners, Dc) for f in frames]
        cds = [cheb_sweep_segmented(b, *geo, dr, c, sig, S, K,
                                    init=init_segments_ref)
               if S else cheb_sweep(b, *geo, dr, c, sig)
               for b, sig in zip(boxes, sigmas)]
        rates = rates_he_ref(cds, boxes, tb.rt_sub, flux[k], he_tables.se,
                             he_tables.w_se, dr, sdr3, rb0,
                             wh_se=he_tables.wh_se if heat else None,
                             cells=cells)
        for f, box in zip(outs, rates):
            add_boxes(f, box, pos[k], rb0)
    return outs


def he_trace_sweep(frames, pos, flux, tb, he_tables, dr, c, sigmas,
                   seg=(0, 0), rb0=0, heat=False, *, cells):
    """The helium engine's trace of the three species' frames ``frames``
    (n_HI, n_HeI, n_HeII; one shape (F0, F1, F2), contiguous): the sources
    of batch k have their box corners at ``pos[k]`` (staged, (nb, B, 3)
    int32) and their fluxes in ``flux[k]`` ((nb, B)); ``tb`` holds the host
    engine's tables (``raytrace_cheb.ChebTables``), ``he_tables`` the (3, E)
    bin tables se, w_se, wh_se and the kernel's records of them, packed with
    wh_se where ``heat`` (``raytrace_he.HeBinTables``), ``sigmas``
    the species' threshold cross sections. Per batch three sweeps, K1 or,
    with ``seg`` = (S, K), S > 0, K2 over K segments of S shells; the
    three-species rate pass over the (Ds)^3 subbox at ``rb0`` (``rt_sub``),
    with ``heat`` its heat channel; its 3-4 rate boxes accumulated at rb0.
    Returns the rate frames [G_HI, G_HeI, G_HeII(, heat)].

    The plain version for CPU frames; for CUDA frames one call of the loop
    of csrc/trace_loop.cu, which issues every batch's kernels on the current
    stream and does not synchronize. Counted as one "he_trace_sweep", 3 nb
    sweeps (3 nb K "cheb_sweep_seg" and 3 nb "init_segments" where it
    segments), nb "rates_he" and nb "accumulate_boxes", and one
    "extract_boxes" per chunk of ``chunk_size`` batches of the three
    species' boxes, ceil(nb / chunk) in all. The rate pass, kernel and
    plain version alike, evaluates the rated cells ``cells`` of ``rt_sub``
    (``cheb_rates.rated_cells``, int32, 1 to Ds^3 of them; the host
    engine's ``rated_cells``)."""
    frames = tuple(frames)
    if len(frames) != 3 or len(sigmas) != 3:
        raise ValueError(f"he_trace_sweep: {len(frames)} frames and "
                         f"{len(sigmas)} cross sections, three species each")
    S, K = (int(v) for v in seg)
    if frames[0].device.type == "cpu":
        return he_trace_sweep_ref(frames, pos, flux, tb, he_tables, dr, c,
                                  sigmas, (S, K), rb0, heat, cells=cells)
    dt, dev = frames[0].dtype, frames[0].device
    nb, B = pos.shape[:2]
    Dc, Ds = tb.sw.shape[-1], tb.rt_sub.shape[-1]
    bands = he_tables.bands
    k = chunk_size(nb, B, Dc, dt.itemsize, channels=3)
    # the three species' boxes of a chunk, each species' contiguous as the
    # extract writes it
    boxes = torch.empty((3, k, B, Dc, Dc, Dc), dtype=dt, device=dev)
    box0 = boxes[0, 0]
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    (B, Dc, R1), spec = sweep._geom(box0, *geo, c)
    spec.update(rt_sub=(tb.rt_sub, (3, Ds, Ds, Ds), dt),
                flux=(flux, (nb, B), dt),
                pos=(pos, (nb, B, 3), torch.int32),
                rec=(bands.rec, (bands.rec.numel(),), dt),
                **{f"frame{s}": (f, tuple(frames[0].shape), dt)
                   for s, f in enumerate(frames)})
    spec["cells"] = (cells, (cells.numel(),), torch.int32)
    sfx = sweep._check("he_trace_sweep", box0, spec)
    _check_bands("he_trace_sweep", bands, bool(heat))
    if frames[0].dim() != 3:
        raise ValueError(f"he_trace_sweep: frames {tuple(frames[0].shape)}")
    if not 1 <= cells.numel() <= Ds ** 3 or not 0 <= rb0 <= Dc - Ds:
        raise ValueError(f"he_trace_sweep: the rate pass takes 1 to Ds^3 "
                         f"rated cells ({cells.numel()}) and its subbox of "
                         f"{Ds} at {rb0} inside the box {Dc}")
    from ._build import load
    lib = load("trace_loop")
    n_out = 3 + bool(heat)
    outs = [torch.zeros_like(frames[0]) for _ in range(n_out)]
    cd = torch.empty((3, B, Dc, Dc, Dc), dtype=dt, device=dev)
    # the rate pass writes its rated cells only: its boxes start at 0 once
    # per trace and keep 0 everywhere else over all the batches
    rates = torch.zeros((n_out, B, Ds, Ds, Ds), dtype=dt, device=dev)
    planes = [torch.empty((B, 3, 2, Dc, Dc), dtype=dt, device=dev)
              if S else None for _ in range(2)]
    _, sdr3 = rate_consts(dr, dt)
    sweep._launch(lib, f"he_trace_sweep_{sfx}",
                  "cheb_sweep_seg" if S else "cheb_sweep", box0, R1, c, dr,
                  sigmas[0],
                  (*frames, pos, flux, *geo, tb.rt_sub, cells, bands.rec,
                   bands.head, *outs[:3], outs[3] if heat else None, boxes,
                   cd, rates, *planes),
                  (sdr3, float(sigmas[1]), float(sigmas[2]), rb0, Ds,
                   cells.numel(), S, K, *frames[0].shape, nb, k),
                  count=3 * nb * (K if S else 1),
                  variant=int(S > 0))
    launches["extract_boxes"] += -(-nb // k)
    launches["accumulate_boxes"] += nb
    launches["rates_he"] += nb
    if S:
        launches["init_segments"] += 3 * nb
    launches["he_trace_sweep"] += 1
    return outs
