"""Diagnostics & observability.

* ``photon_budget``: global photon-conservation check: total ionizations/s
  implied by the rate grid against the total source emission rate. The
  analog of the reference's photon-loss statistic (raytracing.f90:540-551),
  but exact and grid-global.
* ``stage_timer``: context manager timing a device computation with a
  device synchronization, optionally appending to a log.
* Profiling with ``torch.profiler``: ``trace_annotated`` names a function's
  calls in a trace, ``profile_trace`` captures a block into a Chrome trace,
  ``device_op_times`` sums its device time per kernel and
  ``device_idle_share`` gives the share of the captured window in which the
  device ran nothing.
"""

import contextlib
import glob
import json
import os
import time

import numpy as np
import torch

from .constants import S_STAR_REF
from .utils.logutils import printlog

__all__ = ["photon_budget", "stage_timer", "trace_annotated", "profile_trace",
           "device_op_times", "device_idle_share"]


def _host(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def photon_budget(phi_ion, ndens, xh_av, src_flux, dr):
    """Photon-conservation summary.

    Returns a dict with emitted and absorbed photon rates and the loss
    fraction. ``absorbed = sum(Gamma * nHI) * dr^3`` (the inverse of the
    photon-conserving division, raytracing.f90:531). Inputs are numpy
    arrays or tensors on any device.

    Sign convention: ``loss = 1 - absorbed/emitted``. Truncated rays (the
    LLS cutoff) make it positive; a small negative value with the
    spectral-bin engine is the bin quadrature's rate bias (absorbed
    integral slightly over-estimated, bounded by the bins' accuracy
    target), not a conservation violation.
    """
    phi = _host(phi_ion)
    nHI = _host(ndens) * (1.0 - _host(xh_av))
    absorbed = float((phi * nHI).sum() * float(dr) ** 3)
    emitted = float(_host(src_flux).sum() * S_STAR_REF)
    loss = 1.0 - absorbed / emitted if emitted > 0 else 0.0
    return {"emitted_per_s": emitted, "absorbed_per_s": absorbed,
            "loss_fraction": loss}


@contextlib.contextmanager
def stage_timer(name, logfile=None, quiet=False):
    """Time a device stage with a completion barrier.

    Put the stage's result tensor(s) into the yielded dict under "sync":

        with stage_timer("Raytracing", log) as st:
            phi = trace(...)
            st["sync"] = phi

    At exit the device of every tensor in st["sync"] is synchronized
    (PyTorch returns before the GPU finishes). Without a "sync" entry the
    timing is dispatch-only and the log says so.
    """
    from .evolve_loop import force
    t0 = time.time()
    result = {}
    try:
        yield result
    finally:
        synced = "sync" in result
        if synced:
            sync = result["sync"]
            force(*(sync if isinstance(sync, (tuple, list)) else (sync,)))
        result["seconds"] = time.time() - t0
        tag = "" if synced else " (dispatch only: no sync tensor given)"
        printlog(f"{name} took {result['seconds']:.3f} s.{tag}",
                 logfile, quiet)


# Chrome-trace categories of the operations the device runs (kernels and
# the copies and fills of the copy engines)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_annotated(name, fn):
    """Wrap fn so that its calls appear as ranges named ``name`` in
    ``profile_trace`` captures."""
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def profile_trace(outdir):
    """Capture a profile of the enclosed block into a Chrome trace (JSON)
    in ``outdir``: the host's operations and, where a GPU is present, its
    kernels and copies. Put the block's result tensor(s) into the yielded
    dict under "sync", as with ``stage_timer``, so that the capture waits
    for the device work::

        with profile_trace(outdir) as p:
            phi, _ = rt.trace_batches(...)
            p["sync"] = phi
        times = device_op_times(outdir)

    The trace's path is stored under "path" of the dict.
    """
    from torch.profiler import ProfilerActivity, profile
    from .evolve_loop import force
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    result = {}
    with profile(activities=activities) as prof:
        yield result
        sync = result.get("sync")
        if sync is not None:
            force(*(sync if isinstance(sync, (tuple, list)) else (sync,)))
    result["path"] = os.path.join(
        str(outdir), f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(result["path"])


def _trace_events(outdir):
    """The complete events ("ph": "X") of every Chrome trace in
    ``outdir``, one list per file."""
    out = []
    for f in sorted(glob.glob(os.path.join(str(outdir), "**", "*.json"),
                              recursive=True)):
        with open(f) as fh:
            data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        out.append([e for e in events
                    if e.get("ph") == "X" and "dur" in e and "ts" in e])
    return out


def device_op_times(outdir, top=None):
    """Device time (ms) per kernel or copy name over the ``profile_trace``
    captures in ``outdir``, sorted in descending order; the ``top`` first
    with ``top``. Empty when no operation ran on a device."""
    agg = {}
    for events in _trace_events(outdir):
        for e in events:
            if e.get("cat") in _DEVICE_CATS:
                agg[e["name"]] = agg.get(e["name"], 0.0) + e["dur"] / 1e3
    items = sorted(agg.items(), key=lambda kv: -kv[1])
    return dict(items[:top] if top else items)


def device_idle_share(outdir):
    """Share of the captured window in which the device ran nothing:
    1 - (the union of the device operations' intervals) / (the window),
    the window of a capture being its first event's start to its last
    event's end (host or device), summed over the captures in ``outdir``.
    Raises ValueError when no operation ran on a device."""
    busy = window = 0.0
    for events in _trace_events(outdir):
        if not events:
            continue
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in _DEVICE_CATS)
        window += (max(e["ts"] + e["dur"] for e in events)
                   - min(e["ts"] for e in events))
        end = -np.inf
        for t0, t1 in spans:
            if t1 > end:
                busy += t1 - max(t0, end)
                end = t1
    if busy == 0.0:
        raise ValueError(f"no device operation in the traces of {outdir}")
    return 1.0 - busy / window
