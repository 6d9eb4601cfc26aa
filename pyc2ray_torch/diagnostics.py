"""Diagnostics & observability.

* ``photon_budget``: global photon-conservation check: total ionizations/s
  implied by the rate grid against the total source emission rate. The
  analog of the reference's photon-loss statistic (raytracing.f90:540-551),
  but exact and grid-global.
* ``stage_timer``: context manager timing a device computation with a
  device synchronization, optionally appending to a log.

The JAX package's profiler helpers (``profile_trace``, ``trace_annotated``,
``device_op_times``) have no counterpart here yet.
"""

import contextlib
import time

import numpy as np
import torch

from .constants import S_STAR_REF
from .utils.logutils import printlog

__all__ = ["photon_budget", "stage_timer"]


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
