"""The engine-agnostic convergence loop of the evolve path.

Each path supplies one ``iteration`` callback that performs (raytrace ->
chemistry) and returns the host scalars the criterion needs; the loop owns
the criterion, the stage timing, and the per-iteration photon-conservation
log (the reference logs photon loss every iteration, evolve.py:202).

Timing: PyTorch returns before the GPU finishes, so stage timings are
closed by ``force``, which synchronizes the device of its tensors.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .utils.logutils import printlog

__all__ = ["IterationResult", "force", "conv_criterion_for",
           "run_convergence_loop"]


def force(*tensors):
    """Wait for the device work producing ``tensors`` to finish."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


class IterationResult(NamedTuple):
    """Host-side scalars one convergence iteration must produce."""
    conv_flag: int          # number of non-converged cells
    sum_xh1: float          # sum(xh_intermed)
    sum_xh0: float          # sum(1 - xh_intermed)
    photon_loss: Optional[float] = None  # 1 - absorbed/emitted, if tracked


def conv_criterion_for(num_cells, num_src, convergence_fraction):
    """The reference's convergence criterion (evolve.py:127)."""
    return min(int(convergence_fraction * num_cells), (num_src - 1) / 3)


def run_convergence_loop(iteration, num_cells, num_src,
                         convergence_fraction=1e-4, max_iterations=100,
                         logfile=None, quiet=False, loss_fraction=None):
    """Iterate ``iteration(niter)`` until global convergence.

    ``iteration`` performs one (raytrace -> chemistry) pass, updating its
    own state in its closure, and returns an IterationResult. Convergence
    (reference evolve.py:216-232): the non-converged cell count drops
    below the criterion OR the relative change of both sum(xh) and
    sum(1-xh) drops below convergence_fraction.

    When ``iteration`` reports photon_loss and ``loss_fraction`` is set
    (Raytracing.loss_fraction), a loss above the bound logs a WARNING: the
    adaptive-radius engine's contract is that its truncation stays below
    this bound (the role of the reference's subbox early-exit,
    raytracing.f90:193-221).

    Returns the number of iterations executed.
    """
    criterion = conv_criterion_for(num_cells, num_src, convergence_fraction)
    prev_sum_xh1 = 2.0 * num_cells
    prev_sum_xh0 = 2.0 * num_cells
    converged = False
    niter = 0
    res = None
    while not converged and niter < max_iterations:
        niter += 1
        res = iteration(niter)
        # failure detection (beyond reference, which has none —
        # SURVEY.md section 5): a NaN/Inf in the global sums means the
        # physics state is corrupt; without this check the NaN
        # comparisons below would silently spin to max_iterations
        if not (np.isfinite(res.sum_xh1) and np.isfinite(res.sum_xh0)):
            msg = (f"non-finite global state at iteration {niter} "
                   f"(sum_xh1={res.sum_xh1!r}, sum_xh0={res.sum_xh0!r}) — "
                   "inputs or timestep produced NaN/Inf fields")
            printlog("ERROR: " + msg, logfile, quiet)
            raise FloatingPointError(msg)
        rel1 = (abs((res.sum_xh1 - prev_sum_xh1) / res.sum_xh1)
                if res.sum_xh1 > 0 else 1.0)
        rel0 = (abs((res.sum_xh0 - prev_sum_xh0) / res.sum_xh0)
                if res.sum_xh0 > 0 else 1.0)
        msg = (f"Non-converged points: {int(res.conv_flag)} of {num_cells} "
               f"({int(res.conv_flag) / num_cells * 100:.3f} %), relative "
               f"change in ionfrac: {rel1:.2e}")
        if res.photon_loss is not None:
            # reference: "Photon loss: ..." per iteration (evolve.py:202)
            msg += f", photon loss fraction: {res.photon_loss:.3e}"
            if res.photon_loss < 0:
                # sign convention: loss = 1 - absorbed/emitted, so a
                # NEGATIVE value means absorption slightly exceeds
                # emission. With spectral-bin engines that is the bin
                # quadrature's rate bias (bounded by the configured
                # compression/GL target, e.g. ~1e-3 at the production
                # 14-node default), not a conservation violation.
                msg += " (absorbed > emitted: spectral-bin quadrature " \
                       "bias, bounded by the bins' accuracy target)"
        printlog(msg, logfile, quiet)
        if (res.photon_loss is not None and loss_fraction is not None
                and res.photon_loss > loss_fraction):
            printlog(f"WARNING: photon loss {res.photon_loss:.3e} exceeds "
                     f"Raytracing.loss_fraction = {loss_fraction:.1e}; "
                     f"raise the adaptive safety factor or R_max",
                     logfile, quiet)
        converged = (res.conv_flag < criterion) or (
            (rel1 < convergence_fraction) and (rel0 < convergence_fraction))
        prev_sum_xh1, prev_sum_xh0 = res.sum_xh1, res.sum_xh0
    if converged:
        printlog("Multiple source convergence reached.", logfile, quiet)
    else:
        tail = (f" ({int(res.conv_flag)} cells above the criterion)"
                if res is not None else " (no iterations executed)")
        printlog(f"WARNING: evolve loop hit max_iterations = "
                 f"{max_iterations} without converging{tail}",
                 logfile, quiet)
    return niter
