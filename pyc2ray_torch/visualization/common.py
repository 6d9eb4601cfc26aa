"""Plot helpers (equivalent of reference visualization/common.py:3-47).

Twin of pyc2ray_tpu/visualization/common.py. The functions draw on a
matplotlib axes the caller made; the module itself does not import
matplotlib. A tensor argument is moved to the host as a NumPy array."""

import numpy as np
import torch

__all__ = ["xfrac_plot", "resid_plot", "to_host"]


def to_host(a):
    """``a`` as a NumPy array: a tensor (on any device) is copied to the
    host, anything else goes through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def xfrac_plot(xfrac_slice, ax, cmap="jet", interp="none", vmin=None,
               vmax=None):
    """Plot an ionized-fraction slice in log scale."""
    xfrac_slice = to_host(xfrac_slice)
    im = ax.imshow(np.log10(np.maximum(xfrac_slice, 1e-20)), origin="lower",
                   cmap=cmap, interpolation=interp, vmin=vmin, vmax=vmax)
    ax.set_title("Ionized fraction (log)")
    return im


def resid_plot(a_slice, b_slice, ax, cmap="bwr", interp="none"):
    """Plot the relative residual between two slices."""
    a_slice, b_slice = to_host(a_slice), to_host(b_slice)
    resid = (a_slice - b_slice) / np.maximum(np.abs(b_slice), 1e-30)
    vmax = np.abs(resid).max()
    im = ax.imshow(resid, origin="lower", cmap=cmap, interpolation=interp,
                   vmin=-vmax, vmax=vmax)
    ax.set_title("Relative residual")
    return im
