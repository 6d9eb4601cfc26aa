"""Checkpoint / resume support.

The port's own copy of pyc2ray_tpu/io/checkpoint.py (numpy only). The
reference's outputs double as checkpoints (per-slice xfrac/IonRates
files, resumed by scanning file names: c2ray_cubep3m.py:157-181,
utils/other_utils.py:4-15). We keep that UX and additionally provide a
single-file npz checkpoint carrying the full simulation state (the
reference never checkpoints time/redshift and resets temperature;
SURVEY.md section 5).
"""

import glob
import os

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]


def save_checkpoint(directory, z, xh, ndens, phi_ion, time, zred,
                    temp=None, xhe1=None, xhe2=None, prefix="checkpoint"):
    """Write a full-state checkpoint for redshift slice z.

    ``temp`` (non-isothermal runs) and ``xhe1``/``xhe2`` (helium-engine
    runs) are included when given so those runs resume losslessly."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}_{z:.6f}.npz")
    arrays = dict(xh=np.asarray(xh), ndens=np.asarray(ndens),
                  phi_ion=np.asarray(phi_ion),
                  time=np.float64(time), zred=np.float64(zred),
                  z=np.float64(z))
    if temp is not None:
        arrays["temp"] = np.asarray(temp)
    if xhe1 is not None:
        arrays["xhe1"] = np.asarray(xhe1)
    if xhe2 is not None:
        arrays["xhe2"] = np.asarray(xhe2)
    np.savez(path, **arrays)
    return path


def latest_checkpoint(directory, prefix="checkpoint"):
    """Find the checkpoint with the lowest redshift (latest in time)."""
    files = glob.glob(os.path.join(directory, f"{prefix}_*.npz"))
    if not files:
        return None

    def z_of(f):
        core = os.path.basename(f)[len(prefix) + 1:-4]
        return float(core)

    return min(files, key=z_of)


def load_checkpoint(path):
    """Load a checkpoint written by save_checkpoint as a dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
