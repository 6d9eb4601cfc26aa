"""Output-scan helpers for resuming runs (reference utils/other_utils.py)."""

import glob
import os

import numpy as np

__all__ = ["get_redshifts_from_output", "find_bins", "get_source_redshifts"]


def get_redshifts_from_output(output_dir, prefix="xfrac"):
    """Scan an output directory for xfrac files and return their redshifts
    sorted descending (reference other_utils.py:4-15)."""
    zs = []
    for f in glob.glob(os.path.join(output_dir, prefix + "*")):
        base = os.path.basename(f)
        core = base.replace(prefix, "").lstrip("_")
        for ext in (".pkl", ".dat", ".npy", ".bin"):
            if core.endswith(ext):
                core = core[: -len(ext)]
        try:
            zs.append(float(core))
        except ValueError:
            continue
    return np.sort(np.array(zs))[::-1]


def find_bins(value, binning_array):
    """Bracketing bin VALUES (low, high) around ``value``
    (other_utils.py:17-63): returns the sorted-array neighbors, with None
    beyond the ends. Scalar input -> scalar pair; array input -> arrays."""
    sorted_bins = np.sort(np.asarray(binning_array))

    def one(v):
        i = int(np.digitize(v, sorted_bins))
        lo = sorted_bins[i - 1] if i > 0 else None
        hi = sorted_bins[i] if i < len(sorted_bins) else None
        return lo, hi

    if isinstance(value, (np.ndarray, list)):
        pairs = [one(v) for v in value]
        return (np.array([p[0] for p in pairs]),
                np.array([p[1] for p in pairs]))
    return one(value)


def get_source_redshifts(source_dir, pattern="*-coarsest_wsubgrid_sources.dat"):
    """Scan a directory of CubeP3M source catalogs for their redshifts
    (other_utils.py:66-92)."""
    zs = []
    for f in glob.glob(os.path.join(source_dir, pattern)):
        base = os.path.basename(f)
        z_str = base.split("-")[0]
        try:
            zs.append(float(z_str))
        except ValueError:
            continue
    return np.sort(np.array(zs))[::-1]
