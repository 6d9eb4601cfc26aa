"""Source catalog I/O and formatting.

Equivalent of reference utils/sourceutils.py:7-112. The device raytracer
takes (NumSrc, 3) 0-indexed int32 positions; the file formats and the
model-level API keep the C2Ray (3, NumSrc) 1-indexed convention so existing
source files and scripts work unchanged.
"""

import numpy as np

from ..constants import S_STAR_REF

__all__ = ["format_sources", "read_test_sources", "generate_test_sourcefile"]


def format_sources(src_pos, src_flux):
    """(3, NumSrc) 1-indexed positions -> (NumSrc, 3) 0-indexed int32,
    flux -> float64 (reference sourceutils.py:7-33)."""
    pos = (np.asarray(src_pos).T - 1).astype(np.int32)
    flux = np.asarray(src_flux, dtype=np.float64)
    return pos, flux


def read_test_sources(file, numsrc, S_star_ref=S_STAR_REF):
    """Read a C2Ray-format test source file (sourceutils.py:70-112).

    Format: first line = number of sources; then rows "i j k flux 1.0"
    with 1-indexed positions. Returns ((3, numsrc) positions, normalized
    fluxes)."""
    with open(file, "r") as f:
        inp = np.loadtxt(f, skiprows=1, usecols=(0, 1, 2, 3), ndmin=2)
    max_n = inp.shape[0]
    if numsrc > max_n:
        raise ValueError(
            f"Number of sources given ({numsrc}) is larger than that of "
            f"the file ({max_n})")
    src_pos = np.transpose(inp[:numsrc, 0:3])
    src_flux = inp[:numsrc, 3] / S_star_ref
    return src_pos, src_flux


def generate_test_sourcefile(filename, N, numsrc, strength, seed=100):
    """Write a random equal-strength test source catalog
    (sourceutils.py:35-68)."""
    rng = np.random.RandomState(seed)
    srcpos = 1 + rng.randint(0, N, size=3 * numsrc)
    srcpos = srcpos.reshape((numsrc, 3), order="C")
    srcflux = strength * np.ones((numsrc, 1))
    zerocol = np.zeros((numsrc, 1))
    output = np.hstack((srcpos, srcflux, zerocol))
    with open(filename, "w") as f:
        f.write(f"{numsrc:n}\n")
    with open(filename, "a") as f:
        np.savetxt(f, output, "%i %i %i %.0e %.1f")
