"""Halo catalogs of the CubeP3M models, read with h5py or without it.

``read_halo_catalog`` is what ``C2Ray_CubeP3M.read_sources`` and
``C2Ray_244Test.read_sources`` read: the (NumSrc, 3) 1-indexed positions
and the (NumSrc,) halo masses of an HDF5 catalog. It uses h5py where it
imports; elsewhere (the GPU machine has no h5py) ``read_catalog`` reads the
layout of the catalogs committed under examples/eor_simulation/inputs/
sources by byte offset: 20 000 sources, ``sources_positions`` int64 and
``sources_mass`` float64, little-endian, each dataset contiguous and
uncompressed (h5py's ``get_offset()``). Any other file raises a
``ValueError`` that names h5py.
"""

import numpy as np

__all__ = ["read_halo_catalog", "read_catalog", "HDF5_SIGNATURE",
           "CATALOG_NSRC", "CATALOG_POS_AT", "CATALOG_MASS_AT"]

HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"
CATALOG_NSRC = 20000
CATALOG_POS_AT, CATALOG_MASS_AT = 2048, 482048
_NAMES = (b"sources_positions", b"sources_mass")


def read_catalog(file):
    """A committed halo catalog read without h5py: (positions (NumSrc, 3)
    int64, masses (NumSrc,) float64). Checks the HDF5 signature, the
    dataset names in the header, the file's size and the value ranges
    (positions >= 1, masses finite and positive)."""
    with open(file, "rb") as f:
        raw = f.read()
    if (raw[:len(HDF5_SIGNATURE)] != HDF5_SIGNATURE
            or len(raw) != CATALOG_MASS_AT + 8 * CATALOG_NSRC
            or not all(n in raw[:CATALOG_POS_AT] for n in _NAMES)):
        raise ValueError(
            f"{file}: not a {CATALOG_NSRC}-source HDF5 catalog of the "
            f"committed layout; reading any other catalog needs h5py")
    pos = np.frombuffer(raw, "<i8", 3 * CATALOG_NSRC, CATALOG_POS_AT)
    mass = np.frombuffer(raw, "<f8", CATALOG_NSRC, CATALOG_MASS_AT)
    if pos.min() < 1 or not (np.all(np.isfinite(mass)) and mass.min() > 0):
        raise ValueError(f"{file}: positions or masses out of range; "
                         f"reading this catalog needs h5py")
    return pos.reshape(CATALOG_NSRC, 3).copy(), mass.copy()


def read_halo_catalog(file):
    """(positions (NumSrc, 3), masses (NumSrc,)) of an HDF5 halo catalog:
    through h5py where it imports, else ``read_catalog``."""
    try:
        import h5py
    except ImportError:
        return read_catalog(file)
    with h5py.File(file, "r") as f:
        return f["sources_positions"][:], f["sources_mass"][:]
