"""C2Ray binary I/O (cbin / xfrac / density formats).

The port's own copy of pyc2ray_tpu/io/cbin.py (numpy only): self-contained
replacements for the tools21cm readers/writers the reference relies on
(``t2c.save_cbin`` for outputs, c2ray_cubep3m.py:136-138;
``t2c.XfracFile`` for golden references,
test/unit_tests_hackathon/1_single_black_body/run_test.py:39; CubeP3M
``coarser_densities/<z>n_all.dat`` files, c2ray_cubep3m.py:114-126).

Formats:
* cbin: header of three int32 mesh dimensions, then raw array data
  (C order), 32- or 64-bit floats.
* xfrac (C2Ray output): Fortran unformatted records — a record with three
  int32 dims, then a record with the float64 (or float32) data; each record
  framed by int32 byte counts.
* CubeP3M density: three int32 dims then float32 data (Fortran order).
"""

import numpy as np

__all__ = ["save_cbin", "read_cbin", "XfracFile", "DensityFile"]


def save_cbin(filename, data, bits=64, order="C"):
    """Write a cbin file: int32[3] mesh dims + raw data."""
    data = np.asarray(data)
    dtype = np.float64 if bits == 64 else np.float32
    with open(filename, "wb") as f:
        np.asarray(data.shape, dtype=np.int32).tofile(f)
        data.astype(dtype).flatten(order=order).tofile(f)


def read_cbin(filename, bits=64, order="C"):
    """Read a cbin file written by save_cbin."""
    dtype = np.float64 if bits == 64 else np.float32
    with open(filename, "rb") as f:
        dims = np.fromfile(f, count=3, dtype=np.int32)
        data = np.fromfile(f, dtype=dtype)
    return data.reshape(tuple(dims), order=order)


class XfracFile:
    """Reader for original-C2Ray ionized-fraction binaries.

    Layout (Fortran unformatted, sequential): [reclen][m1 m2 m3][reclen]
    [reclen][data][reclen], data float64 Fortran-ordered. Falls back to a
    headerless cbin layout if record markers are absent.
    """

    def __init__(self, filename):
        with open(filename, "rb") as f:
            raw = f.read()
        buf = np.frombuffer(raw, dtype=np.int32)
        if buf[0] == 12:  # Fortran record marker for the 3-int header
            dims = buf[1:4]
            offset = 4 * 6  # marker + 3 dims + marker + data marker
            n = int(np.prod(dims.astype(np.int64)))
            data = np.frombuffer(raw, dtype=np.float64, count=n,
                                 offset=offset)
        else:
            dims = buf[0:3]
            n = int(np.prod(dims.astype(np.int64)))
            data = np.frombuffer(raw, dtype=np.float64, count=n, offset=12)
        self.mesh = tuple(int(d) for d in dims)
        self.xi = data.reshape(self.mesh, order="F")


class DensityFile:
    """Reader for CubeP3M coarse density files (<z>n_all.dat):
    int32[3] dims then float32 data, Fortran order."""

    def __init__(self, filename):
        with open(filename, "rb") as f:
            dims = np.fromfile(f, count=3, dtype=np.int32)
            data = np.fromfile(f, dtype=np.float32)
        self.mesh = tuple(int(d) for d in dims)
        self.cgs_density = data[:int(np.prod(self.mesh))].reshape(
            self.mesh, order="F").astype(np.float64)
