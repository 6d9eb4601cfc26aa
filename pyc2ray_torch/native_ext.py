"""ctypes loader for the sequential C++ oracle (native/c2ray_native.cpp).

Counterpart of pyc2ray_tpu/native_ext.py. The C++ file is framework-free
and has a plain C interface:

* ``oracle_sweep_native`` — the sequential, C2Ray-faithful raytrace (the
  reference solution of examples/single_source_test);
* ``chemistry_global_native`` — the sequential chemistry pass;
* ``build_geometry_tables_native`` — the octahedral table builder, held
  bit-equal to ops/geometry.py's numpy builder in the tests (the port
  builds its tables with numpy only).

At first use the source is compiled by ``g++ -O3 -shared -fPIC`` into the
port's build directory (ops/_build.py; a library's name carries a hash of
the source and the flags), never into native/. Where g++ or the source is
missing the loader raises: nothing falls back.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .ops._build import _build_dir

__all__ = ["load_native", "build_geometry_tables_native",
           "oracle_sweep_native", "chemistry_global_native"]

SOURCE = Path(__file__).resolve().parents[1] / "native" / "c2ray_native.cpp"
# -ffp-contract=off: no FMA contraction, so the tables match the numpy
# builder bit for bit
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-std=c++17", "-shared"]

_lib = None

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _so_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _build_dir() / f"libc2ray_native_{h.hexdigest()[:16]}.so"


def load_native():
    """The native library, compiled first where it is missing. Raises
    RuntimeError if it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.exists():
        raise RuntimeError(f"native oracle source missing: {SOURCE}")
    so = _so_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            os.unlink(tmp)
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{' '.join(cmd)} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.build_geometry_tables.restype = ctypes.c_int64
    lib.build_geometry_tables.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        _i32p, _i32p, _f64p, _f64p, _f64p, _f64p, _i32p, _i32p]
    lib.oracle_sweep.restype = None
    lib.oracle_sweep.argtypes = [
        ctypes.c_int32, ctypes.c_int32, _i32p, _f64p, _f64p, _f64p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        _f64p, _f64p, _f64p, _f64p,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        _f64p, _f64p, _f64p]
    lib.chemistry_global.restype = ctypes.c_int64
    lib.chemistry_global.argtypes = [
        ctypes.c_int64, ctypes.c_double, _f64p, _f64p, _f64p, _f64p, _f64p,
        _f64p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double]
    _lib = lib
    return _lib


def build_geometry_tables_native(N, max_q):
    """The octahedral traversal tables by the C++ builder: (offsets, nbr,
    sw, path, diag, dist2, shell_start, shell_size), unpadded."""
    lib = load_native()
    last_r = N // 2 - 1 + (N % 2)
    last_l = -(N // 2)
    lo, hi = max(last_l, -max_q), min(last_r, max_q)
    capacity = (hi - lo + 1) ** 3
    offsets = np.empty((3, capacity), dtype=np.int32)
    nbr = np.empty((4, capacity), dtype=np.int32)
    sw = np.empty((4, capacity), dtype=np.float64)
    path = np.empty(capacity, dtype=np.float64)
    diag = np.empty(capacity, dtype=np.float64)
    dist2 = np.empty(capacity, dtype=np.float64)
    shell_start = np.empty(max_q + 2, dtype=np.int32)
    shell_size = np.empty(max_q + 1, dtype=np.int32)
    C = lib.build_geometry_tables(N, max_q, capacity, offsets, nbr, sw,
                                  path, diag, dist2, shell_start, shell_size)
    if C < 0:
        raise RuntimeError(f"native geometry builder failed (code {C})")
    C = int(C)
    return (offsets[:, :C], nbr[:, :C], sw[:, :C], path[:C], diag[:C],
            dist2[:C], shell_start, shell_size)


def oracle_sweep_native(ndens, xh_av, src_pos, src_flux, dr, sig,
                        r_max_lls, tables=None, grey=False):
    """Sequential raytrace of all sources over the (N, N, N) grid, in
    float64. ``src_pos`` (NumSrc, 3) 0-indexed, ``src_flux`` in units of
    S_star; ``tables`` = (photo_thin, photo_thick, heat_thin, heat_thick,
    minlogtau, dlogtau) unless ``grey``. Returns (phi_ion, phi_heat,
    coldensh of the last source)."""
    lib = load_native()
    N = ndens.shape[0]
    ndens_c = np.ascontiguousarray(ndens, dtype=np.float64)
    xh_c = np.ascontiguousarray(xh_av, dtype=np.float64)
    pos_c = np.ascontiguousarray(src_pos, dtype=np.int32)
    flux_c = np.ascontiguousarray(src_flux, dtype=np.float64)
    if (ndens_c.shape != (N,) * 3 or xh_c.shape != ndens_c.shape
            or pos_c.shape != (flux_c.shape[0], 3)
            or pos_c.min(initial=0) < 0 or pos_c.max(initial=0) >= N):
        raise ValueError(f"oracle_sweep_native: ndens {ndens_c.shape}, xh_av "
                         f"{xh_c.shape}, src_pos {pos_c.shape} (in [0, N)), "
                         f"src_flux {flux_c.shape}")
    phi = np.zeros_like(ndens_c)
    heat = np.zeros_like(ndens_c)
    cdh = np.zeros_like(ndens_c)
    if grey:
        z = np.zeros(1)
        thin = thick = hthin = hthick = z
        num_tau, minlogtau, dlogtau = 0, 0.0, 1.0
    else:
        thin, thick, hthin, hthick, minlogtau, dlogtau = tables
        thin, thick, hthin, hthick = (
            np.ascontiguousarray(t, dtype=np.float64)
            for t in (thin, thick, hthin, hthick))
        num_tau = thin.shape[0] - 1
    lib.oracle_sweep(N, pos_c.shape[0], pos_c, flux_c,
                     ndens_c.ravel(), xh_c.ravel(), float(dr), float(sig),
                     float(r_max_lls), 1 if grey else 0,
                     thin, thick, hthin, hthick,
                     num_tau, float(minlogtau), float(dlogtau),
                     phi.ravel(), heat.ravel(), cdh.ravel())
    return phi, heat, cdh


def chemistry_global_native(dt, ndens, temp, xh, xh_av, phi_ion,
                            bh00, albpow, colh0, temph0, abu_c):
    """Sequential chemistry pass (chemistry.f90:13-204) in float64;
    returns (xh_intermed, xh_av, conv_flag)."""
    lib = load_native()
    shape = np.asarray(xh).shape
    nd = np.ascontiguousarray(ndens, dtype=np.float64).ravel()
    tp = np.ascontiguousarray(temp, dtype=np.float64).ravel()
    x0 = np.ascontiguousarray(xh, dtype=np.float64).ravel()
    xav = np.ascontiguousarray(xh_av, dtype=np.float64).ravel().copy()
    xi = x0.copy()
    phi = np.ascontiguousarray(phi_ion, dtype=np.float64).ravel()
    if not nd.size == tp.size == x0.size == xav.size == phi.size:
        raise ValueError("chemistry_global_native: fields of unequal size")
    cf = lib.chemistry_global(x0.size, float(dt), nd, tp, x0, xav, xi, phi,
                              bh00, albpow, colh0, temph0, abu_c)
    return xi.reshape(shape), xav.reshape(shape), int(cf)
