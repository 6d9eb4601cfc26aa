"""Build and bind the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use they are
compiled by nvcc into one shared library under ``build/torch_kernels/`` at
the repository root (``PYC2RAY_TORCH_BUILD`` overrides the directory) and
loaded with ctypes. The library's name carries a hash of the sources and
the flags, so an edited source is rebuilt and a stale library never loads.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("cheb_sweep.cu",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
build_log = ""      # nvcc's output of the last build in this process


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built at first use")
    return found


def _build_dir():
    d = os.environ.get("PYC2RAY_TORCH_BUILD")
    if d:
        return Path(d)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _bind(lib):
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("cheb_sweep_f32", "cheb_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [f64, f64, i32, ptr]
        fn.restype = i32
    lib.cheb_sweep_error_string.argtypes = [i32]
    lib.cheb_sweep_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """Return the kernel library, compiling it first if needed. A build
    keeps nvcc's output, with ptxas's report of registers, shared memory
    and spills per kernel, in ``build_log``."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out_dir = _build_dir()
    so = out_dir / f"libpyc2ray_torch_{h.hexdigest()[:16]}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, so)
    _lib = _bind(ctypes.CDLL(str(so)))
    return _lib
