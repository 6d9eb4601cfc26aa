"""Build and bind the port's CUDA kernels.

Each source in ``csrc/`` has a plain C interface. At first use every
source is compiled by its own nvcc process, all started together, into a
shared library under ``build/torch_kernels/`` at the repository root
(``PYC2RAY_TORCH_BUILD`` overrides the directory), and loaded with ctypes.
A library's name carries a hash of its source, the shared header and the
flags, so an edited source is rebuilt and a stale library never loads.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "NVCC_FLAGS", "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("cheb_sweep", "cheb_sweep_rates")      # csrc/<name>.cu
HEADERS = ("cheb_sweep.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the launch arguments every entry point ends with: B, Dc, c, R1; dr, sig;
# threads, cluster, shared_planes, smem; max_clusters; stream
_LAUNCH = [_I] * 4 + [_D] * 2 + [_I] * 4 + [ctypes.POINTER(_I), _P]
# exported function -> argtypes, per library; every function returns the
# cudaError_t of its launches as an int
_SIGNATURES = {
    "cheb_sweep": {
        "cheb_sweep": [_P] * 8 + _LAUNCH,
        "cheb_sweep_gamma": [_P] * 11 + [_I, _D, _D] + _LAUNCH,
        "cheb_sweep_seg": [_P] * 10 + [_I, _I] + _LAUNCH,
    },
    "cheb_sweep_rates": {
        "cheb_sweep_rates": [_P] * 16 + [_I, _D, _I] + _LAUNCH,
    },
}

_libs = {}
build_log = ""      # nvcc's output of the builds in this process


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


def _so_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in HEADERS + (f"{name}.cu",):
        h.update((CSRC / f).read_bytes())
    return _build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def _bind(name, lib):
    for fn, argtypes in _SIGNATURES[name].items():
        for sfx in ("f32", "f64"):
            f = getattr(lib, f"{fn}_{sfx}")
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    if name == "cheb_sweep":
        lib.cheb_cluster_barriers.argtypes = [_I] * 4 + [_P]
        lib.cheb_cluster_barriers.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    return lib


def load(name=None):
    """Return the library of ``csrc/<name>.cu`` (all of them, as a dict,
    when ``name`` is None), compiling what is missing first, one nvcc
    process per source, in parallel. ``build_log`` keeps nvcc's output,
    with ptxas's report of registers, shared memory and spills per
    kernel."""
    global build_log
    names = SOURCES if name is None else (name,)
    todo = {n: _so_path(n) for n in names if n not in _libs}
    procs = {}
    for n, so in todo.items():
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, cmd)
    failed = []
    for n, (proc, tmp, cmd) in procs.items():
        out, _ = proc.communicate()
        build_log += f"== {n}.cu\n{out}"
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for n, so in todo.items():
        _libs[n] = _bind(n, ctypes.CDLL(str(so)))
    return dict(_libs) if name is None else _libs[name]
