"""Build and bind the port's CUDA kernels.

Each source in ``csrc/`` has a plain C interface. At first use every
source is compiled by its own nvcc process, all started together, into a
shared library under ``build/torch_kernels/`` at the repository root
(``PYC2RAY_TORCH_BUILD`` overrides the directory), and loaded with ctypes.
A library's name carries a hash of its source, the shared header and the
flags, so an edited source is rebuilt and a stale library never loads.
``PROBES`` are sources of measurement-only forms that ``load`` builds only
when they are named (chip_smoke.py's tables of design steps).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "NVCC_FLAGS", "SOURCES", "PROBES"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("cheb_sweep", "cheb_sweep_rates", "cheb_rates", "trace_loop",
           "chemistry", "thermal", "flat_sweep")        # csrc/<name>.cu
PROBES = ("flat_probe", "thermal_probe", "box_probe")   # built only when
                                                      # named
HEADERS = ("cheb_sweep.cuh", "cheb_sweep_kernels.cuh", "cheb_sweep_rates.cuh",
           "cheb_rates.cuh", "cheb_rates_he.cuh", "rounded.cuh",
           "flat_sweep.cuh", "thermal.cuh", "box_sweep.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the launch arguments every entry point ends with: B, Dc, c, R1; dr, sig;
# threads, cluster, shared_planes, smem, rate_threads, ring; max_clusters;
# stream
_LAUNCH = [_I] * 4 + [_D] * 2 + [_I] * 6 + [ctypes.POINTER(_I), _P]
# exported function -> argtypes, per library; every function returns the
# cudaError_t of its launches as an int
_SIGNATURES = {
    "cheb_sweep": {
        "cheb_sweep": [_P] * 8 + _LAUNCH,
        "cheb_sweep_gamma": [_P] * 12 + [_I, _D, _D] + _LAUNCH,
        "cheb_sweep_seg": [_P] * 10 + [_I, _I] + _LAUNCH,
        # nhi, box, planes; B, Dc, c; dr; stream
        "cheb_init_segments": [_P] * 3 + [_I] * 3 + [_D, _P],
    },
    "cheb_sweep_rates": {
        "cheb_sweep_rates": [_P] * 16 + [_I, _D, _D, _I] + _LAUNCH,
    },
    "cheb_rates": {
        # cd, nhi, rt_sub, cells, flux, bins_s, bins_w, bins_wh, phi, heat;
        # B, E, Dc, Ds, rb0, n_valid; dr, sig, sdr3; stream
        "rates_dense": [_P] * 10 + [_I] * 6 + [_D] * 3 + [_P],
        # cd x 3, n x 3, rt_sub, cells, flux, rec, bands, out x 4;
        # B, Dc, Ds, rb0, n_valid; dr, sdr3; stream
        "rates_he": [_P] * 15 + [_I] * 5 + [_D] * 2 + [_P],
    },
    "trace_loop": {
        # frames, boxes, channels, pos, batch, B, D, shift, F0, F1, F2,
        # cells, valid, n_cells, stream
        "accumulate_boxes": [_P, _P, _I, _P] + [_I] * 7 + [_P, _P, _I, _P],
        # frames, boxes, channels, pos, k0, k, B, D, S0, S1, stream
        "extract_chunk": [_P, _P, _I, _P] + [_I] * 4
        + [ctypes.c_longlong] * 2 + [_P],
        # 23 pointers and the scratch; mode, E, R2, sdr3, s_fac,
        # threads_b, rb0, Ds, n_valid, seg_S, seg_K, F0, F1, F2, nb, chunk
        "cheb_trace_sweep": [_P] * 24 + [_I, _I, _D, _D, _D] + [_I] * 11
        + _LAUNCH,
        # 23 pointers and the scratch; sdr3, sigma_HeI, sigma_HeII,
        # rb0, Ds, n_valid, seg_S, seg_K, F0, F1, F2, nb, chunk
        "he_trace_sweep": [_P] * 24 + [_D, _D, _D] + [_I] * 10
        + _LAUNCH,
        # the box engine's: tabs, dims, vals (csrc/box_sweep.cuh's
        # make_geom), then each entry's own: threads, shared, held
        "box_resident": [_P] * 3 + [_I] * 2 + [ctypes.POINTER(_I)],
        # frame, pos, out; n; stream
        "box_gather": [_P] * 6 + [_I, _P],
        # nhi, cdin, ring; n, threads, shared, blocks; stream
        "box_sweep": [_P] * 6 + [_I] * 4 + [_P],
        # bins, nhi, cdin, flux, sdr3, phi, heat; n; stream
        "box_rates": [_P] * 10 + [_I, _P],
        # bins, frame, pos, flux, sdr3, nhi, cdin, ring, phi, heat,
        # phi_frame, heat_frame; nb, B, dev_batch, chunk, threads, shared,
        # blocks; launches (4); stream
        "box_trace_sweep": [_P] * 15 + [_I] * 7 + [_P] * 2,
    },
    "chemistry": {
        # dt (pointer, kind, value), the fields, mask, outputs, count and
        # iterations; cells, cap, (recomb,) params, stream
        "chemistry_pass": [_P, _I, _D] + [_P] * 10
        + [ctypes.c_longlong, _I, _P, _P],
        "chemistry_pass_he": [_P, _I, _D] + [_P] * 21
        + [ctypes.c_longlong, _I, _I, _P, _P],
    },
    "thermal": {
        # dt (pointer, kind, value), temp, ndens, xh, heat, out; cells,
        # nsub, params, stream
        "thermal_update": [_P, _I, _D] + [_P] * 5
        + [ctypes.c_longlong, _I, _P, _P],
    },
    "flat_sweep": {
        # tabs, dims, vals (the engine's tables, csrc/flat_sweep.cuh's
        # make_geom), then each entry's own: nhi, pos, nhi_octa, cd; B,
        # cluster, shared; max_clusters, stream
        "flat_sweep": [_P] * 7 + [_I] * 3 + [_P, _P],
        # nhi, pos, out; B; stream
        "flat_gather": [_P] * 6 + [_I, _P],
        # nhi_octa, flux, sdr3, cd, phi, heat; B; stream
        "flat_rates": [_P] * 9 + [_I, _P],
        # pos, phi, heat, phi_grid, heat_grid; B; stream
        "flat_accumulate": [_P] * 8 + [_I, _P],
        # nhi, pos, flux, sdr3, nhi_octa, cd, phi, heat, phi_grid,
        # heat_grid; nb, B, chunk, cluster, shared; stream
        "flat_trace_sweep": [_P] * 13 + [_I] * 5 + [_P],
    },
    "flat_probe": {},
    "box_probe": {
        # form, tabs, dims, vals, nhi, cdin, scratch; n, threads, group,
        # blocks; stream
        "box_sweep_probe": [_I] + [_P] * 6 + [_I] * 4 + [_P],
        # form, tabs, dims, vals; threads, group; held
        "box_probe_resident": [_I] + [_P] * 3 + [_I, _I, ctypes.POINTER(_I)],
        # form, tabs, dims, vals, bins, nhi, cdin, flux, sdr3, phi, heat;
        # n; stream
        "box_rates_probe": [_I] + [_P] * 10 + [_I, _P],
    },
    "thermal_probe": {
        # form; thermal_update's arguments
        "thermal_probe": [_I, _P, _I, _D] + [_P] * 5
        + [ctypes.c_longlong, _I, _P, _P],
        # bases (or None), n, first bits, exponents, their count, the
        # count of differing results, stream
        "thermal_pair_check": [_P, ctypes.c_longlong, ctypes.c_uint, _P, _I,
                               _P, _P],
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
    if name == "flat_probe":
        # tabs, dims, vals (flat_sweep.cuh's make_geom), then each entry's
        # own: nhi, pos, nhi_octa, cd; B, cluster, form; stream
        lib.flat_sweep_probe.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        # nhi, pos, out; B, form; stream
        lib.flat_gather_probe.argtypes = [_P] * 6 + [_I] * 2 + [_P]
        # nhi, pos, nhi_octa, flux, sdr3, cd, phi, heat; B, form; stream
        lib.flat_rates_probe.argtypes = [_P] * 11 + [_I] * 2 + [_P]
        lib.flat_sweep_forms.argtypes = [_P, _I]
        lib.flat_rates_forms.argtypes = [_P, _I]
        # pos, phi, phi_grid; B; stream
        lib.flat_accumulate_probe.argtypes = [_P] * 6 + [_I, _P]
        for f in ("flat_sweep_probe", "flat_gather_probe", "flat_rates_probe",
                  "flat_sweep_forms", "flat_rates_forms",
                  "flat_accumulate_probe"):
            getattr(lib, f).restype = ctypes.c_int
    if name == "cheb_sweep":
        lib.cheb_cluster_barriers.argtypes = [_I] * 4 + [_P]
        lib.cheb_cluster_barriers.restype = ctypes.c_int
        for sfx in ("f32", "f64"):
            f = getattr(lib, f"cheb_bin_sums_{sfx}")
            f.argtypes = [_P] * 5 + [_I, ctypes.c_longlong, _I, _I, _P]
            f.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    return lib


def load(name=None, extra=()):
    """Return the library of ``csrc/<name>.cu`` (the engines' libraries
    of ``SOURCES`` and those named in ``extra``, as a dict, when ``name``
    is None), compiling what is missing first, one nvcc process per source,
    in parallel. ``build_log`` keeps nvcc's output, with ptxas's report of
    registers, shared memory and spills per kernel."""
    global build_log
    names = SOURCES + tuple(extra) if name is None else (name,)
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
