"""The port's CUDA kernels rehearsed on the host: what the
``tests/test_torch_rehearsal_*.py`` files share.

The device parts of ``pyc2ray_torch/ops/csrc/cheb_sweep.cuh``,
``cheb_sweep_kernels.cuh``, ``cheb_sweep_rates.cuh``, ``cheb_rates.cuh``,
``cheb_rates_he.cuh``, ``trace_loop.cu``, ``chemistry.cu``,
``thermal.cuh``, ``flat_sweep.cuh``, ``flat_probe.cu``, ``box_sweep.cuh``
and ``box_probe.cu`` (everything before their launch code), with
``rounded.cuh``, are cut out of the sources and compiled with g++ against
the stand-in headers of
``tests/kernel_host/`` (every thread of every block of a cluster is a
std::thread; the cluster barrier, the mapping of shared memory between
blocks and the warp's ballot and sum are emulated; arithmetic is compiled
without contraction). The library is built once for all the files and
their xdist workers: its name carries a hash of what goes into it, one
process builds it under a lock, to a temporary name that it then renames,
so no process loads a half-written library and an edited source is built
again. The tests hold the kernels against the plain PyTorch versions; that
the sources build for the card and run there is shown by chip_smoke.py and
the ``cuda`` tests."""

import ctypes
import ctypes.util
import fcntl
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.ops.trace_loop import add_boxes, extract_boxes_ref
from pyc2ray_torch.radiation.spectral_bins import SpectralBins

SIG = 6.30e-18
DR = 6.7e20
ROOT = Path(__file__).resolve().parent
CSRC = ROOT.parent / "pyc2ray_torch" / "ops" / "csrc"
HOST = ROOT / "kernel_host"
BUILD = ROOT.parent / "build" / "kernel_host"
CXX_FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread"]

# device construct -> its stand-in
_SUBST = {
    'asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");':
        "emu_cluster_arrive();",
    'asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");':
        "emu_cluster_wait();",
    "extern __shared__ __align__(16) unsigned char smem_raw[];":
        "unsigned char* smem_raw = emu_smem();",
    'asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));':
        "r = emu_add_ftz_f32(a, b);",
    'asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n" ::"r"(d), '
    '"l"(src), "n"(B) : "memory");':
        "(void)d; std::memcpy(dst, src, B);",
    'asm volatile("cp.async.commit_group;\\n" ::: "memory");': "",
    'asm volatile("cp.async.wait_group 1;\\n" ::: "memory");': "",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));': "r = 1.0f / x;",
    'asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));': "r = 1.0 / x;",
}

# file written for the host build -> (source, the marker where its launch
# code begins, the text that closes what is cut)
_PARTS = {
    "cheb_sweep.cuh": ("cheb_sweep.cuh",
                       "// Allow `kernel` on the current device",
                       "}  // namespace cheb\n"),
    "cheb_sweep_kernels.cuh": ("cheb_sweep_kernels.cuh",
                               "// The launches of the four kernels",
                               "}  // namespace cheb\n"),
    "cheb_sweep_rates.cuh": ("cheb_sweep_rates.cuh",
                             "// The launch of both phases",
                             "}  // namespace cheb\n"),
    "cheb_rates.cuh": ("cheb_rates.cuh", "// The launch of the pass on",
                       "}  // namespace cheb\n"),
    "cheb_rates_he.cuh": ("cheb_rates_he.cuh",
                          "// The launch of the helium pass on",
                          "}  // namespace cheb\n"),
    "k_loop.inc": ("trace_loop.cu", "// The launches of the two kernels",
                   "}  // namespace\n"),
    "k_chem.inc": ("chemistry.cu", "// The launches of the two kernels",
                   "}  // namespace chem\n"),
    "thermal.cuh": ("thermal.cuh", "// The launch of the thermal kernel",
                    "}  // namespace thermal\n"),
    "flat_sweep.cuh": ("flat_sweep.cuh", None, ""),   # no launch code
    "k_flat_probe.inc": ("flat_probe.cu",
                         "// The launches of the probe's forms",
                         "}  // namespace flat_probe\n"),
    "rounded.cuh": ("rounded.cuh", None, ""),      # no launch code
    "box_sweep.cuh": ("box_sweep.cuh",
                      "// The launches of the box kernels (host code).",
                      "}  // namespace box\n"),
    "k_box_probe.inc": ("box_probe.cu",
                        "// The launches of the probe's forms (host code).",
                        "}  // namespace box_probe\n"),
}


def device_part(name, cut, tail):
    """Source ``name`` up to the marker ``cut`` (where its launch code
    begins; all of it where ``cut`` is None), closed by ``tail``, with the
    device constructs replaced."""
    text = (CSRC / name).read_text()
    text = (text if cut is None else text[:text.index(cut)]) + tail
    for old, new in _SUBST.items():
        text = text.replace(old, new)
    assert "asm" not in text and "extern __shared__" not in text, name
    return text


def _build(gxx):
    """The path of the host library, built first where it is missing."""
    parts = {f: device_part(*spec) for f, spec in _PARTS.items()}
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for f in sorted(parts):
        h.update(f.encode() + parts[f].encode())
    for f in sorted(HOST.iterdir()):
        h.update(f.name.encode() + f.read_bytes())
    so = BUILD / f"librehearsal_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():              # another process built it meanwhile
            return so
        with tempfile.TemporaryDirectory(dir=BUILD) as d:
            for f, text in parts.items():
                Path(d, f).write_text(text)
            tmp = Path(d) / "librehearsal.so"
            cmd = [gxx, *CXX_FLAGS, f"-I{d}", f"-I{HOST}", "-o", str(tmp),
                   str(HOST / "rehearsal.cpp")]
            done = subprocess.run(cmd, capture_output=True, text=True)
            assert done.returncode == 0, done.stderr[-4000:]
            os.replace(tmp, so)
    return so


_lib = None


def load_library():
    """The host library with its functions' argument types (cached)."""
    global _lib
    if _lib is not None:
        return _lib
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    lib = ctypes.CDLL(str(_build(gxx)))
    for f in (lib.rehearse_f32, lib.rehearse_f64):
        f.argtypes = [ctypes.c_int, ctypes.POINTER(Args)]
        f.restype = ctypes.c_int
    for f in (lib.rehearse_boxes_f32, lib.rehearse_boxes_f64):
        f.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] + [ctypes.c_int] * 7
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)
        f.restype = None
    for f in (lib.rehearse_extract_f32, lib.rehearse_extract_f64):
        f.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 2 + [ctypes.c_int])
        f.restype = None
    for f in (lib.rehearse_init_f32, lib.rehearse_init_f64):
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                      + [ctypes.c_double] + [ctypes.c_int] * 2)
        f.restype = None
    for f in (lib.rehearse_rates_f32, lib.rehearse_rates_f64):
        f.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                      + [ctypes.c_double] * 3 + [ctypes.c_int] * 2)
        f.restype = None
    for f in (lib.rehearse_rates_he_f32, lib.rehearse_rates_he_f64):
        f.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                      + [ctypes.c_double] * 2 + [ctypes.c_int] * 2)
        f.restype = ctypes.c_int
    for f in (lib.rehearse_he_fits_f32, lib.rehearse_he_fits_f64):
        f.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
        f.restype = ctypes.c_int
    for f in (lib.rehearse_chem_f32, lib.rehearse_chem_f64):
        f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_double] + [ctypes.c_int] * 3
        f.restype = None
    for f in (lib.rehearse_flat_f32, lib.rehearse_flat_f64):
        f.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 6
        f.restype = None
    lib.rehearse_flat_forms.argtypes = [ctypes.c_void_p] * 2
    lib.rehearse_flat_forms.restype = None
    for f in (lib.rehearse_box_f32, lib.rehearse_box_f64):
        f.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 13
        f.restype = ctypes.c_int
    for f in (lib.rehearse_thermal_f32, lib.rehearse_thermal_f64):
        f.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_double] + [ctypes.c_int] * 4
        f.restype = ctypes.c_int
    _lib = lib
    return lib


@pytest.fixture(scope="module")
def lib():
    return load_library()


class Args(ctypes.Structure):
    """struct Args of kernel_host/rehearsal.cpp."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "nhi", "sw", "path", "diag", "mm", "mp", "rt", "bs", "bw", "bwh",
            "flux", "pin", "pout", "box", "box2", "ci", "dc", "scratch")]
        + [(n, ctypes.c_int) for n in ("B", "Dc", "c", "R1", "E", "r0", "r1")]
        + [(n, ctypes.c_double) for n in ("dr", "sig", "R2", "sdr3", "s_fac")]
        + [(n, ctypes.c_int) for n in ("threads", "C", "sh", "smem",
                                       "rate_threads", "ring")])


def three_bins():
    return SpectralBins(s=np.array([1.0, 0.5, 0.2]),
                        w_photo=np.array([0.5, 0.3, 0.2]),
                        w_heat=np.array([0.1, 0.2, 0.3]), num_bins=3)


K1, K1F, K2, K3, K3H = range(5)


class Case:
    """One engine shape with random densities and fluxes (with B > 1 the
    last flux is 0),
    and the kernels on the host under a launch plan (cluster size, planes
    shared, chain threads, rate threads, ring slots)."""

    def __init__(self, lib, N, R, B, dt, plan):
        self.rt = ChebRaytracer(N, R, SIG, three_bins(), batch_size=B,
                                dtype=dt, device="cpu")
        self.g, self.tb = self.rt.geom, self.rt.tables
        tb, Dc = self.tb, self.g.Dc
        rng = np.random.RandomState(N + B)
        self.nhi = torch.from_numpy(
            10 ** rng.uniform(-4, -2, (B, Dc, Dc, Dc))).to(dt)
        self.flux = torch.from_numpy(rng.uniform(0.5, 2.0, B)).to(dt)
        if B > 1:
            self.flux[-1] = 0.0
        self.geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
        self.fn = lib.rehearse_f32 if dt == torch.float32 else lib.rehearse_f64
        self.dt, self.plan = dt, plan

    def run(self, kind, planes=None, r0=0, r1=0, box=None, plan=None,
            smem=None):
        """Kernel ``kind``; returns (box, second box, planes out), or the
        launch code's refusal; K3 and K3h also leave phase A's boxes in
        ``self.ci`` and ``self.dc``. Every output starts as NaN."""
        nhi, tb, g = self.nhi, self.tb, self.g
        B, Dc, R1 = nhi.shape[0], g.Dc, tb.sw.shape[2]
        E = tb.bins_s.shape[0] if kind in (K1F, K3, K3H) else 0
        C, sh, threads, rate_threads, ring = plan or self.plan
        if kind != K1F and plan is None:
            rate_threads = ring = 0
        if smem is None:
            smem = sweep.plan_sizes(Dc, nhi.element_size(), C, sh,
                                    2 * E if kind == K1F else 0, ring)[0]

        def nan(*shape):
            return torch.full(shape, float("nan"), dtype=self.dt)
        box = nan(*nhi.shape) if box is None else box
        box2, pout = nan(*nhi.shape), nan(B, 3, 2, Dc, Dc)
        self.ci, self.dc = nan(*nhi.shape), nan(*nhi.shape)
        scratch = nan(B, 12, Dc, Dc)
        dr_t = torch.tensor(DR, dtype=self.dt)
        sdr3 = sweep.s_over_dr3(dr_t, self.dt)
        keep = (nhi, *self.geo, tb.rt_tab, tb.bins_s, tb.bins_w, tb.bins_wh,
                self.flux, planes, pout, box, box2, self.ci, self.dc, scratch)
        args = Args(*[None if t is None else t.data_ptr() for t in keep],
                    B, Dc, g.c, R1, E, r0, r1, DR, SIG,
                    self.rt.R_max_LLS ** 2, float(sdr3),
                    float(sdr3 * dr_t), threads, C, int(sh), smem,
                    rate_threads, ring)
        rc = self.fn(kind, ctypes.byref(args))
        return (box, box2, pout) if rc == 0 else rc


# (cluster size, planes shared, chain threads, rate threads, ring slots): a
# ring as large as any share; one smaller than most shares, whose overflow
# the chain threads evaluate; more rate threads than chain threads
PLANS = [(1, False, 2, 1, 512), (4, False, 3, 2, 7), (4, True, 2, 3, 64),
         (8, True, 3, 1, 3), (2, False, 5, 2, 40), (16, True, 1, 1, 16)]

# (16, 6): an unclipped box; (8, 6) and (16, 8): clipped by the mesh (the
# plus faces leave the box); (9, 8): clipped, box side 9; (16, 3): box side
# rounded past the radius; B = 1 and 2
SWEEP_SHAPES = [(16, 6.0, 2), (8, 6.0, 2), (16, 8.0, 1), (9, 8.0, 1),
                (16, 3.0, 2)]


# The box kernels of the trace loop (csrc/trace_loop.cu). A case: the frame's
# extents, the staged box side Dc, the side D and shift of the boxes that
# are accumulated, B, and whether the corners of its nb = 3 batches of B
# boxes cluster.
def corners(rng, nb, B, shape, Dc, clustered):
    if clustered:
        # every box within two cells of one corner, some at the same cell
        base = rng.randint(0, np.array(shape) - Dc - 1, size=3)
        pos = base + rng.randint(0, 3, size=(nb, B, 3))
        pos[:, 1] = pos[:, 0]
        pos[:, -1] = pos[:, 2]
    else:
        pos = rng.randint(0, np.array(shape) - Dc + 1, size=(nb, B, 3))
    return torch.from_numpy(pos.astype(np.int32))


# overlap: a cubic frame of a batch clustered as halos are; subbox: a
# (Ds)^3 rates subbox 2 cells into (Dc)^3 boxes, as ChebRaytracer.add_boxes
# shifts it by rb0; domain: a non-cubic halo-extended block as domain.py
# builds it, boxes spread over it; single: B = 1; chunks: 20 clustered
# boxes, so a cell takes up to 20 adds, more than one chunk of the loads an
# owner issues before it adds (8); masks: 40 clustered boxes, more than one
# 32-box coverage mask
BOX_CASES = {
    "overlap": ((20, 20, 20), 7, 7, 0, 8, True),
    "subbox": ((21, 21, 21), 9, 5, 2, 6, False),
    "domain": ((13, 30, 22), 8, 8, 0, 5, False),
    "single": ((11, 12, 13), 6, 6, 0, 1, False),
    "chunks": ((14, 15, 16), 5, 5, 0, 20, True),
    "masks": ((9, 10, 11), 4, 4, 0, 40, True),
}


def check_box_kernels(lib, case, dt, threads):
    """extract_boxes and accumulate_boxes bit for bit against their plain
    versions on BOX_CASES[case] (test_torch_rehearsal_boxes_*.py)."""
    shape, Dc, D, shift, B, clustered = BOX_CASES[case]
    rng = np.random.RandomState(sum(shape) + threads)
    pos = corners(rng, 3, B, shape, Dc, clustered)
    fn = lib.rehearse_boxes_f32 if dt == torch.float32 else \
        lib.rehearse_boxes_f64
    ex = lib.rehearse_extract_f32 if dt == torch.float32 else \
        lib.rehearse_extract_f64
    ptrs = ctypes.c_void_p * 4

    def call(extract, frames, boxes, k, d, sh, reverse=0):
        if extract:                 # a chunk of one batch
            ex(ptrs(*[f.data_ptr() for f in frames]),
               ptrs(*[b.data_ptr() for b in boxes]), len(frames),
               pos.data_ptr(), k, 1, B, d, shape[1] * shape[2], shape[2],
               reverse)
            return
        fn(ptrs(*[f.data_ptr() for f in frames]),
           ptrs(*[b.data_ptr() for b in boxes]), len(frames),
           pos.data_ptr(), k, B, d, sh, *shape, None, None, 0, threads,
           reverse)

    def rand(*sh):
        return torch.from_numpy(rng.standard_normal(sh)).to(dt)
    for n in (1, 3):
        frames = [rand(*shape) for _ in range(n)]
        for k in range(3):
            got = [torch.full((B, Dc, Dc, Dc), float("nan"), dtype=dt)
                   for _ in range(n)]
            call(1, frames, got, k, Dc, 0)
            for f, g in zip(frames, got):
                assert torch.equal(g, extract_boxes_ref(f, pos[k], Dc))
    for n in (1, 2, 4):
        frames = [rand(*shape) for _ in range(n)]
        want = [f.clone() for f in frames]
        got = {r: [f.clone() for f in frames] for r in (0, 1)}
        for k in range(3):
            boxes = [rand(B, D, D, D) for _ in range(n)]
            for f, b in zip(want, boxes):
                add_boxes(f, b, pos[k], shift)
            for r in (0, 1):
                call(0, got[r], boxes, k, D, shift, reverse=r)
        for r in (0, 1):
            for g, w in zip(got[r], want):
                assert torch.equal(g, w), (case, n, r)
    if clustered:
        # the batch does overlap: some cell takes the adds of several boxes,
        # of all B where the boxes are larger than the cluster
        cover = torch.zeros(shape, dtype=torch.int32)
        for p in pos[0].tolist():
            cover[p[0]:p[0] + D, p[1]:p[1] + D, p[2]:p[2] + D] += 1
        assert int(cover.max()) == B


def glibc_exp(dt):
    """(exp, expm1) elementwise by glibc's exp/expm1 (float64) or expf/
    expm1f (float32), the functions the host build of the kernels calls."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    if dt == torch.float32:
        fns = []
        for name in ("expf", "expm1f"):
            f = getattr(libm, name)
            f.argtypes, f.restype = [ctypes.c_float], ctypes.c_float
            fns.append(f)
    else:
        fns = [math.exp, math.expm1]

    def elementwise(f):
        return lambda x: torch.tensor([f(v) for v in x.reshape(-1).tolist()],
                                      dtype=x.dtype).reshape(x.shape)
    return [elementwise(f) for f in fns]


def he_case(N, R, B, dt, heat, seed=71):
    """A helium engine (CPU, 8 bins), the three species' absorber boxes
    (n_HeII 0 in one cell, n_HeI in another), their plain K1 boxes (cd_HI
    past MAX_COLDENSH in a third cell) and fluxes with the last one 0."""
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    from pyc2ray_torch.radiation import BlackBodySource, helium
    from pyc2ray_torch.constants import ev2fr
    bins = helium.make_spectral_bins_he(
        BlackBodySource(5e4, False, ev2fr * 13.598, 2.8), panels_per_band=2,
        nodes=4)
    rt = HeRaytracer(N, R, bins, 0.074, batch_size=B, dtype=dt, device="cpu",
                     do_heating=heat)
    g, tb = rt.geom, rt.eng.tables
    rng = np.random.RandomState(seed)
    nb = [torch.from_numpy(10 ** rng.uniform(lo, lo + 2, (B,) + (g.Dc,) * 3)
                           ).to(dt) for lo in (-4, -5, -6)]
    c = g.c
    nb[2][0, c + 1, c, c] = 0.0
    nb[1][-1, c, c + 1, c] = 0.0
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    cds = [sweep.cheb_sweep_ref(n, *geo, DR, c, sig)
           for n, sig in zip(nb, rt.sigma_th)]
    cds[0][0, c, c + 2, c] = 1e31
    flux = torch.from_numpy(rng.uniform(0.5, 2.0, B)).to(dt)
    if B > 1:
        flux[-1] = 0.0
    return rt, cds, nb, flux
