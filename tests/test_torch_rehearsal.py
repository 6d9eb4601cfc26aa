"""The port's CUDA kernels rehearsed on the host.

The device parts of ``pyc2ray_torch/ops/csrc/cheb_sweep.cuh``,
``cheb_sweep_kernels.cuh``, ``cheb_sweep_rates.cuh``, ``cheb_rates.cuh``,
``cheb_rates_he.cuh``, ``trace_loop.cu`` and ``chemistry.cu`` are cut out
of the sources,
compiled with g++ against the stand-in headers of ``tests/kernel_host/``
(every thread of every block of a cluster is a std::thread; the cluster
barrier and the mapping of shared memory between blocks are emulated;
arithmetic is compiled without contraction) and held
against the plain PyTorch versions: K1, K2 and phase A of K3 bit for bit,
K1f, K3 and K3h within the tolerance of their exp/expm1, and K1f with rate
threads bit for bit against itself without; the trace loop's box extract
and ordered accumulate bit for bit against ``extract_boxes_ref`` and
``add_boxes``, with their blocks in either order, up to 1100 boxes a
batch;
the start of a segmented sweep and the dense rate passes over the engine's
rated cells bit for bit against ``init_segments_ref``, ``rates_dense_ref``
and the helium engine's ``rates_he_ref`` (the plain passes with glibc's exp
and expm1, the ones the host build calls, in place of torch's); the sizes
the helium loop's host side refuses (``he_loop_fits``); the chemistry passes
against ``global_pass_ref`` and ``global_pass_he_ref`` (see below). This
checks the kernels' logic (shell windows, the dealing of cells to blocks,
plane ownership, stitches, carried planes, the ring that hands K1f's cells
to the rate threads, the one owner of every frame cell where boxes overlap,
per-cell freezing and the block-reduced count) for every cluster size and
placement; that the sources build for the card and run there is shown by
chip_smoke.py and the ``cuda`` tests."""

import ctypes
import ctypes.util
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pyc2ray_torch.ops import cheb_rates, sweep
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.ops.trace_loop import add_boxes, extract_boxes_ref
from pyc2ray_torch.radiation.spectral_bins import SpectralBins

SIG = 6.30e-18
DR = 6.7e20
ROOT = Path(__file__).resolve().parent
CSRC = ROOT.parent / "pyc2ray_torch" / "ops" / "csrc"
HOST = ROOT / "kernel_host"

# device construct -> its stand-in
_SUBST = {
    'asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");':
        "emu_cluster_arrive();",
    'asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");':
        "emu_cluster_wait();",
    "extern __shared__ __align__(16) unsigned char smem_raw[];":
        "unsigned char* smem_raw = emu_smem();",
}


def _device_part(name, cut, tail):
    """Source ``name`` up to the marker ``cut`` (where its launch code
    begins), closed by ``tail``, with the device constructs replaced."""
    text = (CSRC / name).read_text()
    text = text[:text.index(cut)] + tail
    for old, new in _SUBST.items():
        text = text.replace(old, new)
    assert "asm" not in text and "extern __shared__" not in text, name
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    d = tmp_path_factory.mktemp("kernel_host")
    (d / "cheb_sweep.cuh").write_text(_device_part(
        "cheb_sweep.cuh", "// Allow `kernel` on the current device",
        "}  // namespace cheb\n"))
    (d / "cheb_sweep_kernels.cuh").write_text(_device_part(
        "cheb_sweep_kernels.cuh", "// The launches of the four kernels",
        "}  // namespace cheb\n"))
    (d / "cheb_sweep_rates.cuh").write_text(_device_part(
        "cheb_sweep_rates.cuh", "// The launch of both phases",
        "}  // namespace cheb\n"))
    (d / "cheb_rates.cuh").write_text(_device_part(
        "cheb_rates.cuh", "// The launch of the pass on",
        "}  // namespace cheb\n"))
    (d / "cheb_rates_he.cuh").write_text(_device_part(
        "cheb_rates_he.cuh", "// The launch of the helium pass on",
        "}  // namespace cheb\n"))
    (d / "k_loop.inc").write_text(_device_part(
        "trace_loop.cu", "// The launches of the two kernels",
        "}  // namespace\n"))
    (d / "k_chem.inc").write_text(_device_part(
        "chemistry.cu", "// The launches of the two kernels",
        "}  // namespace chem\n"))
    so = d / "librehearsal.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
           "-pthread", f"-I{d}", f"-I{HOST}", "-o", str(so),
           str(HOST / "rehearsal.cpp")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for f in (lib.rehearse_f32, lib.rehearse_f64):
        f.argtypes = [ctypes.c_int, ctypes.POINTER(_Args)]
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
    return lib


class _Args(ctypes.Structure):
    """struct Args of kernel_host/rehearsal.cpp."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "nhi", "sw", "path", "diag", "mm", "mp", "rt", "bs", "bw", "bwh",
            "flux", "pin", "pout", "box", "box2", "ci", "dc", "scratch")]
        + [(n, ctypes.c_int) for n in ("B", "Dc", "c", "R1", "E", "r0", "r1")]
        + [(n, ctypes.c_double) for n in ("dr", "sig", "R2", "sdr3", "s_fac")]
        + [(n, ctypes.c_int) for n in ("threads", "C", "sh", "smem",
                                       "rate_threads", "ring")])


def _bins():
    return SpectralBins(s=np.array([1.0, 0.5, 0.2]),
                        w_photo=np.array([0.5, 0.3, 0.2]),
                        w_heat=np.array([0.1, 0.2, 0.3]), num_bins=3)


K1, K1F, K2, K3, K3H = range(5)


class _Case:
    """One engine shape with random densities and fluxes (with B > 1 the
    last flux is 0),
    and the kernels on the host under a launch plan (cluster size, planes
    shared, chain threads, rate threads, ring slots)."""

    def __init__(self, lib, N, R, B, dt, plan):
        self.rt = ChebRaytracer(N, R, SIG, _bins(), batch_size=B, dtype=dt,
                                device="cpu")
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
        args = _Args(*[None if t is None else t.data_ptr() for t in keep],
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
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B", [(16, 6.0, 2), (8, 6.0, 2), (16, 8.0, 1),
                                   (9, 8.0, 1), (16, 3.0, 2)])
def test_kernels_on_the_host_match_plain(lib, N, R, B, dt):
    for plan in PLANS:
        case = _Case(lib, N, R, B, dt, plan)
        nhi, geo, g, tb = case.nhi, case.geo, case.g, case.tb
        # K1
        k1, _, _ = case.run(K1)
        want = sweep.cheb_sweep_ref(nhi, *geo, DR, g.c, SIG)
        assert torch.equal(k1, want), plan
        # K2 chained over ragged segments: box and carried planes
        planes = sweep.init_planes(nhi, g.c, DR)
        planes_ref = planes.clone()
        box, box_ref = torch.zeros_like(nhi), torch.zeros_like(nhi)
        for r0 in range(1, g.r_max + 1, 3):
            box, _, planes = case.run(K2, planes=planes, r0=r0,
                                      r1=min(r0 + 3, g.r_max + 1), box=box)
            box_ref, planes_ref = sweep.cheb_sweep_seg_ref(
                nhi, *geo, DR, g.c, SIG, planes_ref, r0, 3, box_ref)
            assert torch.equal(planes, planes_ref), (plan, r0)
            assert torch.equal(box, box_ref), (plan, r0)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B", [(16, 6.0, 2), (8, 6.0, 2), (16, 8.0, 1),
                                   (9, 8.0, 1), (16, 3.0, 2)])
def test_fused_kernels_on_the_host_match_plain(lib, N, R, B, dt):
    """K1f with rate threads and a ring: bit for bit against the same
    kernel without them (every cell evaluated by its chain thread inside
    the sub-step). K3's and K3h's phase A: cdin and dcol of every rated
    cell bit for bit. All three against their plain versions within libm's
    exp/expm1 against torch's, a few ulp per bin; the source cell and the
    flux (one of them 0) included."""
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    for plan in PLANS:
        case = _Case(lib, N, R, B, dt, plan)
        nhi, geo, g, tb = case.nhi, case.geo, case.g, case.tb
        rates = (nhi, *geo, tb.rt_tab, case.flux, DR, g.c, SIG, tb.bins_s,
                 tb.bins_w)

        def check(got, refs):
            for a, ref in zip(got, refs):
                torch.testing.assert_close(a, ref, rtol=rtol, atol=0)
                assert float(ref[0, g.c, g.c, g.c]) > 0
                assert B == 1 or bool((a[-1] == 0).all())        # flux 0
        want = sweep.cheb_sweep_ref(
            nhi, *geo, DR, g.c, SIG, bins=(tb.bins_s, tb.bins_w),
            rt_tab=tb.rt_tab, R2=case.rt.R_max_LLS ** 2, flux=case.flux)
        got = case.run(K1F)[0]
        assert torch.equal(got, case.run(K1F, plan=plan[:3] + (0, 0))[0]), plan
        check((got,), (want,))
        check(case.run(K3)[:1], (sweep.cheb_sweep_rates_ref(*rates),))
        check(case.run(K3H)[:2],
              sweep.cheb_sweep_rates_ref(*rates, bins_wh=tb.bins_wh))
        # phase A against the plain version's emit
        ci_ref, dc_ref = torch.zeros_like(nhi), torch.zeros_like(nhi)

        def emit(f, r, mask, cdin, dcol, nhi_f, out):
            zero = torch.zeros_like(cdin)
            sweep._put(ci_ref, f, r, g.c, torch.where(mask, cdin, zero))
            sweep._put(dc_ref, f, r, g.c, torch.where(mask, dcol, zero))
        dr_t = torch.tensor(DR, dtype=dt)
        sweep._sweep_shells(nhi, *geo, dr_t, torch.tensor(SIG, dtype=dt),
                            g.c, sweep.init_planes(nhi, g.c, dr_t), 1,
                            g.r_max + 1, emit)
        valid = tb.rt_tab[:, 1] > 0.5
        assert torch.equal(case.ci[:, valid], ci_ref[:, valid]), plan
        assert torch.equal(case.dc[:, valid], dc_ref[:, valid]), plan


def test_host_launch_code_refuses_other_sizes(lib):
    """make_plan computes the shared-memory size itself and refuses a
    caller whose size differs (the launch then never happens), a cluster
    size that is no power of two, rate threads or a ring for a kernel
    that defers nothing, and a ring that no thread drains."""
    case = _Case(lib, 8, 6.0, 1, torch.float64, (4, True, 1, 0, 0))
    smem = sweep.plan_sizes(case.g.Dc, 8, 4, True)[0]
    assert case.run(K1, smem=smem + 8) == 1
    assert case.run(K1, plan=(3, True, 1, 0, 0), smem=smem) == 1
    assert isinstance(case.run(K1), tuple)
    smem = sweep.plan_sizes(case.g.Dc, 8, 4, True, 6, 5)[0]
    assert case.run(K1F, plan=(4, True, 1, 2, 5), smem=smem + 4) == 1
    assert case.run(K1F, plan=(4, True, 1, 0, 5)) == 1
    assert case.run(K3, plan=(4, True, 1, 2, 5)) == 1
    assert isinstance(case.run(K1F, plan=(4, True, 1, 2, 5)), tuple)


# The box kernels of the trace loop (csrc/trace_loop.cu). A case: the frame's
# extents, the staged box side Dc, the side D and shift of the boxes that
# are accumulated, B, and whether the corners of its nb = 3 batches of B
# boxes cluster.
def _corners(rng, nb, B, shape, Dc, clustered):
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


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(BOX_CASES))
@pytest.mark.parametrize("threads", [7, 64])
def test_box_kernels_on_the_host_match_plain(lib, case, dt, threads):
    """extract_boxes and accumulate_boxes bit for bit against their plain
    versions, for one channel and for several at once (the helium engine's
    three species; Gamma and heat; its four rate channels), on frames that
    do not start at zero; the accumulate also with its blocks in reverse
    order, which a design where two threads write one cell would not
    survive."""
    shape, Dc, D, shift, B, clustered = BOX_CASES[case]
    rng = np.random.RandomState(sum(shape) + threads)
    pos = _corners(rng, 3, B, shape, Dc, clustered)
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


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_accumulate_on_the_host_with_more_boxes_than_staged(lib, dt):
    """accumulate_boxes with 1100 clustered boxes in a batch, more than the
    kernel stages in shared memory (1024: their corners are read from
    device memory), whose near-box mask spans 35 words: an owner's adds run
    on across the 32-box words in ascending box order, bit for bit against
    add_boxes, with its blocks in either order; some cell takes all 1100
    adds."""
    shape, D, B = (6, 6, 7), 3, 1100
    rng = np.random.RandomState(71)
    pos = _corners(rng, 1, B, shape, D, True)
    box = torch.from_numpy(rng.standard_normal((B, D, D, D))).to(dt)
    frame = torch.from_numpy(rng.standard_normal(shape)).to(dt)
    want = frame.clone()
    add_boxes(want, box, pos[0])
    fn = lib.rehearse_boxes_f32 if dt == torch.float32 else \
        lib.rehearse_boxes_f64
    for reverse in (0, 1):
        got = frame.clone()
        fn((ctypes.c_void_p * 4)(got.data_ptr()),
           (ctypes.c_void_p * 4)(box.data_ptr()), 1, pos.data_ptr(), 0, B, D,
           0, *shape, None, None, 0, 32, reverse)
        assert torch.equal(got, want), reverse
    p = pos[0].long()
    assert bool((p.amax(0) - p.amin(0) < D).all())      # a cell in all boxes


# The chunked extract (csrc/trace_loop.cu): a case is the frame's extents,
# the padding of its rows (a pitched view: the frame a slice of a wider
# tensor), the box side D, B, the batches nb and the chunk k. D = 8: rows of
# 16 bytes in both types (vectors of 16 bytes); D = 7 and 5: neither (a
# vector of one cell); nb = 5, k = 2 ends on a short chunk.
CHUNK_CASES = {
    "wide": ((20, 21, 22), 0, 8, 3, 5, 2),
    "pitched": ((13, 30, 22), 5, 7, 4, 3, 3),
    "narrow": ((11, 12, 13), 0, 5, 6, 4, 4),
    "planes": ((17, 16, 15), 3, 12, 2, 5, 2),
}


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_extract_chunk_on_the_host_matches_plain(lib, case, dt):
    """The extract, a chunk of k batches a launch, bit for bit against
    extract_chunk_ref (each batch's extract_boxes_ref) with one channel and
    with three: every chunk of the trace, the short last one too, with the
    blocks in either order, on a frame that is a view with padded rows."""
    from pyc2ray_torch.ops.trace_loop import extract_chunk_ref
    shape, pad, D, B, nb, k = CHUNK_CASES[case]
    rng = np.random.RandomState(sum(shape) + D)
    pos = torch.from_numpy(rng.randint(0, np.array(shape) - D + 1,
                                       size=(nb, B, 3)).astype(np.int32))
    fn = lib.rehearse_extract_f32 if dt == torch.float32 else \
        lib.rehearse_extract_f64
    ptrs = ctypes.c_void_p * 4
    wide = [torch.from_numpy(rng.standard_normal(
        shape[:2] + (shape[2] + pad,))).to(dt) for _ in range(3)]
    frames = [w[:, :, :shape[2]] for w in wide]
    S0, S1 = frames[0].stride(0), frames[0].stride(1)
    for n in (1, 3):
        for reverse in (0, 1):
            for k0 in range(0, nb, k):
                kk = min(k, nb - k0)
                got = [torch.full((kk, B, D, D, D), float("nan"), dtype=dt)
                       for _ in range(n)]
                fn(ptrs(*[f.data_ptr() for f in frames[:n]]),
                   ptrs(*[g.data_ptr() for g in got]), n, pos.data_ptr(),
                   k0, kk, B, D, S0, S1, reverse)
                for f, g in zip(frames, got):
                    want = extract_chunk_ref(f, pos, k0, kk, D)
                    assert torch.equal(g, want), (n, reverse, k0)


# (N, R, B, clustered): the engine's rates subbox (Ds = 13 of Dc = 16 at
# rb0 = 1) and the full box of a clipped one (Dc = 8); 3 batches of B
# sources, clustered as halos are or spread, and 40 clustered sources in the
# clipped box (two 32-box masks)
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B,clustered", [(16, 6.0, 6, True),
                                             (16, 6.0, 5, False),
                                             (8, 6.0, 4, True),
                                             (8, 6.0, 40, True)])
def test_rated_accumulate_on_the_host_matches_plain(lib, N, R, B, clustered,
                                                    dt):
    """accumulate_boxes over the engine's rated cells (the unfused modes'
    rate boxes, 0 at every other cell) bit for bit against the slice adds
    of the whole boxes at shift rb0, one channel and two (Gamma and heat),
    its blocks in either order: where boxes overlap, the owner of a frame
    cell is the lowest box that rates it."""
    rt = ChebRaytracer(N, R, SIG, _bins(), batch_size=B, dtype=dt,
                       device="cpu")
    g, tb, Ds, rb0 = rt.geom, rt.tables, rt.Ds, rt._rb0
    cells, valid = rt.rated_cells, tb.rt_sub[2].contiguous()
    shape = (N + g.Dc - 1,) * 3
    rng = np.random.RandomState(N + B)
    if clustered:
        pos = rng.randint(0, N - 2, 3) + rng.randint(0, 3, (3, B, 3))
        pos[:, 1] = pos[:, 0]
    else:
        pos = rng.randint(0, N, (3, B, 3))
    pos = torch.from_numpy(pos.astype(np.int32))
    fn = lib.rehearse_boxes_f32 if dt == torch.float32 else \
        lib.rehearse_boxes_f64
    ptrs = ctypes.c_void_p * 4
    for n in ((1, 2) if B <= 32 else (2,)):
        frames = [torch.from_numpy(np.abs(rng.standard_normal(shape))).to(dt)
                  for _ in range(n)]
        want = [f.clone() for f in frames]
        got = {r: [f.clone() for f in frames] for r in (0, 1)}
        for k in range(3):
            boxes = [torch.from_numpy(np.abs(rng.standard_normal(
                (B, Ds, Ds, Ds)))).to(dt) * (valid > 0.5) for _ in range(n)]
            for f, bx in zip(want, boxes):
                add_boxes(f, bx, pos[k], rb0)
            for r in (0, 1):
                fn(ptrs(*[f.data_ptr() for f in got[r]]),
                   ptrs(*[bx.data_ptr() for bx in boxes]), n,
                   pos.data_ptr(), k, B, Ds, rb0, *shape, cells.data_ptr(),
                   valid.data_ptr(), cells.numel(), 16, r)
        for r in (0, 1):
            for a, w in zip(got[r], want):
                assert torch.equal(a, w), (n, r)
    if clustered:
        # some frame cell takes the rates of several boxes
        cover = torch.zeros(shape, dtype=torch.int32)
        for p in pos[0].tolist():
            cover[tuple(slice(c + rb0, c + rb0 + Ds) for c in p)] += (
                valid > 0.5).to(torch.int32)
        assert int(cover.max()) >= 3


# The start of a segmented sweep and the dense rate pass of the unfused
# sweep modes (csrc/cheb_sweep_kernels.cuh, csrc/cheb_rates.cuh).
def _libm(dt):
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


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B", [(16, 6.0, 2), (8, 6.0, 2), (16, 8.0, 1)])
@pytest.mark.parametrize("reverse", [0, 1])
def test_init_segments_on_the_host_matches_plain(lib, N, R, B, dt, reverse):
    """init_segments_kernel bit for bit against init_segments_ref (the box
    and shell 0's planes), with its blocks in either order; chained with K2
    it gives K1's box."""
    case = _Case(lib, N, R, B, dt, (1, False, 5, 0, 0))
    nhi, g = case.nhi, case.g
    box = torch.full_like(nhi, float("nan"))
    planes = torch.full((B, 3, 2, g.Dc, g.Dc), float("nan"), dtype=dt)
    fn = lib.rehearse_init_f32 if dt == torch.float32 else \
        lib.rehearse_init_f64
    fn(nhi.data_ptr(), box.data_ptr(), planes.data_ptr(), B, g.Dc, g.c, DR,
       7, reverse)
    want_box, want_planes = sweep.init_segments_ref(nhi, g.c, DR)
    assert torch.equal(box, want_box) and torch.equal(planes, want_planes)
    assert torch.equal(want_planes, sweep.init_planes(nhi, g.c, DR))
    S = 3
    for r0 in range(1, g.r_max + 1, S):
        box, _, planes = case.run(K2, planes=planes, r0=r0,
                                  r1=min(r0 + S, g.r_max + 1), box=box)
    assert torch.equal(box, sweep.cheb_sweep_ref(nhi, *case.geo, DR, g.c,
                                                 SIG))


# (N, R, B, rb0): (16, 6) a rates subbox (Ds = 13 of Dc = 16) and (8, 6) the
# full box of a clipped one, as the engine builds them; rb0 = 2 a subbox
# away from the box's corner (the kernel's offset arithmetic)
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B,rb0", [(16, 6.0, 2, None), (8, 6.0, 2, None),
                                       (16, 6.0, 2, 2)])
@pytest.mark.parametrize("heat", [False, True])
def test_rate_pass_on_the_host_matches_plain(lib, monkeypatch, N, R, B, rb0,
                                             dt, heat):
    """rates_dense_kernel on the engine's list of rated cells
    (``rated_cells``) bit for bit against rates_dense_ref on K1's boxes with
    a zero-density cell, a cell past MAX_COLDENSH and a zero flux, Gamma and
    with ``heat`` the heating rate, its blocks in either order: the kernel
    writes the listed cells of every box and no other (the outputs start as
    NaN), where the plain pass gives 0, so its zeroed outputs equal the
    plain pass's. The plain pass takes glibc's exp and expm1 in place of
    torch's (whose vectorized forms differ from them by an ulp here and
    there)."""
    case = _Case(lib, N, R, B, dt, (1, False, 5, 0, 0))
    rt, g, tb, nhi = case.rt, case.g, case.tb, case.nhi
    nhi[0, g.c + 1, g.c, g.c] = 0.0
    cd = sweep.cheb_sweep_ref(nhi, *case.geo, DR, g.c, SIG)
    cd[-1, g.c, g.c + 2, g.c] = 1e31
    Ds, rt_sub, cells = rt.Ds, tb.rt_sub, rt.rated_cells
    if rb0 is None:
        rb0 = rt._rb0
    else:
        Ds -= rb0
        rt_sub = rt_sub[:, rb0:, rb0:, rb0:].contiguous()
        cells = cheb_rates.rated_cells(rt_sub)
    listed = torch.zeros(Ds ** 3, dtype=torch.bool)
    listed[cells.long()] = True
    assert 0 < cells.numel() < Ds ** 3
    assert torch.equal(listed.view((Ds,) * 3), rt_sub[2] > 0.5)
    sdr3 = float(sweep.s_over_dr3(DR, dt))
    wh = tb.bins_wh if heat else None
    outs = {}
    for reverse in (0, 1):
        phi, heat_box = (torch.full((B,) + (Ds,) * 3, float("nan"), dtype=dt)
                         for _ in range(2))
        ptrs = [t.data_ptr() if t is not None else None for t in (
            cd, nhi, rt_sub, cells, case.flux, tb.bins_s, tb.bins_w, wh, phi,
            heat_box if heat else None)]
        fn = lib.rehearse_rates_f32 if dt == torch.float32 else \
            lib.rehearse_rates_f64
        fn((ctypes.c_void_p * 10)(*ptrs), B, tb.bins_s.shape[0], g.Dc, Ds,
           rb0, cells.numel(), DR, SIG, sdr3, 64, reverse)
        outs[reverse] = (phi, heat_box)
    exp, expm1 = _libm(dt)
    monkeypatch.setattr(torch, "exp", exp)
    monkeypatch.setattr(torch, "expm1", expm1)
    want = cheb_rates.rates_dense_ref(cd, nhi, rt_sub, case.flux, tb.bins_s,
                                      tb.bins_w, DR, SIG, sdr3, rb0,
                                      bins_wh=wh)
    monkeypatch.undo()
    for reverse, got in outs.items():
        for a, w in zip(got, want):
            if w is None:
                continue
            written = ~torch.isnan(a).view(B, -1)
            assert torch.equal(written, listed.expand(B, -1)), reverse
            assert not bool(w.view(B, -1)[:, ~listed].any())
            assert float(w.max()) > 0
            assert torch.equal(torch.nan_to_num(a, nan=0.0), w), reverse
    assert float(want[0][1].abs().max()) == 0.0 or B == 1      # zero flux


# The helium engine's rate pass (csrc/cheb_rates_he.cuh) and the sizes its
# loop takes (he_trace_sweep in csrc/trace_loop.cu).
def _he_case(N, R, B, dt, heat, seed=71):
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


# (N, R, B, rb0): (16, 6) a rates subbox (Ds = 13 of Dc = 16) and (8, 6) the
# full box of a clipped one, as the engine builds them; rb0 = 2 a subbox
# away from the box's corner
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B,rb0", [(16, 6.0, 2, None), (8, 6.0, 2, None),
                                       (16, 6.0, 1, 2)])
@pytest.mark.parametrize("heat", [False, True])
def test_rate_pass_he_on_the_host_matches_plain(lib, monkeypatch, N, R, B,
                                                rb0, dt, heat):
    """rates_he_kernel on the host engine's list of rated cells bit for bit
    against rates_he_ref on the three species' K1 boxes, with zero-density
    cells of HeI and HeII, a cell past MAX_COLDENSH and a zero flux: the
    three rates and with ``heat`` the heat per HI atom, its blocks in either
    order, written at the listed cells of every box and no other (the
    outputs start as NaN). The plain pass takes glibc's exp and expm1 in
    place of torch's. Sizes the launch code does not take are refused."""
    rt, cds, nb, flux = _he_case(N, R, B, dt, heat)
    eng, heb = rt.eng, rt.he_tables
    Ds, rt_sub, cells = eng.Ds, eng.tables.rt_sub, eng.rated_cells
    if rb0 is None:
        rb0 = eng._rb0
    else:
        Ds -= rb0
        rt_sub = rt_sub[:, rb0:, rb0:, rb0:].contiguous()
        cells = cheb_rates.rated_cells(rt_sub)
    listed = torch.zeros(Ds ** 3, dtype=torch.bool)
    listed[cells.long()] = True
    assert 0 < cells.numel() < Ds ** 3
    sdr3 = float(sweep.s_over_dr3(DR, dt))
    wh = heb.wh_se if heat else None
    fn = lib.rehearse_rates_he_f32 if dt == torch.float32 else \
        lib.rehearse_rates_he_f64
    other = cheb_rates.he_bands(heb.se, heb.w_se, None if heat else heb.se)

    def host(reverse, n_valid=cells.numel(), ds=Ds, r0=rb0,
             bands=heb.bands):
        outs = [torch.full((B,) + (Ds,) * 3, float("nan"), dtype=dt)
                for _ in range(4)]
        ptrs = [t.data_ptr() if t is not None else None for t in (
            *cds, *nb, rt_sub, cells, flux, bands.rec, bands.head,
            *outs[:3], outs[3] if heat else None)]
        rc = fn((ctypes.c_void_p * 15)(*ptrs), B, rt.geom.Dc, ds, r0,
                n_valid, DR, sdr3, 64, reverse)
        return rc, outs[:3 + heat]
    got = {reverse: host(reverse) for reverse in (0, 1)}
    exp, expm1 = _libm(dt)
    monkeypatch.setattr(torch, "exp", exp)
    monkeypatch.setattr(torch, "expm1", expm1)
    want = cheb_rates.rates_he_ref(cds, nb, rt_sub, flux, heb.se, heb.w_se,
                                   DR, sdr3, rb0, wh_se=wh, cells=cells)
    monkeypatch.undo()
    assert len(want) == 3 + heat
    for reverse, (rc, outs) in got.items():
        assert rc == 0
        for a, w in zip(outs, want):
            written = ~torch.isnan(a).view(B, -1)
            assert torch.equal(written, listed.expand(B, -1)), reverse
            assert float(w.max()) > 0
            assert torch.equal(torch.nan_to_num(a, nan=0.0), w), reverse
    c = eng.geom.c - rb0
    if 0 <= c + 1 < Ds:
        assert float(want[2][0, c + 1, c, c]) == 0.0       # n_HeII = 0
    if B > 1:
        assert not any(bool(w[-1].any()) for w in want)      # zero flux
    # sizes the launch code refuses: more listed cells than the subbox
    # holds, a subbox leaving the box, records packed with the heat
    # channel's table where the pass has no heat output or the other way
    for bad in (dict(n_valid=Ds ** 3 + 1), dict(r0=eng.geom.Dc - Ds + 1),
                dict(bands=other)):
        assert host(0, **bad)[0] == 1, bad


# he_loop_fits's arguments: nb, E, rb0, Ds, n_valid, seg_S, seg_K, F0, F1, F2,
# chunk, B, Dc, c, R1 (a bench-like call), and the changes it refuses
HE_FITS = [3, 72, 0, 64, 1000, 0, 0, 320, 320, 320, 2, 8, 64, 32, 31]
HE_REFUSED = {"chunk 0": {10: 0}, "subbox beyond the box": {2: 1},
              "no listed cell": {4: 0},
              "more cells than the subbox": {4: 64 ** 3 + 1},
              "frame narrower than a box": {8: 63},
              "bands of a negative count of bins": {1: -4},
              "source outside the box": {13: 64},
              "B above 65535": {11: 65536},
              "chunk of 2^31 cells": {10: 1024},
              "bins beyond the shared memory of a block": {1: 8000}}


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_host_he_loop_refuses_other_sizes(lib, dt):
    """The host side of he_trace_sweep (he_loop_fits) takes a bench-like
    call, with and without the heat channel and segmented with its planes,
    and refuses bad sizes (the launch then never happens): a chunk of 0,
    a subbox leaving the box, no or too many rated cells, a frame narrower
    than a box, bands of a negative count of bins, a source cell outside
    the box, too many boxes or cells for a launch, bins beyond the pass's
    shared memory; the heat channel's table without its frame or the other
    way, segments without planes or of no shells, no list of rated
    cells."""
    fn = lib.rehearse_he_fits_f32 if dt == torch.float32 else \
        lib.rehearse_he_fits_f64

    def fits(v, heat_bins=0, heat_out=0, planes=0, cells=1):
        arr = (ctypes.c_int * 15)(*v)
        return fn(ctypes.cast(arr, ctypes.c_void_p), heat_bins, heat_out,
                  planes, cells)
    assert fits(HE_FITS) == 1
    assert fits(HE_FITS, heat_bins=1, heat_out=1) == 1
    seg = list(HE_FITS)
    seg[5:7] = [8, 4]
    assert fits(seg, planes=1) == 1
    for name, change in HE_REFUSED.items():
        v = list(HE_FITS)
        for i, x in change.items():
            v[i] = x
        assert fits(v) == 0, name
    assert fits(HE_FITS, heat_bins=1) == 0
    assert fits(HE_FITS, heat_out=1) == 0
    assert fits(seg) == 0
    seg[6] = 0
    assert fits(seg, planes=1) == 0
    assert fits(HE_FITS, cells=0) == 0


# The chemistry passes of csrc/chemistry.cu. On the host the kernels call
# glibc's exp, expm1 and pow and divide by a scalar as the card does (a
# multiply by its reciprocal), where torch's CPU path calls its vectorized
# exp, expm1 and pow and divides; the few-ulp differences that leaves are
# carried on by the iteration, most where <x> cancels (the reason for the
# 1e-8 of test_torch_chemistry.py's far-from-source case). So the results
# are held to the plain versions within those tolerances, with equal
# counts; the kernels' own logic (per-cell freezing, the cap, the mask, the
# block-reduced count in any block order and grid) is held exactly.
CHEM = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598 ** 2,
            temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
HE_SIGS = dict(sig_h_he1=1.18e-18, sig_he1_he1=7.42e-18, sig_h_lya2=3.4e-19,
               sig_he1_lya2=3.0e-18)
HE_ORDER = ("ndens", "temp", "xh", "xh_av", "y1", "y1_av", "y2", "y2_av",
            "phi_h", "phi_he1", "phi_he2")
CHEM_RTOL = {torch.float64: 1e-8, torch.float32: 1e-6}
CHEM_DT = 1e13


def _chem_fields(seed, dt, n=16 ** 3):
    """Hydrogen and helium fields from neutral to nearly ionized, Gamma
    over eight decades (the cells far from sources included)."""
    rng = np.random.RandomState(seed)
    xh = rng.uniform(1e-4, 0.99, n)
    y1, y2 = rng.uniform(1e-4, 0.6, n), rng.uniform(0.0, 0.35, n)
    f = dict(ndens=10 ** rng.uniform(-4, -1, n), temp=rng.uniform(5e3, 3e4, n),
             xh=xh, xh_av=np.clip(xh * rng.uniform(0.8, 1.2, n), 0, 0.999),
             y1=y1, y1_av=y1 * rng.uniform(0.8, 1.2, n), y2=y2,
             y2_av=y2 * rng.uniform(0.8, 1.2, n),
             phi_h=10 ** rng.uniform(-18, -10, n),
             phi_he1=10 ** rng.uniform(-18, -10, n),
             phi_he2=10 ** rng.uniform(-19, -11, n),
             heat=10 ** rng.uniform(-30, -20, n))
    t = {k: torch.from_numpy(v).to(dt) for k, v in f.items()}
    t["mask"] = torch.from_numpy(rng.uniform(size=n) > 0.3)
    return t


def _host_pass(lib, t, p, helium=0, mask=False, cap=400, blocks=5, threads=64,
               reverse=0):
    """A chemistry kernel on the host: the hydrogen pass (``helium`` 0) or
    the helium pass (1 + 2 heat + 4 recombination photons) over the fields
    ``t`` with the parameters ``p``. Returns (outputs, count, iterations)."""
    from pyc2ray_torch.ops import chemistry as ch, chemistry_he as che
    dt = t["xh"].dtype
    outs = [torch.full_like(t["xh"], float("nan"))
            for _ in range(6 if helium else 2)]
    count = torch.zeros((), dtype=torch.int64)
    its = torch.full(t["xh"].shape, -1, dtype=torch.int32)
    m = t["mask"].data_ptr() if mask else None
    if helium:
        ptrs = ([t[k].data_ptr() for k in HE_ORDER]
                + [t["heat"].data_ptr() if helium & 2 else None, m])
        params = che._kernel_params_he(p, dt)
    else:
        ptrs = [t[k].data_ptr() for k in ("ndens", "temp", "xh", "xh_av",
                                          "phi_h")] + [m]
        params = ch._kernel_params(p)
    ptrs += [o.data_ptr() for o in outs] + [count.data_ptr(), its.data_ptr()]
    fn = lib.rehearse_chem_f32 if dt == torch.float32 else \
        lib.rehearse_chem_f64
    fn(helium, (ctypes.c_void_p * len(ptrs))(*ptrs), t["xh"].numel(), cap,
       (ctypes.c_double * len(params))(*params), 0, None, CHEM_DT, blocks,
       threads, reverse)
    return outs, int(count), its


def _plain_iterations(t, p, cap=400):
    """The doric iterations each cell takes in global_pass_ref's loop."""
    from pyc2ray_torch.ops.chemistry import (MIN_FRACTIONAL_CHANGE,
                                             MIN_FRACTION_OF_ATOMS, doric)
    xav = t["xh_av"]
    active = torch.ones(xav.shape, dtype=torch.bool)
    its = torch.zeros(xav.shape, dtype=torch.int32)
    for _ in range(cap):
        if not bool(active.any()):
            break
        rhe = t["ndens"] * (xav + p.abu_c)
        _, av = doric(t["xh"], CHEM_DT, t["temp"], rhe, t["phi_h"], p)
        done = (torch.abs((av - xav) / (1.0 - av)) < MIN_FRACTIONAL_CHANGE) \
            | ((1.0 - av) < MIN_FRACTION_OF_ATOMS)
        xav = torch.where(active, av, xav)
        its += active.int()
        active = active & ~done
    return its


def _votes(xav, xav_entry, mask=None):
    """global_pass_ref's not-converged test per cell."""
    yh = 1.0 - xav_entry
    delta = xav - xav_entry
    v = (delta.abs() > 1e-3) & ((delta / yh).abs() > 1e-3) & (yh > 1e-8)
    return v if mask is None else v & mask


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_chemistry_pass_on_the_host_matches_plain(lib, dt):
    """The hydrogen kernel against global_pass_ref, with and without the
    mask: xh and <x> within CHEM_RTOL, the count equal, each cell's
    iterations those of the plain loop, the count the masked sum of the
    per-cell votes of the kernel's own outputs."""
    from pyc2ray_torch.ops.chemistry import ChemistryParams, global_pass_ref
    p = ChemistryParams(**CHEM)
    for seed in (0, 1):
        t = _chem_fields(seed, dt)
        for mask in (False, True):
            (xi, xa), count, its = _host_pass(lib, t, p, mask=mask)
            ref = global_pass_ref(CHEM_DT, t["ndens"], t["temp"], t["xh"],
                                  t["xh_av"], t["phi_h"], p,
                                  mask=t["mask"] if mask else None)
            for a, b in zip((xi, xa), ref[:2]):
                torch.testing.assert_close(a, b, rtol=CHEM_RTOL[dt], atol=0)
            assert count == int(ref[2]) > 0
            assert count == int(_votes(
                xa, t["xh_av"], t["mask"] if mask else None).sum())
        assert torch.equal(its, _plain_iterations(t, p))
        assert int(its.max()) > 8


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_chemistry_pass_on_the_host_is_per_cell(lib, dt):
    """Any grid and block order gives the same bits and count. With a cap
    of 8 a cell that converged within 8 iterations holds the bits of the
    uncapped pass, the rest stop at the cap; the capped pass matches
    global_pass_ref with MAX_INNER_ITER = 8 within CHEM_RTOL."""
    from pyc2ray_torch.ops import chemistry as ch
    p = ch.ChemistryParams(**CHEM)
    t = _chem_fields(2, dt)
    out, count, its = _host_pass(lib, t, p, mask=True)
    for blocks, threads, reverse in ((1, 32, 0), (7, 64, 1), (64, 64, 1)):
        o, c, i = _host_pass(lib, t, p, mask=True, blocks=blocks,
                             threads=threads, reverse=reverse)
        assert all(torch.equal(a, b) for a, b in zip(o, out)) and c == count
        assert torch.equal(i, its)
    o8, c8, i8 = _host_pass(lib, t, p, cap=8, mask=True)
    assert torch.equal(i8, its.clamp(max=8))
    early = its < 8
    assert 0 < int(early.sum()) < its.numel()
    for a, b in zip(o8, out):
        assert torch.equal(a[early], b[early])
        assert not torch.equal(a[~early], b[~early])
    cap, ch.MAX_INNER_ITER = ch.MAX_INNER_ITER, 8
    try:
        ref = ch.global_pass_ref(CHEM_DT, t["ndens"], t["temp"], t["xh"],
                                 t["xh_av"], t["phi_h"], p, mask=t["mask"])
    finally:
        ch.MAX_INNER_ITER = cap
    for a, b in zip(o8, ref[:2]):
        torch.testing.assert_close(a, b, rtol=CHEM_RTOL[dt], atol=0)
    assert c8 == int(ref[2])


# option -> (helium flags: 1 + 2 heat + 4 recombination photons, abu_he);
# float32 without the heat channel (see below)
HE_OPTIONS = {"plain": (1, 0.074), "secondary": (3, 0.074),
              "recombination": (5, 0.074), "all": (7, 0.074),
              "no_helium": (1, 0.0)}
HE_CASES = ([(o, torch.float64) for o in sorted(HE_OPTIONS)]
            + [(o, torch.float32) for o in ("plain", "recombination",
                                            "no_helium")])


@pytest.mark.parametrize("option,dt", HE_CASES)
def test_chemistry_pass_he_on_the_host_matches_plain(lib, option, dt):
    """The helium kernel against global_pass_he_ref in each option (the
    mask with "all" and "recombination"): the six fractions within
    CHEM_RTOL, the count equal; any block order the same bits. With abu_he
    = 0 its xh and <x> are the hydrogen kernel's bit for bit. In float32
    with the heat channel the plain pass's own 400-iteration cells (a tenth
    of these) and its one-ulp sensitivity put the two up to 2e-4 apart:
    those options are held in float64 here and bit for bit on the card."""
    from pyc2ray_torch.ops.chemistry import ChemistryParams
    from pyc2ray_torch.ops.chemistry_he import (HeChemistryParams,
                                                global_pass_he_ref)
    flags, abu_he = HE_OPTIONS[option]
    p = HeChemistryParams(chem=ChemistryParams(**CHEM), abu_he=abu_he,
                          sec_ramp_hi=0.62, sec_ramp_hei=0.31, **HE_SIGS)
    t = _chem_fields(3, dt, n=12 ** 3)
    mask = option in ("all", "recombination")
    out, count, its = _host_pass(lib, t, p, helium=flags, mask=mask)
    ref = global_pass_he_ref(
        CHEM_DT, *(t[k] for k in HE_ORDER), p,
        mask=t["mask"] if mask else None,
        heat=t["heat"] if flags & 2 else None,
        recombination_photons=bool(flags & 4))
    for a, b in zip(out, ref[:6]):
        torch.testing.assert_close(a, b, rtol=CHEM_RTOL[dt], atol=0)
    assert count == int(ref[6]) > 0
    o, c, i = _host_pass(lib, t, p, helium=flags, mask=mask, blocks=3,
                         reverse=1)
    assert all(torch.equal(a, b) for a, b in zip(o, out)) and c == count
    assert torch.equal(i, its)
    if abu_he == 0.0:
        h, hc, hi = _host_pass(lib, t, p.chem)
        assert torch.equal(h[0], out[0]) and torch.equal(h[1], out[1])
        assert hc == count and torch.equal(hi, its)

