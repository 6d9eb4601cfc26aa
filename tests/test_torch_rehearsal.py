"""The port's CUDA sweep kernels rehearsed on the host.

The device parts of ``pyc2ray_torch/ops/csrc/cheb_sweep.cuh``,
``cheb_sweep.cu`` and ``cheb_sweep_rates.cu`` are cut out of the sources,
compiled with g++ against the stand-in headers of ``tests/kernel_host/``
(every thread of every block of a cluster is a std::thread; the cluster
barrier and the mapping of shared memory between blocks are emulated;
arithmetic is compiled without contraction) and held
against the plain PyTorch versions: K1, K2 and phase A of K3 bit for bit,
K1f within the tolerance of its exp/expm1. This checks the kernels' logic
(shell windows, the dealing of cells to blocks, plane ownership, stitches,
carried planes) for every cluster size and placement; that the
sources build for the card and run there is shown by chip_smoke.py and the
``cuda`` tests."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
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
    (d / "k_sweep.inc").write_text(_device_part(
        "cheb_sweep.cu", "// The launches of the three kernels",
        "}  // namespace\n"))
    (d / "k_rates.inc").write_text(_device_part(
        "cheb_sweep_rates.cu", "template <typename T>\nint launch(",
        "}  // namespace\n").replace("namespace {", "namespace rates {"))
    so = d / "librehearsal.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
           "-pthread", f"-I{d}", f"-I{HOST}", "-o", str(so),
           str(HOST / "rehearsal.cpp")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for f in (lib.rehearse_f32, lib.rehearse_f64):
        f.argtypes = [I] + [P] * 14 + [I] * 7 + [D] * 4 + [I] * 4
        f.restype = I
    return lib


def _bins():
    return SpectralBins(s=np.array([1.0, 0.5, 0.2]),
                        w_photo=np.array([0.5, 0.3, 0.2]),
                        w_heat=np.array([0.1, 0.2, 0.3]), num_bins=3)


class _Case:
    """One engine shape with random densities, and the kernels on the
    host under a launch plan."""

    def __init__(self, lib, N, R, B, dt, plan, threads):
        self.rt = ChebRaytracer(N, R, SIG, _bins(), batch_size=B, dtype=dt,
                                device="cpu")
        self.g, self.tb = self.rt.geom, self.rt.tables
        tb, Dc = self.tb, self.g.Dc
        rng = np.random.RandomState(N + B)
        self.nhi = torch.from_numpy(
            10 ** rng.uniform(-4, -2, (B, Dc, Dc, Dc))).to(dt)
        self.geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
        self.fn = lib.rehearse_f32 if dt == torch.float32 else lib.rehearse_f64
        self.dt, self.plan, self.threads = dt, plan, threads

    def run(self, kind, rt_tab=None, bins=(None, None), planes=None, r0=0,
            r1=0, R2=0.0, sdr3=0.0, box=None):
        """Kernel ``kind`` (0 K1, 1 K1f, 2 K2, 3 K3's phase A); returns
        (box, second box, planes out). Every output starts as NaN."""
        nhi, tb, g = self.nhi, self.tb, self.g
        B, Dc, R1 = nhi.shape[0], g.Dc, tb.sw.shape[2]
        E = 0 if bins[0] is None else bins[0].shape[0]
        C, sh = self.plan
        smem = sweep.plan_sizes(Dc, nhi.element_size(), C, sh,
                                2 * E if kind == 1 else 0)[0]

        def nan(*shape):
            return torch.full(shape, float("nan"), dtype=self.dt)
        box = nan(*nhi.shape) if box is None else box
        box2, pout = nan(*nhi.shape), nan(B, 3, 2, Dc, Dc)
        scratch = nan(B, 12, Dc, Dc)
        ptrs = [None if t is None else t.data_ptr() for t in (
            nhi, *self.geo, rt_tab, *bins, planes, pout, box, box2, scratch)]
        rc = self.fn(kind, *ptrs, B, Dc, g.c, R1, E, r0, r1, DR, SIG, R2,
                     sdr3, self.threads, C, int(sh), smem)
        assert rc == 0
        return box, box2, pout


# (cluster size, planes shared, threads per block)
PLANS = [(1, False, 2), (4, False, 3), (4, True, 2), (8, True, 3),
         (2, False, 5), (16, True, 1)]


# (16, 6): an unclipped box; (8, 6) and (16, 8): clipped by the mesh (the
# plus faces leave the box); (9, 8): clipped, box side 9; (16, 3): box side
# rounded past the radius; B = 1 and 2
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B", [(16, 6.0, 2), (8, 6.0, 2), (16, 8.0, 1),
                                   (9, 8.0, 1), (16, 3.0, 2)])
def test_kernels_on_the_host_match_plain(lib, N, R, B, dt):
    for plan in PLANS:
        case = _Case(lib, N, R, B, dt, plan[:2], plan[2])
        nhi, geo, g, tb = case.nhi, case.geo, case.g, case.tb
        # K1
        k1, _, _ = case.run(0)
        want = sweep.cheb_sweep_ref(nhi, *geo, DR, g.c, SIG)
        assert torch.equal(k1, want), plan
        # K2 chained over ragged segments: box and carried planes
        planes = sweep.init_planes(nhi, g.c, DR)
        planes_ref = planes.clone()
        box, box_ref = torch.zeros_like(nhi), torch.zeros_like(nhi)
        for r0 in range(1, g.r_max + 1, 3):
            box, _, planes = case.run(2, planes=planes, r0=r0,
                                      r1=min(r0 + 3, g.r_max + 1), box=box)
            box_ref, planes_ref = sweep.cheb_sweep_seg_ref(
                nhi, *geo, DR, g.c, SIG, planes_ref, r0, 3, box_ref)
            assert torch.equal(planes, planes_ref), (plan, r0)
            assert torch.equal(box, box_ref), (plan, r0)
        # K1f
        R2 = case.rt.R_max_LLS ** 2
        got, _, _ = case.run(1, rt_tab=tb.rt_tab,
                             bins=(tb.bins_s, tb.bins_w), R2=R2,
                             sdr3=float(sweep.s_over_dr3(float(DR), dt)))
        want = sweep.cheb_sweep_ref(nhi, *geo, DR, g.c, SIG,
                                    bins=(tb.bins_s, tb.bins_w),
                                    rt_tab=tb.rt_tab, R2=R2)
        # libm's exp/expm1 against torch's: a few ulp per bin
        torch.testing.assert_close(
            got, want, rtol=1e-5 if dt == torch.float32 else 1e-12, atol=0)
        # K3's phase A: cdin and dcol of every valid cell, against the
        # plain version's emit
        ci, dc, _ = case.run(3)
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
        assert torch.equal(ci[:, valid], ci_ref[:, valid]), plan
        assert torch.equal(dc[:, valid], dc_ref[:, valid]), plan


def test_host_launch_code_refuses_other_sizes(lib):
    """make_plan computes the shared-memory size itself and refuses a
    caller whose size differs (the launch then never happens)."""
    case = _Case(lib, 8, 6.0, 1, torch.float64, (4, True), 1)
    nhi, tb, g = case.nhi, case.tb, case.g
    smem = sweep.plan_sizes(g.Dc, 8, 4, True)[0]
    ptrs = [nhi.data_ptr(), *[t.data_ptr() for t in case.geo]] + [None] * 8
    args = (nhi.shape[0], g.Dc, g.c, tb.sw.shape[2], 0, 0, 0, DR, SIG, 0.0,
            0.0, 1)
    assert lib.rehearse_f64(0, *ptrs, *args, 4, 1, smem + 8) == 1
    assert lib.rehearse_f64(0, *ptrs, *args, 3, 1, smem) == 1
