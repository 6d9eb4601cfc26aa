#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pyc2ray_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device and build: the card's name and power limit, and the build of the
   CUDA kernels (nvcc, into build/torch_kernels/) with its time.
2. Each kernel against its plain PyTorch version on the card, with kernel,
   plain and bound times. The sweep K1 at the bench shape (N=256, R=30:
   Dc=64, B=8) in float32 and at a small clipped-box shape in float64.
2b. The shell-segmented sweep K2 at the R=100 row of the raytracing
   benchmark harness (N=250, R=100, B=8: Dc=208, S=24 by the auto rule,
   K=5), against the plain version and bit for bit against K1, and at a
   small clipped shape in float64 with a ragged last segment; the fused
   kernels K1f (fuse_rates) and K3 (fuse_fold) at the bench shape with
   compressed bins in float32 and at a small clipped shape in float64 that
   holds a zero-density cell.
3. The full-width main path: ChebRaytracer.trace_batches + global_pass at
   N=256, R=30, Ns=2048, B=8, compressed black-body bins, float32 (the
   configuration of bench.py, positions from seed 100). Prints ns per
   cell-update, the chemistry time, the combined Mcell-updates/s and the
   sweep's launch count, which must equal the number of batches. The GPU
   trace of the first 16 sources is held against the CPU (plain) trace.
3b. The engine's other sweep modes at full width: the bench configuration
   with fuse_fold=True (K3) and with fuse_rates=True (K1f), each Gamma
   held against phase 3's; the R=100 harness configuration (N=250, R=100,
   B=8, Ns=100 from seed 100, compressed bins, float32) auto-segmented
   (K2) and with shell_segment=0 (K1), held against each other. Each run
   prints ns per cell-update and its launch counts, which are asserted.
4. One evolve3D timestep to convergence at N=64, R=8, 16 sources, float32,
   held against the same call on the CPU.
5. A ``kernels`` JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Needs one CUDA card; exits non-zero without one. Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_BENCH, R_BENCH, NS_BENCH, B_BENCH = 256, 30.0, 2048, 8
SIG = 6.30e-18
DR = 6.7e20
DT = 3.15e13
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores
H100_F64_FLOPS = 34e12           # float64 outside the tensor cores
SWEEP_FLOPS_PER_CELL = 27        # per face cell: 4 P*sig, 4 max, 4 div,
                                 # 4 P*w, 6 adds, diag*, /, 2 muls, +
RATE_OPS_PER_BIN = 7             # per bin and rated cell: tau_in*s,
                                 # dtau*s, exp, expm1, 2 muls, 1 add (a
                                 # transcendental counted as one op)
RATE_OPS_PER_CELL = 7            # tau_in, dtau, prefactor (2 muls, div),
                                 # result (mul, div)
N_R100, R_R100, NS_R100 = 250, 100.0, 100   # raytracing harness, R=100 row


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_bins():
    from pyc2ray_torch.constants import ev2fr
    from pyc2ray_torch.radiation import BlackBodySource
    from pyc2ray_torch.radiation.bins_compress import compress_bins
    from pyc2ray_torch.radiation.spectral_bins import make_spectral_bins
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    dense = make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                               fmin, fmax, panels=48, nodes=16)
    return compress_bins(dense, target_rel=1e-3, cache=False)


def chem_params():
    from pyc2ray_torch.ops.chemistry import ChemistryParams
    return ChemistryParams(bh00=2.59e-13, albpow=-0.7,
                           colh0=1.3e-8 * 0.83 / (13.598 ** 2),
                           temph0=13.598 / 8.617e-05, abu_c=7.1e-7)


def least_ms(nbytes, ops, dtype):
    """Least time of a call: the larger of its bytes over the memory rate
    and its operations over the card's peak for the type."""
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_F64_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sweep_work(B, Dc, R1, dtype):
    """(bytes, flops) of one whole sweep: nHI box in, one box out and the
    geometry tables in, each once; 27 flops per face cell."""
    isz = torch.finfo(dtype).bits // 8
    box = B * Dc ** 3 * isz
    geom = (4 + 2) * 3 * R1 * Dc * Dc * isz + 2 * 3 * R1 * Dc * Dc
    return 2 * box + geom, SWEEP_FLOPS_PER_CELL * B * 3 * 2 * Dc * Dc * (R1 - 1)


def sweep_bound_ms(B, Dc, R1, dtype):
    """Least time of one sweep call (see sweep_work and bound_ms)."""
    return least_ms(*sweep_work(B, Dc, R1, dtype), dtype)


def check_sweep(N, R, B, dtype, rtol, seed, reps):
    """Kernel vs plain version on CUDA tensors at the engine's shapes."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    from pyc2ray_torch.radiation.spectral_bins import SpectralBins
    grey = SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                        w_heat=np.array([0.0]), num_bins=1)
    rt = ChebRaytracer(N, R, SIG, grey, batch_size=B, dtype=dtype)
    g, tb = rt.geom, rt.tables
    rng = np.random.RandomState(seed)
    nhi = torch.from_numpy(
        10 ** rng.uniform(-4, -2, (B, g.Dc, g.Dc, g.Dc))).to("cuda", dtype)
    args = (nhi, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p, DR, g.c, SIG)
    out = sweep.cheb_sweep(*args)
    ref = sweep.cheb_sweep_ref(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(torch.finfo(dtype).tiny)).max())
    torch.testing.assert_close(out, ref, rtol=rtol, atol=0.0)
    ms = cuda_ms(lambda: sweep.cheb_sweep(*args), reps)
    plain_ms = cuda_ms(lambda: sweep.cheb_sweep_ref(*args), 3)
    bound_ms, bound_by = sweep_bound_ms(B, g.Dc, g.r_max + 1, dtype)
    log(f"sweep N={N} R={R} B={B} Dc={g.Dc} c={g.c} R1={g.r_max + 1} "
        f"{str(dtype).split('.')[-1]}: max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (rtol {rtol:g}) kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def grey_bins():
    from pyc2ray_torch.radiation.spectral_bins import SpectralBins
    return SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                        w_heat=np.array([0.0]), num_bins=1)


def random_nhi(rt, B, dtype, seed, zero_cell=False):
    """(B, Dc, Dc, Dc) HI densities 1e-4..1e-2 on the card; with
    ``zero_cell`` one cell of source 1 next to its centre is 0."""
    g = rt.geom
    rng = np.random.RandomState(seed)
    nhi = torch.from_numpy(
        10 ** rng.uniform(-4, -2, (B, g.Dc, g.Dc, g.Dc))).to("cuda", dtype)
    if zero_cell:
        nhi[1, g.c, g.c + 1, g.c] = 0.0
    return nhi


def compare(name, out, ref, rtol, floor=0.0):
    """Assert out ~ ref (finite, rtol, absolute floor * max|ref|); return
    the max abs error."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = (out - ref).abs()
    max_abs = float(err.max())
    atol = floor * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    big = ref.abs() > atol
    max_rel = float((err[big] / ref.abs()[big]).max()) if bool(big.any()) \
        else 0.0
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"above {atol:.3e} (rtol {rtol:g})")
    return max_abs


def timing(name, kernel, plain, reps, nbytes, ops, dtype, calls=1):
    """Kernel and plain ms per call (``calls`` calls per ``kernel()``)
    and the bound of one call from its bytes and operations."""
    ms = cuda_ms(kernel, reps) / calls
    plain_ms = cuda_ms(plain, 1) / calls
    b_ms, b_by = least_ms(nbytes / calls, ops / calls, dtype)
    log(f"  {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}) per call")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def check_seg(N, R, B, dtype, rtol, seed, reps, shell_segment="auto"):
    """K2 chained over its K segments vs the plain sweep and vs K1."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    rt = ChebRaytracer(N, R, SIG, grey_bins(), batch_size=B, dtype=dtype,
                       shell_segment=shell_segment)
    g, tb = rt.geom, rt.tables
    S, K = rt.seg_S, rt.seg_K
    if not S:
        raise RuntimeError(f"K2 check: N={N} R={R} B={B} is not segmented")
    nhi = random_nhi(rt, B, dtype, seed)
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)

    def chain(seg=sweep.cheb_sweep_seg):
        planes = sweep.init_planes(nhi, g.c, DR)
        box = torch.zeros_like(nhi)
        for k in range(K):
            box, planes = seg(nhi, *geo, DR, g.c, SIG, planes, 1 + k * S, S,
                              box)
        box[:, g.c, g.c, g.c] = nhi[:, g.c, g.c, g.c] * (0.5 * torch.tensor(
            DR, dtype=dtype, device="cuda"))
        return box

    log(f"K2 cheb_sweep_seg N={N} R={R} B={B} Dc={g.Dc} R1={g.r_max + 1} "
        f"S={S} K={K} {str(dtype).split('.')[-1]}:")
    out = chain()
    k1 = sweep.cheb_sweep(nhi, *geo, DR, g.c, SIG)
    torch.cuda.synchronize()
    if not torch.equal(out, k1):
        raise RuntimeError("K2: the segmented box differs from K1's")
    log("  K2 box equals K1 box bit for bit")
    max_abs = compare("K2 vs plain", out, chain(sweep.cheb_sweep_seg_ref),
                      rtol)
    isz = torch.finfo(dtype).bits // 8
    nbytes, ops = sweep_work(B, g.Dc, g.r_max + 1, dtype)
    nbytes += K * 2 * B * 6 * g.Dc ** 2 * isz       # carried planes in, out
    t = timing("K2", chain, lambda: chain(sweep.cheb_sweep_seg_ref), reps,
               nbytes, ops, dtype, calls=K)
    return dict(max_abs_err=max_abs, **t)


def check_fused(N, R, B, dtype, rtol, floor, seed, reps, bins,
                zero_cell=False):
    """K1f and K3 vs their plain versions; returns {name: numbers}."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    rt = ChebRaytracer(N, R, SIG, bins, batch_size=B, dtype=dtype)
    g, tb = rt.geom, rt.tables
    nhi = random_nhi(rt, B, dtype, seed, zero_cell)
    flux = torch.linspace(0.5, 2.0, B, dtype=dtype, device="cuda")
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    kw = dict(bins=(tb.bins_s, tb.bins_w), rt_tab=tb.rt_tab,
              R2=rt.R_max_LLS ** 2)
    rates = (nhi, *geo, tb.rt_tab, flux, DR, g.c, SIG, tb.bins_s, tb.bins_w)
    kernels = {
        "K1f": (lambda: sweep.cheb_sweep(nhi, *geo, DR, g.c, SIG, **kw),
                lambda: sweep.cheb_sweep_ref(nhi, *geo, DR, g.c, SIG, **kw)),
        "K3": (lambda: sweep.cheb_sweep_rates(*rates),
               lambda: sweep.cheb_sweep_rates_ref(*rates))}
    isz = torch.finfo(dtype).bits // 8
    nbytes, ops = sweep_work(B, g.Dc, g.r_max + 1, dtype)
    n_rated = B * int((tb.rt_tab[:, 1] > 0.5).sum())
    ops += n_rated * (RATE_OPS_PER_BIN * bins.num_bins + RATE_OPS_PER_CELL)
    extra = {"K1f": g.Dc ** 3 * isz,                    # the dist2 channel
             "K3": 2 * g.Dc ** 3 * isz + B * isz}       # rates table, flux
    log(f"K1f/K3 N={N} R={R} B={B} Dc={g.Dc} R1={g.r_max + 1} "
        f"E={bins.num_bins} {str(dtype).split('.')[-1]}"
        f"{' (one zero-density cell)' if zero_cell else ''}:")
    out = {}
    for name, (kern, plain) in kernels.items():
        max_abs = compare(f"{name} vs plain", kern(), plain(), rtol, floor)
        out[name] = dict(max_abs_err=max_abs, **timing(
            name, kern, plain, reps, nbytes + extra[name], ops, dtype))
    return out


def run_path(rt, nd, xh, pos_b, flux_b, ns, R, expect, label, chem=None):
    """A warm-up trace, then one trace_batches (and global_pass with
    ``chem``) with the launch counts set to 0 just before and read just
    after; asserts the counts equal ``expect`` (others 0) and the output
    finite. Returns (phi, counts)."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.chemistry import global_pass
    rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    sweep.reset_launches()
    t0 = time.time()
    phi, _ = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    t_ray = time.time() - t0
    counts = dict(sweep.launches)
    want = {k: expect.get(k, 0) for k in counts}
    if counts != want:
        raise RuntimeError(f"{label}: kernel launches {counts}, expected "
                           f"{want}")
    if not bool(torch.isfinite(phi).all()) or not float(phi.max()) > 0.0:
        raise RuntimeError(f"{label}: Gamma is not finite and positive")
    msg = ""
    if chem is not None:
        dt_d = torch.tensor(DT, dtype=rt.dtype).to("cuda")
        temp = torch.full_like(nd, 1e4)
        t0 = time.time()
        xi, xa, _ = global_pass(dt_d, nd, temp, xh, xh, phi, chem)
        torch.cuda.synchronize()
        msg = f", chemistry {time.time() - t0:.4f} s"
        if not (bool(torch.isfinite(xi).all())
                and bool(torch.isfinite(xa).all())):
            raise RuntimeError(f"{label}: chemistry output is not finite")
    ns_cell = 1e9 * t_ray / (ns * 4.0 / 3.0 * np.pi * R ** 3)
    log(f"{label}: raytrace {t_ray:.4f} s = {ns_cell:.4f} ns/cell-update"
        f"{msg}, launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return phi, counts


def stage_breakdown(rt, nd, xh, pos_b, flux_b, nbatch):
    """Device time per batch of each stage of trace_extended, over the
    first ``nbatch`` batches (CUDA events around each stage)."""
    from pyc2ray_torch.ops.sweep import cheb_sweep
    g, tb, N = rt.geom, rt.tables, rt.N
    nhi3 = nd.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3))
    wrap = torch.arange(-g.c, N + g.Dc - 1 - g.c, device="cuda") % N
    nhi_pad = nhi3[wrap][:, wrap][:, :, wrap]
    phi_pad = torch.zeros_like(nhi_pad)
    dr_t = torch.tensor(DR, dtype=rt.dtype).to("cuda")
    D, sh = rt.Ds, rt._rb0
    tot = dict(extract=0.0, sweep=0.0, rates=0.0, accumulate=0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for pos, flux in list(zip(pos_b, flux_b))[:nbatch]:
        ev[0].record()
        boxes = rt._extract_boxes(nhi_pad, pos.to("cuda"))
        ev[1].record()
        cd = cheb_sweep(boxes, tb.sw, tb.path, tb.diag, tb.mask_m,
                        tb.mask_p, DR, g.c, rt.sig)
        ev[2].record()
        phi_box = rt._rates(cd, boxes, flux, dr_t)
        ev[3].record()
        for (p0, p1, p2), box in zip(pos.tolist(), phi_box):
            phi_pad[p0 + sh:p0 + sh + D, p1 + sh:p1 + sh + D,
                    p2 + sh:p2 + sh + D] += box
        ev[4].record()
        torch.cuda.synchronize()
        for k, name in enumerate(tot):
            tot[name] += ev[k].elapsed_time(ev[k + 1])
    return {k: v / nbatch for k, v in tot.items()}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    from pyc2ray_torch.evolve import evolve3D
    from pyc2ray_torch.ops import _build, sweep
    from pyc2ray_torch.ops.chemistry import global_pass
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(sys.version.split()[0], "torch", torch.__version__, "cuda",
        torch.version.cuda)

    # ---- 1. device and build -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.time()
    _build.load()
    log(f"build: {time.time() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # ---- 2. kernel vs plain version on the card -------------------------
    k_bench = check_sweep(N_BENCH, R_BENCH, B_BENCH, torch.float32,
                          rtol=1e-5, seed=1, reps=20)
    check_sweep(8, 6.0, 2, torch.float64, rtol=1e-12, seed=2, reps=20)
    t0 = time.time()
    bins = make_bins()
    log(f"bins: {bins.num_bins} compressed nodes ({time.time() - t0:.1f} s)")

    # ---- 2b. the kernels of the other sweep modes vs their plain versions
    k_seg = check_seg(N_R100, R_R100, B_BENCH, torch.float32, rtol=1e-5,
                      seed=3, reps=3)
    # N=16, R=8 clips the box; S=3 leaves a ragged last segment of r_max=8
    check_seg(16, 8.0, 2, torch.float64, rtol=1e-12, seed=4, reps=3,
              shell_segment=3)
    k_fused = check_fused(N_BENCH, R_BENCH, B_BENCH, torch.float32,
                          rtol=1e-4, floor=1e-6, seed=5, reps=10, bins=bins)
    check_fused(16, 8.0, 2, torch.float64, rtol=1e-10, floor=0.0, seed=6,
                reps=3, bins=bins, zero_cell=True)

    # ---- 3. full-width main path -------------------------------------
    chem = chem_params()
    dt = torch.float32
    N = N_BENCH
    rt = ChebRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH, dtype=dt)
    rng = np.random.RandomState(100)
    src_pos = rng.randint(0, N, size=(NS_BENCH, 3))
    src_flux = np.ones(NS_BENCH)
    pos_b, flux_b = rt.prepare_sources(src_pos, src_flux)
    nbatch = pos_b.shape[0]

    def grid(v):
        return torch.full((N ** 3,), v, dtype=dt, device="cuda")
    ndens, temp, xh = grid(1e-3), grid(1e4), grid(1.2e-3)
    dt_d = torch.tensor(DT, dtype=dt).to("cuda")

    rt.trace_batches(ndens, xh, pos_b, flux_b, DR)        # warm-up
    torch.cuda.synchronize()
    sweep.reset_launches()
    t0 = time.time()
    phi, _ = rt.trace_batches(ndens, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    t_ray = time.time() - t0
    t0 = time.time()
    xi, xa, cf = global_pass(dt_d, ndens, temp, xh, xh, phi, chem)
    torch.cuda.synchronize()
    t_chem = time.time() - t0
    counts = dict(sweep.launches)
    launches = counts.pop("cheb_sweep")
    if launches != nbatch or any(counts.values()):
        raise RuntimeError(f"sweep kernel launched {launches} times on the "
                           f"main path, expected one per batch ({nbatch}); "
                           f"other kernels {counts}")
    for name, t in (("phi", phi), ("xh", xi), ("xh_av", xa)):
        if t.shape != (N ** 3,) or not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"main path: {name} is not finite of shape "
                               f"({N ** 3},)")
    if not float(phi.max()) > 0.0:
        raise RuntimeError("main path: no cell received photons")
    updates = NS_BENCH * 4.0 / 3.0 * np.pi * R_BENCH ** 3
    ns_cell = 1e9 * t_ray / updates
    mcell = updates / (t_ray + t_chem) / 1e6
    log(f"main path N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32 "
        f"bins={bins.num_bins}: raytrace {t_ray:.4f} s = {ns_cell:.4f} "
        f"ns/cell-update, chemistry {t_chem:.4f} s, raytrace+chem "
        f"{mcell:.2f} Mcell-updates/s, sweep launches {launches} "
        f"(batches {nbatch}), conv_flag {int(cf)}")
    br = stage_breakdown(rt, ndens, xh, pos_b, flux_b, 16)
    log("per-batch device ms: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in br.items()))

    # the same trace of the first 16 sources on the GPU and on the CPU
    rt_cpu = ChebRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH,
                           dtype=dt, device="cpu")
    nd_np = np.full((N,) * 3, 1e-3)
    xh_np = np.full((N,) * 3, 1.2e-3)
    phi_g = rt.trace(nd_np, xh_np, src_pos[:16], src_flux[:16], DR).cpu()
    phi_c = rt_cpu.trace(nd_np, xh_np, src_pos[:16], src_flux[:16], DR)
    floor = 1e-6 * float(phi_c.max())
    torch.testing.assert_close(phi_g, phi_c, rtol=1e-4, atol=floor)
    log(f"main path, 16 sources: GPU vs CPU max abs diff "
        f"{float((phi_g - phi_c).abs().max()):.3e} (floor {floor:.3e})")

    # ---- 3b. the other sweep modes at full width --------------------------
    fused_launches = {}
    for mode, kname in (("fuse_fold", "cheb_sweep_rates"),
                        ("fuse_rates", "cheb_sweep_fused_rates")):
        rtf = ChebRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH,
                            dtype=dt, **{mode: True})
        phi_f, counts = run_path(
            rtf, ndens, xh, pos_b, flux_b, NS_BENCH, R_BENCH, {kname: nbatch},
            f"{mode} N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32",
            chem)
        fused_launches[kname] = counts[kname]
        # the unfused path rebuilds cdin = cd - dcol in float32, which
        # cancels where dcol >> cdin: compare above a floor at the peak
        compare(f"{mode} Gamma vs the unfused Gamma", phi_f, phi, 1e-4,
                1e-6)
        del rtf, phi_f
    nh = N_R100
    rng = np.random.RandomState(100)
    h_pos = rng.randint(0, nh, size=(NS_R100, 3))
    h_nd = torch.full((nh ** 3,), 1e-3, dtype=dt, device="cuda")
    h_xh = torch.full((nh ** 3,), 1.2e-3, dtype=dt, device="cuda")
    h_phi = {}
    for seg in ("auto", 0):
        rth = ChebRaytracer(nh, R_R100, SIG, bins, batch_size=B_BENCH,
                            dtype=dt, shell_segment=seg)
        if seg == "auto" and not rth.seg_S:
            raise RuntimeError("R=100: auto did not segment the sweep")
        hp, hf = rth.prepare_sources(h_pos, np.ones(NS_R100))
        nb = hp.shape[0]
        expect = ({"cheb_sweep_seg": rth.seg_K * nb} if rth.seg_S
                  else {"cheb_sweep": nb})
        h_phi[seg], counts = run_path(
            rth, h_nd, h_xh, hp, hf, NS_R100, R_R100, expect,
            f"R=100 harness N={nh} Ns={NS_R100} B={B_BENCH} float32 "
            f"shell_segment={seg!r} (S={rth.seg_S}, K={rth.seg_K})")
        if seg == "auto":
            seg_launches = counts["cheb_sweep_seg"]
        del rth
    compare("segmented Gamma vs monolithic", h_phi["auto"], h_phi[0], 1e-6)
    log("  segmented Gamma equals monolithic bit for bit: "
        f"{torch.equal(h_phi['auto'], h_phi[0])}")
    del h_phi, h_nd, h_xh

    # ---- 4. one evolve3D timestep, GPU vs CPU ---------------------------
    Ne, Re, nse = 64, 8.0, 16
    rng = np.random.RandomState(7)
    e_pos = rng.randint(0, Ne, size=(nse, 3))
    e_flux = rng.uniform(0.5, 2.0, nse)
    e_nd = 10 ** rng.uniform(-3.5, -2.5, (Ne,) * 3)
    e_temp = np.full((Ne,) * 3, 1e4)
    e_xh = np.full((Ne,) * 3, 1.2e-3)
    out = {}
    for devname in ("cuda", "cpu"):
        rte = ChebRaytracer(Ne, Re, SIG, bins, batch_size=B_BENCH, dtype=dt,
                            device=devname)
        sweep.reset_launches()
        t0 = time.time()
        out[devname] = evolve3D(DT, DR, e_flux, e_pos, rte, chem, e_temp,
                                e_nd, e_xh, quiet=True)
        n_k1 = sweep.launches["cheb_sweep"]
        log(f"evolve3D N={Ne} R={Re} {nse} sources on {devname}: "
            f"{time.time() - t0:.2f} s, sweep launches {n_k1}")
        if devname == "cuda" and n_k1 == 0:
            raise RuntimeError("evolve3D on cuda never launched the kernel")
    (xh_g, phi_g), (xh_c, phi_c) = out["cuda"], out["cpu"]
    for a in (xh_g, phi_g):
        if not np.all(np.isfinite(a)):
            raise RuntimeError("evolve3D: non-finite output")
    np.testing.assert_allclose(xh_g, xh_c, rtol=1e-4, atol=0)
    np.testing.assert_allclose(phi_g, phi_c, rtol=1e-4,
                               atol=1e-6 * np.abs(phi_c).max())
    log(f"evolve3D GPU vs CPU: xh max rel "
        f"{np.max(np.abs(xh_g - xh_c) / np.abs(xh_c)):.3e}, phi max abs "
        f"{np.max(np.abs(phi_g - phi_c)):.3e} of max {phi_c.max():.3e}")

    # ---- 5. kernels line and result -----------------------------------
    # launches: each kernel's count over its own path's run (phase 3 for
    # K1, 3b for the others); the other numbers from phases 2 and 2b at
    # that path's shapes. No single PyTorch call computes any of them.
    src = "pyc2ray_torch/ops/csrc/"
    tpu = "pyc2ray_tpu/ops/pallas_sweep.py:"
    kernels = [
        dict(name="cheb_sweep", source=src + "cheb_sweep.cu",
             replaces=tpu + "353", launches=launches, **k_bench),
        dict(name="cheb_sweep_fused_rates", source=src + "cheb_sweep.cu",
             replaces=tpu + "325",
             launches=fused_launches["cheb_sweep_fused_rates"],
             **k_fused["K1f"]),
        dict(name="cheb_sweep_seg", source=src + "cheb_sweep.cu",
             replaces=tpu + "455", launches=seg_launches, **k_seg),
        dict(name="cheb_sweep_rates", source=src + "cheb_sweep_rates.cu",
             replaces=tpu + "669",
             launches=fused_launches["cheb_sweep_rates"], **k_fused["K3"])]
    kernels = [dict(name=k.pop("name"), route="cuda", **k, library_ms=None)
               for k in kernels]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
