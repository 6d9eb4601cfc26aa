#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pyc2ray_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device and build: the card's name and power limit, and the build of the
   CUDA kernels (nvcc, into build/torch_kernels/) with its time.
2. Each kernel against its plain PyTorch version on the card: the sweep at
   the bench shape (N=256, R=30: Dc=64, B=8) in float32 and at a small
   clipped-box shape in float64; kernel and plain times.
3. The full-width main path: ChebRaytracer.trace_batches + global_pass at
   N=256, R=30, Ns=2048, B=8, compressed black-body bins, float32 (the
   configuration of bench.py, positions from seed 100). Prints ns per
   cell-update, the chemistry time, the combined Mcell-updates/s and the
   sweep's launch count, which must equal the number of batches. The GPU
   trace of the first 16 sources is held against the CPU (plain) trace.
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


def sweep_bound_ms(B, Dc, R1, dtype):
    """Least time of one sweep call: the larger of its bytes (nHI box in,
    cd box out, geometry tables in, each once) over the memory rate and
    its arithmetic over the card's peak for the type."""
    isz = torch.finfo(dtype).bits // 8
    box = B * Dc ** 3 * isz
    geom = (4 + 2) * 3 * R1 * Dc * Dc * isz + 2 * 3 * R1 * Dc * Dc
    nbytes = 2 * box + geom
    flops = SWEEP_FLOPS_PER_CELL * B * 3 * 2 * Dc * Dc * (R1 - 1)
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_F64_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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

    # ---- 3. full-width main path -------------------------------------
    t0 = time.time()
    bins = make_bins()
    log(f"bins: {bins.num_bins} compressed nodes ({time.time() - t0:.1f} s)")
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
    launches = sweep.launches
    if launches != nbatch:
        raise RuntimeError(f"sweep kernel launched {launches} times on the "
                           f"main path, expected one per batch ({nbatch})")
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
        log(f"evolve3D N={Ne} R={Re} {nse} sources on {devname}: "
            f"{time.time() - t0:.2f} s, sweep launches {sweep.launches}")
        if devname == "cuda" and sweep.launches == 0:
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
    kernels = [dict(
        name="cheb_sweep", route="cuda",
        source="pyc2ray_torch/ops/csrc/cheb_sweep.cu",
        replaces="pyc2ray_tpu/ops/pallas_sweep.py:353",
        launches=launches, max_abs_err=k_bench["max_abs_err"],
        ms=k_bench["ms"], plain_ms=k_bench["plain_ms"],
        bound_ms=k_bench["bound_ms"], bound_by=k_bench["bound_by"],
        library_ms=None)]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
