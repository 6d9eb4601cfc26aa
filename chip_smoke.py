#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pyc2ray_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device and build: the card's name and power limit, and the build of the
   CUDA kernels (nvcc, into build/torch_kernels/) with its time and ptxas's
   registers, shared memory and spills per kernel; the cost of one cluster
   barrier per cluster size (the link of the sweep's chain).
2. Each kernel against its plain PyTorch version on the card, with kernel,
   plain and bound times. The sweep K1 at the bench shape (N=256, R=30:
   Dc=64, B=8) in float32, at a small clipped-box shape in float64 and at
   the heating example's shape (N=48: Dc=48, B=1) in float64, bit for bit,
   each with the launch plan the host rule chose (cluster size, plane
   placement, cudaOccupancyMaxActiveClusters) and with the planes forced
   into the other placement; K1's time per design step (one block per
   source; clusters of 4, 8, 16 with the planes in the global scratch;
   planes in distributed shared memory), per block size, and over
   B = 1, 8, 32, 128 at Dc=64.
2b. The shell-segmented sweep K2 at the R=100 row of the raytracing
   benchmark harness (N=250, R=100, B=8: Dc=208, S=24 by the auto rule,
   K=5), against the plain version and bit for bit against K1, in both
   plane placements and per design step as K1, and at a
   small clipped shape in float64 with a ragged last segment; the fused
   kernels K1f (fuse_rates) and K3 (fuse_fold) at the bench shape with
   compressed bins in float32 and at a small clipped shape in float64 that
   holds a zero-density cell: complete rate boxes, the per-source flux and
   the source cell's closed form included, K1f with its rate threads and
   without; their time per design step (K1f: the bins inside the sub-step,
   128 and 256 rate threads, a small ring, fewer chain threads; K3: the
   cluster size of its first launch).
2c. The fused kernel with the heating output, K3h (fuse_fold with
   do_heating), at the bench shape in float32 and at the small clipped
   float64 shape with a zero-density cell: both outputs against the plain
   version, and its Gamma bit for bit against K3's. Then the chain floor
   of every kernel, a dense pass of the bin sums over the card and the
   rate floor it sets for K1f, K3 and K3h.
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
   prints ns per cell-update, its launch counts, which are asserted, and
   for the fused modes the per-batch stage times (one kernel call per
   batch and nothing after it but the accumulate).
3c. The non-isothermal path at full width: the bench configuration with
   do_heating=True and fuse_fold=True (K3h, one launch per batch) and with
   do_heating=True alone (K1 + the rate pass with the heat channel); each
   Gamma held against phase 3's, the two heat fields against each other,
   the per-batch stage times of both; then update_temperature over the
   256^3 cells from 100 K with that heat.
4. One evolve3D timestep to convergence at N=64, R=8, 16 sources, float32,
   held against the same call on the CPU.
4b. One non-isothermal evolve3D timestep (thermal=ThermalParams) at the
   same size with fuse_fold=True, GPU against CPU: xh, Gamma and T.
4c. The entry point: C2Ray_Test(<the heating example's parameters as a
   dict>, 48, device="cuda"), six timesteps in float64 with engine cheb
   as examples/heating_test/run_test.py runs them, then that script's five
   checks of the temperature and ionization profiles.
5. The script's wall time, a ``kernels`` JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Needs one CUDA card; exits non-zero without one. Imports nothing of JAX.
``python3 chip_smoke.py --kernels`` stops after phase 2c (the kernels
against their plain versions and their times) and prints no result line.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
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
HEAT_OPS_PER_BIN = 2             # K3h, beside the above: w_heat*core, add
HEAT_OPS_PER_CELL = 2            # and the second result (mul, div)
N_R100, R_R100, NS_R100 = 250, 100.0, 100   # raytracing harness, R=100 row
N_EVOLVE, R_EVOLVE, NS_EVOLVE = 64, 8.0, 16  # the evolve3D steps of 4, 4b
N_HEATING, STEPS_HEATING = 48, 6             # examples/heating_test defaults
T_START = time.time()


def log(*a):
    print(*a, flush=True)


def heating_params(results_basename):
    """The parameters of examples/heating_test/run_test.py as a parsed
    mapping: examples/single_source_test/parameters.yml with NumTau 500,
    the heating rates on, a cold start at 100 K, Material.isothermal false
    and Raytracing.engine cheb (tests/test_torch_models.py holds this dict
    equal to the YAML that the example writes)."""
    return {
        "Grid": {"boxsize": 0.014, "resume": 0},
        "Material": {"isothermal": False, "temp0": 1e2, "xh0": 1.2e-3,
                     "avg_dens": 1.0e-6},
        "CGS": {"albpow": -0.7, "bh00": 2.59e-13, "alcpow": -0.672,
                "eth0": 13.598, "ethe0": 24.587, "ethe1": 54.416,
                "xih0": 1.0, "fh0": 0.83, "colh0_fact": 1.3e-8},
        "Abundances": {"abu_h": 0.926, "abu_he": 0.074, "abu_c": 7.1e-7},
        "Photo": {"sigma_HI_at_ion_freq": 6.30e-18, "minlogtau": -20,
                  "maxlogtau": 4, "NumTau": 500, "grey": 0,
                  "SourceType": "blackbody", "compute_heating_rates": 1,
                  "R_max_cMpc": 0.01640625},
        "BlackBodySource": {"Teff": 5e4, "cross_section_pl_index": 2.8},
        "Cosmology": {"cosmological": 0, "h": 1.0, "Omega0": 0.27,
                      "Omega_B": 0.044, "cmbtemp": 2.726, "zred_0": 9.0},
        "Output": {"results_basename": results_basename,
                   "logfile": "pyC2Ray.log"},
        "Raytracing": {"loss_fraction": 1e-2, "subboxsize": 150,
                       "max_subbox": 1000, "source_batch_size": 1,
                       "convergence_fraction": 1e-4, "dtype": "float64",
                       "engine": "cheb"},
    }


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


def plan_text(name):
    """The plan of kernel ``name``'s last launch and what the card said it
    holds of such clusters at once (asked only where the rule chose)."""
    from pyc2ray_torch.ops import sweep
    p = sweep.last_plan[name]
    held = [n for (_, q), n in sweep.occupancy.items() if q == p]
    return (f"C={p.cluster} planes="
            f"{'shared' if p.shared_planes else 'scratch'} "
            f"threads={p.threads} smem={p.smem} B"
            + (f" max_active_clusters={held[0]}" if held else ""))


def design_steps(label, call, name, Dc, dtype, reps, calls=1):
    """Time ``call(plan)`` per design step of the sweep loop (the shell
    window on one block per source; clusters of 4, 8, 16 on the global
    scratch; the planes in distributed shared memory), then with the host
    rule's plan per block size. A step that does not fit the shared memory
    at this shape is said so. ``calls`` kernel calls per ``call``."""
    from pyc2ray_torch.ops import sweep
    isz = torch.finfo(dtype).bits // 8
    steps = [("step 1 shell window, one block per source",
              dict(cluster=1, shared_planes=False))]
    steps += [(f"step 2 cluster of {C}, planes in scratch",
               dict(cluster=C, shared_planes=False)) for C in (4, 8, 16)]
    steps += [(f"step 3 cluster of {C}, planes shared",
               dict(cluster=C, shared_planes=True)) for C in (4, 8, 16)]
    steps += [(f"with {threads} threads per block", dict(threads=threads))
              for threads in (128, 256, 512)]
    for text, plan in steps:
        smem = sweep.plan_sizes(Dc, isz, plan.get("cluster", 1),
                                plan.get("shared_planes", False))[0]
        if smem > sweep.SMEM_MAX:
            log(f"  {label} {text}: does not fit ({smem} B of shared "
                f"memory per block)")
            continue
        ms = cuda_ms(lambda: call(plan), reps) / calls
        log(f"  {label} {text}: {ms:.4f} ms per call ({plan_text(name)})")


def fused_steps(label, call, name, reps):
    """Time ``call(plan)`` of a fused kernel per design step. K1f, its
    rates: every cell's bins evaluated by its chain thread inside the
    dependent sub-step (no rate threads, clusters of 8 and 16); handed
    through the ring to 128 or 256 rate threads per block; a ring of 64
    slots per buffer, whose overflow the chain threads evaluate; 256 chain
    threads. K3 and K3h, whose rates are a second launch: the cluster size
    of the first."""
    if label == "K1f":
        steps = [("rates inside the sub-step (no rate threads)",
                  dict(rate_threads=0)),
                 ("rates inside the sub-step, cluster of 8",
                  dict(rate_threads=0, cluster=8)),
                 ("128 rate threads", dict(rate_threads=128)),
                 ("256 rate threads", dict(rate_threads=256)),
                 ("256 rate threads, ring of 64 slots",
                  dict(rate_threads=256, ring=64)),
                 ("256 rate threads, 256 chain threads",
                  dict(rate_threads=256, threads=256))]
    else:
        steps = [(f"cluster of {C}, planes shared",
                  dict(cluster=C, shared_planes=True)) for C in (8, 16)]
    for text, plan in steps:
        ms = cuda_ms(lambda: call(plan), reps)
        log(f"  {label} {text}: {ms:.4f} ms per call ({plan_text(name)})")


def rate_floor(bins, n_cells, dtype, reps=10):
    """ns per cell and bin of a dense pass of the fused kernels' bin sums
    (sum_e w_e exp(-tau_in s_e) (-expm1(-dtau s_e))) over ``n_cells``
    cells on the whole card, where nothing waits for it."""
    from pyc2ray_torch.ops import sweep
    rng = np.random.RandomState(11)
    tau = torch.from_numpy(rng.uniform(0.0, 3.0, n_cells)).to("cuda", dtype)
    dtau = torch.from_numpy(rng.uniform(0.0, 0.1, n_cells)).to("cuda", dtype)
    bs = torch.from_numpy(np.asarray(bins.s)).to("cuda", dtype)
    bw = torch.from_numpy(np.asarray(bins.w_photo)).to("cuda", dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = sweep.dense_bin_sums(tau, dtau, bs, bw, 8 * sms)
    ref = sweep._bin_sum(tau, dtau, bs, bw)[0]
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise RuntimeError("dense bin sums differ from their plain version")
    ms = cuda_ms(lambda: sweep.dense_bin_sums(tau, dtau, bs, bw, 8 * sms),
                 reps)
    ns = 1e6 * ms / (n_cells * bins.num_bins)
    log(f"dense bin sums, {n_cells} cells x {bins.num_bins} bins "
        f"{str(dtype).split('.')[-1]}: {ms:.4f} ms = {ns:.6f} ns per cell "
        f"and bin over the card (bit-equal to the plain version)")
    return ns


def barrier_costs(B, n=2000):
    """us per cluster barrier, for B clusters of each size: a launch of n
    barriers against a launch of none. Returns {cluster size: us}."""
    from pyc2ray_torch.ops import sweep
    out = {}
    for C in (1, 2, 4, 8, 16):
        t0 = cuda_ms(lambda: sweep.cluster_barriers(B, C, 0), 20)
        t1 = cuda_ms(lambda: sweep.cluster_barriers(B, C, n), 20)
        out[C] = 1e3 * (t1 - t0) / n
    return out


def check_sweep(N, R, B, dtype, seed, reps, steps=False):
    """K1 vs its plain version on CUDA tensors at the engine's shapes, bit
    for bit, with the plan the host rule chose and with the planes forced
    into the other placement."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    rt = ChebRaytracer(N, R, SIG, grey_bins(), batch_size=B, dtype=dtype)
    g, tb = rt.geom, rt.tables
    nhi = random_nhi(rt, B, dtype, seed)
    args = (nhi, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p, DR, g.c, SIG)
    out = sweep.cheb_sweep(*args)
    ref = sweep.cheb_sweep_ref(*args)
    torch.cuda.synchronize()
    chosen = sweep.last_plan["cheb_sweep"]
    max_abs = float((out - ref).abs().max())
    log(f"sweep N={N} R={R} B={B} Dc={g.Dc} c={g.c} R1={g.r_max + 1} "
        f"{str(dtype).split('.')[-1]}: plan {plan_text('cheb_sweep')}, "
        f"max_abs_err={max_abs:.3e}")
    if not torch.equal(out, ref):
        raise RuntimeError("K1 differs from its plain version")
    other = sweep.cheb_sweep(*args, plan=dict(
        shared_planes=not chosen.shared_planes))
    torch.cuda.synchronize()
    if not torch.equal(other, ref):
        raise RuntimeError("K1 in the other plane placement differs from "
                           "its plain version")
    log(f"  other placement ({plan_text('cheb_sweep')}): bit-equal")
    ms = cuda_ms(lambda: sweep.cheb_sweep(*args), reps)
    plain_ms = cuda_ms(lambda: sweep.cheb_sweep_ref(*args), 3)
    bound_ms, bound_by = sweep_bound_ms(B, g.Dc, g.r_max + 1, dtype)
    log(f"  K1: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    # what the host spends to enqueue one call (checks, plan lookup, output
    # allocation, the launch): the device is not waited for inside the loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        sweep.cheb_sweep(*args)
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    log(f"  K1: host_ms={host_ms:.4f} per call to enqueue")
    if steps:
        design_steps("K1", lambda plan: sweep.cheb_sweep(*args, plan=plan),
                     "cheb_sweep", g.Dc, dtype, reps)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, cluster=chosen.cluster)


def batch_scan(N, R, dtype, seed, reps):
    """K1's time per call over the batch size at one box shape, each with
    the plan the host rule chose for it."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    rt = ChebRaytracer(N, R, SIG, grey_bins(), batch_size=1, dtype=dtype)
    g, tb = rt.geom, rt.tables
    for B in (1, 8, 32, 128):
        nhi = random_nhi(rt, B, dtype, seed)
        args = (nhi, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p, DR, g.c,
                SIG)
        ms = cuda_ms(lambda: sweep.cheb_sweep(*args), reps)
        log(f"  K1 batch scan Dc={g.Dc} R1={g.r_max + 1} B={B}: {ms:.4f} ms "
            f"per call = {ms / B:.4f} ms per source "
            f"({plan_text('cheb_sweep')})")


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


def timing(name, kernel, plain, reps, nbytes, ops, dtype, kname, calls=1):
    """Kernel and plain ms per call (``calls`` calls per ``kernel()``),
    the bound of one call from its bytes and operations, and the cluster
    size of the launches of kernel ``kname`` that were timed."""
    from pyc2ray_torch.ops import sweep
    ms = cuda_ms(kernel, reps) / calls
    cluster = sweep.last_plan[kname].cluster
    plain_ms = cuda_ms(plain, 1) / calls
    b_ms, b_by = least_ms(nbytes / calls, ops / calls, dtype)
    log(f"  {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}) per call, {plan_text(kname)}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                cluster=cluster)


def check_seg(N, R, B, dtype, rtol, seed, reps, shell_segment="auto",
              steps=False):
    """K2 chained over its K segments vs the plain sweep (bit for bit, in
    both plane placements) and vs K1."""
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

    def chain(seg=sweep.cheb_sweep_seg, **kw):
        planes = sweep.init_planes(nhi, g.c, DR)
        box = torch.zeros_like(nhi)
        for k in range(K):
            box, planes = seg(nhi, *geo, DR, g.c, SIG, planes, 1 + k * S, S,
                              box, **kw)
        box[:, g.c, g.c, g.c] = nhi[:, g.c, g.c, g.c] * (0.5 * torch.tensor(
            DR, dtype=dtype, device="cuda"))
        return box

    log(f"K2 cheb_sweep_seg N={N} R={R} B={B} Dc={g.Dc} R1={g.r_max + 1} "
        f"S={S} K={K} {str(dtype).split('.')[-1]}:")
    out = chain()
    chosen = sweep.last_plan["cheb_sweep_seg"]
    log(f"  plan {plan_text('cheb_sweep_seg')}")
    k1 = sweep.cheb_sweep(nhi, *geo, DR, g.c, SIG)
    torch.cuda.synchronize()
    if not torch.equal(out, k1):
        raise RuntimeError("K2: the segmented box differs from K1's")
    log("  K2 box equals K1 box bit for bit")
    ref = chain(sweep.cheb_sweep_seg_ref)
    max_abs = compare("K2 vs plain", out, ref, rtol)
    # the other plane placement: shared planes need the largest cluster at
    # this box side
    other = dict(shared_planes=not chosen.shared_planes)
    if other["shared_planes"]:
        other["cluster"] = 16
    if not (torch.equal(out, ref) and torch.equal(chain(plan=other), ref)):
        raise RuntimeError("K2 differs from its plain version")
    log(f"  other placement ({plan_text('cheb_sweep_seg')}): bit-equal")
    isz = torch.finfo(dtype).bits // 8
    nbytes, ops = sweep_work(B, g.Dc, g.r_max + 1, dtype)
    nbytes += K * 2 * B * 6 * g.Dc ** 2 * isz       # carried planes in, out
    t = timing("K2", chain, lambda: chain(sweep.cheb_sweep_seg_ref), reps,
               nbytes, ops, dtype, "cheb_sweep_seg", calls=K)
    if steps:
        design_steps("K2", lambda plan: chain(plan=plan), "cheb_sweep_seg",
                     g.Dc, dtype, reps, calls=K)
    return dict(max_abs_err=max_abs, **t)


def check_fused(N, R, B, dtype, rtol, floor, seed, reps, bins,
                zero_cell=False, steps=False):
    """K1f and K3 (complete boxes: the flux and the source cell inside) vs
    their plain versions, K1f with its rate threads and with every cell
    kept inside its sub-step; returns {name: numbers}, with the number of
    rated cells of a call."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    rt = ChebRaytracer(N, R, SIG, bins, batch_size=B, dtype=dtype)
    g, tb = rt.geom, rt.tables
    nhi = random_nhi(rt, B, dtype, seed, zero_cell)
    flux = torch.linspace(0.5, 2.0, B, dtype=dtype, device="cuda")
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    kw = dict(bins=(tb.bins_s, tb.bins_w), rt_tab=tb.rt_tab,
              R2=rt.R_max_LLS ** 2, flux=flux)
    rates = (nhi, *geo, tb.rt_tab, flux, DR, g.c, SIG, tb.bins_s, tb.bins_w)
    kernels = {
        "K1f": (lambda plan=None: sweep.cheb_sweep(nhi, *geo, DR, g.c, SIG,
                                                   plan=plan, **kw),
                lambda: sweep.cheb_sweep_ref(nhi, *geo, DR, g.c, SIG, **kw)),
        "K3": (lambda plan=None: sweep.cheb_sweep_rates(*rates, plan=plan),
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
    knames = {"K1f": "cheb_sweep_fused_rates", "K3": "cheb_sweep_rates"}
    for name, (kern, plain) in kernels.items():
        ref = plain()
        max_abs = compare(f"{name} vs plain", kern(), ref, rtol, floor)
        if not float(ref[:, g.c, g.c, g.c].min()) > 0.0:
            raise RuntimeError(f"{name}: the plain version's source cell is "
                               f"not positive")
        if name == "K1f":
            compare("K1f without rate threads vs plain",
                    kern(dict(rate_threads=0)), ref, rtol, floor)
        out[name] = dict(max_abs_err=max_abs, n_rated=n_rated, **timing(
            name, kern, plain, reps, nbytes + extra[name], ops, dtype,
            knames[name]))
        if steps:
            fused_steps(name, kern, knames[name], reps)
    return out


def check_heat(N, R, B, dtype, rtol, floor, seed, reps, bins,
               zero_cell=False, steps=False):
    """K3h vs its plain version (both outputs, each with its own floor at
    its peak) and its Gamma vs K3's; returns its numbers."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    rt = ChebRaytracer(N, R, SIG, bins, batch_size=B, dtype=dtype,
                       do_heating=True, fuse_fold=True)
    g, tb = rt.geom, rt.tables
    nhi = random_nhi(rt, B, dtype, seed, zero_cell)
    flux = torch.linspace(0.5, 2.0, B, dtype=dtype, device="cuda")
    rates = (nhi, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p, tb.rt_tab,
             flux, DR, g.c, SIG, tb.bins_s, tb.bins_w)

    def kern(plan=None):
        return sweep.cheb_sweep_rates(*rates, bins_wh=tb.bins_wh, plan=plan)

    def plain():
        return sweep.cheb_sweep_rates_ref(*rates, bins_wh=tb.bins_wh)

    log(f"K3h N={N} R={R} B={B} Dc={g.Dc} R1={g.r_max + 1} "
        f"E={bins.num_bins} {str(dtype).split('.')[-1]}"
        f"{' (one zero-density cell)' if zero_cell else ''}:")
    (phi, heat), (phi_r, heat_r) = kern(), plain()
    err_phi = compare("K3h Gamma vs plain", phi, phi_r, rtol, floor)
    err_heat = compare("K3h heat vs plain", heat, heat_r, rtol, floor)
    if not float(heat_r[:, g.c, g.c, g.c].min()) > 0.0:
        raise RuntimeError("K3h: the plain version's source-cell heat is not "
                           "positive")
    if zero_cell and float(heat[1, g.c, g.c + 1, g.c]) != 0.0:
        raise RuntimeError("K3h: heat at the zero-density cell is not 0")
    if not torch.equal(phi, sweep.cheb_sweep_rates(*rates)):
        raise RuntimeError("K3h: Gamma differs from K3's")
    log("  K3h Gamma equals K3 Gamma bit for bit")
    isz = torch.finfo(dtype).bits // 8
    nbytes, ops = sweep_work(B, g.Dc, g.r_max + 1, dtype)
    n_rated = B * int((tb.rt_tab[:, 1] > 0.5).sum())
    ops += n_rated * ((RATE_OPS_PER_BIN + HEAT_OPS_PER_BIN) * bins.num_bins
                      + RATE_OPS_PER_CELL + HEAT_OPS_PER_CELL)
    # K3's bytes (rates table, flux) plus the heating weights and one more
    # output box
    nbytes += (2 * g.Dc ** 3 * isz + B * isz + bins.num_bins * isz
               + B * g.Dc ** 3 * isz)
    res = dict(max_abs_err=max(err_phi, err_heat), heat_max_abs_err=err_heat,
               n_rated=n_rated,
               **timing("K3h", kern, plain, reps, nbytes, ops, dtype,
                        "cheb_sweep_rates_heat"))
    if steps:
        fused_steps("K3h", kern, "cheb_sweep_rates_heat", reps)
    return res


def run_path(rt, nd, xh, pos_b, flux_b, ns, R, expect, label, chem=None):
    """A warm-up trace, then one trace_batches (and global_pass with
    ``chem``) with the launch counts set to 0 just before and read just
    after; asserts the counts equal ``expect`` (others 0) and the output
    finite. Returns (phi, heat, counts), heat None without do_heating."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.chemistry import global_pass
    rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    sweep.reset_launches()
    t0 = time.time()
    phi, heat = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    t_ray = time.time() - t0
    counts = dict(sweep.launches)
    want = {k: expect.get(k, 0) for k in counts}
    if counts != want:
        raise RuntimeError(f"{label}: kernel launches {counts}, expected "
                           f"{want}")
    for name, t in (("Gamma", phi), ("heat", heat)):
        if (t is None) != (name == "heat" and not rt.do_heating):
            raise RuntimeError(f"{label}: {name} is {type(t).__name__}")
        if t is not None and (not bool(torch.isfinite(t).all())
                              or not float(t.max()) > 0.0):
            raise RuntimeError(f"{label}: {name} is not finite and positive")
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
    return phi, heat, counts


def stage_breakdown(rt, nd, xh, pos_b, flux_b, nbatch):
    """Device time per batch of each stage of trace_extended, over the
    first ``nbatch`` batches (CUDA events around each stage), for the
    default mode, fuse_rates and fuse_fold, with or without do_heating.
    "sweep" is the kernel (K1, or one call of K1f, K3 or K3h, which
    returns complete rate boxes), "rates" what follows it (the rate pass;
    nothing in a fused mode), "accumulate" the per-source slice adds of
    Gamma and, with do_heating, of the heat."""
    from pyc2ray_torch.ops.sweep import cheb_sweep, cheb_sweep_rates
    g, tb, N = rt.geom, rt.tables, rt.N
    nhi3 = nd.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3))
    wrap = torch.arange(-g.c, N + g.Dc - 1 - g.c, device="cuda") % N
    nhi_pad = nhi3[wrap][:, wrap][:, :, wrap]
    pads = [torch.zeros_like(nhi_pad) for _ in range(1 + rt.do_heating)]
    dr_t = torch.tensor(DR, dtype=rt.dtype).to("cuda")
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    c = g.c
    tot = dict(extract=0.0, sweep=0.0, rates=0.0, accumulate=0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for pos, flux in list(zip(pos_b, flux_b))[:nbatch]:
        ev[0].record()
        boxes = rt._extract_boxes(nhi_pad, pos.to("cuda"))
        ev[1].record()
        if rt.fuse_fold:
            out = cheb_sweep_rates(
                boxes, *geo, tb.rt_tab, flux, DR, c, rt.sig, tb.bins_s,
                tb.bins_w, bins_wh=tb.bins_wh if rt.do_heating else None)
            ev[2].record()
            out = out if rt.do_heating else (out,)
        elif rt.fuse_rates and not rt.do_heating:
            out = (cheb_sweep(boxes, *geo, DR, c, rt.sig,
                              bins=(tb.bins_s, tb.bins_w), rt_tab=tb.rt_tab,
                              R2=rt.R_max_LLS ** 2, flux=flux),)
            ev[2].record()
        else:
            cd = cheb_sweep(boxes, *geo, DR, c, rt.sig)
            ev[2].record()
            out = rt._rates(cd, boxes, flux, dr_t)[:1 + rt.do_heating]
        ev[3].record()
        D = out[0].shape[-1]
        sh = rt._rb0 if D == rt.Ds else 0
        for pad, rate_box in zip(pads, out):
            for (p0, p1, p2), box in zip(pos.tolist(), rate_box):
                pad[p0 + sh:p0 + sh + D, p1 + sh:p1 + sh + D,
                    p2 + sh:p2 + sh + D] += box
        ev[4].record()
        torch.cuda.synchronize()
        for k, name in enumerate(tot):
            tot[name] += ev[k].elapsed_time(ev[k + 1])
    return {k: v / nbatch for k, v in tot.items()}


def heating_checks(temp, xh, N):
    """The five checks of examples/heating_test/run_test.py on the final
    temperature and ionized-fraction fields; returns {name: bool} and the
    binned profiles."""
    c = N // 2
    i, j, k = np.indices((N, N, N))
    r = np.sqrt((i - c) ** 2 + (j - c) ** 2 + (k - c) ** 2)
    rb = np.arange(0, N // 2)
    t_prof = np.array([temp[(r >= a) & (r < a + 1)].mean() for a in rb])
    x_prof = np.array([xh[(r >= a) & (r < a + 1)].mean() for a in rb])
    r_front = int(np.argmin(np.abs(x_prof - 0.5)))
    post = t_prof[r_front:]
    return {
        "core photoheated above 5e3 K": bool(t_prof[1] > 5e3),
        "distant gas within 3x of initial 100 K": bool(t_prof[-1] < 300.0),
        "T profile monotone non-increasing beyond the I-front (tol 1%)":
            bool(np.all(np.diff(post) <= 0.01 * post[:-1] + 1e-9)),
        "T peak sits at/inside the I-front":
            int(np.argmax(t_prof)) <= r_front + 1,
        "ionized gas (x>0.9) is photoheated (median T > 5e3 K)":
            bool(np.any(xh > 0.9))
            and float(np.median(temp[xh > 0.9])) > 5e3,
    }, t_prof, x_prof


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    from pyc2ray_torch import C2Ray_Test
    from pyc2ray_torch.evolve import evolve3D
    from pyc2ray_torch.ops import _build, sweep
    from pyc2ray_torch.ops.thermal import ThermalParams, update_temperature
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
    # per kernel <element type, planes shared(, heat output)>: registers,
    # spills, static shared memory (the sweeps' shared memory is dynamic,
    # see the plans)
    kernel = ""
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(\d+)([a-z_]+kernel)"
                      r"(?:I([fd])((?:Lb[01]E)+))?", line)
        if m:
            kernel = m.group(2) + (
                f"<{'float' if m.group(3) == 'f' else 'double'}, "
                + ", ".join("true" if b == "1" else "false" for b in
                            re.findall(r"Lb([01])E", m.group(4))) + ">"
                if m.group(3) else "")
        elif "spill" in line or "registers" in line:
            log(f"  ptxas {kernel}: "
                + line.replace("ptxas info    :", "").strip())
    barrier_us = barrier_costs(B_BENCH)
    log(f"cluster barrier, {B_BENCH} clusters of 512 threads per block: "
        + ", ".join(f"C={C} {us:.4f} us" for C, us in barrier_us.items()))

    # ---- 2. kernel vs plain version on the card -------------------------
    k_bench = check_sweep(N_BENCH, R_BENCH, B_BENCH, torch.float32, seed=1,
                          reps=20, steps=True)
    batch_scan(N_BENCH, R_BENCH, torch.float32, seed=1, reps=10)
    check_sweep(8, 6.0, 2, torch.float64, seed=2, reps=20)
    # the heating example's sweep: R beyond the mesh, one source
    k_f64 = check_sweep(N_HEATING, 56.25, 1, torch.float64, seed=8, reps=20)
    t0 = time.time()
    bins = make_bins()
    log(f"bins: {bins.num_bins} compressed nodes ({time.time() - t0:.1f} s)")

    # ---- 2b. the kernels of the other sweep modes vs their plain versions
    k_seg = check_seg(N_R100, R_R100, B_BENCH, torch.float32, rtol=1e-5,
                      seed=3, reps=3, steps=True)
    # N=16, R=8 clips the box; S=3 leaves a ragged last segment of r_max=8
    check_seg(16, 8.0, 2, torch.float64, rtol=1e-12, seed=4, reps=3,
              shell_segment=3)
    k_fused = check_fused(N_BENCH, R_BENCH, B_BENCH, torch.float32,
                          rtol=1e-4, floor=1e-6, seed=5, reps=10, bins=bins,
                          steps=True)
    check_fused(16, 8.0, 2, torch.float64, rtol=1e-10, floor=0.0, seed=6,
                reps=3, bins=bins, zero_cell=True)

    # ---- 2c. K3h (fuse_fold with the heating output) vs its plain version
    k_heat = check_heat(N_BENCH, R_BENCH, B_BENCH, torch.float32, rtol=1e-4,
                        floor=1e-6, seed=5, reps=10, bins=bins, steps=True)
    check_heat(16, 8.0, 2, torch.float64, rtol=1e-10, floor=0.0, seed=6,
               reps=3, bins=bins, zero_cell=True)
    # the chain floor: 3 (R1 - 1) sub-steps, each at least one cluster
    # barrier at the cluster size the kernel ran with
    for name, res, n_sub in (
            ("K1 bench", k_bench, 3 * 30),
            ("K1 float64 heating shape", k_f64, 3 * 24),
            ("K2 R=100, per call of 24 shells", k_seg, 3 * 100 / 5),
            ("K1f", k_fused["K1f"], 3 * 30), ("K3", k_fused["K3"], 3 * 30),
            ("K3h", k_heat, 3 * 30)):
        C = res["cluster"]
        log(f"chain floor {name}: {n_sub:g} sub-steps x {barrier_us[C]:.4f} "
            f"us (C={C}) = {1e-3 * n_sub * barrier_us[C]:.5f} ms; measured "
            f"{res['ms']:.4f} ms, byte/operation bound "
            f"{res['bound_ms']:.5f} ms")
    # the rate floor of the fused kernels: their rated cells x bins x what
    # a cell and bin cost in a dense pass over the whole card
    ns_bin = rate_floor(bins, B_BENCH * 64 ** 3, torch.float32)
    for name, res in (("K1f", k_fused["K1f"]), ("K3", k_fused["K3"]),
                      ("K3h", k_heat)):
        res["rate_floor_ms"] = 1e-6 * res.pop("n_rated") * bins.num_bins \
            * ns_bin
        log(f"rate floor {name}: {res['rate_floor_ms']:.5f} ms "
            f"({ns_bin:.6f} ns per cell and bin), measured "
            f"{res['ms']:.4f} ms")
    if "--kernels" in sys.argv[1:]:
        log(f"chip_smoke --kernels wall time: {time.time() - T_START:.1f} s")
        return 0

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
    # the sweep between rate passes (its tables may have left the L2)
    log(f"  K1 in the pipeline {br['sweep']:.4f} ms per batch (the device "
        f"is drained before each batch, so this holds the host's time to "
        f"enqueue), alone {k_bench['ms']:.4f} ms per call "
        f"({plan_text('cheb_sweep')})")

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
        phi_f, _, counts = run_path(
            rtf, ndens, xh, pos_b, flux_b, NS_BENCH, R_BENCH, {kname: nbatch},
            f"{mode} N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32",
            chem)
        fused_launches[kname] = counts[kname]
        # the unfused path rebuilds cdin = cd - dcol in float32, which
        # cancels where dcol >> cdin: compare above a floor at the peak
        compare(f"{mode} Gamma vs the unfused Gamma", phi_f, phi, 1e-4,
                1e-6)
        br = stage_breakdown(rtf, ndens, xh, pos_b, flux_b, 16)
        log("  per-batch device ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in br.items()))
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
        h_phi[seg], _, counts = run_path(
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

    # ---- 3c. the non-isothermal path at full width ------------------------
    heat_f = {}
    for fold, kname in ((True, "cheb_sweep_rates_heat"),
                        (False, "cheb_sweep")):
        rth = ChebRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH,
                            dtype=dt, do_heating=True, fuse_fold=fold)
        label = (f"do_heating{' + fuse_fold' if fold else ''} N={N} "
                 f"R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32")
        phi_h, heat_f[fold], counts = run_path(
            rth, ndens, xh, pos_b, flux_b, NS_BENCH, R_BENCH,
            {kname: nbatch}, label, chem)
        if fold:
            heat_launches = counts[kname]
        compare(f"{'K3h' if fold else 'K1 + rate pass'} Gamma vs phase 3's",
                phi_h, phi, 1e-4, 1e-6)
        br = stage_breakdown(rth, ndens, xh, pos_b, flux_b, 16)
        log("  per-batch device ms: " + ", ".join(f"{k} {v:.4f}"
                                                 for k, v in br.items()))
        del rth, phi_h
    # the unfused heat inherits the float32 cancellation of cd - dcol
    compare("K3h heat vs the rate pass's heat", heat_f[True], heat_f[False],
            1e-4, 1e-6)
    thermal = ThermalParams(bh00=chem.bh00, albpow=chem.albpow,
                            colh0=chem.colh0, temph0=chem.temph0,
                            abu_c=chem.abu_c)
    t_cold = grid(100.0)
    update_temperature(dt_d, t_cold, ndens, xh, heat_f[True], thermal,
                       z=9.0, nsub=1)                          # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    t_new = update_temperature(dt_d, t_cold, ndens, xh, heat_f[True],
                               thermal, z=9.0)
    torch.cuda.synchronize()
    t_therm = time.time() - t0
    t_lo, t_hi = float(t_new.min()), float(t_new.max())
    if (t_new.shape != (N ** 3,) or not bool(torch.isfinite(t_new).all())
            or t_lo < thermal.t_floor or t_hi > thermal.t_cap
            or not t_hi > 100.0):
        raise RuntimeError(f"update_temperature: T range {t_lo}..{t_hi}")
    log(f"update_temperature N={N} float32, 16 substeps from 100 K: "
        f"{t_therm:.4f} s = {1e9 * t_therm / N ** 3:.3f} ns/cell, T range "
        f"{t_lo:.1f}..{t_hi:.1f} K, "
        f"{int((t_new > 1e3).sum())} cells above 1e3 K")
    del heat_f, t_new, t_cold

    # ---- 4. one evolve3D timestep, GPU vs CPU ---------------------------
    Ne, Re, nse = N_EVOLVE, R_EVOLVE, NS_EVOLVE
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

    # ---- 4b. one non-isothermal evolve3D timestep, GPU vs CPU -------------
    e_cold = np.full((Ne,) * 3, 1e2)
    out = {}
    for devname in ("cuda", "cpu"):
        rte = ChebRaytracer(Ne, Re, SIG, bins, batch_size=B_BENCH, dtype=dt,
                            device=devname, do_heating=True, fuse_fold=True)
        sweep.reset_launches()
        t0 = time.time()
        out[devname] = evolve3D(DT, DR, e_flux, e_pos, rte, chem, e_cold,
                                e_nd, e_xh, quiet=True, thermal=thermal,
                                zred=9.0)
        n_k3h = sweep.launches["cheb_sweep_rates_heat"]
        log(f"evolve3D(thermal) N={Ne} R={Re} {nse} sources fuse_fold on "
            f"{devname}: {time.time() - t0:.2f} s, K3h launches {n_k3h}")
        if (n_k3h > 0) != (devname == "cuda"):
            raise RuntimeError(f"evolve3D(thermal) on {devname}: {n_k3h} "
                               f"K3h launches")
    (xh_g, phi_g, t_g), (xh_c, phi_c, t_c) = out["cuda"], out["cpu"]
    for a in (xh_g, phi_g, t_g):
        if a.shape != (Ne,) * 3 or not np.all(np.isfinite(a)):
            raise RuntimeError("evolve3D(thermal): non-finite output")
    if not t_g.max() > 1e3:
        raise RuntimeError("evolve3D(thermal): nothing was heated")
    np.testing.assert_allclose(xh_g, xh_c, rtol=1e-4, atol=0)
    np.testing.assert_allclose(phi_g, phi_c, rtol=1e-4,
                               atol=1e-6 * np.abs(phi_c).max())
    np.testing.assert_allclose(t_g, t_c, rtol=1e-3, atol=0)
    log(f"evolve3D(thermal) GPU vs CPU: xh max rel "
        f"{np.max(np.abs(xh_g - xh_c) / np.abs(xh_c)):.3e}, phi max abs "
        f"{np.max(np.abs(phi_g - phi_c)):.3e} of max {phi_c.max():.3e}, T "
        f"max rel {np.max(np.abs(t_g - t_c) / t_c):.3e} (T range "
        f"{t_g.min():.1f}..{t_g.max():.1f} K)")

    # ---- 4c. the entry point: the heating example through C2Ray_Test ------
    Nh, steps = N_HEATING, STEPS_HEATING
    with tempfile.TemporaryDirectory() as tmp:
        quiet_log = io.StringIO()
        sweep.reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(quiet_log):
            sim = C2Ray_Test(heating_params(tmp + "/"), Nh, device="cuda")
            sim.ndens = 1e-3 * np.ones((Nh,) * 3)
            srcpos = np.array([[Nh // 2 + 1]] * 3, dtype=float)
            srcflux = np.array([50.0])
            zreds = sim.generate_redshift_array(2, 2e6)
            dt_h = sim.set_timestep(zreds[0], zreds[1], steps)
            for _ in range(steps):
                sim.evolve3D(dt_h, srcflux, srcpos)
        t_sim = time.time() - t0
    n_iter = quiet_log.getvalue().count("Raytracing took")
    n_k1 = sweep.launches["cheb_sweep"]
    g_h = sim.raytracer.geom
    log(f"C2Ray_Test heating example N={Nh} (float64, engine cheb, "
        f"Dc={g_h.Dc}, R1={g_h.r_max + 1}, "
        f"{sim.raytracer.num_bins} bins): {steps} timesteps, {n_iter} "
        f"raytrace iterations, {t_sim:.2f} s with set-up, K1 launches "
        f"{n_k1}")
    if n_k1 == 0 or n_k1 != n_iter:
        raise RuntimeError(f"heating example: {n_k1} K1 launches for "
                           f"{n_iter} single-source iterations")
    temp_h, xh_h = np.asarray(sim.temp), np.asarray(sim.xh)
    if not (np.all(np.isfinite(temp_h)) and np.all(np.isfinite(xh_h))):
        raise RuntimeError("heating example: non-finite temp or xh")
    checks, t_prof, x_prof = heating_checks(temp_h, xh_h, Nh)
    log("  r [cells]: <T> [K], <x>: " + "; ".join(
        f"{a}: {t_prof[a]:.1f}, {x_prof[a]:.3e}"
        for a in range(0, Nh // 2, 3)))
    for name, passed in checks.items():
        log(f"  {name}: {'PASSED' if passed else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError("heating example: " + ", ".join(
            k for k, v in checks.items() if not v) + " FAILED")

    # ---- 5. kernels line and result -----------------------------------
    # launches: each kernel's count over its own path's run (phase 3 for
    # K1, 3b for K1f, K2 and K3, 3c for K3h); the other numbers from phases
    # 2, 2b and 2c at that path's shapes. No single PyTorch call computes any of them.
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
             launches=fused_launches["cheb_sweep_rates"], **k_fused["K3"]),
        dict(name="cheb_sweep_rates_heat", source=src + "cheb_sweep_rates.cu",
             replaces=tpu + "669", launches=heat_launches, **k_heat)]
    kernels = [dict(name=k.pop("name"), route="cuda", **k, library_ms=None)
               for k in kernels]
    log(f"chip_smoke wall time: {time.time() - T_START:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
