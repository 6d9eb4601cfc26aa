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
   cluster size of its first launch); K3 at the shapes of the EoR run's
   buckets (N=250, B=16, R=7.68 and 15.37: Dc=24 and 40) and of the
   adaptive bench mix's smaller buckets (N=256, B=8, R=7.5 and 15), in
   float32, with the plans the host rule chose.
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
   Then where the two part: Gamma of one trace on equal inputs, global_pass
   on equal Gamma (and the inner iterations each cell took), doric's terms
   and update_temperature on equal inputs.
4b. One non-isothermal evolve3D timestep (thermal=ThermalParams) at the
   same size with fuse_fold=True, GPU against CPU: xh, Gamma and T.
4c. The entry point: C2Ray_Test(<the heating example's parameters as a
   dict>, 48, device="cuda"), six timesteps in float64 with engine cheb
   as examples/heating_test/run_test.py runs them (the model layer builds
   its engines with fuse_fold: one K3h launch per raytrace iteration), then
   that script's five checks of the temperature and ionization profiles.
4d. The adaptive engine at the bench mix: N=256, R_max=30 (buckets 7.5, 15,
   30), 12288 sources at positions from seed 100 with fluxes over three
   decades, B=8, float32, fuse_fold. Its Gamma equals the sum of one
   fuse_fold ChebRaytracer per bucket bit for bit, each bucket launching K3
   once per batch; ns per cell-update, the per-batch stage times of the
   smallest bucket, and the GPU trace of the first 16 sources against the
   CPU.
4e. The production EoR run, examples/eor_simulation/run_test.py's loop:
   C2Ray_CubeP3M(<its parameters.yml>, 250, device="cuda") (engine
   adaptive, float32, B=16) on the committed inputs, both slices
   (21.062 -> 20.134 -> 19.284) with one timestep each. Per slice the
   bucket counts, raytrace iterations, K3 launches (asserted: iterations x
   batches), s per trace and per chemistry pass, Mcell-updates/s and the
   photon loss; xh finite in [0, 1] and changed, the outputs read back
   equal to the state. Then one trace under torch.profiler: its top device
   kernels and the device's idle share; and the Gamma of the first 16
   sources against the CPU. The catalogs are read without h5py
   (``read_catalog``).
2d. (after 2c) K1 at the helium engine's three threshold cross sections
   (sigma_HI, sigma_HeI, sigma_HeII of make_spectral_bins_he) at the bench
   shape in float32, bit for bit against its plain version, with its time.
3d. (after 3c) The table-exact flat engine (ops/raytrace.py) at the bench
   configuration in float64 with the model layer's black-body tables: ns per
   cell-update, device launches per batch and the device idle share of a
   profiled window, and the trace of the first 16 sources against the CPU.
3e. The helium engine (HeRaytracer, 72 default bins) at the bench fields in
   float32: ns per cell-update, its K1 launches (three per batch, asserted),
   one global_pass_he, the per-batch device ms of the three sweeps, the rate
   pass and the accumulate; Gamma_HI of a helium-free field against the
   hydrogen engine at the same bins.
3f. The octahedral sheet engine (BoxRaytracer, engine: box, plain PyTorch)
   at the bench configuration in float32 with the compressed bins: ns per
   cell-update (Ns cut only where 2048 sources would outrun
   BOX_BUDGET_S), device launches per batch and per shell, the device idle
   share and busy ms of 16 profiled batches, per-stage ms, the cost of the
   box side's alignment to 8, the trace of the first 16 sources against the
   CPU (1e-5 above 1e-6 of the peak); the grey spectrum in float64 at N=64
   with 8 sources, R beyond the mesh, against the flat engine (rtol 2e-7).
   It launches none of the five kernels (asserted).
4f. (after 4e) The golden: examples/single_source_test at its full
   configuration (N=128, 2 slices x 10 timesteps, parameters.yml unchanged:
   engine flat, float64) through C2Ray_Test on the card against the
   sequential C++ oracle's evolve loop (native_ext, built with g++ into
   build/torch_kernels/); the eight statistics of run_test.py, each held to
   its tolerance; the wall time of the port's part and of the oracle's.
4g. One evolve3D_he timestep at N=64 with 16 sources in float64 with
   secondary ionizations and recombination photons, GPU against CPU; then
   C2Ray_Test with engine he, the heating rates and isothermal false for two
   timesteps at N=128 on the card: iterations, K1 launches (three per
   iteration, asserted) and the photon loss of each timestep.
4h. The heating example of 4c with Raytracing.engine box: its five checks,
   no kernel launched (asserted), xh and T against 4c's cheb run.
5. The multi-GPU paths (pyc2ray_torch.parallel) as a world of 2 ranks
   spawned on the one card over gloo, both on cuda:0 (and again with one
   rank per card over nccl where the machine has two cards or more; with
   one, a line says that branch did not run). Every rank: 5a the bench
   configuration with fuse_fold (K3) through trace_sharded, Gamma held
   against 3b's single-rank K3 Gamma at 1e-5 above 1e-6 of the peak; 5b
   the EoR run's first slice with one timestep through
   C2Ray_CubeP3M(mesh=make_mesh()), 5c the same under a domain mesh
   di = 2 (owner-local adaptive buckets), each held against 4e's first
   slice (raytrace iterations within one, xh within 1e-5 absolute, photon
   loss within loss_fraction), with s per timestep and per iteration and per
   rank the K3 launches, ms and bytes in collectives per iteration, the
   halo bytes (5c) and the device idle share of one trace of the rank's
   share; 5d phase 4g's helium model for its first timestep under a source
   and a domain mesh of 2, xh and T held to 1e-10 and the helium fractions
   to 1e-9 of 4g's. A rank's exception fails the phase.
6. The script's wall time, a ``kernels`` JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Needs one CUDA card; exits non-zero without one. Imports nothing of JAX.
``python3 chip_smoke.py --kernels`` stops after phase 2d (the kernels
against their plain versions and their times) and prints no result line.
``python3 chip_smoke.py --nccl``, on a machine with two cards or more, runs
after phase 1 only phase 5's nccl world with its single-rank references
(``nccl_branch``) and prints no result line.
"""

import contextlib
import io
import json
import os
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
NS_ADAPT, B_ADAPT = 12288, 8                 # the adaptive bench mix (4d)
EOR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "eor_simulation")
EOR_ZLIST = (21.062, 20.134, 19.284)         # run_test.py's first slices
N_EOR, B_EOR = 250, 16                       # its mesh; parameters.yml's B
ABU_HE = 0.074                               # parameters.yml's abu_he
N_GOLDEN, STEPS_GOLDEN = 128, 10             # run_test.py --full
BOX_BUDGET_S = 20.0          # 3f's timed trace: the batches of Ns = 2048
                             # that fit at the pace of 16 unprofiled ones
N_BOX_GREY, NS_BOX_GREY = 64, 8              # 3f's grey check
# the adaptive ladder of parameters.yml at N=250: R_max_LLS = 15 cMpc x
# 250 / 244 cells and half of it (a quarter is below R_min = 4)
R_EOR = (15.0 * N_EOR / 244.0 / 2.0, 15.0 * N_EOR / 244.0)
# the committed halo catalogs: HDF5 files whose two datasets are contiguous
# and uncompressed (h5py's get_offset())
HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"
CATALOG_NSRC = 20000
CATALOG_POS_AT, CATALOG_MASS_AT = 2048, 482048
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
    from pyc2ray_torch.ops.raytrace_box import grey_bins
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
    from pyc2ray_torch.ops.raytrace_box import grey_bins
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
    from pyc2ray_torch.ops.raytrace_box import grey_bins
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
                zero_cell=False, steps=False, names=("K1f", "K3")):
    """K1f and K3 (complete boxes: the flux and the source cell inside) vs
    their plain versions, K1f with its rate threads and with every cell
    kept inside its sub-step; returns {name: numbers}, with the number of
    rated cells of a call. ``names`` selects the kernels."""
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
    log(f"{'/'.join(names)} N={N} R={R:g} B={B} Dc={g.Dc} R1={g.r_max + 1} "
        f"E={bins.num_bins} {str(dtype).split('.')[-1]}"
        f"{' (one zero-density cell)' if zero_cell else ''}:")
    out = {}
    knames = {"K1f": "cheb_sweep_fused_rates", "K3": "cheb_sweep_rates"}
    for name in names:
        kern, plain = kernels[name]
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


def cell_updates(ns, R):
    """Cell-updates of a trace of ``ns`` sources at radius R (the
    reference's normalisation, Ns 4/3 pi R^3)."""
    return ns * 4.0 / 3.0 * np.pi * R ** 3


def run_path(rt, nd, xh, pos_b, flux_b, updates, expect, label, chem=None):
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
    ns_cell = 1e9 * t_ray / updates
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
    nhi_pad = rt.wrap_pad(nd.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3)))
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
        for pad, rate_box in zip(pads, out):
            rt.add_boxes(pad, rate_box, pos)
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


def read_catalog(sim, file):
    """A halo catalog of examples/eor_simulation/inputs/sources as
    ``sim.read_sources(file)`` returns it, read without h5py (the card's
    machine has none): sources_positions (20000, 3) int64 and sources_mass
    (20000,) float64, little-endian, at their byte offsets. Raises on any
    other layout; tests/test_torch_cubep3m.py holds it against
    read_sources."""
    with open(file, "rb") as f:
        raw = f.read()
    if (raw[:len(HDF5_SIGNATURE)] != HDF5_SIGNATURE
            or len(raw) != CATALOG_MASS_AT + 8 * CATALOG_NSRC):
        raise ValueError(f"{file}: not a {CATALOG_NSRC}-source HDF5 catalog "
                         f"of the committed layout")
    pos = np.frombuffer(raw, "<i8", 3 * CATALOG_NSRC, CATALOG_POS_AT)
    mass = np.frombuffer(raw, "<f8", CATALOG_NSRC, CATALOG_MASS_AT)
    if pos.min() < 1 or not (np.all(np.isfinite(mass)) and mass.min() > 0):
        raise ValueError(f"{file}: positions or masses out of range")
    return sim._sources_from_catalog(pos.reshape(CATALOG_NSRC, 3).copy(),
                                     mass.copy(), file)


def inner_iterations(dt, nd, temp, xh, phi, chem, doric=None):
    """global_pass's loop (ops/chemistry.py) with a count of the doric
    iterations each cell took before it froze; ``doric`` replaces
    ops/chemistry.py::doric."""
    from pyc2ray_torch.ops import chemistry as ch
    doric = doric or ch.doric
    xh_av = xh
    active = torch.ones(xh.shape, dtype=torch.bool, device=xh.device)
    its = torch.zeros(xh.shape, dtype=torch.int32, device=xh.device)
    for _ in range(ch.MAX_INNER_ITER):
        if not bool(active.any()):
            break
        _, xh_av_new = doric(xh, dt, temp, nd * (xh_av + chem.abu_c), phi,
                             chem)
        rel = torch.abs((xh_av_new - xh_av) / (1.0 - xh_av_new))
        done = (rel < ch.MIN_FRACTIONAL_CHANGE) | (
            (1.0 - xh_av_new) < ch.MIN_FRACTION_OF_ATOMS)
        xh_av = torch.where(active, xh_av_new, xh_av)
        its = its + active.to(torch.int32)
        active = active & ~done
    return its, xh_av


def doric_reference_form(xh, dt, temp, rhe, phi, p):
    """ops/chemistry.py::doric with the reference's time average
    (1 - ee) / deltht in every dtype, where doric's float32 form takes
    -expm1(-deltht): the other side of the inner-iteration comparison."""
    from pyc2ray_torch.constants import EPSILON
    brech0 = p.clumping * p.bh00 * (temp / 1e4) ** p.albpow
    acolh0 = p.colh0 * torch.sqrt(temp) * torch.exp(-p.temph0 / temp)
    aih0 = phi + rhe * acolh0
    delth = aih0 + rhe * brech0
    eqxh = aih0 / delth
    deltht = delth * dt
    ee = torch.exp(-deltht)
    x = torch.clamp((xh - eqxh) * ee + eqxh, min=EPSILON)
    avg = torch.where(deltht < 1.0e-8, torch.ones_like(deltht),
                      (1.0 - ee) / deltht)
    return x, torch.clamp(eqxh + (xh - eqxh) * avg, min=EPSILON)


def doric_terms(xh, dt, temp, rhe, phi, p):
    """ops/chemistry.py::doric's intermediate terms and results, by name."""
    from pyc2ray_torch.ops.chemistry import doric
    brech0 = p.clumping * p.bh00 * (temp / 1e4) ** p.albpow
    acolh0 = p.colh0 * torch.sqrt(temp) * torch.exp(-p.temph0 / temp)
    deltht = (phi + rhe * acolh0 + rhe * brech0) * dt
    ee = torch.exp(-deltht)
    x, x_av = doric(xh, dt, temp, rhe, phi, p)
    return {"brech0 (pow)": brech0, "acolh0 (sqrt, exp)": acolh0,
            "ee = exp(-delth dt)": ee,
            "(1 - ee) / (delth dt), the reference's form":
            (1.0 - ee) / deltht,
            "-expm1(-delth dt) / (delth dt), doric's float32 form":
            -torch.expm1(-deltht) / deltht, "xh": x, "xh_av": x_av}


def max_rel(a, b, floor=0.0):
    """max |a - b| / |b| over the cells where |b| > floor * max|b|, both
    on the CPU in float64."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    big = b.abs() > floor * float(b.abs().max())
    return float(((a - b).abs()[big] / b.abs()[big]).max()) \
        if bool(big.any()) else 0.0


def bisect_gap(bins, chem, thermal, pos, flux, nd, xh):
    """Where the card and the CPU part in phase 4's float32 timestep, one
    stage at a time on equal inputs: Gamma of one trace (the engine of
    phase 4); global_pass on the CPU's Gamma, with the doric iterations
    each cell took; doric's terms on the inputs of its first iteration;
    update_temperature on equal heat."""
    from pyc2ray_torch.ops.chemistry import global_pass
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    from pyc2ray_torch.ops.thermal import update_temperature
    dt = torch.float32
    Ne = nd.shape[0]
    out = {}
    for dev in ("cuda", "cpu"):
        rt = ChebRaytracer(Ne, R_EVOLVE, SIG, bins, batch_size=B_BENCH,
                           dtype=dt, device=dev, do_heating=True,
                           fuse_fold=True)
        out[dev] = [t.cpu() for t in rt.trace(nd, xh, pos, flux, DR)]
    (phi_g, heat_g), (phi_c, heat_c) = out["cuda"], out["cpu"]
    log(f"gap bisection N={Ne} float32: Gamma of one trace card vs CPU max "
        f"rel {max_rel(phi_g, phi_c, 1e-6):.3e} (above 1e-6 of the peak), "
        f"heat {max_rel(heat_g, heat_c, 1e-6):.3e}")
    res = {}
    for dev in ("cuda", "cpu"):
        def f(a):
            return torch.as_tensor(a, dtype=dt).reshape(-1).to(dev)
        dt_d = torch.tensor(DT, dtype=dt).to(dev)
        temp = torch.full((Ne ** 3,), 1e4, dtype=dt, device=dev)
        x0 = f(xh)
        xi, xa, cf = global_pass(dt_d, f(nd), temp, x0, x0, f(phi_c), chem)
        its, _ = inner_iterations(dt_d, f(nd), temp, x0, f(phi_c), chem)
        terms = doric_terms(x0, dt_d, temp, f(nd) * (x0 + chem.abu_c),
                            f(phi_c), chem)
        t_new = update_temperature(dt_d, torch.full_like(temp, 100.0),
                                   f(nd), x0, f(heat_c), thermal, z=9.0)
        res[dev] = dict(xi=xi.cpu(), xa=xa.cpu(), cf=int(cf), its=its.cpu(),
                        terms={k: v.cpu() for k, v in terms.items()},
                        T=t_new.cpu())
    g, c = res["cuda"], res["cpu"]
    diff_its = g["its"] != c["its"]
    d_xa = (g["xa"].double() - c["xa"].double()).abs() \
        / c["xa"].double().abs()
    log(f"  global_pass on equal Gamma: xh max rel "
        f"{max_rel(g['xi'], c['xi']):.3e}, xh_av {max_rel(g['xa'], c['xa']):.3e}"
        f", conv_flag {g['cf']} / {c['cf']}; cells whose doric iterations "
        f"differ: {int(diff_its.sum())} of {diff_its.numel()} (xh_av max "
        f"rel there {float(d_xa[diff_its].max()) if bool(diff_its.any()) else 0.0:.3e}, "
        f"elsewhere {float(d_xa[~diff_its].max()):.3e}); iterations "
        f"{int(c['its'].min())}..{int(c['its'].max())}")
    for name in g["terms"]:
        log(f"  doric on equal inputs, {name}: max rel "
            f"{max_rel(g['terms'][name], c['terms'][name]):.3e}")
    log(f"  update_temperature on equal inputs (16 substeps from 100 K): T "
        f"max rel {max_rel(g['T'], c['T']):.3e}")


def adaptive_bench(bins):
    """Phase 4d: the adaptive engine at the bench mix against one fuse_fold
    engine per bucket; returns the K3 launches of its trace."""
    from pyc2ray_torch.ops.adaptive import AdaptiveRaytracer
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    N, dt = N_BENCH, torch.float32
    rng = np.random.RandomState(100)
    pos = rng.randint(0, N, size=(NS_ADAPT, 3))
    flux = 10 ** rng.uniform(-3.0, 0.0, NS_ADAPT)
    ada = AdaptiveRaytracer(N, R_BENCH, SIG, bins, batch_size=B_ADAPT,
                            dtype=dt, fuse_fold=True)
    nd = torch.full((N ** 3,), 1e-3, dtype=dt, device="cuda")
    xh = torch.full((N ** 3,), 1.2e-3, dtype=dt, device="cuda")
    avg = float(nd.mean())
    batches, _ = ada.prepare_sources(pos, flux, dr=DR, avg_dens=avg)
    counts = list(batches.counts)
    nb = [p.shape[0] for p in batches.pos]
    log(f"adaptive bench mix N={N} R_max={R_BENCH:g} Ns={NS_ADAPT} "
        f"B={B_ADAPT} float32: {ada.describe_buckets(batches)}; batches "
        f"{nb}; Dc {[e.geom.Dc for e in ada.engines]}")
    if ada.radii != [7.5, 15.0, 30.0] or min(counts) == 0 \
            or counts[0] != max(counts):
        raise RuntimeError(f"adaptive bench mix: buckets {ada.radii} "
                           f"{counts}, expected every bucket of [7.5, 15, "
                           f"30] used and the smallest the largest")
    updates = sum(cell_updates(c, r) for c, r in zip(counts, ada.radii))
    phi, _, launches = run_path(ada, nd, xh, batches, None, updates,
                                {"cheb_sweep_rates": sum(nb)},
                                "adaptive bench mix, all buckets")
    sel_b = ada.assign_buckets(flux, DR, avg)
    total = None
    for k, r in enumerate(ada.radii):
        eng = ChebRaytracer(N, r, SIG, bins, batch_size=B_ADAPT, dtype=dt,
                            fuse_fold=True)
        sel = np.nonzero(sel_b == k)[0]
        pb, fb = eng.prepare_sources(pos[sel], flux[sel])
        p_k, _, _ = run_path(
            eng, nd, xh, pb, fb, cell_updates(sel.size, r),
            {"cheb_sweep_rates": pb.shape[0]},
            f"  bucket R={r:g} alone ({sel.size} sources, {pb.shape[0]} "
            f"batches, Dc={eng.geom.Dc})")
        total = p_k if total is None else total + p_k
    if not torch.equal(phi, total):
        raise RuntimeError("adaptive Gamma differs from the sum of its "
                           "buckets' engines")
    log("  adaptive Gamma equals the sum of the per-bucket engines bit for "
        "bit")
    br = stage_breakdown(ada.engines[0], nd, xh, batches.pos[0],
                         batches.flux[0], 16)
    log(f"  per-batch device ms, bucket R={ada.radii[0]:g}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in br.items()))
    ada_cpu = AdaptiveRaytracer(N, R_BENCH, SIG, bins, batch_size=B_ADAPT,
                                dtype=dt, device="cpu", fuse_fold=True)
    nd_np = np.full((N,) * 3, 1e-3)
    xh_np = np.full((N,) * 3, 1.2e-3)
    phi_g = ada.trace(nd_np, xh_np, pos[:16], flux[:16], DR,
                      avg_dens=avg).cpu()
    phi_c = ada_cpu.trace(nd_np, xh_np, pos[:16], flux[:16], DR,
                          avg_dens=avg)
    floor = 1e-6 * float(phi_c.max())
    torch.testing.assert_close(phi_g, phi_c, rtol=1e-4, atol=floor)
    log(f"  adaptive, 16 sources: GPU vs CPU max abs diff "
        f"{float((phi_g - phi_c).abs().max()):.3e} (floor {floor:.3e})")
    return launches["cheb_sweep_rates"]


def eor_slice(sim, k):
    """One slice of examples/eor_simulation/run_test.py's loop with one
    timestep, the launch counts set to 0 just before evolve3D and read just
    after; returns the catalog and the numbers parsed from the log."""
    from pyc2ray_torch.ops import sweep
    zi, zf = EOR_ZLIST[k], EOR_ZLIST[k + 1]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        sim.read_density(zi)
        srcpos, flux = read_catalog(
            sim, os.path.join(EOR_DIR, "inputs", "sources",
                              f"{zi:.3f}-sources.hdf5"))
        dt = sim.set_timestep(zi, zf, 1)
        sim.cosmo_evolve(dt)
        sweep.reset_launches()
        t0 = time.time()
        sim.evolve3D(dt, flux, srcpos)
        torch.cuda.synchronize()
        t_step = time.time() - t0
        launches = dict(sweep.launches)
        sim.write_output(zf)
    text = text.getvalue()
    counts = [int(c) for c in re.findall(
        r"R=[\d.]+: (\d+)", text.split("Adaptive radii")[1].splitlines()[0])]
    return srcpos, flux, dict(
        zi=zi, zf=zf, t_step=t_step, launches=launches, counts=counts,
        t_ray=[float(t) for t in re.findall(r"Raytracing took ([\d.]+) s",
                                            text)],
        t_chem=[float(t) for t in re.findall(r"Chemistry took ([\d.]+) s",
                                             text)],
        loss=[float(v) for v in re.findall(
            r"photon loss fraction: ([-+\d.e]+)", text)],
        converged="Multiple source convergence reached." in text)


def eor_run(bins):
    """Phase 4e: the production EoR run on the committed inputs; returns
    the K3 launches of its timesteps, K3's device ms per call in the
    profiled trace and the first slice's iterations, photon loss and xh.
    ``bins`` are make_bins(), the bins the model builds from parameters.yml
    (asserted)."""
    from pyc2ray_torch import C2Ray_CubeP3M
    from pyc2ray_torch.diagnostics import (device_idle_share,
                                           device_op_times, profile_trace)
    from pyc2ray_torch.io import read_cbin
    from pyc2ray_torch.ops.adaptive import AdaptiveRaytracer
    from pyc2ray_torch.utils import format_sources
    from pyc2ray_torch.utils.paramutils import read_paramfile
    params = read_paramfile(os.path.join(EOR_DIR, "parameters.yml"))
    k3 = 0
    with tempfile.TemporaryDirectory() as tmp:
        params["Output"]["results_basename"] = tmp + "/"
        params["Output"]["inputs_basename"] = \
            os.path.join(EOR_DIR, "inputs") + "/"
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            sim = C2Ray_CubeP3M(params, N_EOR, device="cuda")
        rt = sim.raytracer
        log(f"EoR run: C2Ray_CubeP3M(examples/eor_simulation/parameters.yml, "
            f"{N_EOR}, device='cuda') in {time.time() - t0:.2f} s: "
            f"buckets R = {rt.radii}, Dc {[e.geom.Dc for e in rt.engines]}, "
            f"B = {rt.engines[0].batch_size}, {rt.dtype}, "
            f"{rt.engines[0].num_bins} bins, fuse_fold")
        if (type(rt) is not AdaptiveRaytracer or rt.radii != list(R_EOR)
                or rt.dtype != torch.float32
                or rt.engines[0].batch_size != B_EOR):
            raise RuntimeError("EoR run: the model did not build the "
                               "adaptive engine of parameters.yml")
        xh0 = np.array(sim.xh)
        for k in range(2):
            srcpos, flux, r = eor_slice(sim, k)
            n_it = len(r["t_ray"])
            nbatch = sum(-(-c // B_EOR) for c in r["counts"])
            want = {name: 0 for name in r["launches"]}
            want["cheb_sweep_rates"] = n_it * nbatch
            if r["launches"] != want or not r["converged"] or n_it == 0:
                raise RuntimeError(f"EoR slice {k}: launches "
                                   f"{r['launches']}, expected {want}; "
                                   f"converged {r['converged']}")
            k3 += r["launches"]["cheb_sweep_rates"]
            updates = sum(cell_updates(c, R) for c, R
                          in zip(r["counts"], rt.radii))
            t_ray, t_chem = np.mean(r["t_ray"]), np.mean(r["t_chem"])
            log(f"EoR slice z = {r['zi']:.3f} -> {r['zf']:.3f}: buckets "
                f"{dict(zip(rt.radii, r['counts']))} ({nbatch} batches), "
                f"{n_it} raytrace iterations, K3 launches "
                f"{r['launches']['cheb_sweep_rates']}, {r['t_step']:.2f} s "
                f"per timestep; per iteration raytrace {t_ray:.3f} s "
                f"({1e9 * t_ray / updates:.3f} ns/cell-update), chemistry "
                f"{t_chem:.3f} s, {updates / (t_ray + t_chem) / 1e6:.2f} "
                f"Mcell-updates/s; photon loss {r['loss'][-1]:.3e} (bound "
                f"loss_fraction {sim.loss_fraction:g}); <n> "
                f"{sim.ndens.mean():.4e} cm^-3")
            if r["loss"][-1] > sim.loss_fraction:
                raise RuntimeError("EoR run: photon loss above "
                                   "loss_fraction")
            xh = np.asarray(sim.xh)
            if (xh.shape != (N_EOR,) * 3 or not np.all(np.isfinite(xh))
                    or xh.min() < 0.0 or xh.max() > 1.0
                    or np.array_equal(xh, xh0)):
                raise RuntimeError(f"EoR slice {k}: xh not finite in [0, 1] "
                                   f"or unchanged")
            suffix = f"_{r['zf']:.3f}.dat"
            back = read_cbin(f"{tmp}/xfrac{suffix}", bits=64, order="F")
            rates = read_cbin(f"{tmp}/IonRates{suffix}", bits=32, order="F")
            if not (np.array_equal(back, xh) and np.array_equal(
                    rates, np.asarray(sim.phi_ion, np.float32))):
                raise RuntimeError(f"EoR slice {k}: outputs differ from the "
                                   f"state")
            log(f"  xh {xh.min():.3e}..{xh.max():.3e}, mean {xh.mean():.4e}; "
                f"cells with xh > 0.5: {int((xh > 0.5).sum())}; outputs read "
                f"back equal to the state")
            xh0 = np.array(xh)
            if k == 0:
                # phase 5b/5c's single-rank reference
                first = dict(iterations=n_it, loss=r["loss"][-1], xh=xh0,
                             t_step=r["t_step"], t_ray=float(t_ray))

        # one trace of the last slice's state under the profiler
        pos, fl = format_sources(srcpos, flux)
        nd = torch.as_tensor(sim.ndens, dtype=rt.dtype,
                             device="cuda").reshape(-1)
        xh_d = torch.as_tensor(sim.xh, dtype=rt.dtype,
                               device="cuda").reshape(-1)
        avg = float(nd.mean())
        batches, _ = rt.prepare_sources(pos, fl, dr=sim.dr, avg_dens=avg)
        phi = rt.trace_batches(nd, xh_d, batches, None, sim.dr)[0]
        torch.cuda.synchronize()
        t0 = time.time()
        phi = rt.trace_batches(nd, xh_d, batches, None, sim.dr)[0]
        torch.cuda.synchronize()
        t_plain = time.time() - t0
        prof = os.path.join(tmp, "profile")
        t0 = time.time()
        with profile_trace(prof) as p:
            p["sync"] = rt.trace_batches(nd, xh_d, batches, None, sim.dr)[0]
        t_prof = time.time() - t0
        if not torch.equal(p["sync"], phi):
            raise RuntimeError("EoR run: the profiled trace differs")
        idle = device_idle_share(prof)
        top = device_op_times(prof)
        busy = sum(top.values())
        nbatch = sum(b.shape[0] for b in batches.pos if b is not None)
        # K3's two launches per call: the sweep (phase A), the rates (B)
        k3_ms = {ph: sum(ms for name, ms in top.items() if kern in name)
                 / nbatch for ph, kern in (("A", "sweep_fold_kernel"),
                                           ("B", "box_rates_kernel"))}
        log(f"EoR trace under torch.profiler: {t_prof:.3f} s (unprofiled "
            f"{t_plain:.3f} s), trace file "
            f"{os.path.getsize(p['path']) / 2 ** 20:.1f} MiB; device idle "
            f"share {idle:.4f} of the profiled trace, "
            f"{1.0 - 1e-3 * busy / t_plain:.4f} of the unprofiled one "
            f"(device busy {busy:.2f} ms in {len(top)} kinds of "
            f"operation); K3 on the device {k3_ms['A']:.4f} + "
            f"{k3_ms['B']:.4f} ms per call ({nbatch} calls); top: "
            + "; ".join(f"{name[:70]} {ms:.2f} ms" for name, ms
                        in list(top.items())[:8]))

        # the first 16 sources, GPU against the plain CPU path
        rt_cpu = AdaptiveRaytracer(N_EOR, rt.R_max, rt.engines[0].sig,
                                   bins, radii=rt.radii,
                                   batch_size=B_EOR, dtype=rt.dtype,
                                   device="cpu", fuse_fold=True)
        for a, b in zip(rt.engines[0].tables, rt_cpu.engines[0].tables):
            if not torch.equal(a.cpu(), b):
                raise RuntimeError("EoR run: the CPU engine's tables differ")
        p16, f16 = pos[:16], fl[:16]
        phi_g = rt.trace(nd, xh_d, p16, f16, sim.dr, avg_dens=avg).cpu()
        phi_c = rt_cpu.trace(sim.ndens, sim.xh, p16, f16, sim.dr,
                             avg_dens=avg)
        floor = 1e-6 * float(phi_c.max())
        torch.testing.assert_close(phi_g, phi_c, rtol=1e-4, atol=floor)
        log(f"  first batch (16 sources): GPU vs CPU max abs diff "
            f"{float((phi_g - phi_c).abs().max()):.3e} (floor {floor:.3e}, "
            f"peak {float(phi_c.max()):.3e})")
    return k3, k3_ms["A"] + k3_ms["B"], first


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "single_source_test")
# examples/single_source_test/run_test.py:200-210: name, tolerance
GOLDEN_TOLERANCES = (("Absolute mean", 1e-8), ("Absolute std", 3e-7),
                     ("Absolute max", 5e-6), ("Absolute min", 5e-6),
                     ("Relative mean", 1e-7), ("Relative std", 3e-6),
                     ("Relative max", 2e-5), ("Relative min", 2e-5))


def golden_run(N, numzred, steps, device, results_basename):
    """examples/single_source_test/run_test.py through the port:
    C2Ray_Test on that example's parameters.yml (read unchanged; only the
    output directory is ``results_basename``), one 1e49 photons/s
    black-body source, ``numzred - 1`` slices of ``steps`` timesteps, each
    timestep also run by the sequential C++ oracle's evolve loop as
    run_test.py:104-128 writes it. Returns the simulation, the eight
    statistics {name: (value, tolerance)} of run_test.py:200-210 and the
    wall seconds of the port's part and of the oracle's part."""
    from pyc2ray_torch import C2Ray_Test
    from pyc2ray_torch.native_ext import (chemistry_global_native,
                                          oracle_sweep_native)
    from pyc2ray_torch.utils import format_sources
    from pyc2ray_torch.utils.paramutils import read_paramfile
    params = read_paramfile(os.path.join(GOLDEN_DIR, "parameters.yml"))
    params["Output"]["results_basename"] = results_basename
    with contextlib.redirect_stdout(io.StringIO()):
        sim = C2Ray_Test(params, N, device=device)
    zred_array = sim.generate_redshift_array(numzred, 1e7)
    srcpos = np.array([[3 * N // 4], [3 * N // 4], [N // 2]], dtype=float)
    srcflux = np.array([1e49 / 1e48])
    sim.ndens = 1e-3 * np.ones((N, N, N))
    pos0, flux0 = format_sources(srcpos, srcflux)
    tables = (sim.photo_thin_table, sim.photo_thick_table,
              sim.heat_thin_table, sim.heat_thick_table, sim.minlogtau,
              sim.dlogtau)

    def oracle_evolve_loop(dt, dr, xh, ndens, temp):
        num_cells = N ** 3
        conv_criterion = min(int(1e-4 * num_cells), 0)
        prev1 = prev0 = 2.0 * num_cells
        xh_av = xh.copy()
        converged = False
        while not converged:
            phi, _, _ = oracle_sweep_native(ndens, xh_av, pos0, flux0, dr,
                                            sim.sig, sim.R_max_LLS,
                                            tables=tables)
            xh_int, xh_av, conv_flag = chemistry_global_native(
                dt, ndens, temp, xh, xh_av, phi, sim.bh00, sim.albpow,
                sim.colh0, sim.temph0, sim.abu_c)
            s1, s0 = xh_int.sum(), (1 - xh_int).sum()
            rel1 = abs((s1 - prev1) / s1) if s1 > 0 else 1.0
            rel0 = abs((s0 - prev0) / s0) if s0 > 0 else 1.0
            converged = (conv_flag < conv_criterion) or (rel1 < 1e-4
                                                         and rel0 < 1e-4)
            prev1, prev0 = s1, s0
        return xh_int

    xh_oracle = sim.xh.copy()
    xh_initial = sim.xh.copy()
    temp = sim.temp.copy()
    t_port = t_oracle = 0.0
    for k in range(len(zred_array) - 1):
        dt = sim.set_timestep(zred_array[k], zred_array[k + 1], steps)
        for _ in range(steps):
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                sim.cosmo_evolve(dt)
                sim.evolve3D(dt, srcflux, srcpos)
            t_port += time.time() - t0
            t0 = time.time()
            xh_oracle = oracle_evolve_loop(dt, sim.dr, xh_oracle, sim.ndens,
                                           temp)
            t_oracle += time.time() - t0
    if np.array_equal(np.asarray(sim.xh), xh_initial):
        raise RuntimeError("golden: the ionized fraction did not change")
    abserr = sim.xh - xh_oracle
    relerr = abserr / xh_oracle
    values = (abserr.mean(), abserr.std(), abserr.max(), abserr.min(),
              relerr.mean(), relerr.std(), relerr.max(), relerr.min())
    stats = {name: (float(v), tol)
             for (name, tol), v in zip(GOLDEN_TOLERANCES, values)}
    return sim, stats, t_port, t_oracle


def he_bins():
    """The three-species bins at make_spectral_bins_he's defaults (3 panels
    x 8 nodes per band, 72 bins), for the parameters.yml black body."""
    from pyc2ray_torch.constants import ev2fr
    from pyc2ray_torch.radiation import BlackBodySource
    from pyc2ray_torch.radiation.helium import make_spectral_bins_he
    return make_spectral_bins_he(
        BlackBodySource(5e4, False, ev2fr * 13.598, 2.8))


def check_sweep_he(bins_he, reps):
    """Phase 2d: K1 at the bench shape at each species' threshold cross
    section (the helium engine sweeps each absorber at its own), bit for
    bit against its plain version, with the time per call of both."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    dt = torch.float32
    rt = HeRaytracer(N_BENCH, R_BENCH, bins_he, ABU_HE, batch_size=B_BENCH,
                     dtype=dt)
    g, tb = rt.geom, rt.eng.tables
    nhi = random_nhi(rt.eng, B_BENCH, dt, seed=12)
    out = {}
    for name, sig in zip(("HI", "HeI", "HeII"), rt.sigma_th):
        args = (nhi, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p, DR, g.c,
                sig)
        got = sweep.cheb_sweep(*args)
        ref = sweep.cheb_sweep_ref(*args)
        torch.cuda.synchronize()
        max_abs = float((got - ref).abs().max())
        if not torch.equal(got, ref):
            raise RuntimeError(f"K1 at sigma_{name} differs from its plain "
                               f"version (max abs {max_abs:.3e})")
        ms = cuda_ms(lambda: sweep.cheb_sweep(*args), reps)
        plain_ms = cuda_ms(lambda: sweep.cheb_sweep_ref(*args), 2)
        out[name] = dict(sig=sig, ms=ms, plain_ms=plain_ms,
                         max_abs_err=max_abs)
        log(f"K1 at sigma_{name} = {sig:.4e} cm^2, B={B_BENCH} Dc={g.Dc} "
            f"R1={g.r_max + 1} float32: max_abs_err={max_abs:.3e} "
            f"(bit-equal), kernel_ms={ms:.4f}, plain_ms={plain_ms:.4f} "
            f"({plan_text('cheb_sweep')})")
    return out


def launches_in(prof):
    """Device kernels in the profile_trace captures of ``prof``."""
    from pyc2ray_torch.diagnostics import _trace_events
    return sum(e.get("cat") == "kernel" for events in _trace_events(prof)
               for e in events)


def flat_bench(src_pos, tmp):
    """Phase 3d: the table-exact flat engine at the bench configuration in
    float64 with the black-body tables of the model layer (NumTau 2000):
    ns per cell-update, device launches per batch and the device idle share
    of a profiled window of 16 batches, and the trace of the first 16
    sources on the card against the CPU."""
    from pyc2ray_torch.constants import ev2fr
    from pyc2ray_torch.diagnostics import device_idle_share, profile_trace
    from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
    from pyc2ray_torch.radiation import BlackBodySource, make_tau_table
    N, dt = N_BENCH, torch.float64
    tau, dlogtau = make_tau_table(-20.0, 4.0, 2000)
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    thin, thick = BlackBodySource(5e4, False, fmin, 2.8).make_photo_table(
        tau, fmin, fmax, 1e48)
    cfg = RaytraceConfig(N=N, R_max_LLS=R_BENCH, sig=SIG,
                         batch_size=B_BENCH, dtype=dt)
    t0 = time.time()
    rt = Raytracer(cfg, thin, thick, -20.0, dlogtau, device="cuda")
    t_build = time.time() - t0
    flux = np.ones(NS_BENCH)
    pos_b, flux_b = rt.prepare_sources(src_pos, flux)
    nbatch = pos_b.shape[0]
    nd = torch.full((N ** 3,), 1e-3, dtype=dt, device="cuda")
    xh = torch.full((N ** 3,), 1.2e-3, dtype=dt, device="cuda")
    rt.trace_batches(nd, xh, pos_b[:2], flux_b[:2], DR)          # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    phi, _ = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    t_ray = time.time() - t0
    if not (bool(torch.isfinite(phi).all()) and float(phi.max()) > 0.0):
        raise RuntimeError("flat engine: Gamma not finite and positive")
    nwin = 16
    t0 = time.time()
    with profile_trace(os.path.join(tmp, "flat")) as p:
        p["sync"] = rt.trace_batches(nd, xh, pos_b[:nwin], flux_b[:nwin],
                                     DR)[0]
    t_prof = time.time() - t0
    idle = device_idle_share(os.path.join(tmp, "flat"))
    per_batch = launches_in(os.path.join(tmp, "flat")) / nwin
    log(f"flat engine N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float64 "
        f"(q_max {rt.geom_np.max_q}, {rt.geom_np.num_cells} cells, "
        f"{len(rt.shells)} shells, tables {t_build:.1f} s): {nbatch} "
        f"batches in {t_ray:.4f} s = "
        f"{1e9 * t_ray / cell_updates(NS_BENCH, R_BENCH):.4f} "
        f"ns/cell-update, {1e3 * t_ray / nbatch:.3f} ms per batch; "
        f"{per_batch:.1f} device launches per batch, device idle share "
        f"{idle:.4f} of a profiled window of {nwin} batches ({t_prof:.2f} s)")
    rt_cpu = Raytracer(cfg, thin, thick, -20.0, dlogtau, device="cpu")
    nd_np, xh_np = np.full((N,) * 3, 1e-3), np.full((N,) * 3, 1.2e-3)
    phi_g = rt.trace(nd_np, xh_np, src_pos[:16], flux[:16], DR).cpu()
    phi_c = rt_cpu.trace(nd_np, xh_np, src_pos[:16], flux[:16], DR)
    # the thick-cell table difference amplifies a last-bit log10
    # difference where dtau ~ 1e-7: an absolute floor at 1e-12 of the peak
    floor = 1e-12 * float(phi_c.max())
    torch.testing.assert_close(phi_g, phi_c, rtol=1e-12, atol=floor)
    log(f"  flat engine, 16 sources, float64: GPU vs CPU max rel "
        f"{max_rel(phi_g, phi_c, 1e-12):.3e} (above 1e-12 of the peak), "
        f"max abs {float((phi_g - phi_c).abs().max()):.3e}")
    return dict(t_ray=t_ray, per_batch=per_batch, idle=idle)


def box_bench(src_pos, bins, tmp):
    """Phase 3f: the octahedral sheet engine (ops/raytrace_box.py, plain
    PyTorch) at the bench configuration in float32 with the compressed
    bins: ns per cell-update over the batches of the Ns = 2048 sources that
    fit BOX_BUDGET_S at the pace of 16 unprofiled batches (all of them
    unless the engine is slower than that), device launches per batch and
    the device idle share of a profiled window of 16 batches, and the trace
    of the first 16 sources against the CPU (relative 1e-5 above 1e-6 of
    the peak); per batch the device's busy ms and each stage's ms, and the
    cost of the box side's alignment to 8 (``unaligned_box``: the same 16
    batches, Gamma bit-equal). Then the grey spectrum in float64 at N = 64,
    8 sources, R beyond the mesh, on the card against the flat engine's
    analytic grey rates at rtol 2e-7. None of the five kernels runs
    (asserted)."""
    from pyc2ray_torch.diagnostics import (device_idle_share,
                                           device_op_times, profile_trace)
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
    from pyc2ray_torch.ops.raytrace_box import BoxRaytracer, grey_bins
    from pyc2ray_torch.ops.raytrace_cheb import wrap_pad
    N, dt = N_BENCH, torch.float32
    sweep.reset_launches()
    rt = BoxRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH, dtype=dt)
    g = rt.geom
    flux = np.ones(NS_BENCH)
    pos_b, flux_b = rt.prepare_sources(src_pos, flux)
    nd = torch.full((N ** 3,), 1e-3, dtype=dt, device="cuda")
    xh = torch.full((N ** 3,), 1.2e-3, dtype=dt, device="cuda")
    rt.trace_batches(nd, xh, pos_b[:1], flux_b[:1], DR)          # warm-up
    nwin = 16
    torch.cuda.synchronize()
    t0 = time.time()
    rt.trace_batches(nd, xh, pos_b[:nwin], flux_b[:nwin], DR)
    torch.cuda.synchronize()
    t_win = time.time() - t0
    nb = min(pos_b.shape[0], max(nwin, int(BOX_BUDGET_S * nwin / t_win)))
    t0 = time.time()
    phi, _ = rt.trace_batches(nd, xh, pos_b[:nb], flux_b[:nb], DR)
    torch.cuda.synchronize()
    t_ray = time.time() - t0
    if not (bool(torch.isfinite(phi).all()) and float(phi.max()) > 0.0):
        raise RuntimeError("box engine: Gamma not finite and positive")
    t0 = time.time()
    with profile_trace(os.path.join(tmp, "box")) as p:
        p["sync"] = rt.trace_batches(nd, xh, pos_b[:nwin], flux_b[:nwin],
                                     DR)[0]
    t_prof = time.time() - t0
    idle = device_idle_share(os.path.join(tmp, "box"))
    per_batch = launches_in(os.path.join(tmp, "box")) / nwin
    cut = ("" if nb == pos_b.shape[0] else
           f" (cut to the first {nb} of {pos_b.shape[0]} batches, "
           f"{nb * B_BENCH} sources: BOX_BUDGET_S)")
    log(f"box engine N={N} R={R_BENCH} Ns={nb * B_BENCH} B={B_BENCH} "
        f"float32 {rt.num_bins} bins (Q {g.Q}, Dc {g.Dc}, c {g.c}; sheet "
        f"stacks of {B_BENCH * 2 * g.Q * g.Dc ** 2} cells){cut}: {nb} "
        f"batches in {t_ray:.4f} s = "
        f"{1e9 * t_ray / cell_updates(nb * B_BENCH, R_BENCH):.4f} "
        f"ns/cell-update, {1e3 * t_ray / nb:.3f} ms per batch (16 "
        f"unprofiled: {1e3 * t_win / nwin:.3f}); {per_batch:.1f} device "
        f"launches per batch, device idle share {idle:.4f} of a profiled "
        f"window of {nwin} batches ({t_prof:.2f} s)")
    dev_ms = sum(device_op_times(os.path.join(tmp, "box")).values()) / nwin
    stages = box_stages(rt, nd, xh, pos_b, flux_b, nwin)
    # the sweep body's device launches per shell, from one batch's sweep
    H = rt._sheets(wrap_pad(nd.reshape((N,) * 3), g.c, g.Dc), pos_b[0])
    pathdr = rt.tables.path * torch.tensor(DR, dtype=dt).to("cuda")
    with profile_trace(os.path.join(tmp, "box_sweep")) as p:
        p["sync"] = rt._sweep(H, pathdr, DR)
    per_shell = launches_in(os.path.join(tmp, "box_sweep")) / (g.Q - 1)
    del H
    log(f"  box engine per batch: device busy {dev_ms:.3f} ms (profiled "
        f"window); stages " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in stages.items())
        + f" ms (CUDA events); the sweep {per_shell:.2f} device launches "
        f"per shell over {g.Q - 1} shells")
    # the cost of the box side's alignment: the same 16 batches on the
    # unaligned geometry, in turns with the aligned one
    rt_u = unaligned_box(rt)
    if rt_u is not None:
        ms, phis = {}, {}
        for eng, tag in ((rt, "aligned"), (rt_u, "unaligned"),
                         (rt_u, "unaligned"), (rt, "aligned")):
            torch.cuda.synchronize()
            t0 = time.time()
            phis[tag] = eng.trace_batches(nd, xh, pos_b[:nwin],
                                          flux_b[:nwin], DR)[0]
            torch.cuda.synchronize()
            ms.setdefault(tag, []).append(1e3 * (time.time() - t0) / nwin)
        if not torch.equal(phis["aligned"], phis["unaligned"]):
            raise RuntimeError("box engine: the unaligned geometry's Gamma "
                               "differs")
        gu = rt_u.geom
        log(f"  box side aligned Dc={g.Dc} against unaligned {gu.Dc} (Gamma "
            f"bit-equal; sheet cells x{(g.Dc / gu.Dc) ** 2:.4f}, box cells "
            f"x{(g.Dc / gu.Dc) ** 3:.4f}): ms per batch over {nwin} "
            f"batches, in turns A U U A: "
            + " / ".join(f"{v:.3f}" for v in ms["aligned"][:1]
                         + ms["unaligned"] + ms["aligned"][1:]))
        del rt_u
    rt_cpu = BoxRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH,
                          dtype=dt, device="cpu")
    nd_np, xh_np = np.full((N,) * 3, 1e-3), np.full((N,) * 3, 1.2e-3)
    phi_g = rt.trace(nd_np, xh_np, src_pos[:16], flux[:16], DR).cpu()
    phi_c = rt_cpu.trace(nd_np, xh_np, src_pos[:16], flux[:16], DR)
    torch.testing.assert_close(phi_g, phi_c, rtol=1e-5,
                               atol=1e-6 * float(phi_c.max()))
    log(f"  box engine, 16 sources, float32: GPU vs CPU max rel "
        f"{max_rel(phi_g, phi_c, 1e-6):.3e} (above 1e-6 of the peak; "
        f"bound 1e-5), max abs {float((phi_g - phi_c).abs().max()):.3e}")
    # the grey spectrum against the flat engine on the card
    Ng = N_BOX_GREY
    rng = np.random.RandomState(64)
    nd_g = 10 ** rng.uniform(-4, -2, (Ng,) * 3)
    xh_g = rng.uniform(0.0, 0.9, (Ng,) * 3)
    pos_g = rng.randint(0, Ng, size=(NS_BOX_GREY, 3))
    flux_g = rng.uniform(0.5, 2.0, NS_BOX_GREY)
    box = BoxRaytracer(Ng, 1e9, SIG, grey_bins(), batch_size=B_BENCH,
                       dtype=torch.float64)
    flat = Raytracer(RaytraceConfig(N=Ng, R_max_LLS=1e9, sig=SIG,
                                    batch_size=B_BENCH, dtype=torch.float64,
                                    grey_analytic=True), device="cuda")
    t0 = time.time()
    phi_b = box.trace(nd_g, xh_g, pos_g, flux_g, DR)
    torch.cuda.synchronize()
    t_box = time.time() - t0
    phi_f = flat.trace(nd_g, xh_g, pos_g, flux_g, DR)
    torch.testing.assert_close(phi_b, phi_f, rtol=2e-7, atol=0.0)
    log(f"  box engine grey float64 N={Ng} R=1e9 (Q {box.geom.Q}, Dc "
        f"{box.geom.Dc}), {NS_BOX_GREY} sources in {t_box:.3f} s: against "
        f"the flat engine's analytic grey rates max rel "
        f"{max_rel(phi_b, phi_f):.3e} (rtol 2e-7)")
    if any(sweep.launches.values()):
        raise RuntimeError(f"box engine launched kernels {sweep.launches}")
    log("  box engine: none of the five kernels launched (launch counts "
        "all 0; no TPU kernel lies on this path)")
    return dict(t_ray=t_ray, per_batch=per_batch, idle=idle)


def box_stages(rt, nd, xh, pos_b, flux_b, nbatch):
    """Per-batch ms of the box engine's stages over the first ``nbatch``
    batches (CUDA events, a synchronize after each batch: the engine is
    launch-bound, so a stage's time is mostly its host's enqueue)."""
    from pyc2ray_torch.ops.raytrace_cheb import add_boxes, wrap_pad
    from pyc2ray_torch.ops.sweep import s_over_dr3
    g, N = rt.geom, rt.N
    nhi_pad = wrap_pad(nd.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3)),
                       g.c, g.Dc)
    pad = torch.zeros_like(nhi_pad)
    pathdr = rt.tables.path * torch.tensor(DR, dtype=rt.dtype).to("cuda")
    s_dr3 = s_over_dr3(DR, rt.dtype).to("cuda")
    tot = dict.fromkeys(("sheets", "sweep", "rates", "unshear",
                         "accumulate"), 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    for pos, flux in list(zip(pos_b, flux_b))[:nbatch]:
        ev[0].record()
        H = rt._sheets(nhi_pad, pos)
        ev[1].record()
        cdin = rt._sweep(H, pathdr, DR)
        ev[2].record()
        phi, _ = rt._rates(cdin, H, pathdr, flux, s_dr3)
        ev[3].record()
        box = rt._unshear(phi)
        ev[4].record()
        add_boxes(pad, box, pos)
        ev[5].record()
        torch.cuda.synchronize()
        for k, name in enumerate(tot):
            tot[name] += ev[k].elapsed_time(ev[k + 1])
    return {k: v / nbatch for k, v in tot.items()}


def unaligned_box(rt):
    """A copy of box engine ``rt`` on its sheet geometry with the box side
    hi - lo + 1 instead of the next multiple of 8 (the JAX package's
    alignment, which the port keeps for bit-equal tables): the same cells
    in smaller stacks. None where the side is aligned already."""
    import copy
    from pyc2ray_torch.ops.raytrace_box import build_box_tables
    g, N = rt.geom, rt.N
    D = min(N // 2 - 1 + N % 2, g.max_q) + g.c + 1
    if D == g.Dc:
        return None
    cut = {}
    for name, a in g._asdict().items():
        if name == "zidx":
            cut[name] = np.minimum(a[:D, :D], D - 1)
        elif name in ("qidx", "unshear_valid", "k_nonneg"):
            cut[name] = a[:D, :D, :D]
        elif isinstance(a, np.ndarray):
            cut[name] = a[..., :D, :D]
    u = copy.copy(rt)
    u.geom = g._replace(Dc=D, **cut)
    u.tables = rt.tables._replace(**{
        k: torch.from_numpy(np.ascontiguousarray(v)).to(
            "cuda", rt.dtype if v.dtype == np.float64 else None)
        for k, v in build_box_tables(u.geom, N, rt.R_max_LLS).items()})
    return u


def heating_example(engine):
    """examples/heating_test/run_test.py through C2Ray_Test(<its parameters
    as a dict>, 48, device="cuda") with Raytracing.engine ``engine``: six
    timesteps in float64, then that script's five checks, each printed;
    raises if one fails. Returns the simulation, its raytrace iterations,
    the kernel launch counts of the run and its wall time."""
    from pyc2ray_torch import C2Ray_Test
    from pyc2ray_torch.ops import sweep
    Nh, steps = N_HEATING, STEPS_HEATING
    with tempfile.TemporaryDirectory() as tmp:
        params = heating_params(tmp + "/")
        params["Raytracing"]["engine"] = engine
        quiet_log = io.StringIO()
        sweep.reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(quiet_log):
            sim = C2Ray_Test(params, Nh, device="cuda")
            sim.ndens = 1e-3 * np.ones((Nh,) * 3)
            srcpos = np.array([[Nh // 2 + 1]] * 3, dtype=float)
            srcflux = np.array([50.0])
            zreds = sim.generate_redshift_array(2, 2e6)
            dt_h = sim.set_timestep(zreds[0], zreds[1], steps)
            for _ in range(steps):
                sim.evolve3D(dt_h, srcflux, srcpos)
        t_sim = time.time() - t0
    n_iter = quiet_log.getvalue().count("Raytracing took")
    counts = dict(sweep.launches)
    temp_h, xh_h = np.asarray(sim.temp), np.asarray(sim.xh)
    if not (np.all(np.isfinite(temp_h)) and np.all(np.isfinite(xh_h))):
        raise RuntimeError(f"heating example ({engine}): non-finite temp or "
                           f"xh")
    checks, t_prof, x_prof = heating_checks(temp_h, xh_h, Nh)
    log(f"  {engine}: r [cells]: <T> [K], <x>: " + "; ".join(
        f"{a}: {t_prof[a]:.1f}, {x_prof[a]:.3e}"
        for a in range(0, Nh // 2, 3)))
    for name, passed in checks.items():
        log(f"  {name}: {'PASSED' if passed else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"heating example ({engine}): " + ", ".join(
            k for k, v in checks.items() if not v) + " FAILED")
    return sim, n_iter, counts, t_sim


def helium_bench(bins_he, src_pos, chem):
    """Phase 3e: the helium engine at the bench fields in float32 with the
    72 default bins, one trace (K1 three times per batch, counted) and one
    global_pass_he; per-batch device ms of its stages; Gamma_HI of a
    helium-free field against the hydrogen engine at the same bins.
    Returns the K1 launches of the trace."""
    from pyc2ray_torch.ops import chemistry_he, sweep
    from pyc2ray_torch.ops.chemistry_he import (HeChemistryParams,
                                                global_pass_he)
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    from pyc2ray_torch.radiation.spectral_bins import SpectralBins
    N, dt = N_BENCH, torch.float32
    rt = HeRaytracer(N, R_BENCH, bins_he, ABU_HE, batch_size=B_BENCH,
                     dtype=dt)
    pos_b, flux_b = rt.prepare_sources(src_pos, np.ones(NS_BENCH))
    nbatch = pos_b.shape[0]

    def grid(v):
        return torch.full((N,) * 3, v, dtype=dt, device="cuda")
    nd, xh, y1, y2 = grid(1e-3), grid(1.2e-3), grid(1e-3), grid(0.0)
    rt.trace_batches(nd, xh, y1, y2, pos_b[:1], flux_b[:1], DR)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_launches()
    t0 = time.time()
    g = rt.trace_batches(nd, xh, y1, y2, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    t_ray = time.time() - t0
    counts = dict(sweep.launches)
    want = {k: 0 for k in counts}
    want["cheb_sweep"] = 3 * nbatch
    if counts != want:
        raise RuntimeError(f"helium trace: launches {counts}, expected "
                           f"{want}")
    for name, t in zip(("G_HI", "G_HeI", "G_HeII"), g):
        if not (bool(torch.isfinite(t).all()) and float(t.max()) > 0.0):
            raise RuntimeError(f"helium trace: {name} not finite and "
                               f"positive")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    phe = HeChemistryParams(chem=chem, abu_he=ABU_HE)
    dt_d = torch.tensor(DT, dtype=dt).to("cuda")
    temp = grid(1e4)
    t0 = time.time()
    out = global_pass_he(dt_d, nd, temp, xh, xh, y1, y1, y2, y2, *g, phe)
    torch.cuda.synchronize()
    t_chem = time.time() - t0
    if not all(bool(torch.isfinite(t).all()) for t in out[:6]):
        raise RuntimeError("global_pass_he: output not finite")
    # converged within 8 inner iterations: the same outputs with that cap
    cap = chemistry_he.MAX_INNER_ITER
    chemistry_he.MAX_INNER_ITER = 8
    try:
        out8 = global_pass_he(dt_d, nd, temp, xh, xh, y1, y1, y2, y2, *g, phe)
    finally:
        chemistry_he.MAX_INNER_ITER = cap
    within8 = all(torch.equal(a, b) for a, b in zip(out, out8))
    log(f"helium engine N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32 "
        f"{bins_he.num_bins} bins: raytrace {t_ray:.4f} s = "
        f"{1e9 * t_ray / cell_updates(NS_BENCH, R_BENCH):.4f} "
        f"ns/cell-update, K1 launches {counts['cheb_sweep']} (3 x {nbatch} "
        f"batches), peak device memory {peak_gb:.2f} GiB; global_pass_he "
        f"{t_chem:.4f} s, conv_flag {int(out[6])}, converged within 8 "
        f"inner iterations: {within8}")

    # per-batch device ms of each stage, CUDA events, first 16 batches
    eng = rt.eng
    pads = [eng.wrap_pad(f) for f in rt.species_fields(nd, xh, y1, y2)]
    acc = [torch.zeros_like(pads[0]) for _ in range(3)]
    dr_t = torch.tensor(DR, dtype=dt).to("cuda")
    tot = dict(extract=0.0, K1_HI=0.0, K1_HeI=0.0, K1_HeII=0.0,
               rates_he=0.0, accumulate=0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(tot) + 1)]
    nwin = 16
    for pos, flux in list(zip(pos_b, flux_b))[:nwin]:
        ev[0].record()
        boxes = [eng._extract_boxes(p, pos.to("cuda")) for p in pads]
        ev[1].record()
        cds = []
        for s in range(3):
            cds.append(eng.sweep_box(boxes[s], DR, rt.sigma_th[s]))
            ev[2 + s].record()
        rates = rt._rates_he(cds, boxes, flux, dr_t)
        ev[5].record()
        for pad, box in zip(acc, rates):
            eng.add_boxes(pad, box, pos)
        ev[6].record()
        torch.cuda.synchronize()
        for k, name in enumerate(tot):
            tot[name] += ev[k].elapsed_time(ev[k + 1])
    log("  per-batch device ms: " + ", ".join(
        f"{k} {v / nwin:.4f}" for k, v in tot.items()))

    # a helium-free field: Gamma_HI equals the hydrogen engine's at the
    # same bins (the HI row of the helium bins)
    rt0 = HeRaytracer(N, R_BENCH, bins_he, 0.0, batch_size=B_BENCH,
                      dtype=dt)
    zero = grid(0.0)
    g0 = rt0.trace_batches(nd, xh, zero, zero, pos_b[:2], flux_b[:2], DR)
    h_bins = SpectralBins(s=bins_he.s[0], w_photo=bins_he.w_photo,
                          w_heat=bins_he.w_heat[0],
                          num_bins=bins_he.num_bins)
    rth = ChebRaytracer(N, R_BENCH, rt.sigma_th[0], h_bins,
                        batch_size=B_BENCH, dtype=dt)
    phi_h, _ = rth.trace_batches(nd, xh, pos_b[:2], flux_b[:2], DR)
    compare("helium engine Gamma_HI without helium vs the hydrogen engine "
            "(16 sources)", g0[0].reshape(-1), phi_h, 1e-4, 1e-6)
    if float(g0[1].abs().max()) != 0.0 or float(g0[2].abs().max()) != 0.0:
        raise RuntimeError("helium-free field: helium rates not zero")
    return counts["cheb_sweep"]


def helium_evolve(e_pos, e_flux, e_nd, bins_he, chem):
    """Phase 4g: one evolve3D_he timestep at N=64 with 16 sources, float64,
    secondary ionizations and recombination photons on, GPU against CPU;
    then C2Ray_Test with engine he and the heating channel on for two
    timesteps at N=128 on the card. Returns its K1 launches and the state
    after its first timestep (xh, xhe1, xhe2, temp) with its raytrace
    iterations."""
    from pyc2ray_torch import C2Ray_Test
    from pyc2ray_torch.evolve import evolve3D_he
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.chemistry_he import HeChemistryParams
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    from pyc2ray_torch.utils.paramutils import read_paramfile
    Ne = e_nd.shape[0]
    phe = HeChemistryParams(chem=chem, abu_he=ABU_HE, secondary=True,
                            recombination_photons=True)
    grid0 = (np.full((Ne,) * 3, 1e4), e_nd, np.full((Ne,) * 3, 1.2e-3),
             np.full((Ne,) * 3, 1e-3), np.zeros((Ne,) * 3))
    out = {}
    for devname in ("cuda", "cpu"):
        rte = HeRaytracer(Ne, R_EVOLVE, bins_he, ABU_HE, batch_size=B_BENCH,
                          dtype=torch.float64, device=devname,
                          do_heating=True)
        sweep.reset_launches()
        t0 = time.time()
        out[devname] = evolve3D_he(DT, DR, e_flux, e_pos, rte, phe, *grid0,
                                   quiet=True)
        log(f"evolve3D_he N={Ne} R={R_EVOLVE} {len(e_flux)} sources float64 "
            f"(secondary ionizations, recombination photons) on {devname}: "
            f"{time.time() - t0:.2f} s, K1 launches "
            f"{sweep.launches['cheb_sweep']}")
        if (sweep.launches["cheb_sweep"] > 0) != (devname == "cuda"):
            raise RuntimeError(f"evolve3D_he on {devname}: K1 launches "
                               f"{sweep.launches['cheb_sweep']}")
    names = ("xh", "G_HI", "y1", "y2", "G_HeI", "G_HeII")
    for name, g, c in zip(names, out["cuda"], out["cpu"]):
        if g.shape != (Ne,) * 3 or not np.all(np.isfinite(g)):
            raise RuntimeError(f"evolve3D_he: {name} not finite")
        np.testing.assert_allclose(g, c, rtol=1e-7, atol=0, err_msg=name)
    log("  evolve3D_he GPU vs CPU, max rel: " + ", ".join(
        f"{n} {max_rel(torch.from_numpy(g), torch.from_numpy(c)):.3e}"
        for n, g, c in zip(names, out["cuda"], out["cpu"])))

    N = N_GOLDEN
    params = read_paramfile(os.path.join(GOLDEN_DIR, "parameters.yml"))
    params["Raytracing"]["engine"] = "he"
    params["Photo"]["compute_heating_rates"] = 1
    params["Material"]["isothermal"] = False
    with tempfile.TemporaryDirectory() as tmp:
        params["Output"]["results_basename"] = tmp + "/"
        text = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(text):
            sim = C2Ray_Test(params, N, device="cuda")
            sim.ndens = 1e-3 * np.ones((N,) * 3)
            zreds = sim.generate_redshift_array(2, 1e7)
            dt = sim.set_timestep(zreds[0], zreds[1], STEPS_GOLDEN)
            srcpos = np.array([[3 * N // 4], [3 * N // 4], [N // 2]],
                              dtype=float)
            steps = []
            sweep.reset_launches()
            for n in range(2):
                mark = len(text.getvalue())
                sim.cosmo_evolve(dt)
                sim.evolve3D(dt, np.array([10.0]), srcpos)
                steps.append(text.getvalue()[mark:])
                if n == 0:
                    # phase 5d's single-rank reference
                    first = {k: np.array(getattr(sim, k))
                             for k in HE_STATE}
            torch.cuda.synchronize()
        t_sim = time.time() - t0
    k1 = sweep.launches["cheb_sweep"]
    iters = [s.count("Raytracing (3 species) took") for s in steps]
    loss = [[float(v) for v in re.findall(
        r"photon loss fraction: ([-+\d.e]+)", s)] for s in steps]
    g = sim.raytracer.geom
    log(f"C2Ray_Test engine he N={N} float64 (heating, non-isothermal, "
        f"{sim.raytracer.bins.num_bins} bins, Dc={g.Dc}, B=1): 2 timesteps "
        f"in {t_sim:.2f} s with set-up; raytrace iterations {iters}, K1 "
        f"launches {k1}; photon loss at convergence "
        + ", ".join(f"{ls[-1]:.3e}" for ls in loss)
        + f" (bound loss_fraction {sim.loss_fraction:g}); T "
        f"{sim.temp.min():.1f}..{sim.temp.max():.1f} K, xh max "
        f"{sim.xh.max():.4f}, xHeII+xHeIII max "
        f"{(sim.xhe1 + sim.xhe2).max():.4f}")
    if k1 != 3 * sum(iters) or min(iters) == 0:
        raise RuntimeError(f"helium model: {k1} K1 launches for {iters} "
                           f"iterations")
    # the first timestep's loss is the resolution's: in the flat engine at
    # this configuration it halves with every doubling of N (9.2%, 5.0%,
    # 2.1% at N = 16, 32, 64); the converged second timestep's is held
    if loss[-1][-1] > sim.loss_fraction:
        raise RuntimeError("helium model: photon loss of the second timestep "
                           "above loss_fraction")
    for name in ("xh", "xhe1", "xhe2", "temp"):
        a = np.asarray(getattr(sim, name))
        if a.shape != (N,) * 3 or not np.all(np.isfinite(a)):
            raise RuntimeError(f"helium model: {name} not finite")
    if not (sim.xh.max() > 10 * 1.2e-3 and sim.temp.std() > 0.0):
        raise RuntimeError("helium model: the source ionized or heated "
                           "nothing")
    first["iterations"] = iters[0]
    return k1, first


# ---- phase 5: the port's multi-GPU paths as a world of ranks ---------------

HE_STATE = ("xh", "xhe1", "xhe2", "temp")
P5_RANKS = 2


def _p5_bins(wd):
    from pyc2ray_torch.radiation.spectral_bins import SpectralBins
    with np.load(os.path.join(wd, "bins.npz")) as f:
        return SpectralBins(s=f["s"], w_photo=f["w_photo"],
                            w_heat=f["w_heat"], num_bins=int(f["num_bins"]))


def _p5_traffic(mesh, n_iter):
    """ms in collectives and bytes sent per iteration, by kind; the domain
    path's gather of the outputs ("output") once per timestep."""
    return {k: dict(ms=1e3 * v["seconds"] / n, bytes=v["bytes"] / n)
            for k, v in mesh.traffic.items()
            for n in [1 if k == "output" else max(n_iter, 1)]}


def p5_bench_trace(mesh, wd):
    """5a: the bench configuration (fuse_fold: K3) through trace_sharded;
    rank 0 saves Gamma."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    from pyc2ray_torch.parallel import trace_sharded
    N = N_BENCH
    rt = ChebRaytracer(N, R_BENCH, SIG, _p5_bins(wd), batch_size=B_BENCH,
                       dtype=torch.float32, device=mesh.device,
                       fuse_fold=True)
    rng = np.random.RandomState(100)
    src_pos = rng.randint(0, N, size=(NS_BENCH, 3))
    src_flux = np.ones(NS_BENCH)
    nd = torch.full((N,) * 3, 1e-3, dtype=torch.float32, device=mesh.device)
    xh = torch.full((N,) * 3, 1.2e-3, dtype=torch.float32,
                    device=mesh.device)
    trace_sharded(rt, mesh, nd, xh, src_pos, src_flux, DR)     # warm-up
    torch.cuda.synchronize()
    sweep.reset_launches()
    mesh.reset_traffic()
    t0 = time.time()
    phi = trace_sharded(rt, mesh, nd, xh, src_pos, src_flux, DR)
    torch.cuda.synchronize()
    t = time.time() - t0
    launches = dict(sweep.launches)
    if mesh.rank == 0:
        np.save(os.path.join(wd, "5a_phi.npy"), phi.cpu().numpy())
    return dict(seconds=t, launches=launches,
                traffic=_p5_traffic(mesh, 1))


def p5_eor(mesh, wd, label):
    """5b / 5c: examples/eor_simulation's first slice with one timestep
    through C2Ray_CubeP3M(mesh=); rank 0 saves xh. Then one trace of the
    rank's share of the catalog under torch.profiler."""
    from pyc2ray_torch import C2Ray_CubeP3M
    from pyc2ray_torch.diagnostics import (device_idle_share,
                                           device_op_times, profile_trace)
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.parallel import prepare_sources_sharded
    from pyc2ray_torch.utils import format_sources
    from pyc2ray_torch.utils.paramutils import read_paramfile
    rank = mesh.rank
    params = read_paramfile(os.path.join(EOR_DIR, "parameters.yml"))
    results = os.path.join(wd, f"{label}_r{rank}") + "/"
    os.makedirs(results)
    params["Output"]["results_basename"] = results
    params["Output"]["inputs_basename"] = \
        os.path.join(EOR_DIR, "inputs") + "/"
    zi, zf = EOR_ZLIST[0], EOR_ZLIST[1]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        sim = C2Ray_CubeP3M(params, N_EOR, mesh=mesh)
        sim.read_density(zi)
        srcpos, flux = read_catalog(sim, os.path.join(
            EOR_DIR, "inputs", "sources", f"{zi:.3f}-sources.hdf5"))
        dt = sim.set_timestep(zi, zf, 1)
        sim.cosmo_evolve(dt)
        torch.cuda.synchronize()
        sweep.reset_launches()
        mesh.reset_traffic()
        t0 = time.time()
        sim.evolve3D(dt, flux, srcpos)
        torch.cuda.synchronize()
        t_step = time.time() - t0
        launches = dict(sweep.launches)
        n_iter = mesh.traffic["scalars"]["calls"]
        traffic = _p5_traffic(mesh, n_iter)
        sim.write_output(zf)
    log_text = text.getvalue()
    if rank == 0:
        np.save(os.path.join(wd, f"{label}_xh.npy"), np.asarray(sim.xh))
    # one trace of this rank's share under the profiler (the domain path's
    # includes its halo exchange)
    rt = sim.raytracer
    pos, fl = format_sources(srcpos, flux)
    nd = torch.as_tensor(sim.ndens, dtype=rt.dtype, device=rt.device)
    xh = torch.as_tensor(sim.xh, dtype=rt.dtype, device=rt.device)
    avg = float(nd.mean())
    if label == "source":
        nd, xh = nd.reshape(-1), xh.reshape(-1)
        pos_b, flux_b = prepare_sources_sharded(rt, mesh, pos, fl,
                                                dr=sim.dr, avg_dens=avg)

        def trace():
            return rt.shard_trace(nd, xh, pos_b, flux_b, sim.dr)[0]
    else:
        dd = sim._decomposition()
        srcs = dd.prepare_sources(pos, fl, dr=sim.dr, avg_dens=avg)
        nd_b, xh_b = dd.local_block(nd, 1.0), dd.local_block(xh, 0.5)

        def trace():
            return dd._trace_shard(nd_b, xh_b, srcs, sim.dr)[0]
    trace()
    torch.cuda.synchronize()
    t0 = time.time()
    trace()
    torch.cuda.synchronize()
    t_plain = time.time() - t0
    prof = os.path.join(wd, f"{label}_profile_r{rank}")
    with profile_trace(prof) as p:
        p["sync"] = trace()
    busy = sum(device_op_times(prof).values())
    return dict(iterations=n_iter, t_step=t_step, launches=launches,
                traffic=traffic,
                t_iter=[float(v) for v in re.findall(
                    r"Iteration \d+ took ([\d.]+) s", log_text)],
                loss=[float(v) for v in re.findall(
                    r"photon loss fraction: ([-+\d.e]+)", log_text)],
                converged="Multiple source convergence reached." in log_text,
                files=sorted(os.listdir(results)),
                idle=device_idle_share(prof),
                idle_unprofiled=1.0 - 1e-3 * busy / t_plain,
                t_rank_trace=t_plain, loss_fraction=sim.loss_fraction)


def p5_helium(mesh, wd, label):
    """5d: C2Ray_Test with engine he, the heating rates and isothermal
    false at N=128 for one timestep (phase 4g's first); rank 0 saves the
    state."""
    from pyc2ray_torch import C2Ray_Test
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.utils.paramutils import read_paramfile
    N = N_GOLDEN
    params = read_paramfile(os.path.join(GOLDEN_DIR, "parameters.yml"))
    params["Raytracing"]["engine"] = "he"
    params["Photo"]["compute_heating_rates"] = 1
    params["Material"]["isothermal"] = False
    results = os.path.join(wd, f"he_{label}_r{mesh.rank}") + "/"
    os.makedirs(results)
    params["Output"]["results_basename"] = results
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        sim = C2Ray_Test(params, N, mesh=mesh)
        sim.ndens = 1e-3 * np.ones((N,) * 3)
        zreds = sim.generate_redshift_array(2, 1e7)
        dt = sim.set_timestep(zreds[0], zreds[1], STEPS_GOLDEN)
        srcpos = np.array([[3 * N // 4], [3 * N // 4], [N // 2]],
                          dtype=float)
        torch.cuda.synchronize()
        sweep.reset_launches()
        mesh.reset_traffic()
        t0 = time.time()
        sim.cosmo_evolve(dt)
        sim.evolve3D(dt, np.array([10.0]), srcpos)
        torch.cuda.synchronize()
        t_step = time.time() - t0
    if mesh.rank == 0:
        np.savez(os.path.join(wd, f"he_{label}.npz"),
                 **{k: np.asarray(getattr(sim, k)) for k in HE_STATE})
    n_iter = mesh.traffic["scalars"]["calls"]
    return dict(iterations=n_iter, t_step=t_step,
                launches=dict(sweep.launches),
                traffic=_p5_traffic(mesh, n_iter))


def phase5_rank(rank, n_ranks, init, backend, wd):
    """One rank of phase 5's world: 5a-5d in order; the numbers go to
    rank<r>.json, the fields of rank 0 to .npy / .npz files."""
    import torch.distributed as dist
    from pyc2ray_torch.parallel import make_domain_mesh, make_mesh, multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // n_ranks))
    # gloo's ranks share cuda:0, nccl's have a card each
    multihost.initialize(init_method="file://" + init, world_size=n_ranks,
                         rank=rank, backend=backend,
                         local_rank=rank if backend == "nccl" else 0,
                         timeout_s=300)
    smesh = make_mesh()
    dmesh = make_domain_mesh(n_ranks, 1, 1)
    res = {"device": str(smesh.device), "backend": smesh.backend}
    res["5a"] = p5_bench_trace(smesh, wd)
    res["5b"] = p5_eor(smesh, wd, "source")
    res["5c"] = p5_eor(dmesh, wd, "domain")
    res["5d_source"] = p5_helium(smesh, wd, "source")
    res["5d_domain"] = p5_helium(dmesh, wd, "domain")
    with open(os.path.join(wd, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def multi_rank(bins, smi, refs):
    """Phase 5: a world of P5_RANKS ranks on the one card over gloo (and,
    with two or more cards, one rank per card over nccl) runs 5a-5d; each
    held against its single-rank phase (``refs``: see run_world). Returns
    the K3 launches of each rank of the gloo world's 5b."""
    torch.cuda.empty_cache()
    k3_5b = run_world("gloo", bins, smi, refs)
    if torch.cuda.device_count() >= P5_RANKS:
        run_world("nccl", bins, smi, refs)
    else:
        log(f"phase 5 nccl branch (one rank per card): not run, the machine "
            f"has {torch.cuda.device_count()} card (NCCL refuses two ranks "
            f"on one device)")
    return k3_5b


def run_world(backend, bins, smi, refs):
    """5a-5d on a spawned world of P5_RANKS ranks: over gloo all on
    cuda:0, over nccl one per card. ``refs``: 3b's single-rank K3 Gamma
    ("k3_phi") and phase 3's ("phi3"), 4e's first slice ("eor") and 4g's
    first timestep ("he"). Returns each rank's K3 launches in 5b."""
    import torch.multiprocessing as mp
    where = ("one rank per card" if backend == "nccl"
             else f"{P5_RANKS} ranks sharing cuda:0")
    with tempfile.TemporaryDirectory() as wd:
        np.savez(os.path.join(wd, "bins.npz"), s=bins.s,
                 w_photo=bins.w_photo, w_heat=bins.w_heat,
                 num_bins=bins.num_bins)
        t0 = time.time()
        mp.spawn(phase5_rank, args=(P5_RANKS, os.path.join(
            wd, "rendezvous"), backend, wd), nprocs=P5_RANKS, join=True)
        t_world = time.time() - t0
        ranks = []
        for r in range(P5_RANKS):
            with open(os.path.join(wd, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        tag = f"[{backend}, {where}; {smi}]"
        log(f"phase 5 {tag}: the world ran 5a-5d in {t_world:.1f} s "
            f"(spawn included); rank devices "
            f"{[r['device'] for r in ranks]}")
        p5_check_trace(wd, ranks, tag, refs["k3_phi"], refs["phi3"])
        for label, sub in (("source", "5b"), ("domain", "5c")):
            p5_check_eor(wd, ranks, tag, label, sub, refs["eor"])
        for label in ("source", "domain"):
            p5_check_helium(wd, ranks, tag, label, refs["he"])
    return [r["5b"]["launches"]["cheb_sweep_rates"] for r in ranks]


def nccl_branch(smi):
    """``--nccl``: phase 5's world with one rank per card over nccl, alone,
    after the single-rank references it is held against: the bench trace
    by K3 (3b) and by the default mode (3), the EoR run (4e) and the helium
    model (4g)."""
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    if torch.cuda.device_count() < P5_RANKS:
        raise RuntimeError(f"--nccl needs {P5_RANKS} cards; the machine has "
                           f"{torch.cuda.device_count()}")
    bins = make_bins()
    N = N_BENCH
    rng = np.random.RandomState(100)
    src_pos = rng.randint(0, N, size=(NS_BENCH, 3))
    nd = torch.full((N ** 3,), 1e-3, dtype=torch.float32, device="cuda")
    xh = torch.full((N ** 3,), 1.2e-3, dtype=torch.float32, device="cuda")
    phi = {}
    for fold in (False, True):
        rt = ChebRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH,
                           dtype=torch.float32, fuse_fold=fold)
        pos_b, flux_b = rt.prepare_sources(src_pos, np.ones(NS_BENCH))
        phi[fold] = rt.trace_batches(nd, xh, pos_b, flux_b, DR)[0].cpu()
        del rt
    eor_first = eor_run(bins)[2]
    # phase 4's fields, which 4g's first part takes
    rng = np.random.RandomState(7)
    e_pos = rng.randint(0, N_EVOLVE, size=(NS_EVOLVE, 3))
    e_flux = rng.uniform(0.5, 2.0, NS_EVOLVE)
    e_nd = 10 ** rng.uniform(-3.5, -2.5, (N_EVOLVE,) * 3)
    he_first = helium_evolve(e_pos, e_flux, e_nd, he_bins(), chem_params())[1]
    torch.cuda.empty_cache()
    run_world("nccl", bins, smi, dict(k3_phi=phi[True], phi3=phi[False],
                                      eor=eor_first, he=he_first))


def _ms(traffic):
    return ", ".join(f"{k} {v['ms']:.2f} ms / {v['bytes'] / 2 ** 20:.2f} MiB"
                     + (" (once per timestep)" if k == "output" else "")
                     for k, v in sorted(traffic.items()))


def p5_check_trace(wd, ranks, tag, k3_phi, phi3):
    phi = torch.from_numpy(np.load(os.path.join(wd, "5a_phi.npy")))
    phi = phi.reshape(-1)
    err = max_rel(phi, k3_phi, 1e-6)
    err3 = max_rel(phi, phi3, 1e-6)
    updates = cell_updates(NS_BENCH, R_BENCH)
    for r, res in enumerate(ranks):
        a = res["5a"]
        k3 = a["launches"]["cheb_sweep_rates"]
        log(f"5a {tag} rank {r}: trace_sharded N={N_BENCH} R={R_BENCH} "
            f"Ns={NS_BENCH} B={B_BENCH} float32 fuse_fold: "
            f"{a['seconds']:.4f} s = "
            f"{1e9 * a['seconds'] / updates:.4f} ns/cell-update, K3 "
            f"launches {k3}; collectives {_ms(a['traffic'])}")
        if k3 != NS_BENCH // B_BENCH // P5_RANKS or any(
                v for k, v in a["launches"].items()
                if k != "cheb_sweep_rates"):
            raise RuntimeError(f"5a rank {r}: launches {a['launches']}")
    log(f"5a {tag}: Gamma against phase 3b's single-rank K3 Gamma: max "
        f"rel {err:.3e} above 1e-6 of the peak (bound 1e-5); against "
        f"phase 3's unfused Gamma {err3:.3e}")
    if not (err <= 1e-5 and err3 <= 1e-4):
        raise RuntimeError("5a: the sharded Gamma differs from the "
                           "single-rank Gamma")


def p5_check_eor(wd, ranks, tag, label, sub, first):
    xh = np.load(os.path.join(wd, f"{label}_xh.npy"))
    res = [r[sub] for r in ranks]
    r0 = res[0]
    d_xh = float(np.max(np.abs(xh - first["xh"])))
    loss = r0["loss"][-1]
    n_it = r0["iterations"]
    t_it = np.mean(r0["t_iter"]) if r0["t_iter"] else float("nan")
    log(f"{sub} {tag} EoR slice {EOR_ZLIST[0]} -> {EOR_ZLIST[1]} under the "
        f"{label} mesh: {n_it} raytrace iterations (4e: "
        f"{first['iterations']}), {r0['t_step']:.2f} s per timestep (4e: "
        f"{first['t_step']:.2f}), {t_it:.3f} s per iteration (4e raytrace "
        f"{first['t_ray']:.3f}); photon loss {loss:.3e} (4e "
        f"{first['loss']:.3e}, bound {r0['loss_fraction']:g}); xh against "
        f"4e max abs {d_xh:.3e} (bound 1e-5); converged {r0['converged']}")
    for r, rr in enumerate(res):
        log(f"  {sub} rank {r}: K3 launches "
            f"{rr['launches']['cheb_sweep_rates']}, collectives per "
            f"iteration {_ms(rr['traffic'])}; device idle share of the "
            f"rank's trace {rr['idle']:.4f} profiled, "
            f"{rr['idle_unprofiled']:.4f} unprofiled "
            f"({rr['t_rank_trace']:.3f} s); output files "
            f"{len(rr['files'])}")
        if rr["launches"]["cheb_sweep_rates"] == 0:
            raise RuntimeError(f"{sub} rank {r}: K3 never launched")
        if (len(rr["files"]) > 0) != (r == 0):
            raise RuntimeError(f"{sub} rank {r}: output files {rr['files']}")
    if label == "domain":
        halo = res[0]["traffic"].get("halo", {}).get("bytes", 0)
        log(f"  {sub}: halo exchange {halo / 2 ** 20:.3f} MiB sent per "
            f"iteration per rank")
    if not (abs(n_it - first["iterations"]) <= 1 and d_xh <= 1e-5
            and loss <= r0["loss_fraction"] and r0["converged"]):
        raise RuntimeError(f"{sub}: the {label} mesh's timestep differs "
                           f"from 4e's")


def p5_check_helium(wd, ranks, tag, label, first):
    with np.load(os.path.join(wd, f"he_{label}.npz")) as f:
        got = {k: f[k] for k in f.files}
    res = [r[f"5d_{label}"] for r in ranks]
    errs = {k: max_rel(torch.from_numpy(got[k]), torch.from_numpy(first[k]))
            for k in HE_STATE}
    log(f"5d {tag} helium model N={N_GOLDEN} float64 (heating, "
        f"non-isothermal), one timestep under the {label} mesh: "
        f"{res[0]['iterations']} iterations (4g: {first['iterations']}), "
        f"{res[0]['t_step']:.2f} s; max rel against 4g: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; K1 launches per rank "
        + str([rr["launches"]["cheb_sweep"] for rr in res]))
    bounds = dict(xh=1e-10, xhe1=1e-9, xhe2=1e-9, temp=1e-10)
    if any(errs[k] > bounds[k] for k in HE_STATE) or any(
            rr["launches"]["cheb_sweep"] == 0 for rr in res):
        raise RuntimeError(f"5d: the {label} mesh's helium timestep "
                           f"differs from 4g's")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    from pyc2ray_torch.evolve import evolve3D
    from pyc2ray_torch.ops import _build, sweep
    from pyc2ray_torch.ops.thermal import ThermalParams, update_temperature
    from pyc2ray_torch.ops.chemistry import MAX_INNER_ITER, global_pass
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
    if "--nccl" in sys.argv[1:]:
        nccl_branch(smi)
        log(f"chip_smoke --nccl wall time: {time.time() - T_START:.1f} s")
        return 0
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
    # K3 at the shapes of the adaptive paths (4d, 4e): many small boxes
    k_eor = check_fused(N_EOR, R_EOR[0], B_EOR, torch.float32, rtol=1e-4,
                        floor=1e-6, seed=9, reps=20, bins=bins,
                        names=("K3",))["K3"]
    check_fused(N_EOR, R_EOR[1], B_EOR, torch.float32, rtol=1e-4,
                floor=1e-6, seed=9, reps=10, bins=bins, names=("K3",))
    for r in (7.5, 15.0):
        check_fused(N_BENCH, r, B_ADAPT, torch.float32, rtol=1e-4,
                    floor=1e-6, seed=10, reps=10, bins=bins, names=("K3",))

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
                      ("K3h", k_heat), ("K3 EoR shape", k_eor)):
        res["rate_floor_ms"] = 1e-6 * res.pop("n_rated") * bins.num_bins \
            * ns_bin
        log(f"rate floor {name}: {res['rate_floor_ms']:.5f} ms "
            f"({ns_bin:.6f} ns per cell and bin), measured "
            f"{res['ms']:.4f} ms")

    # ---- 2d. K1 at the helium engine's three cross sections -------------
    bins_he = he_bins()
    k_he = check_sweep_he(bins_he, reps=20)
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
    # the inner loop's iterations per cell on this field, with doric and
    # with the reference's float32 time average (which cancels)
    for form, fn in (("doric", None), ("the reference's float32 time "
                                       "average", doric_reference_form)):
        t0 = time.time()
        its, _ = inner_iterations(dt_d, ndens, temp, xh, phi, chem, fn)
        torch.cuda.synchronize()
        log(f"bench chemistry, {form}: inner iterations up to "
            f"{int(its.max())}, mean {float(its.double().mean()):.3f}, cells "
            f"at the cap of {MAX_INNER_ITER} "
            f"{int((its == MAX_INNER_ITER).sum())}; "
            f"{time.time() - t0:.4f} s")
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
    updates = cell_updates(NS_BENCH, R_BENCH)
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
    phi_cpu = phi.cpu()                 # phase 5a prints its distance
    log(f"main path, 16 sources: GPU vs CPU max abs diff "
        f"{float((phi_g - phi_c).abs().max()):.3e} (floor {floor:.3e})")

    # ---- 3b. the other sweep modes at full width --------------------------
    fused_launches = {}
    for mode, kname in (("fuse_fold", "cheb_sweep_rates"),
                        ("fuse_rates", "cheb_sweep_fused_rates")):
        rtf = ChebRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH,
                            dtype=dt, **{mode: True})
        phi_f, _, counts = run_path(
            rtf, ndens, xh, pos_b, flux_b, cell_updates(NS_BENCH, R_BENCH),
            {kname: nbatch},
            f"{mode} N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32",
            chem)
        fused_launches[kname] = counts[kname]
        # the unfused path rebuilds cdin = cd - dcol in float32, which
        # cancels where dcol >> cdin: compare above a floor at the peak
        compare(f"{mode} Gamma vs the unfused Gamma", phi_f, phi, 1e-4,
                1e-6)
        if mode == "fuse_fold":
            k3_phi = phi_f.cpu()        # phase 5a's single-rank reference
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
            rth, h_nd, h_xh, hp, hf, cell_updates(NS_R100, R_R100), expect,
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
            rth, ndens, xh, pos_b, flux_b, cell_updates(NS_BENCH, R_BENCH),
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

    # ---- 3d. the table-exact flat engine at the bench configuration -------
    with tempfile.TemporaryDirectory() as tmp:
        flat_bench(src_pos, tmp)

    # ---- 3e. the helium engine at full width ------------------------------
    he_launches = helium_bench(bins_he, src_pos, chem)

    # ---- 3f. the octahedral sheet engine at the bench configuration -------
    with tempfile.TemporaryDirectory() as tmp:
        box_bench(src_pos, bins, tmp)

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
    bisect_gap(bins, chem, thermal, e_pos, e_flux, e_nd, e_xh)

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
    sim, n_iter, counts, t_sim = heating_example("cheb")
    n_k3h = counts.pop("cheb_sweep_rates_heat")
    g_h = sim.raytracer.geom
    log(f"C2Ray_Test heating example N={N_HEATING} (float64, engine cheb, "
        f"fuse_fold, Dc={g_h.Dc}, R1={g_h.r_max + 1}, "
        f"{sim.raytracer.num_bins} bins): {STEPS_HEATING} timesteps, "
        f"{n_iter} raytrace iterations, {t_sim:.2f} s with set-up, K3h "
        f"launches {n_k3h}")
    if n_k3h == 0 or n_k3h != n_iter or any(counts.values()):
        raise RuntimeError(f"heating example: {n_k3h} K3h launches for "
                           f"{n_iter} single-source iterations, other "
                           f"kernels {counts}")
    heat_4c = (np.asarray(sim.xh), np.asarray(sim.temp))

    # ---- 4d. the adaptive engine at the bench mix ------------------------
    adaptive_bench(bins)

    # ---- 4e. the production EoR run on the committed inputs --------------
    eor_launches, eor_device_ms, eor_first = eor_run(bins)
    k_eor.update(ms=eor_device_ms, ms_back_to_back=k_eor["ms"])

    # ---- 4f. the golden: examples/single_source_test at N=128 -------------
    with tempfile.TemporaryDirectory() as tmp:
        sim, stats, t_port, t_oracle = golden_run(
            N_GOLDEN, 2, STEPS_GOLDEN, "cuda", tmp + "/")
    rt_g = sim.raytracer
    log(f"golden examples/single_source_test N={N_GOLDEN}, 2 slices x "
        f"{STEPS_GOLDEN} timesteps, engine {type(rt_g).__name__} on "
        f"{rt_g.device} ({rt_g.config.dtype}, q_max "
        f"{rt_g.geom_np.max_q}): the port {t_port:.2f} s, the C++ oracle "
        f"{t_oracle:.2f} s; mean xh {float(np.mean(sim.xh)):.12e}")
    failed = []
    for name, (value, tol) in stats.items():
        ok = bool(np.isfinite(value)) and abs(value) <= tol
        log(f"  {name:16s}: {value: .7e}   (tolerance {tol:g}) "
            f"{'PASSED' if ok else 'FAILED'}")
        failed += [] if ok else [name]
    if failed or type(rt_g).__name__ != "Raytracer" \
            or rt_g.device.type != "cuda":
        raise RuntimeError(f"golden: {', '.join(failed) or 'engine'} FAILED")

    # ---- 4g. helium end to end ---------------------------------------------
    _, he_first = helium_evolve(e_pos, e_flux, e_nd, bins_he, chem)

    # ---- 4h. the heating example on the octahedral sheet engine -----------
    sim, n_iter, counts, t_sim = heating_example("box")
    g_b = sim.raytracer.geom
    log(f"C2Ray_Test heating example N={N_HEATING} (float64, engine box, "
        f"Q={g_b.Q}, Dc={g_b.Dc}, {sim.raytracer.num_bins} bins): "
        f"{STEPS_HEATING} timesteps, {n_iter} raytrace iterations, "
        f"{t_sim:.2f} s with set-up; kernel launches {counts}")
    if type(sim.raytracer).__name__ != "BoxRaytracer" \
            or any(counts.values()):
        raise RuntimeError(f"heating example (box): engine "
                           f"{type(sim.raytracer).__name__}, launches "
                           f"{counts}")
    for name, got, want in (("xh", sim.xh, heat_4c[0]),
                            ("T", sim.temp, heat_4c[1])):
        got = np.asarray(got)
        log(f"  box against 4c's cheb run: {name} max rel "
            f"{np.max(np.abs(got - want) / np.abs(want)):.3e}, mean "
            f"{got.mean():.6e} against {want.mean():.6e}")

    # ---- 5. the multi-GPU paths: a world of ranks ----------------------
    del sim
    k3_5b = multi_rank(bins, smi, dict(k3_phi=k3_phi, phi3=phi_cpu,
                                       eor=eor_first, he=he_first))

    # ---- 6. kernels line and result -----------------------------------
    # launches: each kernel's count over its own path's run (phases 3 and
    # 3e for K1: the hydrogen and the helium trace at the bench shape, 3b
    # for K1f and K2, 3c for K3h, 4e for K3: the EoR run's timesteps);
    # the other numbers from phases 2, 2b and 2c at that path's shapes (K3:
    # the EoR run's small bucket, B=16, Dc=24, where back-to-back calls are
    # bounded by the host's enqueue: its ms is the device time per call in
    # 4e's profiled trace, ms_back_to_back the CUDA-event time). No single
    # PyTorch call computes any of them.
    src = "pyc2ray_torch/ops/csrc/"
    tpu = "pyc2ray_tpu/ops/pallas_sweep.py:"
    kernels = [
        dict(name="cheb_sweep", source=src + "cheb_sweep.cu",
             replaces=tpu + "353", launches=launches + he_launches,
             ms_at_sigma_he={k: v["ms"] for k, v in k_he.items()},
             plain_ms_at_sigma_he={k: v["plain_ms"]
                                   for k, v in k_he.items()},
             **k_bench),
        dict(name="cheb_sweep_fused_rates", source=src + "cheb_sweep.cu",
             replaces=tpu + "325",
             launches=fused_launches["cheb_sweep_fused_rates"],
             **k_fused["K1f"]),
        dict(name="cheb_sweep_seg", source=src + "cheb_sweep.cu",
             replaces=tpu + "455", launches=seg_launches, **k_seg),
        dict(name="cheb_sweep_rates", source=src + "cheb_sweep_rates.cu",
             replaces=tpu + "669", launches=eor_launches,
             launches_per_rank_5b=k3_5b, **k_eor),
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
