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
2e. (after 2c) The dense rate pass of the unfused modes (rates_dense,
   ops/cheb_rates.py) on the engine's own sweep boxes against its plain
   version, with and without the heat channel, bit for bit (max_abs_err
   0): at the bench shape and the R=100 shape in float32 with kernel,
   plain and bound ms and the rate floor, and in float64 at a small
   clipped shape (segmented, S=3) and a small shape that rates a subbox,
   each with a zero-density cell; where the engine segments, the start of
   a segmented sweep (init_segments) the same way.
3. The full-width main path: ChebRaytracer.trace_batches + global_pass at
   N=256, R=30, Ns=2048, B=8, compressed black-body bins, float32 (the
   configuration of bench.py, positions from seed 100). The trace is one
   call of the C++ loop (cheb_trace_sweep). Prints ns per cell-update, the
   chemistry time, the combined Mcell-updates/s and the launch counts: one
   loop, and K1, the rate pass, the box extract and the accumulate once per
   batch (asserted); the per-batch device ms of the loop's stages, the
   kernels beside the plain gather, rate pass and slice adds they replaced
   (bit-equal); the loop against trace_extended_plain on the trace's frame
   (bit-equal, ms per trace, the bound: the kernels line's numbers), one
   profiled trace of the loop with each kernel's median device us and the
   idle gap before it (``loop_kernel_gaps``: extract, K1, rates_dense,
   accumulate), and the whole trace before and after the loop as in 3b. The GPU trace of the
   first 16 sources is held against the CPU (plain) trace. The chemistry
   pass is one launch of the hydrogen kernel (asserted; the chemistry
   checks below on its fields).
3b. The engine's other sweep modes at full width: the bench configuration
   with fuse_fold=True (K3) and with fuse_rates=True (K1f), each Gamma
   held against phase 3's; the R=100 harness configuration (N=250, R=100,
   B=8, Ns=100 from seed 100, compressed bins, float32) auto-segmented
   (K2) and with shell_segment=0 (K1), held against each other. Every
   trace is one call of the C++ trace loop (cheb_trace_sweep, every sweep
   mode). Each run prints ns per cell-update,
   its launch counts, which are asserted, and for the fused modes the
   per-batch stage times (one kernel call per batch and nothing after it
   but the accumulate). Each trace also with the batch loop as it was
   issued before (``plain_loop``: trace_extended_plain, the plain rate
   pass), Gamma bit-equal: per trace the wall s, device launches and
   host-to-device copies per batch, device busy ms and idle share, before
   and after.
3c. The non-isothermal path at full width: the bench configuration with
   do_heating=True and fuse_fold=True (K3h, one launch per batch) and with
   do_heating=True alone (K1 + the rate pass with the heat channel, one
   cheb_trace_sweep call, before and after the loop as in 3b with Gamma
   and heat bit-equal); each Gamma held against phase 3's, the two heat
   fields against each other, the per-batch stage times of both; then
   update_temperature over the 256^3 cells from 100 K with that heat: one
   launch of the thermal kernel (csrc/thermal.cu, asserted) bit for bit
   against update_temperature_ref (max_abs_err 0, asserted) in float32 and
   float64, with ms per update by CUDA events, the plain version's ms and
   the bound of its function (``thermal_check``: bytes, flops and the
   transcendentals it needs on the MUFU pipe, THERMAL_OPS, THERMAL_MUFU)
   beside the kernel's own SASS at the issue rate and on the float64 pipe
   (``thermal_instructions``) and ptxas's registers; the design steps of
   the redesign (THERMAL_FORMS of csrc/thermal_probe.cu, each bit-equal,
   asserted, with its ms and its own SASS) and the pow pair against powf
   and pow over every float32 base in [1e-4, 1e5] and 10^8 float64 bases
   (``thermal_pair_check``, no result may differ);
   last the hydrogen chemistry check on phase 3's Gamma with the updated
   temperatures, a temperature of its own in every cell.
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
   its engines with fuse_fold: one trace loop, one K3h launch, one extract
   and one accumulate per raytrace iteration), then
   that script's five checks of the temperature and ionization profiles.
4d. The adaptive engine at the bench mix: N=256, R_max=30 (buckets 7.5, 15,
   30), 12288 sources at positions from seed 100 with fluxes over three
   decades, B=8, float32, fuse_fold. Its Gamma equals the sum of one
   fuse_fold ChebRaytracer per bucket bit for bit, each bucket launching K3
   once per batch; ns per cell-update, the per-batch stage times of the
   smallest bucket, the trace before and after the trace loop as in 3b,
   and the GPU trace of the first 16 sources against the CPU.
4e. The production EoR run, examples/eor_simulation/run_test.py's loop:
   C2Ray_CubeP3M(<its parameters.yml>, 250, device="cuda") (engine
   adaptive, float32, B=16) on the committed inputs, both slices
   (21.062 -> 20.134 -> 19.284) with one timestep each. First the first
   slice on a model of its own with the batch loop before the trace loop
   (``plain_loop``). Per slice the bucket counts, raytrace iterations,
   launches (asserted: K3, extract and accumulate iterations x batches, one
   trace loop per iteration and used bucket), s per trace and per
   chemistry pass, Mcell-updates/s and the photon loss; xh finite in
   [0, 1] and changed, the outputs read back equal to the state; the first
   slice's iterations, xh and photon loss bit-equal to the run before.
   Then one trace before and after the trace loop, each unprofiled and
   under torch.profiler (as in 3b), with the card's name and power limit:
   the top device kernels, the device ms per call of K3's phases and of the
   box kernels, the profiled Gamma equal to the unprofiled one. On that
   trace's own frames and positions, per call: the C++ loop against
   trace_extended_plain (CUDA events, bit-equal) and over every batch the
   box kernels against the gather and the slice adds (bit-equal) and
   torch.take / index_add_ (device time), with the bounds from the bytes
   that data needs: the kernels line's numbers for the three. Then the
   Gamma of the first 16 sources against the CPU. Both slices also run on
   a model of their own with the plain chemistry pass (``plain_chemistry``)
   before the kernel: s per chemistry pass, per raytrace iteration and per
   timestep of both, iterations, xh and photon loss bit-equal (asserted;
   one chemistry_pass launch per iteration with the kernel). Last the
   chemistry checks on the run's last state.
   The catalogs are read by ``read_sources``, without h5py where the
   machine has none (pyc2ray_torch/io/catalog.py).
2d. (after 2c) K1 at the helium engine's three threshold cross sections
   (sigma_HI, sigma_HeI, sigma_HeII of make_spectral_bins_he) at the bench
   shape in float32, bit for bit against its plain version, with its time;
   then the helium engine's three-species rate pass (rates_he,
   ops/cheb_rates.py) on the three species' K1 boxes against its plain
   version, with and without the heat channel, bit for bit (max_abs_err
   0): on one bench batch (B = 8, Dc = Ds = 64, 72 bins, float32) with
   kernel, plain and matmul-form ms (the pass the engine ran before its
   kernel, ``rates_he_matmul``), the rate floor of 2c's dense pass and
   the bound of its function (``function_bound`` of ``he_work``): the
   largest of its bytes, its operations and its transcendentals on the
   MUFU pipe (16 lanes a clock per SM), naming which binds; beside it the
   time of the kernel's own SASS at the issue rate (``he_rates_sass``: the
   bin loops from ``cuobjdump -sass``, a bin of each band at its loop's
   count, spills not counted), a diagnostic; in float64 at a small
   shape with zero-density cells, with its SASS bin loops; last the
   float32 error of the three rates and the heat at the helium bench
   fields against a float64 run (``he_rates_f32_error``: cdin rebuilt as
   cd - dcol, ROADMAP section 3), each as its largest absolute error over
   the peak and its largest relative error above 1e-6 of the peak; the
   same for the hydrogen default mode's rate pass (``rates_f32_error``: K1
   and rates_dense with the heat channel at the bench fields, Gamma and
   the heat, ROADMAP section 3).
3d. (after 3c) The table-exact flat engine (ops/raytrace.py) at the bench
   configuration in float64 with the model layer's black-body tables, its
   trace one call of the loop of csrc/flat_sweep.cu (flat_trace_sweep: per
   device batch of as many sources as the card holds clusters of the
   gather, the sweep and the rate pass, then the ordered accumulate a batch
   at a time): the launch counts of the whole trace (asserted: one loop,
   each kernel as ops/flat_sweep.py::loop_plan counts it), ns per
   cell-update after and before (the plain loop
   flat_trace_sweep_ref, the whole trace bit-equal); the loop against the
   plain loop over 16 batches in float64 and float32, with and without
   heat, bit for bit; device launches per batch (at most 4, asserted) and
   the device idle share of a profiled window of 16 batches, with each
   kernel's median device us and the gap before it; each kernel against
   its plain version on the first batch (max_abs_err 0, asserted) with its
   device ms in the loop, the plain version's ms, one index_add_ beside the
   accumulate, and the bound of its function (``flat_work``: the bytes of
   this data and FLAT_*_OPS operations), the sweep's chain floor (shells x
   phase 1's cluster barrier); the sweep's design steps at the bench and
   the golden's shapes (``FLAT_FORMS``: forms of the probe entry, each but
   the "timing only" ones bit-equal to the plain sweep), its us a source
   per plan (``flat_device_batches``) and the accumulate against the
   first port's and one index_add_ (``flat_accumulate_forms``); the
   gather's and the rate pass's design steps at both shapes
   (``FLAT_GATHER_FORMS`` beside one torch.take, ``FLAT_RATE_ROWS``: the
   forms of csrc/flat_probe.cu and the engine's kernel, each bit-equal to
   its plain version), the rate kernels' own SASS against their bytes
   (``flat_rates_sass``), the gather and the rate kernel on the loop's
   first device batch in float32 and float64, with heat and grey, their
   outputs first made NaN (``flat_kernel_check``), the host seconds of
   ``Raytracer.kernel_tables`` (``timed_tables``); the loop's ms per trace
   against the plain loop's and its bound; the trace of the first 16
   sources against the CPU.
3e. The helium engine (HeRaytracer, 72 default bins) at the bench fields in
   float32: the trace is one call of the C++ loop (he_trace_sweep); its
   launches (one loop, K1 three per batch, rates_he and the accumulate of
   the three channels one per batch, the extract of the three species once
   per chunk of batches; asserted), one global_pass_he; the loop against
   trace_extended_plain (the batch loop in Python with the plain rate
   pass, timed once) on the trace's frames: bit-equal, ns per cell-update
   after and before, ms per trace by CUDA events, the bound of the whole
   loop (the kernels line's numbers), and one profiled trace of the loop
   with each kernel's median device us, the gap before it and the idle share
   (``loop_kernel_gaps``); the per-batch device ms of the extract, the
   three sweeps, rates_he and the accumulate, beside the plain gathers,
   rate pass, matmul form and slice adds (16 batches, the frames bit-equal
   to the plain loop's and to trace_extended's); the loop with the heat
   channel against the plain loop (16 batches, bit-equal); Gamma_HI of a
   helium-free field against the hydrogen engine at the same bins. The
   helium kernel on this trace's rates (256^3 float32), see "chemistry"
   below.
3f. The octahedral sheet engine (BoxRaytracer, engine: box) at the bench
   configuration in float32 with the compressed bins, its trace one
   box_trace_sweep call (csrc/trace_loop.cu, kernels in
   csrc/box_sweep.cuh): launch counts as the loop counts them (asserted
   against box_plan), ns per cell-update of all 2048 sources after and
   before (the plain loop box_trace_sweep_ref, with plain slice adds, cut
   to the batches that fit BOX_BUDGET_S but not below one past the loop's
   first device batch), the loop against the plain loop over those batches
   and over 16 batches with and without heat (bit-equal); device launches
   per batch (at most 3 over the whole trace, asserted), the idle share and
   each kernel's launches (asserted against box_plan) and median device us
   a launch of a profiled trace; box_gather,
   box_sweep and box_rates against their plain versions (max_abs_err 0, on
   NaN buffers) at the bench shape with and without heat and at the grey
   float64 clipped shape (N=64, R beyond the mesh), with kernel, plain,
   library (the gather: torch.take) ms and the bound of the function
   (box_work, function_bound), each at the loop's launch (the rate pass:
   a chunk of batches); the design steps: the sweep's forms
   (BOX_SWEEP_STEPS: the engine's kernel in each block and placement, the
   first port's kernels and the measured forms of csrc/box_probe.cu: S
   sources a thread or a block, a persistent grid, parts of the step taken
   out) and the rate pass's (BOX_RATE_FORMS, BOX_RATE_CHUNKS with the
   bytes of each chunk's rate boxes), each bit-equal where it computes the
   function, the kernels' own SASS at the issue rate, the accumulate at
   this shape against its byte bound and one index_add_; the trace of
   the first 16 sources against the CPU (1e-5 above 1e-6 of the peak); the
   grey spectrum in float64 at N=64 with 8 sources against the flat engine
   (rtol 2e-7).
3g. (after 3f) The trace loop's kernels against their plain versions, bit
   for bit (max_abs_err 0): extract_boxes and accumulate_boxes at the bench
   shape (B=8, Dc=64), the EoR run's (B=16, Dc=24) and on a non-cubic
   frame, each on a batch of boxes spread over the frame and on a batch
   clustered within two cells (two at one cell), with kernel, plain,
   library (torch.take, index_add_) device ms and bound ms of the clustered
   batch; the accumulate over the bench default engine's rated cells (the
   unfused modes' form) on rate boxes 0 elsewhere, the same way (library:
   index_add_ of the rated cells); then the C++ loop (trace_extended with fuse_fold) against
   trace_extended_plain on random fields, each timed against the plain
   loop: the bench configuration with K3 and with K3h, and the EoR run's
   small bucket over 128 batches, the first clustered, with the per-kernel
   device us and gaps of its loop (``loop_kernel_gaps``).
4f. (after 4e) The golden: examples/single_source_test at its full
   configuration (N=128, 2 slices x 10 timesteps, parameters.yml unchanged:
   engine flat, float64) through C2Ray_Test on the card against the
   sequential C++ oracle's evolve loop (native_ext, built with g++ into
   build/torch_kernels/); the eight statistics of run_test.py, each held to
   its tolerance; the wall time of the port's part and of the oracle's, the
   s and count of the engine's traces (each through the flat kernels: one
   flat_trace_sweep a trace, asserted) and the run's launch counts; then
   at the golden's own shape (``golden_kernels``) the sweep, the gather,
   the rate kernel (also of engines of that shape in float32, with heat
   and grey) and one trace against their plain versions on buffers made
   NaN first, and the host seconds of the engine's kernel_tables.
4g. One evolve3D_he timestep at N=64 with 16 sources in float64 with
   secondary ionizations and recombination photons, GPU against CPU, and
   that engine's loop (with the heat channel) against its plain loop on the
   timestep's end state, bit for bit; then
   C2Ray_Test with engine he, the heating rates and isothermal false for two
   timesteps at N=128 on the card: iterations, K1 launches (three per
   iteration, one he_trace_sweep per iteration and three K1 per rates_he,
   asserted) and the photon loss of each timestep; the model
   runs first with the plain chemistry pass: s per pass, per raytrace
   iteration and per timestep before and after, iterations, photon loss
   and state bit-equal, one chemistry_pass_he launch per iteration
   (asserted). Then the chemistry checks on its last state.
4h. The heating example of 4c with Raytracing.engine box: its five checks,
   one box_trace_sweep per raytrace iteration with its kernels' launches
   (asserted), xh and T against 4c's cheb run; each box kernel against
   its plain version (bit-equal) and the sweep's design steps for its one
   source (float64).
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
   to 1e-9 of 4g's, every rank's traces through he_trace_sweep (three K1
   per rates_he, asserted). A rank's exception fails the phase.
Chemistry (in 3, 3e, 4e and 4g, where its fields arise): each chemistry
   kernel against its plain version on the card, bit for bit (every output
   and the count; max_abs_err 0, asserted): the hydrogen kernel on phase 3's
   256^3 float32 Gamma (each cell's iterations equal to the plain loop's,
   asserted) with its one temperature and with 3c's updated temperatures,
   on the EoR run's last 250^3 state in float32 and in float64
   (also through the entry point hydrogenODE), the helium kernel on 3e's
   rates (float32) and on 4g's last state (float64) in the four
   combinations of its options. Per pass: kernel and plain ms (CUDA
   events), the bound from the bytes and the iterations of that data (the
   largest of the bytes, the SASS instructions of the loops at the issue
   rate, their MUFU at 16 lanes a clock per SM and their float64
   DADD/DMUL/DFMA at 64, naming which binds; the flop bound beside), the
   profiler's device kernels (one, asserted), memsets and host
   synchronisations (none, asserted) beside the plain pass's, and the
   distribution of the iterations per cell.
7. (after 5) The user drivers: each module of pyc2ray_torch.examples and
   pyc2ray_torch.tutorials in a process of its own, as ``python -m`` runs
   it, with ``--device cuda`` and a temporary ``--workdir``: the
   raytracing harness's R = 100 row (N=250, Ns=100, --sed bb, --json; its
   ns/cell-update beside 3b's auto-segmented trace) and its helium engine
   (N=256, R=30, Ns=256), stromgren_ifront, shadow_test, multisource,
   stromgren_cosmo, heating_test and single_source_test at their
   defaults, eor_simulation --num_slices 2 (the committed inputs, the
   catalogs through read_sources), multihost_pod in both modes (one rank),
   make_plots where matplotlib is installed, and the three tutorials
   (raytracing with both engines); the harness's two rows alone, the
   others four at a time. Per driver: its exit code, wall time,
   kernel launches (counted in its process and printed at its exit; the
   kernels its path reaches must each launch: the flat engine's five in
   the five flat examples, make_plots and the flat tutorial; the helium
   rows three sweeps per rates_he) and its check lines. A driver fails the
   phase when it exits non-zero or prints FAILED.
6. The script's wall time, a ``kernels`` JSON line (the five sweep kernels,
   then the trace loop's extract_boxes and accumulate_boxes on 4e's EoR
   trace (the accumulate with its rated form at the bench beside, 3g), the dense rate pass rates_dense and init_segments (2e), the loop
   cheb_trace_sweep (phase 3's default bench trace, and 4e's fuse_fold EoR
   trace beside it), the helium engine's rates_he (2d, launches 3e) and its
   loop he_trace_sweep (3e), the chemistry_pass
   kernel on the EoR run's state, chemistry_pass_he on 4g's, the
   thermal kernel thermal_update at 3c's float32 update with the heating
   example's launches, 4c, and the flat engine's flat_gather, flat_sweep,
   flat_rates, flat_accumulate and its loop flat_trace_sweep, 3d, with the
   golden's launches beside, and the box engine's box_gather, box_sweep,
   box_rates and its loop box_trace_sweep, 3f), then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Needs one CUDA card; exits non-zero without one. Imports nothing of JAX.
``python3 chip_smoke.py --kernels`` stops after phase 2d (the kernels
against their plain versions and their times) and prints no result line;
``--flat`` runs after phase 1 only the flat engine's phases 3d and 4f and
prints no result line; ``--box`` the box engine's 3f and 4h (with the
heating example on cheb, 4h's reference) and prints no result line.
``python3 chip_smoke.py --nccl``, on a machine with two cards or more, runs
after phase 1 only phase 5's nccl world with its single-rank references
(``nccl_branch``) and prints no result line.
"""

import contextlib
import ctypes
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
DENSE_OPS_PER_LISTED = 4         # the dense rate pass per listed cell of
                                 # a box: path3*dr, nHI*, cd-dcol, the
                                 # cdin test; per rated cell beside the
                                 # bins RATE_OPS_PER_CELL
HE_OPS_PER_BIN = 20              # the helium rate pass per bin and rated
                                 # cell: tau and dtau (3 muls, 2 adds
                                 # each), exp, expm1, core*, max, div, 3
                                 # species sums (mul, add each)
HE_HEAT_OPS_PER_BIN = 6          # and the heat's 3 sums
HE_OPS_PER_CELL = 11             # per rated cell: the prefactor (2 muls),
                                 # per species dcol*acc, pref*, div
HE_HEAT_OPS_PER_CELL = 7         # the heat: 3 muls, 2 adds, mul, div
HE_OPS_PER_LISTED = 8            # per listed cell of a box: path3*dr, 3
                                 # dcol, 3 cdin, the cdin test
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
BOX_BUDGET_S = 20.0          # 3f's plain loop ("before"): the batches of
                             # Ns = 2048 that fit at the pace of 16 of them
N_BOX_GREY, NS_BOX_GREY = 64, 8              # 3f's grey check
# the adaptive ladder of parameters.yml at N=250: R_max_LLS = 15 cMpc x
# 250 / 244 cells and half of it (a quarter is below R_min = 4)
R_EOR = (15.0 * N_EOR / 244.0 / 2.0, 15.0 * N_EOR / 244.0)
T_START = time.time()
FOLD = dict(fuse="fold", seg=(0, 0), heat=False)   # a fuse_fold engine's mode
NS_PER_CELL = {}             # run_path's ns/cell-update by its label


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


def _template_arg(a):
    """A mangled template argument of log_ptxas's kernels (b0, b1, i5, in1,
    j7) as C++ writes it."""
    if a[0] == "b":
        return "true" if a == "b1" else "false"
    if a[0] == "j":
        return a[1:] + "u"
    return ("-" + a[2:]) if a.startswith("in") else a[1:]


def log_ptxas(word="", quiet=False):
    """ptxas's registers, spills and static shared memory of every kernel
    built in this process whose name holds ``word``, per kernel <element
    type, template arguments> (the sweeps' shared memory is dynamic, see
    the plans), logged unless ``quiet``. Returns {kernel: ptxas's
    lines}."""
    from pyc2ray_torch.ops import _build
    kernel, out = "", {}
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(\d+)([a-z_]+kernel)"
                      r"(?:I([fd])((?:L(?:b[01]|in?\d+|j\d+)E)*))?", line)
        if m:
            kernel = m.group(2) + (
                f"<{'float' if m.group(3) == 'f' else 'double'}"
                + "".join(", " + _template_arg(a) for a in re.findall(
                    r"L(b[01]|in?\d+|j\d+)E", m.group(4))) + ">"
                if m.group(3) else "")
        elif ("spill" in line or "registers" in line) and word in kernel:
            text = line.replace("ptxas info    :", "").strip()
            out[kernel] = (out[kernel] + "; " if kernel in out else "") + text
            if not quiet:
                log(f"  ptxas {kernel}: {text}")
    return out


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


def dense_work(rt, cd, nhi, heat):
    """(bytes, operations, rated cells) of one dense rate pass of engine
    ``rt`` on the boxes ``cd`` and ``nhi``, as this data needs them: the
    engine's list of the subbox's rated cells (``rt.rated_cells``, int32;
    the cells of the table's valid channel), path3 and geominv at the
    listed cells and cd and nHI at the listed cells of every box, the
    fluxes and the bins, each read once, and Gamma (and the heat) written at
    the listed cells of every box (the kernel touches no other cell: its
    output there is the 0 the caller zeroed once); DENSE_OPS_PER_LISTED
    per listed cell of a box, and RATE_OPS_PER_CELL and the bins' operations
    per rated cell of this data (listed, cdin <= MAX_COLDENSH)."""
    from pyc2ray_torch.constants import MAX_COLDENSH
    tb, r, Ds = rt.tables, rt._rb0, rt.Ds
    sub = (slice(None),) + (slice(r, r + Ds),) * 3
    cdin = cd[sub] - nhi[sub] * (tb.rt_sub[0] * DR)
    valid = tb.rt_sub[2] > 0.5
    rated = int((valid & (cdin <= MAX_COLDENSH)).sum())
    n_valid = rt.rated_cells.numel()
    B, E = cd.shape[0], rt.num_bins
    isz = torch.finfo(cd.dtype).bits // 8
    nbytes = (4 * n_valid + isz * (2 * n_valid + (3 + heat) * B * n_valid
                                   + B + (2 + heat) * E))
    per_bin = RATE_OPS_PER_BIN + heat * HEAT_OPS_PER_BIN
    ops = (rated * (per_bin * E + RATE_OPS_PER_CELL
                    + heat * HEAT_OPS_PER_CELL)
           + DENSE_OPS_PER_LISTED * B * n_valid)
    return nbytes, ops, rated


def check_rates(N, R, B, dtype, seed, reps, bins, ns_bin=None,
                zero_cell=False, shell_segment="auto"):
    """Phase 2e: the dense rate pass of the unfused modes (rates_dense,
    ops/cheb_rates.py) against its plain version on the card, on the
    engine's own coldensh_out boxes (``sweep_box``: K1, or K2 where the
    engine segments), with and without the heat channel: max_abs_err must
    be 0. Kernel ms per call on the device (``device_ms``: the kernel and
    the memset of its zeroed outputs) and back to back (CUDA events, the
    wrapper's enqueue included), plain ms (CUDA events) and the bound of
    ``dense_work``; with ``ns_bin`` (phase 2c's dense pass, float32) the
    rate floor, rated cells x bins x ns_bin. Where the engine segments, the
    start of a segmented sweep (init_segments) against init_segments_ref
    the same way. Returns {"photo", "heat"(, "init")}: numbers per call."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.cheb_rates import rates_dense, rates_dense_ref
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    rt = ChebRaytracer(N, R, SIG, bins, batch_size=B, dtype=dtype,
                       shell_segment=shell_segment)
    g, tb = rt.geom, rt.tables
    nhi = random_nhi(rt, B, dtype, seed, zero_cell)
    cd = rt.sweep_box(nhi, DR, SIG)
    flux = torch.linspace(0.5, 2.0, B, dtype=dtype, device="cuda")
    args = (tb.rt_sub, flux, tb.bins_s, tb.bins_w, DR, SIG,
            float(sweep.s_over_dr3(DR, dtype)), rt._rb0)
    cells = rt.rated_cells
    log(f"rates_dense N={N} R={R:g} B={B} Dc={g.Dc} Ds={rt.Ds} rb0="
        f"{rt._rb0} E={bins.num_bins} {str(dtype).split('.')[-1]} on "
        f"{'K2' if rt.seg_S else 'K1'}'s boxes"
        f"{' (one zero-density cell)' if zero_cell else ''}, "
        f"{cells.numel()} rated cells of {rt.Ds ** 3} "
        f"({cells.numel() / rt.Ds ** 3:.3f}):")
    out = {}
    for heat in (False, True):
        wh = tb.bins_wh if heat else None

        def kern():
            return rates_dense(cd, nhi, *args, bins_wh=wh, cells=cells)

        def plain():
            return rates_dense_ref(cd, nhi, *args, bins_wh=wh)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max(float((a - w).abs().max()) for a, w in zip(got, want)
                  if w is not None)
        if (err != 0.0 or not float(want[0].max()) > 0.0
                or not all(bool(torch.isfinite(a).all()) for a in got
                           if a is not None)):
            raise RuntimeError(f"rates_dense{' heat' if heat else ''} N={N} "
                               f"R={R}: max_abs_err {err} against the plain "
                               f"version")
        if zero_cell and float(got[0][1, g.c - rt._rb0, g.c - rt._rb0 + 1,
                                      g.c - rt._rb0]) != 0.0:
            raise RuntimeError("rates_dense: Gamma at the zero-density cell "
                               "is not 0")
        del got, want
        nbytes, ops, rated = dense_work(rt, cd, nhi, heat)
        ms = device_ms(lambda _: kern(), reps)
        b2b = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 1)
        b_ms, b_by = least_ms(nbytes, ops, dtype)
        res = dict(max_abs_err=err, ms=ms, ms_back_to_back=b2b,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   rated_cells=rated)
        floor = ""
        if ns_bin is not None:
            res["rate_floor_ms"] = 1e-6 * rated * bins.num_bins * ns_bin
            floor = f" rate_floor_ms={res['rate_floor_ms']:.5f}"
        log(f"  rates_dense{' heat' if heat else ''}: max_abs_err={err:.1e} "
            f"(bit-equal) kernel_ms={ms:.4f} on the device with its zeroed "
            f"outputs ({b2b:.4f} back to back) plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}){floor} per call, {rated} rated "
            f"cells")
        out["heat" if heat else "photo"] = res
    if rt.seg_S:
        got = sweep.init_segments(nhi, g.c, DR)
        want = sweep.init_segments_ref(nhi, g.c, DR)
        torch.cuda.synchronize()
        err = max(float((a - w).abs().max()) for a, w in zip(got, want))
        if err != 0.0:
            raise RuntimeError(f"init_segments: max_abs_err {err}")
        isz = torch.finfo(dtype).bits // 8
        ms = cuda_ms(lambda: sweep.init_segments(nhi, g.c, DR), reps)
        plain_ms = cuda_ms(lambda: sweep.init_segments_ref(nhi, g.c, DR), 2)
        b_ms, b_by = least_ms(isz * B * (g.Dc ** 3 + 6 * g.Dc ** 2 + 1),
                              2 * B, dtype)
        out["init"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by)
        log(f"  init_segments (S={rt.seg_S}, K={rt.seg_K}): max_abs_err="
            f"{err:.1e} (bit-equal) kernel_ms={ms:.4f} plain_ms="
            f"{plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) per call")
    return out


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
    NS_PER_CELL[label] = ns_cell
    log(f"{label}: raytrace {t_ray:.4f} s = {ns_cell:.4f} ns/cell-update"
        f"{msg}, launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return phi, heat, counts


def extract_chunks(rt, nb):
    """The extract's launches in a trace of engine ``rt`` over ``nb``
    batches: one per chunk of ``trace_loop.chunk_size`` batches (one per
    batch in a checkout before the chunked extract, as kernel_ab.py may
    measure)."""
    from pyc2ray_torch.ops import trace_loop
    if not hasattr(trace_loop, "chunk_size"):
        return nb
    return -(-nb // trace_loop.chunk_size(nb, rt.batch_size, rt.geom.Dc,
                                          rt.dtype.itemsize))


def trace_launches(mode, nb, chunks, traces=1):
    """The kernel launches of ``traces`` Chebyshev traces of ``nb`` batches
    in all, in the sweep mode ``mode`` (``ChebRaytracer._sweep_mode()``: its
    fuse, seg and heat): one trace loop call per trace, the extract once per
    chunk of batches (``chunks`` in all, ``extract_chunks``), and per batch
    the accumulate and the mode's kernels."""
    S, K = mode["seg"]
    out = {"cheb_trace_sweep": int(traces), "extract_boxes": chunks,
           "accumulate_boxes": nb}
    if mode["fuse"] == "fold":
        out["cheb_sweep_rates_heat" if mode["heat"]
            else "cheb_sweep_rates"] = nb
    elif mode["fuse"] == "rates":
        out["cheb_sweep_fused_rates"] = nb
    elif S:
        out.update(cheb_sweep_seg=nb * K, init_segments=nb, rates_dense=nb)
    else:
        out.update(cheb_sweep=nb, rates_dense=nb)
    return out


@contextlib.contextmanager
def plain_loop(engines):
    """Within the block every ChebRaytracer of ``engines`` traces by its
    ``trace_extended_plain``: the batch loop as the port issued it before
    the trace loop (a pageable copy of the positions, PyTorch's gather, the
    sweep mode and one slice add per source, per batch)."""
    for e in engines:
        e.trace_extended = e.trace_extended_plain
    try:
        yield
    finally:
        for e in engines:
            del e.trace_extended


def device_counts(prof):
    """(device kernels, host-to-device copies) in the captures of
    ``prof``."""
    from pyc2ray_torch.diagnostics import _trace_events
    kern = copies = 0
    for events in _trace_events(prof):
        for e in events:
            kern += e.get("cat") == "kernel"
            copies += (e.get("cat") == "gpu_memcpy"
                       and "HtoD" in e.get("name", ""))
    return kern, copies


def loop_before_after(label, engines, trace, nbatch, tmp):
    """One trace (``trace()`` returns its Gamma) with the batch loop before
    the trace loop (``plain_loop(engines)``) and after it, each once
    unprofiled after a warm-up and once under torch.profiler: wall s,
    device kernels and host-to-device copies per batch, device busy ms and
    the idle share of the profiled window and of the unprofiled trace.
    Asserts the four Gammas equal bit for bit; returns {tag: numbers}."""
    from pyc2ray_torch.diagnostics import (device_idle_share,
                                           device_op_times, profile_trace)
    res = {}
    for tag in ("before", "after"):
        with plain_loop(engines if tag == "before" else ()):
            trace()
            torch.cuda.synchronize()
            t0 = time.time()
            phi = trace()
            torch.cuda.synchronize()
            wall = time.time() - t0
            prof = os.path.join(tmp, f"{label.split()[0]}_{tag}")
            with profile_trace(prof) as p:
                p["sync"] = trace()
        if not torch.equal(p["sync"], phi):
            raise RuntimeError(f"{label}, loop {tag}: the profiled trace "
                               f"differs")
        kern, copies = device_counts(prof)
        busy = sum(device_op_times(prof).values())
        res[tag] = dict(s=wall, launches_per_batch=kern / nbatch,
                        copies_per_batch=copies / nbatch, busy_ms=busy,
                        idle_profiled=device_idle_share(prof),
                        idle=1.0 - 1e-3 * busy / wall, phi=phi, prof=prof)
    if not torch.equal(res["before"]["phi"], res["after"]["phi"]):
        raise RuntimeError(f"{label}: the trace loop's Gamma differs from "
                           f"the loop before it")
    for tag, r in res.items():
        log(f"  {label}, loop {tag}: {r['s']:.4f} s per trace, "
            f"{r['launches_per_batch']:.2f} device launches and "
            f"{r['copies_per_batch']:.2f} host-to-device copies per batch "
            f"({nbatch} batches), device busy {r['busy_ms']:.2f} ms, idle "
            f"share {r['idle']:.4f} unprofiled, {r['idle_profiled']:.4f} "
            f"profiled")
    log(f"  {label}: Gamma after equals before bit for bit; per trace "
        f"{res['before']['s'] / res['after']['s']:.2f}x faster")
    return res


def stage_breakdown(rt, nd, xh, pos_b, flux_b, nbatch):
    """Device time per batch of each stage of the batch loop over the first
    ``nbatch`` batches (CUDA events around each stage, a synchronize after
    each batch), for the default mode, fuse_rates and fuse_fold, with or
    without do_heating. "extract" is the extract_boxes kernel, "sweep" the
    kernel (K1, or one call of K1f, K3 or K3h, which returns complete rate
    boxes), "rates" what follows it (the dense rate pass, rates_dense;
    nothing in a fused mode), "accumulate" the accumulate_boxes kernel
    (Gamma and, with do_heating, the heat in one launch); beside them on
    the same batch the plain gather, slice adds and rate pass that the loop
    issued before ("extract_plain", "accumulate_plain", "rates_plain"),
    whose outputs are asserted equal to the kernels' bit for bit."""
    from pyc2ray_torch.ops.cheb_rates import rates_dense_ref
    from pyc2ray_torch.ops.sweep import (cheb_sweep, cheb_sweep_rates,
                                         rate_consts)
    from pyc2ray_torch.ops.trace_loop import (accumulate_boxes, add_boxes,
                                              extract_boxes,
                                              extract_boxes_ref,
                                              stage_positions)
    g, tb, N = rt.geom, rt.tables, rt.N
    nhi_pad = rt.wrap_pad(nd.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3)))
    pads = [torch.zeros_like(nhi_pad) for _ in range(1 + rt.do_heating)]
    plain = [torch.zeros_like(nhi_pad) for _ in pads]
    pos = stage_positions(pos_b[:nbatch], nhi_pad.shape, g.Dc, "cuda")
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    c = g.c
    tot = dict.fromkeys(("extract", "sweep", "rates", "accumulate",
                         "extract_plain", "accumulate_plain", "rates_plain"),
                        0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    for k in range(nbatch):
        flux = flux_b[k]
        cd = None
        ev[0].record()
        boxes = extract_boxes(nhi_pad, pos, k, g.Dc)
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
            out = rt._rates(cd, boxes, flux, DR)[:1 + rt.do_heating]
        ev[3].record()
        # the unfused modes' rate boxes: the rated cells only, as the loop
        rated = {} if cd is None else dict(cells=rt.rated_cells,
                                           valid=tb.rt_sub[2])
        accumulate_boxes(pads, out, pos, k, rt.box_shift(out[0]), **rated)
        ev[4].record()
        boxes_plain = extract_boxes_ref(nhi_pad, pos_b[k].to("cuda"), g.Dc)
        ev[5].record()
        for pad, rate_box in zip(plain, out):
            add_boxes(pad, rate_box, pos_b[k], rt.box_shift(rate_box))
        ev[6].record()
        ref = None if cd is None else rates_dense_ref(
            cd, boxes, tb.rt_sub, flux, tb.bins_s, tb.bins_w, DR, rt.sig,
            rate_consts(DR, rt.dtype)[1], rt._rb0,
            bins_wh=tb.bins_wh if rt.do_heating else None)
        ev[7].record()
        torch.cuda.synchronize()
        if not torch.equal(boxes, boxes_plain):
            raise RuntimeError("stage_breakdown: extract_boxes differs from "
                               "the plain gather")
        if ref is not None and not all(torch.equal(a, b)
                                       for a, b in zip(out, ref)):
            raise RuntimeError("stage_breakdown: rates_dense differs from "
                               "the plain rate pass")
        for i, name in enumerate(tot):
            tot[name] += ev[i].elapsed_time(ev[i + 1])
    if not all(torch.equal(a, b) for a, b in zip(pads, plain)):
        raise RuntimeError("stage_breakdown: accumulate_boxes differs from "
                           "the plain slice adds")
    return {k: v / nbatch for k, v in tot.items()}


def box_flat_index(pos, frame_shape, D):
    """The flat indices (B, D, D, D) into a frame of ``frame_shape`` of the
    cells of the boxes of side D at the corners ``pos`` (B, 3), on the
    device of ``pos``."""
    ar = torch.arange(D, device=pos.device)
    i, j, k = (pos[:, ax, None].long() + ar for ax in range(3))
    F1, F2 = frame_shape[1], frame_shape[2]
    return ((i[:, :, None, None] * F1 + j[:, None, :, None]) * F2
            + k[:, None, None, :])


def box_kernel_work(idx, dtype):
    """(extract bytes, accumulate bytes) of one batch whose boxes cover the
    frame cells ``idx`` (``box_flat_index``): the extract reads the union
    of those cells once and writes the boxes; the accumulate reads the
    boxes and reads and writes the union (what this data needs, overlaps
    counted once)."""
    union, n = torch.unique(idx).numel(), idx.numel()
    isz = torch.finfo(dtype).bits // 8
    return (union + n) * isz, (n + 2 * union) * isz


def check_box_kernels(label, frame_shape, B, D, dtype, seed, reps):
    """extract_boxes and accumulate_boxes in a frame of ``frame_shape`` at
    (B, D) against their plain versions (the gather, the slice adds) on two
    batches, the second clustered (every box within two cells of one
    corner, two at the same cell): max_abs_err must be 0. Times the
    clustered batch, each call's device ms (``device_ms``): the kernel's,
    the plain version's and that of one PyTorch call that computes the same
    function on precomputed flat indices (torch.take; index_add_, which
    adds in no fixed order); beside them the kernel's back-to-back ms (CUDA
    events, the Python wrapper's enqueue included) and the bound from the
    batch's bytes. Then the extract as the trace loop issues it, one chunk
    of ``chunk_size`` random batches a launch (extract_chunk), the same way
    (plain: the stack of the batches' gathers; library: torch.take of the
    chunk's indices), bit for bit, per launch and per batch. Returns the
    chunk's numbers."""
    from pyc2ray_torch.ops.trace_loop import (accumulate_boxes, add_boxes,
                                              chunk_size, extract_boxes,
                                              extract_boxes_ref,
                                              extract_chunk,
                                              extract_chunk_ref,
                                              stage_positions)
    rng = np.random.RandomState(seed)
    hi = np.array(frame_shape) - D
    pos = rng.randint(0, hi + 1, size=(2, B, 3))
    pos[1] = rng.randint(0, hi - 1, 3) + rng.randint(0, 3, (B, 3))
    pos[1, 1] = pos[1, 0]
    pos_b = torch.from_numpy(pos)
    pos_d = stage_positions(pos_b, frame_shape, D, "cuda")
    frame = torch.from_numpy(rng.standard_normal(frame_shape)).to("cuda",
                                                                  dtype)
    boxes = torch.from_numpy(rng.standard_normal((B,) + (D,) * 3)).to(
        "cuda", dtype)
    err = dict(extract=0.0, accumulate=0.0)
    for k in range(2):
        got = extract_boxes(frame, pos_d, k, D)
        want = extract_boxes_ref(frame, pos_d[k], D)
        err["extract"] = max(err["extract"],
                             float((got - want).abs().max()))
        f_k, f_p = frame.clone(), frame.clone()
        accumulate_boxes(f_k, boxes, pos_d, k)
        add_boxes(f_p, boxes, pos_b[k])
        err["accumulate"] = max(err["accumulate"],
                                float((f_k - f_p).abs().max()))
    torch.cuda.synchronize()
    if any(err.values()):
        raise RuntimeError(f"{label}: the box kernels differ from their "
                           f"plain versions: {err}")
    idx = box_flat_index(pos_d[1], frame_shape, D)
    f_k, f_p, f_l = frame.clone(), frame.clone(), frame.clone()
    calls = {
        "extract": (lambda: extract_boxes(frame, pos_d, 1, D),
                    lambda: extract_boxes_ref(frame, pos_d[1], D),
                    lambda: torch.take(frame, idx)),
        "accumulate": (lambda: accumulate_boxes(f_k, boxes, pos_d, 1),
                       lambda: add_boxes(f_p, boxes, pos_b[1]),
                       lambda: f_l.view(-1).index_add_(0, idx.reshape(-1),
                                                       boxes.reshape(-1)))}
    nbytes = dict(zip(calls, box_kernel_work(idx, dtype)))
    for name, (kern, plain, lib) in calls.items():
        ms, plain_ms, lib_ms = (device_ms(lambda _, f=f: f(), reps)
                                for f in (kern, plain, lib))
        b2b = cuda_ms(kern, reps)
        b_ms, b_by = least_ms(nbytes[name], B * D ** 3, dtype)
        log(f"  {label} {name}_boxes: max_abs_err={err[name]:.1e} "
            f"(bit-equal), on the device per call: kernel_ms={ms:.4f} "
            f"({b2b:.4f} back to back) plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f}; bound_ms={b_ms:.5f} ({b_by}, "
            f"{nbytes[name] / 2 ** 20:.2f} MiB)")
    # the loop's form: one chunk of k random batches a launch
    k = chunk_size(256, B, D, torch.finfo(dtype).bits // 8)
    cpos = rng.randint(0, hi + 1, size=(k, B, 3))
    cpos_d = stage_positions(torch.from_numpy(cpos), frame_shape, D, "cuda")
    got = extract_chunk(frame, cpos_d, 0, k, D)
    c_err = float((got - extract_chunk_ref(frame, cpos_d, 0, k, D))
                  .abs().max())
    torch.cuda.synchronize()
    if c_err != 0.0:
        raise RuntimeError(f"{label}: extract_chunk differs from the stack of "
                           f"gathers: {c_err}")
    del got
    cidx = torch.cat([box_flat_index(cpos_d[b], frame_shape, D)
                      for b in range(k)])
    ms, plain_ms, lib_ms = (device_ms(lambda _, f=f: f(), reps) for f in (
        lambda: extract_chunk(frame, cpos_d, 0, k, D),
        lambda: extract_chunk_ref(frame, cpos_d, 0, k, D),
        lambda: torch.take(frame, cidx)))
    c_bytes = box_kernel_work(cidx, dtype)[0]
    b_ms, b_by = least_ms(c_bytes, k * B * D ** 3, dtype)
    log(f"  {label} extract_chunk of k={k} batches (the loop's launch): "
        f"max_abs_err={c_err:.1e} (bit-equal), on the device per launch: "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
        f"(torch.take); bound_ms={b_ms:.5f} ({b_by}, "
        f"{c_bytes / 2 ** 20:.2f} MiB); per batch kernel {ms / k:.5f}, "
        f"torch.take {lib_ms / k:.5f}, bound {b_ms / k:.5f} ms")
    return dict(chunk=k, max_abs_err=c_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def check_rated_accumulate(bins, src_pos, reps=20):
    """accumulate_boxes over the rated cells of the bench default engine's
    rates table (N = 256, R = 30: B = 8, Ds = 64, 43% rated), as the
    unfused modes' loop runs it, on rate boxes that are 0 elsewhere: a batch
    of phase 3's sources (seed 100) and one clustered within two cells (two
    at one cell), each in float32 and the first also in float64, bit for bit
    (max_abs_err 0) against the slice adds of the whole boxes. Times the
    clustered batch as ``check_box_kernels`` does, the library call being
    index_add_ of the rated cells only; the bound counts the rated box
    values, the list and the frame's rated union read and written. Returns
    the clustered float32 batch's numbers."""
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    from pyc2ray_torch.ops.trace_loop import (accumulate_boxes, add_boxes,
                                              stage_positions)
    rng = np.random.RandomState(18)
    B, out = B_BENCH, None
    for dt in (torch.float32, torch.float64):
        rt = ChebRaytracer(N_BENCH, R_BENCH, SIG, bins, batch_size=B,
                           dtype=dt)
        Ds, rb0, cells = rt.Ds, rt._rb0, rt.rated_cells
        valid = rt.tables.rt_sub[2]
        shape = (N_BENCH + rt.geom.Dc - 1,) * 3
        pos = np.stack([src_pos[:B], rng.randint(0, 200, 3)
                        + rng.randint(0, 3, (B, 3))])
        pos[1, 1] = pos[1, 0]
        pos_b = torch.from_numpy(pos)
        pos_d = stage_positions(pos_b, shape, rt.geom.Dc, "cuda")
        frame = torch.from_numpy(np.abs(rng.standard_normal(shape))).to(
            "cuda", dt)
        boxes = torch.from_numpy(np.abs(rng.standard_normal(
            (B, Ds, Ds, Ds)))).to("cuda", dt) * (valid > 0.5)
        err = 0.0
        for k in range(2 if dt == torch.float32 else 1):
            f_k, f_p = frame.clone(), frame.clone()
            accumulate_boxes(f_k, boxes, pos_d, k, rb0, cells, valid)
            add_boxes(f_p, boxes, pos_b[k], rb0)
            err = max(err, float((f_k - f_p).abs().max()))
        torch.cuda.synchronize()
        if err != 0.0:
            raise RuntimeError(f"rated accumulate {dt}: max_abs_err {err}")
        if dt != torch.float32:
            log(f"  bench rated accumulate_boxes float64: max_abs_err="
                f"{err:.1e} (bit-equal)")
            continue
        idx = box_flat_index(pos_d[1] + rb0, shape, Ds).view(B, -1)[
            :, cells.long()].reshape(-1)
        vals = boxes.view(B, -1)[:, cells.long()].reshape(-1)
        f_k, f_p, f_l = frame.clone(), frame.clone(), frame.clone()
        ms, plain_ms, lib_ms = (device_ms(lambda _, f=f: f(), reps) for f in (
            lambda: accumulate_boxes(f_k, boxes, pos_d, 1, rb0, cells, valid),
            lambda: add_boxes(f_p, boxes, pos_b[1], rb0),
            lambda: f_l.view(-1).index_add_(0, idx, vals)))
        isz = torch.finfo(dt).bits // 8
        nbytes = isz * (idx.numel() + 2 * torch.unique(idx).numel()) \
            + 4 * cells.numel()
        b_ms, b_by = least_ms(nbytes, idx.numel(), dt)
        out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"  bench rated accumulate_boxes (B={B} Ds={Ds}, {cells.numel()} "
            f"rated cells a box): max_abs_err={err:.1e} (bit-equal), on the "
            f"device per call of the clustered batch: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} (whole boxes) library_ms={lib_ms:.4f} "
            f"(index_add_ of the rated cells); bound_ms={b_ms:.5f} ({b_by}, "
            f"{nbytes / 2 ** 20:.2f} MiB)")
    return out


def device_ms(fn, n):
    """Device time per call (ms; every kernel and copy, torch.profiler) of
    ``fn(i)`` for i < n."""
    from pyc2ray_torch.diagnostics import device_op_times, profile_trace
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp):
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        return sum(device_op_times(tmp).values()) / n


def eor_trace_kernels(rt, nd, xh, batches, dr):
    """The kernels line's numbers of the trace loop and its box kernels,
    all on the inputs of 4e's profiled EoR trace (each bucket's frame,
    positions and fluxes), per call over that trace's calls.

    Per bucket the loop (one cheb_trace_sweep call) against
    trace_extended_plain: ms per call by CUDA events, max_abs_err over
    Gamma. Device ms per call (``device_ms``): over every chunk of the
    loop's batches (``chunk_size``) the extract as the loop launches it
    (extract_chunk), the plain version (the stack of the batches' gathers)
    and torch.take on precomputed flat indices; over every batch
    accumulate_boxes of the batch's K3 rate boxes into a zero frame, the
    plain slice adds and index_add_ (which adds in no fixed order).
    max_abs_err compares the kernels' boxes and final frame with the plain
    versions'. The bounds count the bytes this data needs
    (``box_kernel_work``), the loop's those of the whole loop
    (``loop_work``)."""
    from pyc2ray_torch.ops.sweep import cheb_sweep_rates
    from pyc2ray_torch.ops.trace_loop import (accumulate_boxes, add_boxes,
                                              chunk_size, extract_chunk,
                                              extract_chunk_ref,
                                              stage_positions)
    N, dt = rt.N, rt.dtype
    nhi3 = nd.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3))
    tot = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0,
                      max_abs_err=0.0)
           for name in ("extract", "accumulate", "loop")}
    n_calls = n_b = n_ch = 0
    for e, pos_b, flux_b in zip(rt.engines, batches.pos, batches.flux):
        if pos_b is None:
            continue
        g, tb = e.geom, e.tables
        nb, B, D = pos_b.shape[0], pos_b.shape[1], g.Dc
        pad = e.wrap_pad(nhi3)
        got = e.trace_extended(pad, pos_b, flux_b, dr)[0]
        want = e.trace_extended_plain(pad, pos_b, flux_b, dr)[0]
        lp = tot["loop"]
        lp["max_abs_err"] = max(lp["max_abs_err"],
                                float((got - want).abs().max()))
        lp["ms"] += cuda_ms(lambda: e.trace_extended(pad, pos_b, flux_b, dr),
                            2)
        lp["plain_ms"] += cuda_ms(
            lambda: e.trace_extended_plain(pad, pos_b, flux_b, dr), 2)
        del got, want
        pos = stage_positions(pos_b, pad.shape, D, "cuda")
        idx = [box_flat_index(pos[k], pad.shape, D) for k in range(nb)]
        geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
        kc = chunk_size(nb, B, D, dt.itemsize)
        spans = [(k0, min(kc, nb - k0)) for k0 in range(0, nb, kc)]
        cidx = [torch.cat(idx[k0:k0 + kk]) for k0, kk in spans]
        chunks, plain = [], []
        ex = tot["extract"]
        n = len(spans)
        ex["ms"] += n * device_ms(
            lambda i: chunks.append(extract_chunk(pad, pos, *spans[i], D)), n)
        ex["plain_ms"] += n * device_ms(
            lambda i: plain.append(extract_chunk_ref(pad, pos, *spans[i], D)),
            n)
        ex["library_ms"] += n * device_ms(
            lambda i: torch.take(pad, cidx[i]), n)
        ex["max_abs_err"] = max([ex["max_abs_err"]] + [
            float((a - b).abs().max()) for a, b in zip(chunks, plain)])
        boxes = [c[s_] for c in chunks for s_ in range(c.shape[0])]
        rates = [cheb_sweep_rates(b, *geo, tb.rt_tab, flux_b[k], dr, g.c,
                                  e.sig, tb.bins_s, tb.bins_w)
                 for k, b in enumerate(boxes)]
        del boxes, plain, chunks
        f_k, f_p, f_l = (torch.zeros_like(pad) for _ in range(3))
        ac = tot["accumulate"]
        ac["ms"] += nb * device_ms(
            lambda k: accumulate_boxes(f_k, rates[k], pos, k), nb)
        ac["plain_ms"] += nb * device_ms(
            lambda k: add_boxes(f_p, rates[k], pos_b[k]), nb)
        ac["library_ms"] += nb * device_ms(
            lambda k: f_l.view(-1).index_add_(0, idx[k].view(-1),
                                              rates[k].view(-1)), nb)
        ac["max_abs_err"] = max(ac["max_abs_err"],
                                float((f_k - f_p).abs().max()))
        for k in range(nb):
            ac["bytes"] += box_kernel_work(idx[k], dt)[1]
        for c in cidx:
            ex["bytes"] += box_kernel_work(c, dt)[0]
        ex["ops"] += nb * B * D ** 3
        ac["ops"] += nb * B * D ** 3
        lb, lops = loop_work(e, pad, pos_b)
        lp["bytes"], lp["ops"] = lp["bytes"] + lb, lp["ops"] + lops
        n_calls, n_b, n_ch = n_calls + 1, n_b + nb, n_ch + n
        del rates, idx, cidx, f_k, f_p, f_l, pad
    out = {}
    for name, t in tot.items():
        n = {"loop": n_calls, "extract": n_ch}.get(name, n_b)
        b_ms, b_by = least_ms(t["bytes"] / n, t["ops"] / n, dt)
        lib = t["library_ms"] / n or None
        out[name] = dict(max_abs_err=t["max_abs_err"], ms=t["ms"] / n,
                         plain_ms=t["plain_ms"] / n, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib)
        log(f"  EoR trace, {name} per call over its {n} calls "
            f"({'CUDA events' if name == 'loop' else 'device time'}): "
            f"max_abs_err={t['max_abs_err']:.1e}, ms={t['ms'] / n:.4f} "
            f"plain_ms={t['plain_ms'] / n:.4f} library_ms="
            f"{'none' if lib is None else f'{lib:.4f}'} "
            f"bound_ms={b_ms:.5f} ({b_by})")
    out["loop"]["batches_per_call"] = n_b / n_calls
    out["extract"]["batches_per_call"] = n_b / n_ch
    if any(v["max_abs_err"] for v in out.values()):
        raise RuntimeError(f"EoR trace: a trace loop kernel differs from its "
                           f"plain version: {out}")
    return out


def check_trace_loop(bins, src_pos):
    """Phase 3g: the trace loop's kernels and the C++ loop against their
    plain versions. extract_boxes and accumulate_boxes at the bench shape
    (B = 8, Dc = 64), the EoR run's (B = 16, Dc = 24) and on a non-cubic
    halo-extended block of a domain of 2 at the EoR shape; then
    ChebRaytracer.trace_extended (fuse_fold: one cheb_trace_sweep call)
    against trace_extended_plain on a random field, bit for bit: at the
    bench configuration with K3 and K3h, and at the EoR run's small bucket
    over 128 batches, the first clustered. The kernels line takes its
    numbers of these kernels from the EoR run's own trace (phase 4e), and
    beside them the accumulate over the bench default engine's rated cells
    (``check_rated_accumulate``) and the extract's chunk at the bench and
    EoR shapes, with its device us in the EoR bucket's loop: this returns
    both."""
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    dt = torch.float32
    log("trace loop kernels, float32 (max_abs_err must be 0):")
    chunks = {}
    for B, Dc, tag in ((B_BENCH, 64, "bench"), (B_EOR, 24, "EoR")):
        side = (N_BENCH if tag == "bench" else N_EOR) + Dc - 1
        chunks[tag] = check_box_kernels(f"{tag} B={B} Dc={Dc} frame {side}^3",
                                        (side,) * 3, B, Dc, dt, seed=12,
                                        reps=20)
    # a frame whose extents differ per axis, as a domain decomposition's
    # halo-extended block is, at the EoR shape
    check_box_kernels("EoR non-cubic block (203, 273, 251)",
                      (203, 273, 251), B_EOR, 24, dt, seed=13, reps=5)
    rated = check_rated_accumulate(bins, src_pos)

    def field(N, seed):
        rng = np.random.RandomState(seed)
        return torch.from_numpy(10 ** rng.uniform(-4, -2, (N,) * 3)).to(
            "cuda", dt)
    nhi = field(N_BENCH, 14)
    flux = 10 ** np.random.RandomState(15).uniform(-1, 0, NS_BENCH)
    for heat in (False, True):
        rt = ChebRaytracer(N_BENCH, R_BENCH, SIG, bins, batch_size=B_BENCH,
                           dtype=dt, fuse_fold=True, do_heating=heat)
        pad = rt.wrap_pad(nhi)
        pos_b, flux_b = rt.prepare_sources(src_pos, flux)
        loop_against_plain(f"bench {'K3h' if heat else 'K3'}", rt, pad,
                           pos_b, flux_b)
        del rt, pad
    # the EoR run's small bucket at a random field, 128 batches
    rt = ChebRaytracer(N_EOR, R_EOR[0], SIG, bins, batch_size=B_EOR,
                       dtype=dt, fuse_fold=True)
    rng = np.random.RandomState(16)
    nb = 128
    pos = rng.randint(0, N_EOR, size=(nb * B_EOR, 3))
    pos[:B_EOR] = (pos[0] + rng.randint(0, 3, (B_EOR, 3))) % N_EOR
    pad = rt.wrap_pad(field(N_EOR, 17))
    pos_b, flux_b = rt.prepare_sources(pos, 10 ** rng.uniform(
        -1, 0, nb * B_EOR))
    loop_against_plain(f"EoR bucket R={R_EOR[0]:.2f} B={B_EOR} "
                       f"Dc={rt.geom.Dc}, {nb} batches", rt, pad, pos_b,
                       flux_b)
    gaps = loop_kernel_gaps(f"EoR bucket R={R_EOR[0]:.2f} B={B_EOR} (K3)", rt,
                            pad, pos_b, flux_b)
    ex = gaps["extract_boxes"]
    chunks["EoR"].update(loop_us_per_launch=ex[0],
                         loop_us_per_batch=ex[0] * ex[2] / nb,
                         loop_launches_per_trace=ex[2])
    del rt, pad
    return rated, chunks


# the kernels of the trace loop by a part of their device names, as
# loop_kernel_gaps names them
LOOP_KERNELS = (("extract_", "extract_boxes"),
                ("init_segments", "init_segments"),
                ("cheb_sweep_kernel", "K1"), ("cheb_sweep_seg", "K2"),
                ("cheb_sweep_gamma", "K1f"), ("sweep_fold", "K3 phase A"),
                ("box_rates", "K3 phase B"), ("rates_dense", "rates_dense"),
                ("rates_he", "rates_he"),
                ("accumulate_boxes", "accumulate_boxes"))


def loop_kernel_gaps(label, rt, pad, pos_b, flux_b):
    """One trace of the C++ loop under torch.profiler: per kernel of the
    loop (LOOP_KERNELS) its median device time, the median idle gap on the
    device before it (from the previous kernel's end) and its share of the
    device time, in us; the loop's device ms per batch and the device's
    idle share between the first kernel's start and the last's end.
    Returns {kernel: (median us, median gap us, count)}."""
    from pyc2ray_torch.diagnostics import _trace_events, profile_trace
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp) as p:
            p["sync"] = rt.trace_extended(pad, pos_b, flux_b, DR)[0]
        ev = sorted((e for events in _trace_events(tmp) for e in events
                     if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    kinds = {}
    for prev, e in zip(ev, ev[1:]):
        name = next((k for part, k in LOOP_KERNELS if part in e["name"]),
                    "other")
        gap = e["ts"] - (prev["ts"] + prev["dur"])
        kinds.setdefault(name, []).append((e["dur"], gap))
    nb = pos_b.shape[0]
    span = ev[-1]["ts"] + ev[-1]["dur"] - ev[0]["ts"]
    busy = sum(e["dur"] for e in ev)
    out = {k: (float(np.median([d for d, _ in v])),
               float(np.median([g for _, g in v])), len(v))
           for k, v in kinds.items()}
    ex = out.get("extract_boxes", (0.0, 0.0, 0))
    log(f"  {label}, the loop on the device per kernel: " + "; ".join(
        f"{k} {d:.2f} us after a gap of {g:.2f} us (median of {n}, "
        f"{sum(x for x, _ in kinds[k]) / busy:.3f} of the kernels' time)"
        for k, (d, g, n) in out.items())
        + f"; {1e-3 * span / nb:.4f} ms per batch from the first kernel's "
        f"start to the last's end, {1e-3 * busy / nb:.4f} ms of it in "
        f"kernels (idle share {1.0 - busy / span:.4f}); "
        f"{len(ev) / nb:.3f} device launches per batch; the "
        f"extract {ex[2]} launches ({ex[2] / nb:.4f} per batch), "
        f"{ex[0] * ex[2] / nb:.3f} us per batch")
    return out


def loop_against_plain(label, rt, pad, pos_b, flux_b, reps=3):
    """``rt.trace_extended`` (the C++ loop in its mode: one
    cheb_trace_sweep call) against ``rt.trace_extended_plain`` on the
    frame ``pad``: bit for bit, with the loop's launch counts
    (``trace_launches``) and the ms per trace of both (CUDA events,
    ``reps`` traces each). Returns max_abs_err, ms and plain_ms."""
    from pyc2ray_torch.ops import sweep
    nb = pos_b.shape[0]
    sweep.reset_launches()
    got = rt.trace_extended(pad, pos_b, flux_b, DR)
    counts = dict(sweep.launches)
    want = rt.trace_extended_plain(pad, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    expect = {k: 0 for k in counts}
    expect.update(trace_launches(rt._sweep_mode(), nb,
                                 extract_chunks(rt, nb)))
    if counts != expect:
        raise RuntimeError(f"{label}: loop launches {counts}, expected "
                           f"{expect}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want)
              if w is not None)
    if err != 0.0 or not float(want[0].max()) > 0.0:
        raise RuntimeError(f"{label}: the loop differs from the plain "
                           f"loop: max_abs_err {err}")
    del got, want
    ms = cuda_ms(lambda: rt.trace_extended(pad, pos_b, flux_b, DR), reps)
    plain_ms = cuda_ms(
        lambda: rt.trace_extended_plain(pad, pos_b, flux_b, DR), reps)
    log(f"  {label}: trace_extended (C++ loop) vs trace_extended_plain: "
        f"max_abs_err={err:.1e} (bit-equal"
        f"{', Gamma and heat' if rt.do_heating else ''}), launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f"; per trace: the loop {ms:.3f} ms, the plain loop "
        f"{plain_ms:.3f} ms ({ms / nb:.4f} / {plain_ms / nb:.4f} ms per "
        f"batch)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def loop_work(rt, pad, pos_b):
    """(bytes, operations) of one trace of engine ``rt`` (one
    cheb_trace_sweep call in its mode) over the batches ``pos_b`` in the
    frame ``pad``, as a function of the whole loop: the frame cells that
    the boxes cover read once; the sweep's tables, K3's rates table (its
    valid channel, the rest at the valid cells) or the rate pass's list of
    rated cells and path3 and geominv at them, the fluxes and the bins
    once; the Gamma (and heat) frame written once. The boxes that pass
    between the loop's kernels are none of its bytes. Operations per batch:
    the sweep's (``sweep_work``), the rates' of this data (the dense pass's
    of ``dense_work`` on the first batch's boxes, on fields as smooth as
    phase 3's every batch rates the same cells; K3's per valid table cell)
    and the accumulate's adds."""
    from pyc2ray_torch.ops.sweep import cheb_sweep
    from pyc2ray_torch.ops.trace_loop import extract_boxes, stage_positions
    g, tb, dt, heat = rt.geom, rt.tables, rt.dtype, rt.do_heating
    isz = torch.finfo(dt).bits // 8
    nb, B = pos_b.shape[:2]
    mode = rt._sweep_mode()
    if mode["fuse"] == "rates":
        raise ValueError("loop_work: no count for fuse_rates")
    pos = stage_positions(pos_b, pad.shape, g.Dc, "cuda")
    covered = torch.zeros(pad.numel(), dtype=torch.bool, device="cuda")
    for k in range(nb):
        covered[box_flat_index(pos[k], pad.shape, g.Dc).view(-1)] = True
    sb, sops = sweep_work(B, g.Dc, g.r_max + 1, dt)
    tables = sb - 2 * B * g.Dc ** 3 * isz          # its tables alone
    if mode["fuse"] == "fold":
        n_valid = int((tb.rt_tab[:, 1] > 0.5).sum())
        tables += isz * (g.Dc ** 3 + n_valid)
        rops = B * n_valid * (
            (RATE_OPS_PER_BIN + heat * HEAT_OPS_PER_BIN) * rt.num_bins
            + RATE_OPS_PER_CELL + heat * HEAT_OPS_PER_CELL)
        side = g.Dc
    else:
        boxes = extract_boxes(pad, pos, 0, g.Dc)
        cd = cheb_sweep(boxes, tb.sw, tb.path, tb.diag, tb.mask_m,
                        tb.mask_p, DR, g.c, rt.sig)
        _, rops, _ = dense_work(rt, cd, boxes, heat)
        n_valid = rt.rated_cells.numel()
        tables += 4 * n_valid + isz * 2 * n_valid
        side = rt.Ds
    nbytes = tables + isz * (int(covered.sum()) + (1 + heat) * pad.numel()
                             + nb * B + (2 + heat) * rt.num_bins)
    return nbytes, nb * (sops + rops + B * side ** 3)


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


@contextlib.contextmanager
def plain_chemistry():
    """Within the block the model layer's timestep loops (evolve3D,
    evolve3D_he) run the chemistry passes' plain versions on the card
    (global_pass_ref, global_pass_he_ref): the passes as the port issued
    them before the kernels, ~30 launches and one host synchronisation per
    inner iteration."""
    import pyc2ray_torch.evolve as ev
    from pyc2ray_torch.ops import chemistry, chemistry_he
    saved = ev.global_pass, chemistry_he.global_pass_he
    ev.global_pass = chemistry.global_pass_ref
    chemistry_he.global_pass_he = chemistry_he.global_pass_he_ref
    try:
        yield
    finally:
        ev.global_pass, chemistry_he.global_pass_he = saved


def pass_profile(fn):
    """``fn()`` under torch.profiler: the device kernels, memsets and
    device-to-host copies it ran, and inside its span the host's kernel
    launch calls and synchronisations (CUDA runtime calls named
    *LaunchKernel, *Synchronize)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from pyc2ray_torch.diagnostics import _trace_events
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("chemistry pass"):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(tmp, "pass.json"))
        events = _trace_events(tmp)[0]
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == "chemistry pass")
    lo, hi = span["ts"], span["ts"] + span["dur"]

    def runtime(word):
        return sum(e.get("cat") == "cuda_runtime" and lo <= e["ts"] <= hi
                   and word in e["name"] for e in events)
    out = dict(
        kernels=sum(e.get("cat") == "kernel" for e in events),
        memsets=sum(e.get("cat") == "gpu_memset" for e in events),
        d2h=sum(e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
                for e in events),
        syncs=runtime("Synchronize"), launch_calls=runtime("LaunchKernel"))
    out["device_events"] = bool(out["kernels"] + out["memsets"] + out["d2h"])
    return out


def iteration_text(its, cap):
    """The distribution of the iterations each cell took (int32 tensor)."""
    h = torch.bincount(its.reshape(-1).long()).cpu().numpy()
    n = h.sum()
    k = np.arange(h.size)
    med = int(np.searchsorted(np.cumsum(h), (n + 1) / 2))
    edges = (1, 2, 3, 4, 5, 9, 17, 33, 65, 129, cap + 1)
    bins = ", ".join(f"{a}-{b - 1}: {int(h[a:b].sum())}" if b - 1 > a
                     else f"{a}: {int(h[a:b].sum())}"
                     for a, b in zip(edges, edges[1:]) if h[a:b].sum())
    return (f"iterations per cell min {int(k[h > 0].min())}, median {med}, "
            f"mean {float((h * k).sum() / n):.3f}, max {int(k[h > 0].max())}"
            f", at the cap of {cap} {int(h[cap]) if h.size > cap else 0}; "
            f"cells by iterations {bins}")


def sass_functions(lib_path):
    """The SASS of a built library (the toolkit's cuobjdump -sass): {function
    name: [(address, instruction, branch target address or None)]}."""
    from pyc2ray_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return parse_sass(subprocess.run(
        [tool, "-sass", str(lib_path)], capture_output=True, text=True,
        check=True, timeout=300).stdout)


def parse_sass(text):
    """``sass_functions`` of cuobjdump's text ``text``."""
    funcs, labels = {}, {}
    name, pending = None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name, pending = m.group(1), []
            funcs[name], labels[name] = [], {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if name is None or m:
            pending += [m.group(1)] if m else []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr, ins = int(m.group(1), 16), m.group(2)
        for lab in pending:
            labels[name][lab] = addr
        pending = []
        t = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b)",
                      ins)
        target = None if t is None else (t.group(1) or int(t.group(2), 16))
        funcs[name].append((addr, ins, target))
    return {n: [(a, i, labels[n].get(t) if isinstance(t, str) else t)
                for a, i, t in ins] for n, ins in funcs.items()}


def _path_counts(ins, at, bodies=False):
    """``shortest(i0, i1)``: the fewest instructions from ins[i0] to
    ins[i1] inclusive over forward edges (a backward branch falls through),
    as (instructions, MUFU, float64 DADD/DMUL/DFMA, subroutine calls) of
    that path; the local loads and stores of spilled registers (LDL, STL)
    are not counted. A branch on the warp's divergence (BRA.DIV, BRA.CONV)
    may fall through. With ``bodies`` a call of a subroutine of the listing
    (CALL.REL to an address in it) also counts the shortest path through
    the subroutine, from its address to its first RET, once per call (and
    the call among the calls)."""
    memo = {}

    def body(i0):
        if i0 not in memo:
            memo[i0] = (0, 0, 0, 0)       # a recursive call counts 0
            i1 = next((i for i in range(i0, len(ins))
                       if re.match(r"RET\b", ins[i][1])), None)
            memo[i0] = (0, 0, 0, 0) if i1 is None else shortest(i0, i1)
        return memo[i0]

    def cost(j):
        one = ins[j:j + 1]
        c = (1 - n_spill(one), n_mufu(one), n_dp(one), 0)
        m = re.match(r"CALL\.REL\S*\s+0x([0-9a-f]+)", ins[j][1])
        if bodies and m and int(m.group(1), 16) in at:
            b = body(at[int(m.group(1), 16)])
            c = (c[0] + b[0], c[1] + b[1], c[2] + b[2], b[3] + 1)
        return c

    def shortest(i0, i1):
        inf = (float("inf"), 0, 0, 0)
        dist = {i0: cost(i0)}
        for i in range(i0, i1 + 1):
            d = dist.get(i, inf)
            if d[0] == inf[0] or i == i1:
                continue
            a, op, t = ins[i]
            # BRA.DIV and BRA.CONV branch on the warp's divergence
            uncond = re.match(r"(BRA(?!\.(?:DIV|CONV))|EXIT|RET)\b",
                              op) is not None
            nxt = []
            if not uncond:
                nxt.append(i + 1)
            if isinstance(t, int) and t > a and t in at and at[t] <= i1:
                nxt.append(at[t])
            for j in nxt:
                cand = tuple(x + y for x, y in zip(d, cost(j)))
                if cand[0] < dist.get(j, inf)[0]:
                    dist[j] = cand
        return dist.get(i1, inf)
    return shortest


def n_mufu(r):
    """MUFU (transcendental unit) instructions of the SASS lines ``r``."""
    return sum(bool(re.search(r"\bMUFU\.", x[1])) for x in r)


def n_spill(r):
    """Local loads and stores (LDL, STL: spilled registers) of ``r``."""
    return sum(bool(re.match(r"(LDL|STL)\b", x[1])) for x in r)


def n_dp(r):
    """Instructions of ``r`` on the float64 pipe's arithmetic (DADD, DMUL,
    DFMA)."""
    return sum(bool(re.search(r"\bD(ADD|MUL|FMA)\b", x[1])) for x in r)


def backward_loops(ins):
    """The (head, back-edge) addresses of the SASS ``ins``' backward
    branches: each closes a loop."""
    return [(t, a) for a, _, t in ins if isinstance(t, int) and t < a]


def loop_counts(ins, cells=1, bodies=False):
    """Instructions of a chemistry kernel's loops from its SASS
    (``sass_functions``): the inner loop, the smallest region closed by a
    backward branch that holds a MUFU (transcendental) instruction, and the
    work around it per cell. A thread of ``cells`` cells whose loop over
    them the compiler unrolled has one copy of the inner loop per cell (the
    innermost MUFU loops, in address order); the work per cell is then the
    shortest path through the smallest loop around all the copies (the
    cells' loads, the rates, the stores) over its segments between them,
    divided by ``cells``; with one copy, the smallest loop around it (the
    loop over cells). Returns {"iter", "cell"}: the fewest instructions a
    lane issues per iteration of the inner loop and per cell around it (the
    shortest path through each region's forward branches: a lower bound,
    the slow paths, the sides of a branch that the path skips and spills
    not counted; "cell" None where no loop around has a forward path
    through it), with "mufu_iter"/"dp_iter" the MUFU and float64
    DADD/DMUL/DFMA instructions on the iteration's path; "iter_static",
    "cell_static": every instruction of each region once (an upper
    estimate: a warp whose lanes part runs both sides of a branch). With
    ``bodies`` the paths count the subroutines they call (``_path_counts``;
    "calls_iter" the calls on the iteration's path; the static counts do
    not)."""
    loops = backward_loops(ins)
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    shortest = _path_counts(ins, at, bodies)

    def region(lo, hi):
        return [x for x in ins if lo <= x[0] <= hi]
    with_mufu = [lp for lp in loops if n_mufu(region(*lp)) > 0]
    if not with_mufu:
        raise RuntimeError(f"SASS: no loop with a MUFU instruction among "
                           f"{len(loops)} backward branches of "
                           f"{len(ins)} instructions")
    inner = min(with_mufu, key=lambda lp: lp[1] - lp[0])
    r_in = region(*inner)
    h, l = at[inner[0]], at[inner[1]]
    it = shortest(h, l)
    out = dict(iter=it[0], mufu_iter=it[1], dp_iter=it[2], calls_iter=it[3],
               iter_static=len(r_in), cell=0, cell_static=0)
    copies = sorted(lp for lp in with_mufu if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in with_mufu))
    if len(copies) != cells:
        copies, cells = [inner], 1
    around = sorted((lp for lp in loops if lp not in copies
                     and lp[0] <= copies[0][0] and lp[1] >= copies[-1][1]),
                    key=lambda lp: lp[1] - lp[0])
    if not around:
        return out
    out["cell"] = None
    for outer in around:
        # from the loop's head to the first copy's head, between copies,
        # from the last copy's end to the back-edge; a copy's head is
        # counted by its iterations
        ends = [at[outer[0]]] + [i for c in copies
                                 for i in (at[c[0]], at[c[1]] + 1)] \
            + [at[outer[1]]]
        segs = [shortest(a, b) for a, b in zip(ends[::2], ends[1::2])]
        if any(sg[0] == float("inf") for sg in segs):
            continue
        heads = sum(1 - n_spill(ins[at[c[0]]:at[c[0]] + 1]) for c in copies)
        out["cell"] = (sum(sg[0] for sg in segs) - heads) / cells
        out["cell_static"] = (len(region(*outer)) - sum(
            len(region(*c)) for c in copies)) / cells
        break
    return out


def bin_loops(ins):
    """The bin loops of a rate-pass kernel from its SASS: every backward
    branch's region that holds a MUFU instruction and no smaller such
    region. Returns {"loops": [{"iter", "static", "mufu", "dp", "bins"}]
    in ascending instructions a bin, "cell"}: per
    loop the shortest path through one iteration (``loop_counts``'s rule)
    with its MUFU and float64 instructions, every instruction of the loop
    once ("static"), and the bins an iteration handles (its divisions, one
    a bin: a float32 IEEE division checks its range with FCHK, a float64
    one starts from MUFU.RCP64H); per listed cell the shortest path from
    the kernel's first instruction to its last EXIT (the block's load of
    the bins once, the loops skipped where a branch skips them: a lower
    bound)."""
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    shortest = _path_counts(ins, at)

    def region(lo, hi):
        return [x for x in ins if lo <= x[0] <= hi]
    cand = [lp for lp in backward_loops(ins) if n_mufu(region(*lp)) > 0]
    inner = [lp for lp in cand
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in cand)]
    loops = []
    for lo, hi in inner:
        p = shortest(at[lo], at[hi])
        r = region(lo, hi)
        bins = sum(bool(re.search(r"\b(FCHK|MUFU\.RCP64H)\b", x[1]))
                   for x in r)
        if bins < 1:
            raise RuntimeError(f"SASS: a bin loop at {lo:#x} without a "
                               f"division")
        loops.append(dict(iter=p[0], static=len(r), mufu=p[1], dp=p[2],
                          bins=bins))
    if not loops:
        raise RuntimeError("SASS: no bin loop with a MUFU instruction")
    loops.sort(key=lambda d: d["iter"] / d["bins"])
    last_exit = max(i for i, x in enumerate(ins)
                    if re.match(r"EXIT\b", x[1]))
    c = shortest(0, last_exit)
    return dict(loops=loops, cell=c[0])


def sass_issue_s(n_cells, cell, loops):
    """The time in s a kernel's own instructions take at the card's issue
    rate (``issue_rate``): ``n_cells`` threads x ``cell`` instructions each
    and ``loops`` [(passes, instructions a pass)], from its SASS
    (``loop_counts``, ``bin_loops``), 32 lanes to a warp-instruction, every
    lane busy. A diagnostic of the kernel, not a bound of its function: it
    moves with the kernel's code."""
    tot = n_cells * cell + sum(n * per for n, per in loops)
    return tot / 32 / issue_rate()[0]


def mufu_s(n):
    """The least time in s of ``n`` transcendentals, each at least one
    instruction of the MUFU pipe: 16 lanes a clock per SM at the largest
    SM clock."""
    _, mhz, sms = issue_rate()
    return n / (16 * sms * mhz * 1e6)


def function_bound(nbytes, t_ops, n_mufu):
    """The bound of a function on the card from what it needs, whatever
    kernel runs it: the largest of its bytes at the memory rate, its
    operations at the peaks of their types (``t_ops`` s, a transcendental
    one operation) and its ``n_mufu`` transcendentals on the MUFU pipe
    (``mufu_s``). Returns (ms, "bytes" or "operations", which part binds,
    {"bytes", "flops", "mufu": ms})."""
    parts = dict(bytes=1e3 * nbytes / H100_BYTES_PER_S, flops=1e3 * t_ops,
                 mufu=1e3 * mufu_s(n_mufu))
    binds = max(parts, key=parts.get)
    return (parts[binds], "bytes" if binds == "bytes" else "operations",
            binds, parts)


_SASS = {}


def chem_instructions(helium, dtype, heat=False, rec=False):
    """``loop_counts`` of the chemistry kernel of csrc/chemistry.cu that a
    pass of ``dtype`` launches (the helium kernel with its options), from
    the SASS of the built library; cached."""
    from pyc2ray_torch.ops import _build
    if "funcs" not in _SASS:
        _SASS["funcs"] = sass_functions(_build._so_path("chemistry"))
    t = "f" if dtype == torch.float32 else "d"
    want = (f"helium_pass_kernelI{t}Lb{int(heat)}ELb{int(rec)}E" if helium
            else f"hydrogen_pass_kernelI{t}E")
    name = next(n for n in _SASS["funcs"] if want in n)
    # a hydrogen thread takes two cells at a time (csrc/chemistry.cu)
    cells = 1 if helium else 2
    return loop_counts(_SASS["funcs"][name], cells)


# the thermal update's design steps (csrc/thermal.cuh's run_form, launched
# by csrc/thermal_probe.cu's thermal_probe_f32/_f64 with its form's index):
# (row, text, nsub, Compton, steps: kFold 1, kRcp 2, kPair 4, kZeroNum 16,
# kSelect 32), nsub 0 and Compton -1 read at run time; the last the
# engine's kernel
THERMAL_FORMS = (
    ("0", "the first port's body (nsub and Compton at run time, every "
     "division, two pow)", 0, -1, 0),
    ("a", "nsub and Compton fixed, the tangent's identities folded", 16, 1,
     1),
    ("b", "+ the reciprocals", 16, 1, 3),
    ("c", "+ the pow pair", 16, 1, 7),
    ("d", "+ zero numerators by a product", 16, 1, 23),
    ("e", "+ phi1 by a select (the engine's kernel)", 16, 1, 55),
)


def thermal_instructions(dtype, form=None):
    """The thermal kernel's own instructions from its SASS: the engine's
    kernel that 3c's update launches (csrc/thermal.cu: nsub 16, Compton
    on, every step) or the probe's design step ``form`` (THERMAL_FORMS).
    ``loop_counts`` with each subroutine's body counted once per call
    (libdevice's float64 pow is one, CALL.REL): per substep the shortest
    path through the substep loop ("substep", with "mufu" and "dp": its
    MUFU and float64 DADD/DMUL/DFMA, "calls" the subroutines it calls), per
    cell the path around the loop ("cell"), "static" every instruction of
    the loop once (the bodies not counted); cached."""
    from pyc2ray_torch.ops import _build
    lib = "thermal" if form is None else "thermal_probe"
    if lib not in _SASS:
        _SASS[lib] = sass_functions(_build._so_path(lib))
    t = "f" if dtype == torch.float32 else "d"
    if form is None:
        pat = rf"thermal_kernelI{t}Li16ELi1ELj\d+E"
    else:
        _, _, nsub, comp, bits = THERMAL_FORMS[form]
        pat = (rf"thermal_kernelI{t}Li{nsub}EL"
               + ("in1" if comp < 0 else f"i{comp}") + rf"ELj{bits}E")
    name = next(n for n in _SASS[lib] if re.search(pat, n))
    lc = loop_counts(_SASS[lib][name], bodies=True)
    return dict(substep=lc["iter"], mufu=lc["mufu_iter"], dp=lc["dp_iter"],
                calls=lc["calls_iter"], static=lc["iter_static"],
                cell=lc["cell"])


def dp_s(n):
    """The least time in s of ``n`` float64 DADD/DMUL/DFMA lane operations
    on the float64 pipe: 64 lanes a clock per SM at the largest SM clock."""
    _, mhz, sms = issue_rate()
    return n / (64 * sms * mhz * 1e6)


def thermal_sass_ms(n, nsub, sass):
    """The ms of ``n`` cells' thermal update of ``nsub`` substeps in the
    kernel's own SASS (``thermal_instructions``): at the issue rate
    (``sass_issue_s``) and on the float64 pipe (``dp_s``, 0 in float32)."""
    if sass["cell"] is None:
        return None, 1e3 * dp_s(n * nsub * sass["dp"])
    return (1e3 * sass_issue_s(n, sass["cell"], [(n * nsub,
                                                   sass["substep"])]),
            1e3 * dp_s(n * nsub * sass["dp"]))


def rates_he_instructions(dtype, heat):
    """``bin_loops`` of the helium rate pass's kernel (rates_he_kernel of
    csrc/cheb_rates_he.cuh in the cheb_rates library) of ``dtype``, with
    or without the heat channel; cached."""
    from pyc2ray_torch.ops import _build
    if "rates" not in _SASS:
        _SASS["rates"] = sass_functions(_build._so_path("cheb_rates"))
    t = "f" if dtype == torch.float32 else "d"
    want = f"rates_he_kernelI{t}Lb{int(heat)}E"
    name = next(n for n in _SASS["rates"] if want in n)
    return bin_loops(_SASS["rates"][name])


def he_rates_sass(rt, rated, heat):
    """The time one helium rate pass of engine ``rt`` over ``rated`` rated
    cells takes at the issue rate in the kernel's own SASS
    (``rates_he_instructions``, ``sass_issue_s``): every listed cell once
    and every rated cell once per bin, a bin of a loop as many instructions
    as the loop's iteration over the bins it handles. A kernel with a loop
    per number of species' terms (bins by band) runs each band's bins in
    its loop, the bands those of ``cheb_rates.he_first_bins`` (L1, L2, L3
    bins with 1, 2, 3 species' terms); any other (one loop, every bin all
    three species) all the bins at the fewest instructions a bin. Returns
    (s, the SASS counts, the bands or None)."""
    sass = rates_he_instructions(rt.dtype, heat)
    heb = rt.he_tables
    E = heb.se.shape[1]
    loops = sass["loops"]
    per_bin = [lp["iter"] / lp["bins"] for lp in loops]
    bands = None
    if len(loops) == 3:
        from pyc2ray_torch.ops.cheb_rates import he_first_bins
        first = he_first_bins(heb.se, heb.w_se, heb.wh_se if heat else None)
        k = [sum(e >= f for f in first) for e in range(E)]
        bands = [k.count(j) for j in (1, 2, 3)]
        work = [(rated * n, p) for n, p in zip(bands, per_bin)]
    else:
        work = [(rated * E, per_bin[0])]
    n_listed = rt.batch_size * rt.eng.rated_cells.numel()
    return sass_issue_s(n_listed, sass["cell"], work), sass, bands


def issue_rate():
    """Warp-instructions per second the card issues: SMs x 4 schedulers x
    the largest SM clock nvidia-smi reports; and that clock in MHz."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 4 * mhz * 1e6, mhz, sms


def lane_efficiency(its):
    """Sum of the cells' iterations over the sum, over the kernel's warps of
    32 consecutive cells, of 32 x the warp's largest iteration count."""
    flat = its.reshape(-1).long()
    n = flat.numel()
    padded = torch.zeros(-(-n // 32) * 32, dtype=torch.long,
                         device=flat.device)
    padded[:n] = flat
    worst = padded.view(-1, 32).amax(1)
    return float(flat.sum()) / float(32 * worst.sum())


# operations of a chemistry pass, a transcendental counted as one: per cell
# once (the temperature's rates, the count's test) and per iteration of a
# cell (n_e, doric's rates and closed form with float32's 10-term series,
# the clamps, the convergence test); the helium pass adds per iteration
# its rates, clamps and tests in the fields' type and the 2x2 solve in
# float64, and the options their channels
CHEM_OPS = {"cell": 12, "iter": 45, "he_cell": 16, "he_iter": 40,
            "he_iter_f64": 105, "heat": 14, "rec": 30}
# transcendentals of a chemistry pass that its function needs whatever the
# data, each at least one MUFU instruction on the card: a float32 exp,
# expm1, sqrt or division one and a float32 pow two; a float64 division or
# sqrt one, a float64 exp, expm1 or pow none (the float64 pipe's). Per cell
# (h: the temperature's rates, the count's test; he: with the helium
# rates') and per iteration (h: doric's equilibrium and float32 expm1, the
# test; he: the same, the helium pair's discriminant and 1 / (l1 - l2)
# in float64, two more tests; heat: the four pow of the secondary
# ionisation; rec: the recycling's four divisions). A term on one side of
# a branch is not counted.
CHEM_MUFU = {torch.float32: {"h_cell": 6, "h_iter": 3, "he_cell": 16,
                             "he_iter": 7, "heat": 8, "rec": 4},
             torch.float64: {"h_cell": 3, "h_iter": 2, "he_cell": 7,
                             "he_iter": 6, "heat": 0, "rec": 4}}
# the thermal update (ops/thermal.py): operations per cell (the heating,
# the heat capacity, the densities) and per substep (the five cooling
# terms and their derivatives, Compton's, the relaxation step and its
# clamp), a transcendental counted as one
THERMAL_OPS = {"cell": 10, "substep": 100}
# its transcendentals on the MUFU pipe whatever the data, as CHEM_MUFU
# counts them: per cell the heat capacity's reciprocal; per substep two
# sqrt, two pow (two each in float32), two exp and five divisions (1 / T,
# the two sqrt's derivatives, the Ly-alpha quotient and its derivative);
# phi1's expm1 and division sit on one side of a branch and are not
# counted
THERMAL_MUFU = {torch.float32: {"cell": 1, "substep": 13},
                torch.float64: {"cell": 1, "substep": 7}}


def chemistry_check(label, helium, args, kw, reps=10):
    """The chemistry kernel (``helium``: the helium pass) against its plain
    version on the card on the pass ``args``, ``kw``: every output bit for
    bit (max_abs_err 0, asserted) and one kernel launch per pass, no host
    synchronisation (the profiler; asserted); kernel and plain ms per pass
    (CUDA events), the bound from this data's bytes and iterations, and the
    per-cell iteration distribution. Returns the kernels line's numbers
    and the iterations (int32)."""
    from pyc2ray_torch.ops import chemistry as ch, chemistry_he as che, sweep
    kern, plain, launch, name, mod = (
        (che.global_pass_he, che.global_pass_he_ref, che._pass_he_cuda,
         "chemistry_pass_he", che) if helium else
        (ch.global_pass, ch.global_pass_ref, ch._pass_cuda,
         "chemistry_pass", ch))
    sweep.reset_launches()
    got = kern(*args, **kw)
    n_launch = sweep.launches[name]
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got[:-1], want[:-1]))
    if not equal or n_launch != 1:
        raise RuntimeError(f"{label}: {name} differs from its plain version "
                           f"(max abs {err:.3e}, counts {int(got[-1])} and "
                           f"{int(want[-1])}) or launched {n_launch} times")
    xh = args[3]
    its = torch.empty(xh.shape, dtype=torch.int32, device=xh.device)
    launch(*args, **kw, iterations=its)
    ms = cuda_ms(lambda: kern(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), 1)
    pk, pp = pass_profile(lambda: kern(*args, **kw)), \
        pass_profile(lambda: plain(*args, **kw))
    # the device's kernels where the capture holds device records, else the
    # host's launch calls: some captures of this single kernel held no
    # device record on the card (PERF.md, open questions)
    n_kern = pk["kernels"] if pk["device_events"] else pk["launch_calls"]
    if n_kern != 1 or pk["syncs"] or pk["d2h"]:
        raise RuntimeError(f"{label}: {name} pass ran {pk} on the device, "
                           f"expected one kernel and no host sync")
    # bytes: every distinct input tensor read once, the outputs written
    fields = {t.data_ptr(): t for t in (*args, *kw.values())
              if isinstance(t, torch.Tensor) and t.dim() > 0}
    nbytes = sum(t.numel() * t.element_size() for t in fields.values()) \
        + sum(t.numel() * t.element_size() for t in got)
    n, n_it = xh.numel(), float(its.double().sum())
    heat, rec = (kw.get("heat") is not None,
                 bool(kw.get("recombination_photons")))
    ops, ops64 = CHEM_OPS["cell"] * n + CHEM_OPS["iter"] * n_it, 0.0
    if helium:
        per = CHEM_OPS["he_iter"] + CHEM_OPS["heat"] * heat \
            + CHEM_OPS["rec"] * rec
        ops += CHEM_OPS["he_cell"] * n + per * n_it
        ops64 = CHEM_OPS["he_iter_f64"] * n_it
    peak = H100_F32_FLOPS if xh.dtype == torch.float32 else H100_F64_FLOPS
    mu = CHEM_MUFU[xh.dtype]
    n_mufu = (mu["he_cell"] * n + (mu["he_iter"] + mu["heat"] * heat
                                   + mu["rec"] * rec) * n_it if helium
              else mu["h_cell"] * n + mu["h_iter"] * n_it)
    t_flops = ops / peak + ops64 / H100_F64_FLOPS
    b_ms, b_by, binds, parts = function_bound(nbytes, t_flops, n_mufu)
    # beside it, what the kernel's own SASS takes at the issue rate: the
    # cell loop once per cell and the inner loop once per iteration
    sass = chem_instructions(helium, xh.dtype, heat, rec)
    issue_ms = None if sass["cell"] is None else 1e3 * sass_issue_s(
        n, sass["cell"], [(n_it, sass["iter"])])
    issue_text = ("not counted (no loop around the inner loop has a forward "
                  "path through it)" if issue_ms is None else
                  f"{issue_ms:.5f} ms, the kernel at {issue_ms / ms:.3f} of "
                  f"it")
    lane_eff = lane_efficiency(its)
    log(f"  {label}: {name} bit-equal to its plain version (max_abs_err "
        f"{err:g}, count {int(got[-1])}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms per pass, bound {b_ms:.5f} ms ({binds} binds), "
        f"the kernel at {b_ms / ms:.3f} of it; per pass "
        f"kernel {pk['kernels']} device kernel(s), {pk['memsets']} "
        f"memset(s), {pk['launch_calls']} launch call(s), {pk['syncs']} host "
        f"syncs; plain {pp['kernels']} kernels, {pp['launch_calls']} launch "
        f"calls, {pp['syncs']} host syncs, {pp['d2h']} D2H copies"
        + ("" if pk["device_events"] else " (no device event captured)"))
    log(f"    {iteration_text(its, mod.MAX_INNER_ITER)}")
    log(f"    iterations per cell {n_it / n:.4f}, lane efficiency "
        f"{lane_eff:.4f} (the iterations over 32 x each warp's largest, "
        f"warps of 32 consecutive cells); the bound of the function is the "
        f"largest of: bytes {parts['bytes']:.5f} ms ({nbytes / 1e9:.4f} GB), "
        f"flops {parts['flops']:.5f} ms ({(ops + ops64) / 1e9:.3f} Gop, a "
        f"transcendental one operation), MUFU {parts['mufu']:.5f} ms "
        f"({n_mufu / 1e9:.4f} G transcendentals at 16 lanes a clock per "
        f"SM); the kernel's own SASS at the issue rate {issue_text}: "
        f"{sass['iter']} instructions per iteration on the shortest path "
        f"without spills "
        f"({sass['mufu_iter']} MUFU, {sass['dp_iter']} float64 "
        f"DADD/DMUL/DFMA; {sass['iter_static']} in the loop), "
        f"{sass['cell']} per cell around them ({sass['cell_static']} "
        f"static)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_binds=binds, bound_share=b_ms / ms,
                max_abs_err=err, launches_per_pass=n_kern,
                plain_launches_per_pass=pp["kernels"],
                plain_syncs_per_pass=pp["syncs"],
                iterations_per_cell=n_it / n, lane_efficiency=lane_eff,
                byte_bound_ms=parts["bytes"], flop_bound_ms=parts["flops"],
                mufu_bound_ms=parts["mufu"],
                issue_ms_at_own_sass=issue_ms,
                sass_per_iteration=sass["iter"],
                sass_per_cell=sass["cell"]), its


def thermal_check(label, args, kw, reps=10):
    """The thermal kernel against update_temperature_ref on the card on the
    update ``args``, ``kw``: bit for bit (max_abs_err 0, asserted), one
    kernel launch an update and no host synchronisation (the profiler;
    asserted); ms per update of the kernel (CUDA events) and of the plain
    version, the bound of the function (``function_bound``: its bytes,
    THERMAL_OPS at the peak of the type and THERMAL_MUFU on the MUFU
    pipe) and beside it the kernel's own SASS (``thermal_instructions``) at
    the issue rate and on the float64 pipe. Returns the kernels line's
    numbers and the plain version's result."""
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.thermal import (update_temperature,
                                           update_temperature_ref)
    sweep.reset_launches()
    got = update_temperature(*args, **kw)
    n_launch = sweep.launches["thermal_update"]
    want = update_temperature_ref(*args, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want) or n_launch != 1:
        ulp = float(((got - want).abs()
                     / torch.finfo(got.dtype).eps / want.abs()).max())
        raise RuntimeError(f"{label}: update_temperature differs from its "
                           f"plain version (max abs {err:.3e}, {ulp:.2f} "
                           f"ulp, {int((got != want).sum())} cells) or "
                           f"launched {n_launch} times")
    ms = cuda_ms(lambda: update_temperature(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: update_temperature_ref(*args, **kw), 1)
    prof = pass_profile(lambda: update_temperature(*args, **kw))
    n_kern = prof["kernels"] if prof["device_events"] else \
        prof["launch_calls"]
    if n_kern != 1 or prof["syncs"] or prof["d2h"]:
        raise RuntimeError(f"{label}: the update ran {prof} on the device, "
                           f"expected one kernel and no host sync")
    temp = args[1]
    n, nsub = temp.numel(), kw.get("nsub", 16)
    nbytes = 5 * n * temp.element_size()
    peak = H100_F32_FLOPS if temp.dtype == torch.float32 else H100_F64_FLOPS
    ops = THERMAL_OPS["cell"] * n + THERMAL_OPS["substep"] * n * nsub
    mu = THERMAL_MUFU[temp.dtype]
    n_mufu = mu["cell"] * n + mu["substep"] * n * nsub
    b_ms, b_by, binds, parts = function_bound(nbytes, ops / peak, n_mufu)
    sass = thermal_instructions(temp.dtype)
    issue_ms, dp_ms = thermal_sass_ms(n, nsub, sass)
    log(f"  {label}: thermal_update bit-equal to update_temperature_ref "
        f"(max_abs_err {err:g}), {n_kern} kernel a call, {prof['syncs']} "
        f"host syncs; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
        f"update; bound of the function {b_ms:.5f} ms ({binds} binds: bytes "
        f"{parts['bytes']:.5f} ms ({nbytes / 1e9:.4f} GB), flops "
        f"{parts['flops']:.5f} ms ({ops / 1e9:.3f} Gop), MUFU "
        f"{parts['mufu']:.5f} ms ({n_mufu / 1e9:.4f} G)), the kernel at "
        f"{b_ms / ms:.3f} of it; T {float(got.min()):.1f}.."
        f"{float(got.max()):.1f} K")
    log(f"    the kernel's own SASS (subroutines counted once a call): "
        f"{sass['substep']:g} "
        f"instructions a substep of a cell on the shortest path "
        f"({sass['mufu']:g} MUFU, {sass['dp']:g} float64 DADD/DMUL/DFMA, "
        f"{sass['calls']:g} calls; {sass['static']:g} in the loop), "
        f"{sass['cell']} a cell around them: at the issue rate "
        + ("not counted" if issue_ms is None else
           f"{issue_ms:.5f} ms, the kernel at {issue_ms / ms:.3f} of it")
        + (f"; on the float64 pipe {dp_ms:.5f} ms, the kernel at "
           f"{dp_ms / ms:.3f} of it" if sass["dp"] else ""))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_binds=binds, bound_share=b_ms / ms, max_abs_err=err,
                launches_per_update=n_kern, byte_bound_ms=parts["bytes"],
                flop_bound_ms=parts["flops"], mufu_bound_ms=parts["mufu"],
                issue_ms_at_own_sass=issue_ms, dp_pipe_ms=dp_ms,
                sass_per_substep=sass["substep"],
                mufu_per_substep=sass["mufu"], dp_per_substep=sass["dp"],
                sass_per_cell=sass["cell"]), want


# the exponents of the pow pair's check, each p with p - 1: the default
# -0.7 and ATen's special ones (the thermal tests' ALBPOW but 0, whose
# x^0 no pow computes)
PAIR_EXPONENTS = (-0.7, 0.5, 1.5, -0.5, -1.0, 2.0, 3.0, 4.0, -2.0)


def thermal_pair_check(n64=10 ** 8, seed=22):
    """csrc/thermal.cuh's pow_pair against powf and pow bit for bit on the
    card (csrc/thermal_probe.cu's thermal_pair_check): every float32 base in
    [1e-4, 1e5] and ``n64`` float64 bases 10^U(-4, 5) (a seeded generator on
    the card, 10^7 at a time), each at (p, p - 1) for every p of
    PAIR_EXPONENTS rounded to the type. Returns {"f32", "f64": (bases,
    results whose bits differ)}."""
    import ctypes
    from pyc2ray_torch.ops import _build
    from pyc2ray_torch.ops.chemistry import _raise_on
    lib = _build.load("thermal_probe")
    ys = [v for p in PAIR_EXPONENTS for v in (p, p - 1.0)]
    ys = (ctypes.c_double * len(ys))(*ys)
    stream = torch.cuda.current_stream().cuda_stream
    lo = np.float32(1e-4)
    lo = lo if lo >= 1e-4 else np.nextafter(lo, np.float32(1))
    hi = np.float32(1e5)
    lo_bits = int(lo.view(np.uint32))
    n32 = int(hi.view(np.uint32)) - lo_bits + 1
    out = {}
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    _raise_on(lib, "thermal_pair_check_f32", lib.thermal_pair_check_f32(
        None, n32, lo_bits, ys, len(ys), bad.data_ptr(), stream))
    out["f32"] = (n32, int(bad))
    bad.zero_()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    done = 0
    while done < n64:
        m = min(10 ** 7, n64 - done)
        x = 10.0 ** (torch.rand(m, dtype=torch.float64, device="cuda",
                                generator=gen) * 9.0 - 4.0)
        _raise_on(lib, "thermal_pair_check_f64", lib.thermal_pair_check_f64(
            x.data_ptr(), m, 0, ys, len(ys), bad.data_ptr(), stream))
        done += m
    out["f64"] = (n64, int(bad))
    return out


def thermal_design_steps(label, args, kw, want, reps):
    """3c's design steps of the thermal update (THERMAL_FORMS, the forms of
    csrc/thermal_probe.cu) on the update ``args``, ``kw`` (nsub 16, Compton
    on): each form's output against the plain version's ``want``
    (max_abs_err 0, asserted), ms per update by CUDA events over ``reps``
    updates, and its own SASS (``thermal_instructions``) at the issue rate
    and on the float64 pipe. Returns {row: dict(ms=, issue_ms=, dp_ms=,
    substep=, mufu=, dp=, cell=)}."""
    import ctypes
    from pyc2ray_torch.ops import _build
    from pyc2ray_torch.ops.chemistry import _dt_arg, _raise_on
    from pyc2ray_torch.ops.thermal import _kernel_params
    lib = _build.load("thermal_probe")
    dt, temp, nd, xh, heat, p = args
    nsub = kw.get("nsub", 16)
    fn = getattr(lib, "thermal_probe_" + (
        "f32" if temp.dtype == torch.float32 else "f64"))
    par = _kernel_params(p, kw.get("z", 0.0))
    par = (ctypes.c_double * len(par))(*par)
    dt_ptr, dt_kind, dt_val = _dt_arg(dt, temp.device)
    stream = torch.cuda.current_stream().cuda_stream
    got = torch.empty_like(temp)
    out = {}
    for form, (row, text, *_) in enumerate(THERMAL_FORMS):
        def call():
            _raise_on(lib, f"thermal form {row}", fn(
                form, dt_ptr, dt_kind, dt_val, temp.data_ptr(),
                nd.data_ptr(), xh.data_ptr(), heat.data_ptr(), got.data_ptr(),
                temp.numel(), nsub, par, stream))
        got.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"3c {label} design step ({row}): max_abs_err "
                               f"{err}, {int((got != want).sum())} cells")
        ms = cuda_ms(call, reps)
        sass = thermal_instructions(temp.dtype, form)
        issue_ms, dp_ms = thermal_sass_ms(temp.numel(), nsub, sass)
        out[row] = dict(ms=ms, issue_ms=issue_ms, dp_ms=dp_ms,
                        substep=sass["substep"], mufu=sass["mufu"],
                        dp=sass["dp"], cell=sass["cell"])
        log(f"  3c {label} step ({row}) {text}: {ms:.4f} ms an update, "
            f"max_abs_err {err:g}; own SASS {sass['substep']:g} a substep "
            f"({sass['mufu']:g} MUFU, {sass['dp']:g} float64), "
            f"{sass['cell']} a cell: "
            + ("not counted" if issue_ms is None else
               f"{issue_ms:.5f} ms at the issue rate ({issue_ms / ms:.3f})")
            + (f", {dp_ms:.5f} ms on the float64 pipe ({dp_ms / ms:.3f})"
               if sass["dp"] else ""))
    return out


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
                                trace_launches(FOLD, sum(nb), sum(
                                    extract_chunks(e, n) for e, n in
                                    zip(ada.engines, nb) if n), len(nb)),
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
            trace_launches(FOLD, pb.shape[0],
                           extract_chunks(eng, pb.shape[0])),
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
    with tempfile.TemporaryDirectory() as tmp:
        loop_before_after(
            f"adaptive bench mix ({sum(nb)} batches)", ada.engines,
            lambda: ada.trace_batches(nd, xh, batches, None, DR)[0],
            sum(nb), tmp)
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
        srcpos, flux = sim.read_sources(
            os.path.join(EOR_DIR, "inputs", "sources",
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
        zi=zi, zf=zf, dt=dt, t_step=t_step, launches=launches, counts=counts,
        t_ray=[float(t) for t in re.findall(r"Raytracing took ([\d.]+) s",
                                            text)],
        t_chem=[float(t) for t in re.findall(r"Chemistry took ([\d.]+) s",
                                             text)],
        loss=[float(v) for v in re.findall(
            r"photon loss fraction: ([-+\d.e]+)", text)],
        converged="Multiple source convergence reached." in text)


def eor_run(bins, smi):
    """Phase 4e: the production EoR run on the committed inputs; returns
    the kernel launches of its timesteps, the device ms per call of K3's two
    phases and of the box kernels in the profiled trace, the first
    slice's iterations, photon loss and xh, and the trace loop's and its
    box kernels' numbers on that trace (``eor_trace_kernels``). ``bins`` are make_bins(), the
    bins the model builds from parameters.yml (asserted); ``smi`` the
    card's name and power limit. The first slice runs first on a model of
    its own with the batch loop before the trace loop (``plain_loop``):
    its iterations, xh and photon loss are held bit-equal to the run's."""
    from pyc2ray_torch import C2Ray_CubeP3M
    from pyc2ray_torch.diagnostics import device_op_times
    from pyc2ray_torch.io import read_cbin
    from pyc2ray_torch.ops.adaptive import AdaptiveRaytracer
    from pyc2ray_torch.utils import format_sources
    from pyc2ray_torch.utils.paramutils import read_paramfile
    params = read_paramfile(os.path.join(EOR_DIR, "parameters.yml"))
    run_counts = {}
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
        with contextlib.redirect_stdout(io.StringIO()):
            sim_plain = C2Ray_CubeP3M(params, N_EOR, device="cuda")
        with plain_loop(sim_plain.raytracer.engines):
            _, _, before = eor_slice(sim_plain, 0)
        xh_before = np.array(sim_plain.xh)
        del sim_plain
        # both slices on a model of its own with the plain chemistry pass
        with contextlib.redirect_stdout(io.StringIO()):
            sim_pc = C2Ray_CubeP3M(params, N_EOR, device="cuda")
        plain_chem = []
        with plain_chemistry():
            for k in range(2):
                r_pc = eor_slice(sim_pc, k)[2]
                r_pc["xh"] = np.array(sim_pc.xh)
                plain_chem.append(r_pc)
        del sim_pc
        for k in range(2):
            srcpos, flux, r = eor_slice(sim, k)
            n_it = len(r["t_ray"])
            nbatch = sum(-(-c // B_EOR) for c in r["counts"])
            want = {name: 0 for name in r["launches"]}
            want["chemistry_pass"] = n_it
            chunks = sum(extract_chunks(e, -(-c // B_EOR)) for e, c in
                         zip(rt.engines, r["counts"]) if c)
            want.update(trace_launches(
                FOLD, n_it * nbatch, n_it * chunks,
                n_it * sum(c > 0 for c in r["counts"])))
            if r["launches"] != want or not r["converged"] or n_it == 0:
                raise RuntimeError(f"EoR slice {k}: launches "
                                   f"{r['launches']}, expected {want}; "
                                   f"converged {r['converged']}")
            for name, n in r["launches"].items():
                run_counts[name] = run_counts.get(name, 0) + n
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
            pc = plain_chem[k]
            n_pc = len(pc["t_ray"])
            want_pc = dict(want, chemistry_pass=0)
            want_pc.update(trace_launches(FOLD, n_pc * nbatch, n_pc * chunks,
                                          n_pc * sum(
                c > 0 for c in r["counts"])))
            log(f"  the plain chemistry pass before the kernel ({smi}): "
                f"{n_pc} raytrace iterations, per iteration chemistry "
                f"{np.mean(pc['t_chem']):.4f} s and raytrace "
                f"{np.mean(pc['t_ray']):.4f} s, {pc['t_step']:.2f} s per "
                f"timestep, photon loss {pc['loss'][-1]:.3e}; the kernel: "
                f"{n_it}, chemistry {t_chem:.4f} s, raytrace {t_ray:.4f} s, "
                f"{r['t_step']:.2f} s, {r['loss'][-1]:.3e}; xh bit-equal "
                f"{np.array_equal(pc['xh'], xh)}")
            if (n_pc != n_it or pc["loss"] != r["loss"]
                    or not np.array_equal(pc["xh"], xh)
                    or pc["launches"] != want_pc):
                raise RuntimeError(
                    f"EoR slice {k}: the run with the chemistry kernel "
                    f"differs from the plain pass's (launches "
                    f"{pc['launches']}, expected {want_pc})")
            if k == 0:
                # phase 5b/5c's single-rank reference
                first = dict(iterations=n_it, loss=r["loss"][-1], xh=xh0,
                             t_step=r["t_step"], t_ray=float(t_ray))
                n_b = len(before["t_ray"])
                want_b = {name: 0 for name in before["launches"]}
                want_b["cheb_sweep_rates"] = n_b * nbatch
                want_b["chemistry_pass"] = n_b
                log(f"  first slice ({smi}), the loop before the trace loop "
                    f"(trace_extended_plain): {n_b} raytrace iterations, "
                    f"per iteration raytrace "
                    f"{np.mean(before['t_ray']):.3f} s, "
                    f"{before['t_step']:.2f} s per timestep, photon loss "
                    f"{before['loss'][-1]:.3e}; after: {n_it}, "
                    f"{t_ray:.3f} s, {r['t_step']:.2f} s, "
                    f"{r['loss'][-1]:.3e}; xh bit-equal "
                    f"{np.array_equal(xh_before, xh)}")
                if (n_b != n_it or before["loss"] != r["loss"]
                        or not np.array_equal(xh_before, xh)
                        or before["launches"] != want_b):
                    raise RuntimeError(
                        f"EoR first slice: the trace loop's run differs "
                        f"from the loop before it (launches before "
                        f"{before['launches']})")

        k_chem = eor_chemistry(sim, r["dt"], smi)

        # one trace of the last slice's state under the profiler
        pos, fl = format_sources(srcpos, flux)
        nd = torch.as_tensor(sim.ndens, dtype=rt.dtype,
                             device="cuda").reshape(-1)
        xh_d = torch.as_tensor(sim.xh, dtype=rt.dtype,
                               device="cuda").reshape(-1)
        avg = float(nd.mean())
        batches, _ = rt.prepare_sources(pos, fl, dr=sim.dr, avg_dens=avg)
        nbatch = sum(b.shape[0] for b in batches.pos if b is not None)
        log(f"EoR trace of the last slice's state ({smi}), the batch loop "
            f"before and after the trace loop:")
        ba = loop_before_after(
            "EoR trace", rt.engines,
            lambda: rt.trace_batches(nd, xh_d, batches, None, sim.dr)[0],
            nbatch, tmp)
        phi = ba["after"]["phi"]
        for tag in ("before", "after"):
            top = device_op_times(ba[tag]["prof"])
            log(f"  EoR trace, loop {tag}, top device operations: "
                + "; ".join(f"{name[:60]} {ms:.2f} ms" for name, ms
                            in list(top.items())[:8]))
        # per call on the device: K3's two launches (the sweep, phase A;
        # the rates, phase B) and the two box kernels
        k3_ms = {ph: sum(ms for name, ms in top.items() if kern in name)
                 / nbatch for ph, kern in (("A", "sweep_fold_kernel"),
                                           ("B", "box_rates_kernel"),
                                           ("extract", "extract_"),
                                           ("accumulate",
                                            "accumulate_boxes"))}
        log(f"  EoR trace, loop after: per call on the device K3 "
            f"{k3_ms['A']:.4f} + {k3_ms['B']:.4f} ms, extract_boxes "
            f"{k3_ms['extract']:.4f} ms, accumulate_boxes "
            f"{k3_ms['accumulate']:.4f} ms ({nbatch} calls each)")
        loop_k = eor_trace_kernels(rt, nd, xh_d, batches, sim.dr)

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
    return run_counts, k3_ms, first, loop_k, k_chem


def eor_chemistry(sim, dt, smi):
    """The hydrogen kernel against its plain version on the EoR run's last
    state (250^3, the last timestep's dt): in float32 as the run takes it,
    and in float64 through the entry point hydrogenODE (its xh bit-equal to
    global_pass_ref's, one launch). Returns the float32 numbers."""
    from pyc2ray_torch import hydrogenODE
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.chemistry import ChemistryParams, global_pass_ref
    f32 = [torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device="cuda").reshape(-1)
           for a in (sim.ndens, sim.temp, sim.xh, sim.phi_ion)]
    nd, temp, xh, phi = f32
    dt_d = torch.tensor(dt, dtype=torch.float32).to("cuda")
    log(f"EoR chemistry on the run's last state ({smi}):")
    k_chem, _ = chemistry_check("EoR 250^3 float32", False,
                                (dt_d, nd, temp, xh, xh, phi, sim.chem), {})
    f64 = [np.asarray(a, dtype=np.float64) for a in
           (sim.ndens, sim.temp, sim.xh, sim.phi_ion)]
    # hydrogenODE's parameters (clumping 1)
    ode = {k: getattr(sim.chem, k) for k in ("bh00", "albpow", "colh0",
                                             "temph0", "abu_c")}
    p64 = ChemistryParams(**ode)
    sweep.reset_launches()
    t0 = time.time()
    got = hydrogenODE(dt, f64[0], f64[1], f64[2], f64[3],
                      max_nonconverged_fraction=1.0, device="cuda", **ode)
    t_ode = time.time() - t0
    n_launch = sweep.launches["chemistry_pass"]
    d = [torch.as_tensor(np.ascontiguousarray(a), device="cuda")
         for a in f64]
    want = global_pass_ref(torch.tensor(dt, dtype=torch.float64).to("cuda"),
                           d[0], d[1], d[2], d[2], d[3], p64)[0]
    ok = np.array_equal(got, want.cpu().numpy())
    log(f"  EoR 250^3 float64 through hydrogenODE: {t_ode:.3f} s with the "
        f"host transfers, {n_launch} chemistry_pass launch; xh bit-equal to "
        f"global_pass_ref's: {ok}")
    if not ok or n_launch != 1:
        raise RuntimeError("hydrogenODE: the float64 kernel differs from the "
                           "plain pass")
    chemistry_check("EoR 250^3 float64", False,
                    (torch.tensor(dt, dtype=torch.float64).to("cuda"),
                     d[0], d[1], d[2], d[2], d[3], p64), {}, reps=3)
    return k_chem


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "single_source_test")
# examples/single_source_test/run_test.py:200-210: name, tolerance
def golden_run(N, numzred, steps, device, results_basename, traces=None):
    """examples/single_source_test/run_test.py through the port:
    C2Ray_Test on that example's parameters.yml (read unchanged; only the
    output directory is ``results_basename``), one 1e49 photons/s
    black-body source, ``numzred - 1`` slices of ``steps`` timesteps, each
    timestep also run by the sequential C++ oracle's evolve loop
    (pyc2ray_torch.examples.single_source_test, whose loop and statistics
    these are, with the port timed apart from the oracle). Returns the
    simulation, the eight statistics {name: (value, tolerance)} of
    run_test.py:200-210 and the wall seconds of the port's part and of the
    oracle's part. With a dict ``traces``, the engine's trace_batches calls
    are timed into it ("n" calls, "s" seconds, "each" call's seconds, each up
    to a synchronize of the card)."""
    from pyc2ray_torch import C2Ray_Test
    from pyc2ray_torch.examples.single_source_test import (
        TABLE_TOLERANCES, oracle_evolve_loop, statistics)
    from pyc2ray_torch.utils import format_sources
    from pyc2ray_torch.utils.paramutils import read_paramfile
    params = read_paramfile(os.path.join(GOLDEN_DIR, "parameters.yml"))
    params["Output"]["results_basename"] = results_basename
    with contextlib.redirect_stdout(io.StringIO()):
        sim = C2Ray_Test(params, N, device=device)
    if traces is not None:
        traces.update(n=0, s=0.0, each=[])
        trace_batches = sim.raytracer.trace_batches

        def timed(*args):
            t0 = time.time()
            out = trace_batches(*args)
            if device == "cuda":
                torch.cuda.synchronize()
            traces["n"] += 1
            traces["s"] += time.time() - t0
            traces["each"].append(time.time() - t0)
            return out
        sim.raytracer.trace_batches = timed
    zred_array = sim.generate_redshift_array(numzred, 1e7)
    srcpos = np.array([[3 * N // 4], [3 * N // 4], [N // 2]], dtype=float)
    srcflux = np.array([1e49 / 1e48])
    sim.ndens = 1e-3 * np.ones((N, N, N))
    pos0, flux0 = format_sources(srcpos, srcflux)
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
            xh_oracle = oracle_evolve_loop(sim, pos0, flux0, dt, sim.dr,
                                           xh_oracle, sim.ndens, temp)
            t_oracle += time.time() - t0
    if np.array_equal(np.asarray(sim.xh), xh_initial):
        raise RuntimeError("golden: the ionized fraction did not change")
    stats = {name: (float(v), tol) for name, v, tol in
             statistics(np.asarray(sim.xh), xh_oracle, TABLE_TOLERANCES)}
    return sim, stats, t_port, t_oracle


def golden_kernels(sim):
    """The flat kernels at the golden's shape (4f): its engine (N = 128, R
    beyond the mesh, so the whole box, one source a batch, float64), its
    source and its last fields. Asserts that flat_plan chose clusters of
    16 blocks with the column densities in the shared ring, then holds the
    sweep kernel to the plain gather and sweep, the gather and the rate
    kernel to the plain gather and rate pass (``flat_kernel_check``, also
    for the engines of its shape in float32, with heat and grey:
    ``flat_variants``) and the loop of one trace to the plain loop,
    max_abs_err 0 each. The cached allocator is emptied and then holds only
    blocks of NaN of the kernels' buffer size, so the scratch the kernels
    write starts as NaN or as a temporary's values, never the golden's last
    column densities. Times the engine's kernel_tables made anew. Returns
    {"flat_gather", "flat_sweep", "flat_rates", "flat_trace_sweep": err,
    "kernel_tables_s": ...}."""
    from pyc2ray_torch.ops import flat_sweep as fs
    from pyc2ray_torch.utils import format_sources
    rt = sim.raytracer
    N, dt = rt.config.N, rt.config.dtype
    C = rt.geom_np.num_cells
    kt = rt.kernel_tables()
    B = rt.config.batch_size
    cluster, shared, _ = fs.flat_plan(kt, B, rt.device)
    if (B, C, cluster, shared) != (1, N ** 3, 16, True):
        raise RuntimeError(f"4f golden: B={B}, {C} cells of {N ** 3}, "
                           f"clusters of {cluster}, shared ring {shared}; "
                           "expected 1, the whole box, 16 and the ring")
    srcpos = np.array([[3 * N // 4], [3 * N // 4], [N // 2]], dtype=float)
    pos_b, flux_b = rt.prepare_sources(*format_sources(srcpos, [10.0]))
    nd = torch.as_tensor(np.asarray(sim.ndens), dtype=dt,
                         device="cuda").reshape(-1)
    xh = torch.as_tensor(np.asarray(sim.xh), dtype=dt,
                         device="cuda").reshape(-1)
    nhi = nd * (1.0 - xh)

    def poison(n):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        blocks = [torch.full((B * C,), float("nan"), dtype=dt, device="cuda")
                  for _ in range(n)]
        return {t.data_ptr() for t in blocks}
    ptrs = poison(4)
    cd = rt.sweep_batch(nhi, pos_b[0], sim.dr)
    on_nan = cd.data_ptr() in ptrs
    cd_plain = rt._sweep(rt._gather(nhi, pos_b[0])[1],
                         rt._dr(sim.dr, "cuda"))
    errs = {"flat_sweep": float((cd - cd_plain).abs().max())}
    del cd, cd_plain
    poison(8)
    got = rt.trace_batches(nd, xh, pos_b, flux_b, sim.dr)[0]
    want = rt.flat_trace_sweep_ref(nd, xh, pos_b, flux_b, sim.dr)[0]
    errs["flat_trace_sweep"] = float((got - want).abs().max())
    if not float(want.max()) > 0.0:
        raise RuntimeError("4f golden: the plain loop's Gamma is not positive")
    del got, want
    errs.update(flat_kernel_check("4f the golden's gather and rates", rt, nhi,
                                  pos_b[0], flux_b[0]))
    for e in flat_variants(N, rt.config.R_max_LLS, B):
        d = e.config.dtype
        for k, v in flat_kernel_check("4f at the golden's shape", e,
                                      nhi.to(d), pos_b[0],
                                      flux_b[0].to(d)).items():
            errs[k] = max(errs[k], v)
        del e
    tables_s = timed_tables("4f the golden's engine", rt)
    log(f"  4f the flat kernels at the golden's shape (N={N}, {C} cells, "
        f"{kt.sizes['n_shells']} shells, B={B}, {dt}, clusters of "
        f"{cluster}, the column densities in the shared ring of depth "
        f"{kt.sizes['depth']}, {fs.ring_bytes(kt, cluster)} B a block) on "
        f"its last fields: the sweep against the plain sweep "
        f"max_abs_err={errs['flat_sweep']:.1e} (its output on a block of "
        f"NaN: {on_nan}), one trace against the plain loop "
        f"max_abs_err={errs['flat_trace_sweep']:.1e}")
    if any(e != 0.0 for e in errs.values()):
        raise RuntimeError(f"4f golden: the flat kernels differ from their "
                           f"plain versions at the golden's shape: {errs}")
    errs["kernel_tables_s"] = tables_s
    return errs


def golden_phase():
    """Phase 4f: examples/single_source_test at N = 128 through the port
    (``golden_run``) against the C++ oracle, every trace through the flat
    kernels (asserted), its eight statistics within their limits
    (asserted), then ``golden_kernels``. Returns (launches, errs)."""
    from pyc2ray_torch.ops import sweep
    sweep.reset_launches()
    g_traces = {}
    with tempfile.TemporaryDirectory() as tmp:
        sim, stats, t_port, t_oracle = golden_run(
            N_GOLDEN, 2, STEPS_GOLDEN, "cuda", tmp + "/", traces=g_traces)
    g_counts = {k: v for k, v in sweep.launches.items() if v}
    rt_g = sim.raytracer
    log(f"golden examples/single_source_test N={N_GOLDEN}, 2 slices x "
        f"{STEPS_GOLDEN} timesteps, engine {type(rt_g).__name__} on "
        f"{rt_g.device} ({rt_g.config.dtype}, q_max "
        f"{rt_g.geom_np.max_q}): the port {t_port:.2f} s, "
        f"{g_traces['s']:.3f} s of it in {g_traces['n']} traces "
        f"({1e3 * g_traces['s'] / max(g_traces['n'], 1):.3f} ms a trace; "
        f"the first, which makes the kernels' tables, "
        f"{1e3 * g_traces['each'][0]:.3f} ms, the median "
        f"{1e3 * float(np.median(g_traces['each'])):.3f} ms), "
        f"the C++ oracle {t_oracle:.2f} s; mean xh "
        f"{float(np.mean(sim.xh)):.12e}; launches "
        + ", ".join(f"{k} {v}" for k, v in g_counts.items()))
    n_tr = g_counts.get("flat_trace_sweep", 0)
    if n_tr != g_traces["n"] or n_tr < 1 or any(
            g_counts.get(k, 0) != g_counts.get("flat_sweep", -1)
            for k in ("flat_gather", "flat_rates", "flat_accumulate")) or \
            g_counts.get("flat_sweep", 0) < n_tr:
        raise RuntimeError(f"golden: the traces did not go through the "
                           f"flat kernels: {g_traces['n']} traces, launches "
                           f"{g_counts}")
    failed = []
    for name, (value, tol) in stats.items():
        ok = bool(np.isfinite(value)) and abs(value) <= tol
        log(f"  {name:16s}: {value: .7e}   (tolerance {tol:g}) "
            f"{'PASSED' if ok else 'FAILED'}")
        failed += [] if ok else [name]
    if failed or type(rt_g).__name__ != "Raytracer" \
            or rt_g.device.type != "cuda":
        raise RuntimeError(f"golden: {', '.join(failed) or 'engine'} FAILED")
    g_errs = golden_kernels(sim)
    return g_counts, g_errs


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


def he_work(rt, cds, nboxes, heat):
    """(bytes, operations, rated cells, transcendentals) of one helium rate
    pass
    (``rates_he``) of engine ``rt`` on the three species' boxes ``cds`` and
    ``nboxes``, as this data needs them: the host engine's list of rated
    cells (int32), path3 and geominv at the listed cells and the six boxes
    at the listed cells of every box, the fluxes and the 2 (3 with heat)
    bin tables of (3, E) each read once, the 3 (4) rates written at the
    listed cells; HE_OPS_PER_LISTED per listed cell of a box, and the bins'
    and HE_OPS_PER_CELL per rated cell of this data (listed, cdin_HI <=
    MAX_COLDENSH); per rated cell and bin from the first at which a species
    has a term (a non-zero se, w_se or, with heat, wh_se) one exp, one
    expm1 and one reciprocal in float32, the reciprocal alone in float64
    (the card's float64 exp and expm1 take no MUFU instruction)."""
    from pyc2ray_torch.constants import MAX_COLDENSH
    eng = rt.eng
    tb, r, Ds = eng.tables, eng._rb0, eng.Ds
    sub = (slice(None),) + (slice(r, r + Ds),) * 3
    cdin = cds[0][sub] - nboxes[0][sub] * (tb.rt_sub[0] * DR)
    rated = int(((tb.rt_sub[2] > 0.5) & (cdin <= MAX_COLDENSH)).sum())
    n_valid = eng.rated_cells.numel()
    B, E = cds[0].shape[0], rt.he_tables.se.shape[1]
    isz = torch.finfo(cds[0].dtype).bits // 8
    nbytes = (4 * n_valid + isz * (2 * n_valid + (9 + heat) * B * n_valid
                                   + B + (2 + heat) * 3 * E))
    per_bin = HE_OPS_PER_BIN + heat * HE_HEAT_OPS_PER_BIN
    ops = (rated * (per_bin * E + HE_OPS_PER_CELL
                    + heat * HE_HEAT_OPS_PER_CELL)
           + HE_OPS_PER_LISTED * B * n_valid)
    heb = rt.he_tables
    term = (heb.se != 0) | (heb.w_se != 0) | ((heb.wh_se != 0) & heat)
    with_term = E - int(term.any(0).int().argmax()) if bool(term.any()) \
        else 0
    per_bin = 3 if cds[0].dtype == torch.float32 else 1
    return nbytes, ops, rated, rated * with_term * per_bin


def rates_he_matmul(rt, cds, nboxes, flux, dr):
    """The helium rate pass in the matmul form the engine ran before its
    kernel (PR 7-15; the JAX engine's einsums as torch.matmul): over every
    cell of the subbox, two (cells, 3) x (3, E) products, an exp/expm1
    block over (cells, E) and the per-species sums as (cells, E) x (E, 3)
    products. Timed beside the kernel; used nowhere in the port."""
    from pyc2ray_torch.constants import MAX_COLDENSH
    from pyc2ray_torch.ops.sweep import s_over_dr3
    eng, heb, dt = rt.eng, rt.he_tables, rt.dtype
    sub = (slice(None),) + (slice(eng._rb0, eng._rb1),) * 3
    cds = [c[sub] for c in cds]
    nboxes = [n[sub] for n in nboxes]
    rt_sub = eng.tables.rt_sub
    dr = torch.tensor(float(dr), dtype=dt)
    path = rt_sub[0][None] * dr
    dcol = [nboxes[s] * path for s in range(3)]
    cdin = [cds[s] - dcol[s] for s in range(3)]
    prefact = flux[:, None, None, None] * s_over_dr3(dr, dt) * rt_sub[1][None]
    tiny = 1e-30 if dt == torch.float32 else 1e-280
    A = torch.stack([c.reshape(-1) for c in cdin], 1)
    Dm = torch.stack([d.reshape(-1) for d in dcol], 1)
    tau_in = A @ heb.se
    dtau_e = Dm @ heb.se
    core = torch.exp(-tau_in) * (-torch.expm1(-dtau_e))
    inv = core / torch.clamp(dtau_e, min=tiny)
    del tau_in, dtau_e, core
    wv = inv @ heb.w_se.T
    sh4 = cds[0].shape
    acc = [(Dm[:, s] * wv[:, s]).reshape(sh4) for s in range(3)]
    if rt.do_heating:
        acc.append((Dm * (inv @ heb.wh_se.T)).sum(dim=1).reshape(sh4))
    mask = (rt_sub[2] > 0.5)[None] & (cdin[0] <= MAX_COLDENSH)
    zero = torch.zeros_like(acc[0])
    dens = nboxes + nboxes[:1]
    return [torch.where(mask & (n > 0),
                        prefact * a / torch.clamp(n, min=tiny), zero)
            for a, n in zip(acc, dens)]


def he_boxes(rt, B, dtype, seed):
    """The three species' (B, Dc, Dc, Dc) absorber boxes on the card (n_HI
    1e-4..1e-2, n_HeI and n_HeII a decade and two below; n_HeII 0 in one
    cell of source 0, n_HeI in one of the last source), their coldensh_out
    boxes by the engine's sweep (K1) at each species' sigma_th, and fluxes
    0.5..2."""
    g = rt.geom
    rng = np.random.RandomState(seed)
    nb = [torch.from_numpy(10 ** rng.uniform(lo, lo + 2, (B,) + (g.Dc,) * 3)
                           ).to("cuda", dtype) for lo in (-4, -5, -6)]
    nb[2][0, g.c + 1, g.c, g.c] = 0.0
    nb[1][-1, g.c, g.c + 1, g.c] = 0.0
    cds = [rt.eng.sweep_box(n, DR, sig) for n, sig in zip(nb, rt.sigma_th)]
    flux = torch.linspace(0.5, 2.0, B, dtype=dtype, device="cuda")
    return cds, nb, flux


def check_rates_he(bins_he, ns_bin, reps=10):
    """Phase 2d: the helium rate pass (rates_he, ops/cheb_rates.py) against
    its plain version on the card, on the three species' K1 boxes, with and
    without the heat channel, bit for bit (max_abs_err 0): at the bench
    shape (one batch, B = 8, Dc = Ds = 64, 72 bins, float32) with kernel
    ms on the device (with its zeroed outputs) and back to back, plain ms,
    the matmul form's ms (``rates_he_matmul``, beside it within rtol 1e-3
    above 1e-6 of the peak), the bound of ``he_work`` and the rate floor
    (rated cells x bins x ``ns_bin``, phase 2c's dense pass); and in
    float64 at a small shape that rates a subbox, with zero-density
    cells. Returns {"photo", "heat"}: the bench shape's numbers per
    call."""
    from pyc2ray_torch.ops.cheb_rates import rates_he, rates_he_ref
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    from pyc2ray_torch.ops.sweep import rate_consts
    out = {}
    for N, R, B, dt in ((N_BENCH, R_BENCH, B_BENCH, torch.float32),
                        (16, 6.0, 2, torch.float64)):
        bench = dt == torch.float32
        for heat in (False, True):
            rt = HeRaytracer(N, R, bins_he, ABU_HE, batch_size=B, dtype=dt,
                             do_heating=heat)
            eng, heb = rt.eng, rt.he_tables
            cds, nb, flux = he_boxes(rt, B, dt, seed=13)
            args = (eng.tables.rt_sub, flux, heb.se, heb.w_se, DR,
                    rate_consts(DR, dt)[1], eng._rb0)
            wh = heb.wh_se if heat else None

            def kern():
                return rates_he(cds, nb, *args, wh_se=wh,
                                cells=eng.rated_cells, bands=heb.bands)

            def plain():
                return rates_he_ref(cds, nb, *args, wh_se=wh,
                                    cells=eng.rated_cells)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max(float((a - w).abs().max()) for a, w in zip(got, want))
            if (err != 0.0 or len(got) != 3 + heat
                    or not all(float(w.max()) > 0.0 for w in want)
                    or not all(bool(torch.isfinite(a).all()) for a in got)):
                raise RuntimeError(f"rates_he N={N} heat={heat}: "
                                   f"max_abs_err {err} against the plain "
                                   f"version")
            name = (f"rates_he{' heat' if heat else ''} N={N} R={R:g} B={B} "
                    f"Dc={rt.geom.Dc} Ds={eng.Ds} E={bins_he.num_bins} "
                    f"{str(dt).split('.')[-1]}")
            c = rt.geom.c - eng._rb0
            if not bench:
                if float(got[2][0, c + 1, c, c]) != 0.0:
                    raise RuntimeError(f"{name}: G_HeII at the cell without "
                                       f"HeII is not 0")
                sass = rates_he_instructions(dt, heat)
                log(f"  {name} (zero-density cells): max_abs_err={err:.1e} "
                    f"(bit-equal); SASS bin loops (instructions, MUFU, "
                    f"float64 a pass, static; bins a pass): "
                    + ", ".join(f"({lp['iter']}, {lp['mufu']}, {lp['dp']}, "
                                f"{lp['static']}; {lp['bins']})"
                                for lp in sass["loops"])
                    + f", {sass['cell']} a listed cell")
                continue
            mm = rates_he_matmul(rt, cds, nb, flux, DR)
            torch.cuda.synchronize()
            rel = max(max_rel(a, m, 1e-6) for a, m in zip(got, mm))
            if not rel < 1e-3:
                raise RuntimeError(f"{name}: the matmul form differs by "
                                   f"{rel:.3e}")
            del got, want, mm
            nbytes, ops, rated, n_mufu = he_work(rt, cds, nb, heat)
            ms = device_ms(lambda _: kern(), reps)
            b2b = cuda_ms(kern, reps)
            plain_ms = cuda_ms(plain, 1)
            mm_ms = cuda_ms(lambda: rates_he_matmul(rt, cds, nb, flux, DR),
                            2)
            peak = H100_F32_FLOPS if dt == torch.float32 else H100_F64_FLOPS
            b_ms, b_by, binds, parts = function_bound(nbytes, ops / peak,
                                                      n_mufu)
            floor = 1e-6 * rated * bins_he.num_bins * ns_bin
            t_sass, sass, bands = he_rates_sass(rt, rated, heat)
            issue_ms = 1e3 * t_sass
            log(f"  {name}: max_abs_err={err:.1e} (bit-equal) kernel_ms="
                f"{ms:.4f} on the device with its zeroed outputs ({b2b:.4f} "
                f"back to back) plain_ms={plain_ms:.4f} matmul_form_ms="
                f"{mm_ms:.4f} (max rel {rel:.3e} above 1e-6 of the peak) "
                f"rate_floor_ms={floor:.5f} per call, "
                f"{rated} rated cells of {B} x {eng.rated_cells.numel()} "
                f"listed")
            log(f"    bound {b_ms:.5f} ms ({binds} binds), the kernel at "
                f"{b_ms / ms:.3f} of it: bytes {parts['bytes']:.5f} ms "
                f"({nbytes / 1e6:.2f} MB), flops {parts['flops']:.5f} ms "
                f"({ops / 1e9:.3f} Gop, a transcendental one operation), "
                f"MUFU {parts['mufu']:.5f} ms ({n_mufu / 1e9:.4f} G "
                f"transcendentals: an exp, an expm1 and a reciprocal a bin "
                f"with a term of a rated cell); the kernel's own SASS at the "
                f"issue rate {issue_ms:.5f} ms, the kernel at "
                f"{issue_ms / ms:.3f} of it; SASS bin loops (instructions "
                f"without spills, MUFU, float64 a pass, static; bins a "
                f"pass): "
                + ", ".join(f"({lp['iter']}, {lp['mufu']}, {lp['dp']}, "
                            f"{lp['static']}; {lp['bins']})"
                            for lp in sass["loops"])
                + f", {sass['cell']} a listed cell; bins with 1 / 2 / 3 "
                f"species' terms {bands}")
            out["heat" if heat else "photo"] = dict(
                max_abs_err=err, ms=ms, ms_back_to_back=b2b,
                plain_ms=plain_ms, matmul_form_ms=mm_ms, bound_ms=b_ms,
                bound_by=b_by, bound_binds=binds, bound_share=b_ms / ms,
                byte_bound_ms=parts["bytes"], flop_bound_ms=parts["flops"],
                mufu_bound_ms=parts["mufu"], issue_ms_at_own_sass=issue_ms,
                sass_bin_loops=sass["loops"], sass_per_cell=sass["cell"],
                band_bins=bands, rate_floor_ms=floor, rated_cells=rated)
    return out


def he_rates_f32_error(bins_he, heat=True):
    """Phase 2d: the float32 error of the helium rate pass, which rebuilds
    each species' cdin = cd - dcol from K1's coldensh_out (ROADMAP §3):
    one bench batch (B = 8, Dc = Ds = 64, 72 bins) at the helium bench
    fields (n_H 1e-3, x_HII 1.2e-3, y_HeII 1e-3, y_HeIII 0: the uniform
    boxes of every source), K1 and rates_he in float32 against the same in
    float64. Returns {channel: (max |G32 - G64| / peak G64, max relative
    error above 1e-6 of the peak)} for G_HI, G_HeI, G_HeII and the heat."""
    from pyc2ray_torch.ops.cheb_rates import rates_he
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    from pyc2ray_torch.ops.sweep import rate_consts
    got = {}
    for dt in (torch.float32, torch.float64):
        rt = HeRaytracer(N_BENCH, R_BENCH, bins_he, ABU_HE,
                         batch_size=B_BENCH, dtype=dt, do_heating=heat)
        eng, heb = rt.eng, rt.he_tables
        shape = (B_BENCH,) + (rt.geom.Dc,) * 3
        nb = [torch.full(shape, float(v), dtype=dt, device="cuda")
              for v in rt.species_fields(*(torch.tensor(x, dtype=dt)
                                           for x in (1e-3, 1.2e-3, 1e-3,
                                                     0.0)))]
        cds = [eng.sweep_box(n, DR, sig) for n, sig in zip(nb, rt.sigma_th)]
        flux = torch.ones(B_BENCH, dtype=dt, device="cuda")
        got[dt] = rates_he(cds, nb, eng.tables.rt_sub, flux, heb.se,
                           heb.w_se, DR, rate_consts(DR, dt)[1], eng._rb0,
                           wh_se=heb.wh_se if heat else None,
                           cells=eng.rated_cells, bands=heb.bands)
    out = {}
    for name, a, b in zip(("G_HI", "G_HeI", "G_HeII", "heat"),
                          got[torch.float32], got[torch.float64]):
        a, b = a.double(), b
        peak = float(b.abs().max())
        out[name] = (float((a - b).abs().max()) / peak, max_rel(a, b, 1e-6))
    log("  rates_he float32 against float64 at the helium bench fields "
        "(one bench batch, cdin rebuilt as cd - dcol in both): "
        + ", ".join(f"{k} max abs error {v[0]:.3e} of the peak, max rel "
                    f"{v[1]:.3e} above 1e-6 of it" for k, v in out.items()))
    return out


def rates_f32_error(bins, heat=True):
    """Phase 2d: the float32 error of the hydrogen default mode's rate pass,
    which rebuilds cdin = cd - dcol from K1's coldensh_out (ROADMAP section
    3): one bench batch (B = 8, Dc = 64, 14 bins) at the bench fields (n_HI
    = 1e-3 (1 - 1.2e-3), uniform boxes of every source), K1 and rates_dense
    (with the heat channel) in float32 against the same in float64.
    Returns {channel: (max |G32 - G64| / peak G64, max relative error
    above 1e-6 of the peak)} for Gamma and the heat."""
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    got = {}
    for dt in (torch.float32, torch.float64):
        rt = ChebRaytracer(N_BENCH, R_BENCH, SIG, bins, batch_size=B_BENCH,
                           dtype=dt, do_heating=heat)
        nhi = torch.full((B_BENCH,) + (rt.geom.Dc,) * 3,
                         1e-3 * (1.0 - 1.2e-3), dtype=dt, device="cuda")
        cd = rt.sweep_box(nhi, DR, SIG)
        flux = torch.ones(B_BENCH, dtype=dt, device="cuda")
        got[dt] = [t for t in rt._rates(cd, nhi, flux, DR) if t is not None]
    out = {}
    for name, a, b in zip(("Gamma", "heat"), got[torch.float32],
                          got[torch.float64]):
        a = a.double()
        peak = float(b.abs().max())
        out[name] = (float((a - b).abs().max()) / peak, max_rel(a, b, 1e-6))
    log("  rates_dense float32 against float64 at the bench fields (one "
        "bench batch, cdin rebuilt as cd - dcol in both): "
        + ", ".join(f"{k} max abs error {v[0]:.3e} of the peak, max rel "
                    f"{v[1]:.3e} above 1e-6 of it" for k, v in out.items())
        + "; the floor is 1e-4 of the peak: "
        + ("under it" if all(v[0] < 1e-4 for v in out.values())
           else "ABOVE it"))
    return out


def he_trace_launches(rt, nb, traces=1):
    """The kernel launches of ``traces`` helium traces of ``nb`` batches in
    all (one ``he_trace_sweep`` call each): three sweeps a batch (K1, or
    the segmented sweep's start and K2 x seg_K), one rate pass and one
    accumulate a batch, one extract of the three species' boxes per chunk
    of ``chunk_size(..., channels=3)`` batches."""
    from pyc2ray_torch.ops import trace_loop
    eng = rt.eng
    k = trace_loop.chunk_size(nb, rt.batch_size, eng.geom.Dc,
                              rt.dtype.itemsize, channels=3)
    out = {"he_trace_sweep": int(traces), "rates_he": nb,
           "accumulate_boxes": nb, "extract_boxes": -(-nb // k)}
    if eng.seg_S:
        out.update(cheb_sweep_seg=3 * nb * eng.seg_K, init_segments=3 * nb)
    else:
        out["cheb_sweep"] = 3 * nb
    return out


def he_loop_against_plain(label, rt, pads, pos_b, flux_b, reps=3):
    """The helium engine's ``trace_extended`` (one he_trace_sweep call)
    against its ``trace_extended_plain`` on the frames ``pads``: bit for
    bit, every channel, with the loop's launch counts
    (``he_trace_launches``) and the ms per trace of both (CUDA events: the
    loop ``reps`` traces after a warm-up, the plain loop the one trace held
    against, after the loop's). Returns max_abs_err, ms and plain_ms."""
    from pyc2ray_torch.ops import sweep
    nb = pos_b.shape[0]
    sweep.reset_launches()
    got = rt.trace_extended(pads, pos_b, flux_b, DR)
    counts = dict(sweep.launches)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = rt.trace_extended_plain(pads, pos_b, flux_b, DR)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    expect = {k: 0 for k in counts}
    expect.update(he_trace_launches(rt, nb))
    if counts != expect:
        raise RuntimeError(f"{label}: loop launches {counts}, expected "
                           f"{expect}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if (err != 0.0 or len(got) != 3 + rt.do_heating or len(want) != len(got)
            or not all(float(w.max()) > 0.0 for w in want)):
        raise RuntimeError(f"{label}: the loop differs from the plain "
                           f"loop: max_abs_err {err}")
    del got, want
    ms = cuda_ms(lambda: rt.trace_extended(pads, pos_b, flux_b, DR), reps)
    log(f"  {label}: trace_extended (the C++ loop) vs trace_extended_plain: "
        f"max_abs_err={err:.1e} (bit-equal, {3 + rt.do_heating} channels), "
        f"launches " + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f"; per trace: the loop {ms:.3f} ms, the plain loop "
        f"{plain_ms:.3f} ms ({ms / nb:.4f} / {plain_ms / nb:.4f} ms per "
        f"batch)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def he_loop_work(rt, pads, pos_b):
    """(bytes, operations) of one helium trace (one he_trace_sweep call)
    over the batches ``pos_b`` in the frames ``pads``, as a function of the
    whole loop: the cells of the three frames that the boxes cover read
    once; the sweep's tables, the list of rated cells, path3 and geominv at
    them, the fluxes and the bin tables once; the rate frames written once.
    The boxes that pass between the loop's kernels are none of its bytes.
    Operations per batch: three sweeps' (``sweep_work``), the rate pass's
    of this data (``he_work`` on the first batch's boxes) and the
    accumulate's adds at the listed cells."""
    from pyc2ray_torch.ops.trace_loop import extract_boxes, stage_positions
    eng = rt.eng
    g, dt, heat = eng.geom, rt.dtype, rt.do_heating
    isz = torch.finfo(dt).bits // 8
    nb, B = pos_b.shape[:2]
    pos = stage_positions(pos_b, pads[0].shape, g.Dc, "cuda")
    covered = torch.zeros(pads[0].numel(), dtype=torch.bool, device="cuda")
    for k in range(nb):
        covered[box_flat_index(pos[k], pads[0].shape, g.Dc).view(-1)] = True
    sb, sops = sweep_work(B, g.Dc, g.r_max + 1, dt)
    boxes = extract_boxes(pads, pos, 0, g.Dc)
    cds = [eng.sweep_box(b, DR, sig) for b, sig in zip(boxes, rt.sigma_th)]
    rops = he_work(rt, cds, boxes, heat)[1]
    n_valid = eng.rated_cells.numel()
    E = rt.he_tables.se.shape[1]
    tables = (sb - 2 * B * g.Dc ** 3 * isz + 4 * n_valid
              + isz * (2 * n_valid + (2 + heat) * 3 * E))
    nbytes = tables + isz * (3 * int(covered.sum())
                             + (3 + heat) * pads[0].numel() + nb * B)
    return nbytes, nb * (3 * sops + rops + (3 + heat) * B * n_valid)


def launches_in(prof):
    """Device kernels in the profile_trace captures of ``prof``."""
    from pyc2ray_torch.diagnostics import _trace_events
    return sum(e.get("cat") == "kernel" for events in _trace_events(prof)
               for e in events)


# the flat engine's operations (csrc/flat_sweep.cuh), a transcendental
# counted as one: per cell and source of the sweep beyond the source cell
# (4 c*sig, 4 max, 4 div, 4 c*w, 8 adds from 0, diag*, /, path*dr,
# nHI*pdr, +); of the rate pass (path*dr, nHI*, cd-dcol, 3 tau, 2 prefactor
# muls, the thick test, the two masks, clamp, the result's mul and
# division, 2 muls of the thin branch) and per table lookup (clamp, log10,
# sub, mul, add, clamp, convert, sub, min, sub, mul, add); the accumulate
# one add a cell, source and channel
FLAT_SWEEP_OPS = 29
FLAT_RATE_OPS = 16
FLAT_LOOKUP_OPS = 12
FLAT_KERNELS = (("flat_gather_kernel", "flat_gather"),
                ("flat_sweep_kernel", "flat_sweep"),
                ("flat_rates_kernel", "flat_rates"),
                ("flat_accumulate_kernel", "flat_accumulate"))


def flat_tables():
    """The model layer's black-body tables (NumTau 2000): photo and heat,
    with minlogtau and dlogtau, in the order Raytracer takes them."""
    from pyc2ray_torch.constants import ev2fr
    from pyc2ray_torch.radiation import BlackBodySource, make_tau_table
    tau, dlogtau = make_tau_table(-20.0, 4.0, 2000)
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    bb = BlackBodySource(5e4, False, fmin, 2.8)
    thin, thick = bb.make_photo_table(tau, fmin, fmax, 1e48)
    hthin, hthick = bb.make_heat_table(tau, fmin, fmax, 1e48)
    return thin, thick, -20.0, dlogtau, hthin, hthick


def flat_engine(tables, dtype, heat, device="cuda"):
    from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
    cfg = RaytraceConfig(N=N_BENCH, R_max_LLS=R_BENCH, sig=SIG,
                         batch_size=B_BENCH, dtype=dtype, do_heating=heat)
    return Raytracer(cfg, *tables, device=device)


def flat_work(rt, pos_b):
    """(bytes, operations) of the flat engine ``rt``'s kernels on batch 0 of
    ``pos_b`` and of its loop over all of them, as the functions need them:
    the tables a kernel reads (the grid order and its offsets for the
    gather; corner codes, weights, path and diag for the sweep; offsets,
    path, geom, rated and the lookups' tables for the rates) once, the grid
    cells the batch covers (their union) once, the (B, C) values a kernel
    hands to the next written and read once; the loop's tables once, the
    covered cells of the trace once, its rate grids written once. Returns
    {kernel: (bytes, ops)}."""
    cfg, heat = rt.config, rt.config.do_heating
    isz = torch.finfo(cfg.dtype).bits // 8
    C = rt.kernel_tables().sizes["C"]
    nb, B = pos_b.shape[:2]
    covered = torch.zeros(cfg.N ** 3, dtype=torch.bool, device="cuda")
    union0 = 0
    for k in range(nb):
        covered[rt._lin_idx(pos_b[k]).view(-1)] = True
        if k == 0:
            union0 = int(covered.sum())
    n_tab = rt.tables.photo_thin.numel()
    lookups = 0 if cfg.grey_analytic else 3 * (1 + heat)
    sweep_tab = C * (16 + 6 * isz)
    rate_tab = C * (12 + 2 * isz + 1) + isz * 2 * (1 + heat) * n_tab
    sweep_ops = FLAT_SWEEP_OPS * B * (C - 1)
    rate_ops = B * C * (FLAT_RATE_OPS + FLAT_LOOKUP_OPS * lookups)
    acc_ops = (1 + heat) * B * C
    out = {
        "flat_gather": (C * 8 + isz * (union0 + B * C), 0),
        "flat_sweep": (sweep_tab + isz * 2 * B * C, sweep_ops),
        "flat_rates": (rate_tab + isz * (union0 + (2 + heat) * B * C + B),
                       rate_ops),
        "flat_accumulate": (C * 12 + isz * (1 + heat) * (B * C
                                                         + 2 * union0),
                            acc_ops),
        "flat_trace_sweep": (C * 8 + sweep_tab + rate_tab + isz * (
            int(covered.sum()) + nb * B + (1 + heat) * cfg.N ** 3),
            nb * (sweep_ops + rate_ops + acc_ops))}
    return out


def flat_kernel_us(prof, table=FLAT_KERNELS):
    """Per kernel of ``table`` ((a part of its device name, its name)) in
    the profile ``prof``: (median device us, median idle gap before it us,
    count); and the profile's device launches."""
    from pyc2ray_torch.diagnostics import _trace_events
    ev = sorted((e for events in _trace_events(prof) for e in events
                 if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    kinds = {}
    for prev, e in zip([None] + ev, ev):
        name = next((k for part, k in table if part in e["name"]),
                    "other")
        gap = 0.0 if prev is None else e["ts"] - (prev["ts"] + prev["dur"])
        kinds.setdefault(name, []).append((e["dur"], gap))
    return {k: (float(np.median([d for d, _ in v])),
                float(np.median([g for _, g in v])), len(v))
            for k, v in kinds.items()}, len(ev)


def flat_loop_vs_plain(label, rt, nd, xh, pos_b, flux_b):
    """The loop (one flat_trace_sweep call) against the plain loop over the
    batches ``pos_b``: Gamma (and heat) bit for bit; returns the
    max_abs_err."""
    got = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    want = rt.flat_trace_sweep_ref(nd, xh, pos_b, flux_b, DR)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want)
              if w is not None)
    if err != 0.0 or not float(want[0].max()) > 0.0 or \
            (want[1] is None) == rt.config.do_heating:
        raise RuntimeError(f"3d {label}: the flat loop differs from the "
                           f"plain loop, max_abs_err {err}")
    log(f"  3d {label}: the loop against the plain loop over "
        f"{pos_b.shape[0]} batches: max_abs_err={err:.1e} (bit-equal"
        f"{', Gamma and heat' if rt.config.do_heating else ''})")
    return err


# the design steps of the flat sweep: (row, what it is, whether its output
# is the sweep's), one per form of csrc/flat_probe.cu's FLAT_PROBE_FORMS in
# its order; the last five take parts of the shell step out to attribute its
# time (their outputs are not the sweep's)
FLAT_FORMS = (
    ("a", "the first port's chain: global column densities, nHI "
          "gathered from the grid in the chain, one cell's operands ahead",
     True),
    ("b", "the bare barrier chain", False),
    ("c", "(a) with nHI pre-gathered by the gather kernel, a launch before",
     True),
    ("c'", "(a) with nHI pre-gathered by the sweep's own prologue", True),
    ("d", "(a) with the column densities in the ring in distributed shared "
          "memory", True),
    ("d'", "(d) with nHI pre-gathered by the prologue", True),
    ("e=f", "(c) and (d), the final form (the engine's shared placement)",
     True),
    ("g", "the engine's global placement: (c) with the corners by their "
          "codes", True),
    ("f+ahead", "(f) with two cells' operands ahead", True),
    ("f+early", "(f) with a corner of lag >= 2 read and its term formed "
                "before the wait", True),
    ("f+local", "(f) with a corner of the block's own slice read from its "
                "own shared memory", True),
    ("f+stage", "(f) with a thread's first cell of a shell copied into "
                "shared memory two shells ahead (cp.async)", True),
    ("f*div", "(f) with a multiply for each division", False),
    ("f*corner", "(f) with every corner read as 0", False),
    ("f*load", "(f) with no operand loaded (constants)", False),
    ("f*load*div", "(f*load) with a multiply for each division", False),
    ("f*load*div*out", "(f*load*div) with no output stored", False))


def flat_probe_lib():
    """The library of csrc/flat_probe.cu: the flat engine's forms that were
    measured and left out, which only this script builds."""
    from pyc2ray_torch.ops import _build
    return _build.load("flat_probe")


def flat_forms():
    """The forms of FLAT_PROBE_FORMS (csrc/flat_probe.cu), one a row of
    FLAT_FORMS."""
    import ctypes
    out = (ctypes.c_int * 64)()
    n = flat_probe_lib().flat_sweep_forms(out, 64)
    if n != len(FLAT_FORMS):
        raise RuntimeError(f"3d: {n} forms of the flat sweep, "
                           f"{len(FLAT_FORMS)} rows")
    return list(out)[:n]


def flat_probe(rt, nhi, pos, form, cluster):
    """A closure that launches the flat sweep's form ``form``
    (csrc/flat_probe.cu's entry, float64; the engine's gather kernel first
    where the form reads nHI gathered without a prologue) on the sources at
    ``pos`` in clusters of ``cluster``, and its output (B, C)."""
    from pyc2ray_torch.ops import flat_sweep as fs
    kt = rt.kernel_tables()
    dev = nhi.device
    pos = fs.stage_positions(pos, kt.sizes["N"], dev)
    B = pos.shape[0]
    cd, no = (torch.full((B, kt.sizes["C"]), float("nan"), dtype=kt.dtype,
                         device=dev) for _ in range(2))
    lib = flat_probe_lib()

    def call():
        err = lib.flat_sweep_probe(
            kt.tabs, kt.dims, fs._vals(kt, DR), fs._ptr(nhi), fs._ptr(pos),
            fs._ptr(no), fs._ptr(cd), B, cluster, form, fs._stream(dev))
        fs._raise_on(lib, "flat_sweep_probe", err, f" (form {form})")
    return call, cd


def flat_design_steps(label, rt, nhi, pos, reps):
    """The flat sweep's design steps at one shape (FLAT_FORMS, float64, the
    engine's cluster size): us a launch and a shell by CUDA events over
    ``reps`` launches back to back, each form's output against the plain
    gather and sweep (max_abs_err 0, asserted, where the form computes the
    sweep). Returns {row: dict(us=, us_per_shell=, max_abs_err=, form=)}."""
    from pyc2ray_torch.ops import flat_sweep as fs
    kt = rt.kernel_tables()
    cluster, shared, _ = fs.flat_plan(kt, pos.shape[0], nhi.device)
    n_shells = kt.sizes["n_shells"]
    want = rt._sweep(rt._gather(nhi, pos)[1], rt._dr(DR, "cuda"))
    out = {}
    for (row, text, checked), form in zip(FLAT_FORMS, flat_forms()):
        call, cd = flat_probe(rt, nhi, pos, form, cluster)
        call()
        err = float((cd - want).abs().max()) if checked else None
        if checked and (err != 0.0 or not bool(torch.isfinite(cd).all())):
            raise RuntimeError(f"3d {label} design step ({row}) form {form}: "
                               f"max_abs_err {err}")
        us = 1e3 * cuda_ms(call, reps)
        out[row] = dict(us=us, us_per_shell=us / n_shells, max_abs_err=err,
                        form=form)
        log(f"  3d {label} step ({row}) {text}: {us:.2f} us a launch, "
            f"{us / n_shells:.4f} us a shell ({n_shells} shells, C="
            f"{cluster}); "
            + (f"max_abs_err {err:.1e}" if checked else "timing only"))
        del cd, call
    log(f"  3d {label}: the engine's plan C={cluster}, column densities "
        f"{'in the shared ring' if shared else 'in global memory'} "
        f"({fs.ring_bytes(kt, cluster)} B of ring a block)")
    return out


def flat_device_batches(rt, nhi, pos_all, reps=3):
    """The sweep's throughput per plan at the bench shape: for each cluster
    size and each placement that fits (the engine's two forms), as many
    sources at once as the card holds clusters (cudaOccupancyMaxActiveClusters),
    us a launch and a source by CUDA events, the gather included; the first
    eight sources' column densities against the plain sweep (max_abs_err 0,
    asserted). Returns {"C=.. ring|global": dict(sources=, us=,
    us_per_source=)}."""
    import ctypes
    from pyc2ray_torch.ops import flat_sweep as fs
    from pyc2ray_torch.ops.sweep import CLUSTERS
    kt = rt.kernel_tables()
    lib = fs._lib()
    forms = dict(zip((r for r, _, _ in FLAT_FORMS), flat_forms()))
    want = rt._sweep(rt._gather(nhi, pos_all[:8])[1], rt._dr(DR, "cuda"))
    out = {}
    for C in CLUSTERS:
        for shared in (True, False):
            if shared and fs.ring_bytes(kt, C) > fs.SMEM_MAX:
                continue
            held = ctypes.c_int(0)
            err = lib.flat_sweep_f64(kt.tabs, kt.dims, fs._vals(kt, 1.0),
                                     None, None, None, None, 8, C,
                                     int(shared), ctypes.byref(held),
                                     fs._stream(nhi.device))
            fs._raise_on(lib, "flat_sweep (occupancy)", err)
            n = held.value
            call, cd = flat_probe(rt, nhi, pos_all[:n],
                                  forms["e=f" if shared else "g"], C)
            call()
            err = float((cd[:8] - want[:min(n, 8)]).abs().max())
            if err != 0.0:
                raise RuntimeError(f"3d device batch C={C}: max_abs_err "
                                   f"{err}")
            us = 1e3 * cuda_ms(call, reps)
            key = f"C={C} {'ring' if shared else 'global'}"
            out[key] = dict(sources=n, us=us, us_per_source=us / n)
            log(f"  3d the sweep in device batches, {key}: {n} sources at "
                f"once, {us:.1f} us a launch with its gather, "
                f"{us / n:.2f} us a source, {8 * us / n:.1f} us a batch of "
                f"8; max_abs_err {err:.1e}")
            del cd, call
    return out


def flat_accumulate_forms(rt, pos, phi, reps=20):
    """The accumulate of one bench batch of 8 (float64), device time per call
    (torch.profiler, ``reps`` calls each, the positions staged once): the
    kernel, the first port's (the owner's atomicAdds in shell order,
    csrc/flat_probe.cu) and one unordered index_add_ of the
    batch; the kernel and the first port's held to the plain ordered
    index_add_ (max_abs_err 0, asserted). Returns ms each."""
    from pyc2ray_torch.ops import flat_sweep as fs
    N = rt.config.N
    kt = rt.kernel_tables()
    dev = phi.device
    pos_d = fs.stage_positions(pos, N, dev)
    lin = rt._lin_idx(pos)
    start = torch.rand(N ** 3, dtype=phi.dtype, device=dev) * 1e-12
    want = start.clone()
    rt._accumulate(want, lin, phi)
    lib, probe = fs._lib(), flat_probe_lib()

    def kernel(grid):
        err = lib.flat_accumulate_f64(
            kt.tabs, kt.dims, fs._vals(kt, 1.0), fs._ptr(pos_d),
            fs._ptr(phi), None, fs._ptr(grid), None, pos_d.shape[0],
            fs._stream(dev))
        fs._raise_on(lib, "flat_accumulate", err)

    def first_port(grid):
        err = probe.flat_accumulate_probe(
            kt.tabs, kt.dims, fs._vals(kt, 1.0), fs._ptr(pos_d),
            fs._ptr(phi), fs._ptr(grid), pos_d.shape[0], fs._stream(dev))
        fs._raise_on(probe, "flat_accumulate_probe", err)
    errs = {}
    for name, fn in (("kernel", kernel), ("first port", first_port)):
        got = start.clone()
        fn(got)
        errs[name] = float((got - want).abs().max())
    if any(errs.values()):
        raise RuntimeError(f"3d accumulate forms differ from the plain "
                           f"ordered index_add_: {errs}")
    grid = start.clone()
    ms = dict(kernel=device_ms(lambda _: kernel(grid), reps),
              first_port=device_ms(lambda _: first_port(grid), reps),
              index_add=device_ms(lambda _: grid.index_add_(
                  0, lin.view(-1), phi.view(-1)), reps))
    log(f"  3d flat_accumulate a bench batch, device time a call: the "
        f"kernel {1e3 * ms['kernel']:.2f} us, the first port's (atomic adds "
        f"in shell order) {1e3 * ms['first_port']:.2f} us, one unordered "
        f"index_add_ of the batch {1e3 * ms['index_add']:.2f} us; the kernel "
        f"and the first port's bit-equal to the plain ordered index_add_")
    return ms


def band_tables(rt, band):
    """The engine ``rt``'s kernel tables with the gather's blocks of at most
    ``band`` rows (ops/raytrace.py::gather_runs; the engine's own where
    ``band`` is its GATHER_BAND)."""
    from pyc2ray_torch.ops import flat_sweep as fs
    from pyc2ray_torch.ops.raytrace import GATHER_BAND, gather_runs
    kt = rt.kernel_tables()
    if band == GATHER_BAND:
        return kt
    lo, side = kt.sizes["lo"], kt.sizes["side"]
    blocks, runs, places, staged = gather_runs(rt.geom_np, lo,
                                               lo + side - 1, band)
    tensors = list(kt.tensors)
    tensors[16:19] = [torch.from_numpy(blocks).cuda(),
                      torch.from_numpy(runs).cuda(),
                      torch.from_numpy(places.view(np.int16)).cuda()]
    return fs.pack_tables(tensors, dict(kt.sizes, n_blk=blocks.shape[0],
                                        g_cells=staged),
                          kt.consts, kt.dtype, kt.heat)


# the gather's design steps: (row, what it is, form of flat_gather_probe,
# rows a block of the staged form)
FLAT_GATHER_FORMS = (
    ("a", "the grid-order form: a thread a cell in grid order, reads "
          "along z, its "
          "8-byte stores scattered over the shells", 0, None),
    ("b", "a thread a cell in octahedral order reading the grid through "
          "the offsets (torch.take's pattern without an index tensor)", 1,
     None),
    ("c0", "staged through shared memory, bands of 32 rows, one load in "
           "flight a thread (each value's row by a division), the runs and "
           "places read from global memory where a warp writes", 3, 32),
    ("c16", "staged through shared memory, bands of 16 rows", 2, 16),
    ("c", "staged through shared memory, bands of 32 rows, a warp a row, "
          "4 loads in flight a lane, the runs and places staged too, at "
          "least 6 blocks an SM (the engine's)", 2, 32),
    ("c64", "staged through shared memory, bands of 64 rows", 2, 64),
    ("c/8", "(c) with 8 loads in flight a lane", 4, 32),
    ("c/16", "(c) with 16 loads in flight a lane", 5, 32),
    ("c/4,1", "(c) not held to 6 blocks an SM", 6, 32),
    ("c/4,8", "(c) held to 8 blocks an SM (32 registers)", 7, 32),
    ("c/8,8", "(c/8) held to 8 blocks an SM (32 registers)", 8, 32),
    ("c16/4,8", "(c/4,8) with bands of 16 rows", 7, 16))


def flat_gather_steps(label, rt, nhi, pos, reps):
    """The gather's design steps at one shape (FLAT_GATHER_FORMS, float64):
    us a launch by CUDA events over ``reps`` launches back to back, each
    form's output (made NaN first) against the plain gather (max_abs_err 0,
    asserted), and one torch.take on precomputed indices beside them.
    Returns {row: dict(us=, max_abs_err=)} with "torch.take"."""
    from pyc2ray_torch.ops import flat_sweep as fs
    lib = flat_probe_lib()
    dev = nhi.device
    lin, want = rt._gather(nhi, pos)
    pos_d = fs.stage_positions(pos, rt.config.N, dev)
    B = pos_d.shape[0]
    out = {}
    for row, text, form, band in FLAT_GATHER_FORMS:
        kt = band_tables(rt, band or 32)
        got = torch.full_like(want, float("nan"))

        def call():
            err = lib.flat_gather_probe(
                kt.tabs, kt.dims, fs._vals(kt, 1.0), fs._ptr(nhi),
                fs._ptr(pos_d), fs._ptr(got), B, form, fs._stream(dev))
            fs._raise_on(lib, "flat_gather_probe", err, f" (form {row})")
        call()
        err = float((got - want).abs().max())
        if err != 0.0 or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"3d {label} gather step ({row}): "
                               f"max_abs_err {err}")
        us = 1e3 * cuda_ms(call, reps)
        out[row] = dict(us=us, max_abs_err=err)
        log(f"  3d {label} gather step ({row}) {text}: {us:.2f} us a launch "
            f"of {B} sources ({kt.sizes['n_blk']} blocks a source, "
            f"{kt.sizes['g_cells']} values staged at most); max_abs_err "
            f"{err:.1e}")
        del got, call
    us = 1e3 * cuda_ms(lambda: torch.take(nhi, lin), reps)
    out["torch.take"] = dict(us=us)
    log(f"  3d {label}: one torch.take on precomputed indices {us:.2f} us")
    return out


# the rate pass's design steps, one a form of csrc/flat_probe.cu's
# FLAT_RATE_FORMS in its order (F | K << 4), and the engine's kernel
FLAT_RATE_ROWS = (
    ("a", "the first form: a thread a cell and source, nHI from the grid "
          "at the "
          "cell's image, every cell masked"),
    ("b", "(a) with nHI from the gathered nhi_octa"),
    ("c", "(b) over the rated cells' list"),
    ("d2", "(c) with 2 sources a thread"),
    ("d4", "(c) with 4 sources a thread"),
    ("d8", "(c) with 8 sources a thread"),
    ("e1", "(c) with each tau's place formed once for every table"),
    ("e2", "(e1) with 2 sources a thread"),
    ("e4", "(e1) with 4 sources a thread"),
    ("e8", "(e1) with 8 sources a thread"))


def flat_rate_forms():
    """The forms of FLAT_RATE_FORMS (csrc/flat_probe.cu), one a row of
    FLAT_RATE_ROWS."""
    import ctypes
    out = (ctypes.c_int * 64)()
    n = flat_probe_lib().flat_rates_forms(out, 64)
    if n != len(FLAT_RATE_ROWS):
        raise RuntimeError(f"3d: {n} forms of the flat rate pass, "
                           f"{len(FLAT_RATE_ROWS)} rows")
    return list(out)[:n]


def flat_rates_on(rt, cd, nhi_octa, flux, outs, form=None, nhi=None,
                  pos=None):
    """A closure that launches the rate kernel of engine ``rt`` (or the
    probe's form ``form``, which reads the grid ``nhi`` at the positions
    ``pos`` where it has no nhi_octa) on the sources' column densities
    ``cd``, gathered nHI ``nhi_octa`` and fluxes ``flux`` into ``outs``
    (phi, heat or None), leaving what it does not write."""
    from pyc2ray_torch.ops import flat_sweep as fs
    kt = rt.kernel_tables()
    dev = cd.device
    sdr3 = rt._s_over_dr3(rt._dr(DR, dev))
    B = cd.shape[0]
    if form is None:
        lib = fs._lib()
        fn = getattr(lib, "flat_rates_" + ("f32" if kt.dtype == torch.float32
                                           else "f64"))

        def call():
            err = fn(kt.tabs, kt.dims, fs._vals(kt, DR), fs._ptr(nhi_octa),
                     fs._ptr(flux), fs._ptr(sdr3), fs._ptr(cd),
                     fs._ptr(outs[0]), fs._ptr(outs[1]), B, fs._stream(dev))
            fs._raise_on(lib, "flat_rates", err)
        return call
    lib = flat_probe_lib()
    pos_d = fs.stage_positions(pos, kt.sizes["N"], dev)

    def call():
        err = lib.flat_rates_probe(
            kt.tabs, kt.dims, fs._vals(kt, DR), fs._ptr(nhi), fs._ptr(pos_d),
            fs._ptr(nhi_octa), fs._ptr(flux), fs._ptr(sdr3), fs._ptr(cd),
            fs._ptr(outs[0]), fs._ptr(outs[1]), B, form, fs._stream(dev))
        fs._raise_on(lib, "flat_rates_probe", err, f" (form {form})")
    return call


def rated_check(rt, got, want, untouched):
    """max_abs_err of the rates ``got`` (phi, heat) against the plain
    pass's ``want``: at the rated cells, where ``untouched`` also inf if an
    unrated cell is not NaN any more; at every cell otherwise. NaN where a
    compared cell is NaN."""
    rated = rt.tables.rated
    errs = []
    for g, w in zip(got, want):
        if w is None:
            continue
        if not untouched:
            errs.append(float((g - w).abs().max()))
        elif not bool(g[:, ~rated].isnan().all()):
            errs.append(float("inf"))
        else:
            errs.append(float((g - w)[:, rated].abs().max()))
    return float(torch.tensor(errs).max())


def flat_rate_steps(label, rt, nhi, pos, cd, nhi_octa, flux, reps):
    """The rate pass's design steps at one shape (FLAT_RATE_ROWS and the
    engine's kernel, float64, engine ``rt``'s channels): us a launch by CUDA
    events over ``reps`` launches back to back, each form's outputs (made
    NaN first: the list forms must leave the unrated cells) against the
    plain rate pass on the same column densities (max_abs_err 0,
    asserted). Returns {row: dict(us=, max_abs_err=)}."""
    heat = rt.config.do_heating
    want = rt._rates(cd, nhi_octa, flux, rt._dr(DR, "cuda"))
    rows = [(r, t, f) for (r, t), f in zip(FLAT_RATE_ROWS, flat_rate_forms())]
    rows.append(("engine", "the engine's flat_rates_kernel (rated cells, "
                           "one source a thread, the shared lookups)", None))
    out = {}
    for row, text, form in rows:
        outs = [torch.full_like(cd, float("nan")),
                torch.full_like(cd, float("nan")) if heat else None]
        call = flat_rates_on(rt, cd, nhi_octa, flux, outs, form, nhi, pos)
        call()
        listed = form is None or bool(form & 2)
        err = rated_check(rt, outs, want, listed)
        if err != 0.0:
            raise RuntimeError(f"3d {label} rate step ({row}): max_abs_err "
                               f"{err}")
        us = 1e3 * cuda_ms(call, reps)
        out[row] = dict(us=us, max_abs_err=err)
        log(f"  3d {label} rate step ({row}) {text}: {us:.2f} us a launch "
            f"of {cd.shape[0]} sources; max_abs_err {err:.1e}")
        del outs, call
    return out


def kernel_sass_counts(ins):
    """A kernel without loops over its work, from its SASS
    (``sass_functions``): the fewest instructions from its first to its
    last EXIT over forward branches (``_path_counts``: the shortest path, a
    lower bound of one thread's) with its MUFU and float64 DADD/DMUL/DFMA,
    and every instruction once ("static", an upper estimate: both sides of
    every branch) with its float64 ones."""
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    last_exit = max(i for i, x in enumerate(ins) if re.match(r"EXIT\b", x[1]))
    path = _path_counts(ins, at)(0, last_exit)
    return dict(path=path[0], path_mufu=path[1], path_dp=path[2],
                static=len(ins), static_dp=n_dp(ins))


def flat_rates_sass(rt, n_rated, B):
    """The rate kernels' own SASS per cell and source (the engine's
    flat_rates_kernel<double, tables, no heat> and the first form, a probe
    form, both one source a thread): ``kernel_sass_counts``, and the time
    of n_rated x B cells (the first form's: every cell) at the issue rate
    (``sass_issue_s``) and of their float64 instructions on the float64
    pipe (64 lanes a clock per SM). Returns
    {"engine": {...}, "first": {...}}."""
    from pyc2ray_torch.ops import _build
    C = rt.kernel_tables().sizes["C"]
    out = {}
    for key, lib, want, per, cells in (
            ("engine", "flat_sweep", "flat_rates_kernelIdLb0ELb0E", 1,
             n_rated * B),
            ("first", "flat_probe", "rates_form_kernelIdLb0ELi0ELi1E", 1,
             C * B)):
        funcs = sass_functions(_build._so_path(lib))
        name = next(n for n in funcs if want in n)
        c = kernel_sass_counts(funcs[name])
        _, mhz, sms = issue_rate()
        static = c["static"] / per
        c.update(per_cell_static=static, per_cell_static_dp=c["static_dp"]
                 / per, cells=cells,
                 issue_ms_static=1e3 * sass_issue_s(cells, static, []),
                 dp_pipe_ms_static=1e3 * cells * c["static_dp"] / per
                 / (64 * sms * mhz * 1e6))
        out[key] = c
        log(f"  3d flat_rates SASS ({key}: {want}, {per} source(s) a "
            f"thread): the shortest path {c['path']} instructions "
            f"({c['path_dp']} float64, {c['path_mufu']} MUFU), "
            f"{c['static']} in all ({c['static_dp']} float64): "
            f"{static:.1f} a cell and source at most, over {cells} cells "
            f"{c['issue_ms_static']:.5f} ms at the issue rate, their float64 "
            f"{c['dp_pipe_ms_static']:.5f} ms on the float64 pipe")
    return out


def flat_kernel_check(label, rt, nhi, pos, flux):
    """The gather and the rate kernel of engine ``rt`` on the sources at
    ``pos`` with fluxes ``flux``, bit for bit against the plain gather and
    rate pass: the gather's output from an allocator emptied and then
    holding only blocks of NaN, the rate kernel's outputs made NaN (its
    unrated cells must stay NaN) and through ``rates_batch`` (zeros there,
    all cells compared). The rates read the sweep kernel's column
    densities. Returns {"flat_gather": err, "flat_rates": err}."""
    B, C = pos.shape[0], rt.geom_np.num_cells
    dt = rt.config.dtype
    want_g = rt._gather(nhi, pos)[1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ptrs = {t.data_ptr() for t in [torch.full((B * C,), float("nan"),
                                              dtype=dt, device="cuda")
                                   for _ in range(2)]}
    got_g = rt.gather_batch(nhi, pos)
    on_nan = got_g.data_ptr() in ptrs
    errs = {"flat_gather": float((got_g - want_g).abs().max())}
    cd = rt.sweep_batch(nhi, pos, DR)
    want = rt._rates(cd, want_g, flux, rt._dr(DR, "cuda"))
    outs = [torch.full_like(cd, float("nan")),
            torch.full_like(cd, float("nan")) if rt.config.do_heating
            else None]
    flat_rates_on(rt, cd, got_g, flux, outs)()
    errs["flat_rates"] = float(torch.tensor([
        rated_check(rt, outs, want, True),
        rated_check(rt, rt.rates_batch(cd, got_g, flux, DR), want,
                    False)]).max())
    mode = ("grey" if rt.config.grey_analytic else "heat"
            if rt.config.do_heating else "tables")
    log(f"  {label} {dt} {mode}: the gather (on a block of NaN: {on_nan}) "
        f"max_abs_err={errs['flat_gather']:.1e}, the rates over "
        f"{int(rt.tables.rated.sum())} of {C} rated cells "
        f"max_abs_err={errs['flat_rates']:.1e} ({B} sources)")
    if any(e != 0.0 for e in errs.values()):
        raise RuntimeError(f"{label}: the flat kernels differ from their "
                           f"plain versions: {errs}")
    return errs


def timed_tables(label, rt):
    """``rt.kernel_tables()`` made anew and timed on the host (s, to a
    synchronize of the card), with its gather's map alone
    (``gather_runs``)."""
    from pyc2ray_torch.ops.raytrace import gather_runs
    torch.cuda.synchronize()
    rt._kernel_tables = None
    t0 = time.time()
    kt = rt.kernel_tables()
    torch.cuda.synchronize()
    s = time.time() - t0
    lo, side = kt.sizes["lo"], kt.sizes["side"]
    t0 = time.time()
    gather_runs(rt.geom_np, lo, lo + side - 1)
    s_runs = time.time() - t0
    log(f"  {label}: Raytracer.kernel_tables {s:.4f} s on the host "
        f"({kt.sizes['C']} cells, {kt.sizes['n_blk']} gather blocks, "
        f"{kt.tensors[17].shape[0]} runs, {kt.sizes['n_rated']} rated "
        f"cells), of it the gather's map {s_runs:.4f} s")
    return dict(s=s, s_gather_runs=s_runs)


def flat_variants(N, R, B):
    """Engines of the flat bench's or the golden's shape beside the
    float64 tables one: float64 with heat, float32 with and without heat,
    and the grey rates in both types."""
    from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
    tables = flat_tables()
    for dt, mode in ((torch.float64, "heat"), (torch.float32, "tables"),
                     (torch.float32, "heat"), (torch.float64, "grey"),
                     (torch.float32, "grey")):
        cfg = RaytraceConfig(N=N, R_max_LLS=R, sig=SIG, batch_size=B,
                             dtype=dt, grey_analytic=mode == "grey",
                             do_heating=mode == "heat")
        yield Raytracer(cfg, *tables, device="cuda")


def flat_bench(src_pos, tmp, barrier_us):
    """Phase 3d: the table-exact flat engine at the bench configuration in
    float64 with the model layer's black-body tables, its trace one
    flat_trace_sweep call (csrc/flat_sweep.cu): launch counts of the whole
    trace (asserted), ns per cell-update after and before (the plain loop,
    the whole trace bit-equal); the loop against the plain loop over 16
    batches in float64 and float32, with and without heat; device launches
    per batch (at most 4, asserted) and the idle share of a profiled window
    of 16 batches with each kernel's median device us; each kernel against
    its plain version on the first batch (bit-equal) with its time, the
    plain version's, the library's (the accumulate: one index_add_) and the
    bound; the trace of the first 16 sources against the CPU. Returns the
    kernels line's entries."""
    from pyc2ray_torch.diagnostics import device_idle_share, profile_trace
    from pyc2ray_torch.ops import flat_sweep as fs
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
    N, dt = N_BENCH, torch.float64
    tables = flat_tables()
    t0 = time.time()
    rt = flat_engine(tables, dt, False)
    t_build = time.time() - t0
    t_tables = timed_tables("3d flat bench", rt)
    flux = np.ones(NS_BENCH)
    pos_b, flux_b = rt.prepare_sources(src_pos, flux)
    nbatch = pos_b.shape[0]
    nd = torch.full((N ** 3,), 1e-3, dtype=dt, device="cuda")
    xh = torch.full((N ** 3,), 1.2e-3, dtype=dt, device="cuda")
    rt.trace_batches(nd, xh, pos_b[:2], flux_b[:2], DR)          # warm-up
    torch.cuda.synchronize()
    sweep.reset_launches()
    t0 = time.time()
    phi, _ = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    t_ray = time.time() - t0
    counts = dict(sweep.launches)
    kt = rt.kernel_tables()
    cluster, shared, dev_batch, launches = fs.loop_plan(kt, nbatch, B_BENCH,
                                                        nd.device)
    want = {k: 0 for k in counts}
    want.update(flat_trace_sweep=1, **launches)
    if counts != want:
        raise RuntimeError(f"3d flat engine: launches {counts}, expected "
                           f"{want}")
    if not (bool(torch.isfinite(phi).all()) and float(phi.max()) > 0.0):
        raise RuntimeError("flat engine: Gamma not finite and positive")
    t0 = time.time()
    phi_plain, _ = rt.flat_trace_sweep_ref(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    t_plain = time.time() - t0
    trace_err = float((phi - phi_plain).abs().max())
    if trace_err != 0.0:
        raise RuntimeError(f"3d flat engine: the trace differs from the "
                           f"plain loop's, max_abs_err {trace_err}")
    del phi_plain
    updates = cell_updates(NS_BENCH, R_BENCH)
    n_shells = kt.sizes["n_shells"]
    log(f"flat engine N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float64 "
        f"(q_max {rt.geom_np.max_q}, {rt.geom_np.num_cells} cells, "
        f"{n_shells} shells, ring depth {kt.sizes['depth']}, tables "
        f"{t_build:.1f} s; the sweep in clusters of {cluster} blocks, "
        f"{dev_batch} sources a launch, column densities "
        f"{'in the shared ring' if shared else 'global'}): "
        f"{nbatch} batches in "
        f"{t_ray:.4f} s = {1e9 * t_ray / updates:.4f} ns/cell-update, "
        f"{1e3 * t_ray / nbatch:.4f} ms per batch (one flat_trace_sweep "
        f"call; launches " + ", ".join(f"{k} {v}" for k, v in counts.items()
                                      if v)
        + f"); before (the plain loop): {t_plain:.4f} s = "
        f"{1e9 * t_plain / updates:.4f} ns/cell-update, "
        f"{1e3 * t_plain / nbatch:.4f} ms per batch; Gamma bit-equal")
    # the loop against the plain loop, 16 batches, both types, heat or not
    errs = {}
    for label, d, heat in (("float64", dt, False),
                           ("float64 with heat", dt, True),
                           ("float32", torch.float32, False),
                           ("float32 with heat", torch.float32, True)):
        e = rt if (d, heat) == (dt, False) else flat_engine(tables, d, heat)
        errs[label] = flat_loop_vs_plain(
            label, e, nd.to(d), xh.to(d), pos_b[:16], flux_b[:16].to(d))
        del e
    # the device: launches per batch, idle share, each kernel's us
    nwin = 16
    prof = os.path.join(tmp, "flat")
    t0 = time.time()
    with profile_trace(prof) as p:
        p["sync"] = rt.trace_batches(nd, xh, pos_b[:nwin], flux_b[:nwin],
                                     DR)[0]
    t_prof = time.time() - t0
    idle = device_idle_share(prof)
    per_k, n_launch = flat_kernel_us(prof)
    per_batch = n_launch / nwin
    # and the launches of the whole trace, profiled
    prof_all = os.path.join(tmp, "flat_trace")
    with profile_trace(prof_all) as p:
        p["sync"] = rt.trace_batches(nd, xh, pos_b, flux_b, DR)[0]
    per_batch_trace = flat_kernel_us(prof_all)[1] / nbatch
    if max(per_batch, per_batch_trace) > 4.0:
        raise RuntimeError(f"3d flat engine: {per_batch:.2f} device "
                           f"launches per batch in {nwin} batches, "
                           f"{per_batch_trace:.2f} over the trace: more "
                           f"than 4")
    # the unprofiled trace's idle share: 1 - its kernels' device time (the
    # profiled medians times the launches a batch) over its wall time
    busy = 1e-3 * sum(per_k[k][0] * launches[k] / nbatch
                      for _, k in FLAT_KERNELS)
    idle_trace = 1.0 - busy * nbatch / (1e3 * t_ray)
    log(f"  3d flat engine, a profiled window of {nwin} batches "
        f"({t_prof:.2f} s): {per_batch:.3f} device launches per batch "
        f"({per_batch_trace:.4f} over the whole trace of {nbatch}), "
        f"device idle share {idle:.4f}; " + "; ".join(
            f"{k} {d:.2f} us after a gap of {g:.2f} us (median of {n})"
            for k, (d, g, n) in per_k.items())
        + f"; the unprofiled trace: {busy:.5f} ms of kernels a batch in "
        f"{1e3 * t_ray / nbatch:.5f} ms, idle share {idle_trace:.4f}")
    # each kernel against its plain version at the shapes the loop gives
    # it: the gather, the sweep (in the loop's plan) and the rates on its
    # first device batch, the accumulate on its first batch of B
    work = flat_work(rt, pos_b)
    pos0 = pos_b.reshape(-1, 3)[:dev_batch]
    flux0 = flux_b.reshape(-1)[:dev_batch]
    work.update({k: v for k, v in flat_work(rt, pos0[None]).items()
                 if k in ("flat_gather", "flat_sweep", "flat_rates")})
    nhi = nd * (1.0 - xh)
    dr_t = torch.tensor(DR, dtype=dt).to("cuda")
    lin, nhi_octa = rt._gather(nhi, pos0)
    no_k = fs.flat_gather(kt, nhi, pos0)
    cd_plain = rt._sweep(nhi_octa, dr_t)
    cd = rt.sweep_batch(nhi, pos0, DR, cluster, shared)
    phi_plain = rt._rates(cd_plain, nhi_octa, flux0, dr_t)[0]
    phi_k = rt.rates_batch(cd_plain, nhi_octa, flux0, DR)[0]
    pos_a, phi_a, lin_a = pos0[:B_BENCH], phi_plain[:B_BENCH], lin[:B_BENCH]
    grid_p = torch.rand(N ** 3, dtype=dt, device="cuda") * 1e-12
    grid_k = grid_p.clone()
    rt._accumulate(grid_p, lin_a, phi_a)
    rt.accumulate_batch(grid_k, None, pos_a, phi_a, None)
    res = {}
    for name, got, ref in (("flat_gather", no_k, nhi_octa),
                           ("flat_sweep", cd, cd_plain),
                           ("flat_rates", phi_k, phi_plain),
                           ("flat_accumulate", grid_k, grid_p)):
        err = float((got - ref).abs().max())
        if err != 0.0:
            raise RuntimeError(f"3d {name} differs from its plain version: "
                               f"max_abs_err {err}")
        res[name] = dict(max_abs_err=err)
    grid = torch.zeros(N ** 3, dtype=dt, device="cuda")
    timed = {
        "flat_gather": (lambda: fs.flat_gather(kt, nhi, pos0),
                        lambda: rt._gather(nhi, pos0)[1],
                        lambda: torch.take(nhi, lin)),
        "flat_sweep": (lambda: rt.sweep_batch(nhi, pos0, DR, cluster,
                                              shared),
                       lambda: rt._sweep(rt._gather(nhi, pos0)[1], dr_t),
                       None),
        "flat_rates": (lambda: rt.rates_batch(cd, nhi_octa, flux0, DR),
                       lambda: rt._rates(cd, nhi_octa, flux0, dr_t),
                       None),
        "flat_accumulate": (
            lambda: rt.accumulate_batch(grid, None, pos_a, phi_a, None),
            lambda: rt._accumulate(grid, rt._lin_idx(pos_a), phi_a),
            lambda: grid.index_add_(0, lin_a.view(-1), phi_a.reshape(-1)))}
    for name, (kern, plain, lib) in timed.items():
        b_ms, b_by = least_ms(*work[name], dt)
        res[name].update(
            ms=per_k[name][0] * 1e-3, ms_wrapper=cuda_ms(kern, 20),
            plain_ms=cuda_ms(plain, 3),
            library_ms=None if lib is None else cuda_ms(lib, 20),
            bound_ms=b_ms, bound_by=b_by, launches=counts[name])
    chain = n_shells * barrier_us[cluster] * 1e-3
    res["flat_sweep"].update(chain_floor_ms=chain, cluster=cluster,
                             shared=shared)
    for name, r in res.items():
        r.update(sources_a_launch=B_BENCH if name == "flat_accumulate"
                 else dev_batch)
    for name, r in res.items():
        log(f"  3d {name}: max_abs_err={r['max_abs_err']:.1e}; device "
            f"{r['ms']:.5f} ms per launch in the loop ({r['sources_a_launch']}"
            f" sources a launch; a wrapper call {r['ms_wrapper']:.5f} ms by "
            f"CUDA events) against the plain version {r['plain_ms']:.4f} ms"
            + ("" if r["library_ms"] is None else
               f" and one {'torch.take' if name == 'flat_gather' else 'index_add_'}"
               f" {r['library_ms']:.5f} ms")
            + f"; bound {r['bound_ms']:.5f} ms ({r['bound_by']}: "
            f"{work[name][0] / 1e6:.2f} MB, {work[name][1] / 1e6:.1f} Mop)"
            + ("" if name != "flat_sweep" else
               f", chain floor {n_shells} x {barrier_us[cluster]:.4f} us "
               f"= {chain:.5f} ms (C={cluster})")
            + f"; {r['launches']} launches in the trace")
    # the sweep's design steps at the bench shape and the golden's (N = 128,
    # the whole box, one source), the accumulate before and after
    steps = {"bench": flat_design_steps("bench", rt, nhi, pos_b[0],
                                        reps=20)}
    rt_g = Raytracer(RaytraceConfig(N=N_GOLDEN, R_max_LLS=1e9, sig=SIG,
                                    batch_size=1, dtype=dt), *tables,
                     device="cuda")
    nhi_g = torch.from_numpy(10 ** np.random.RandomState(9).uniform(
        -4, -2, N_GOLDEN ** 3)).to("cuda", dt)
    pos_g = torch.tensor([[3 * N_GOLDEN // 4, 3 * N_GOLDEN // 4,
                           N_GOLDEN // 2]], device="cuda")
    steps["golden"] = flat_design_steps(f"the golden's shape (N={N_GOLDEN}, "
                                        "whole box, B=1)", rt_g, nhi_g, pos_g,
                                        reps=5)
    # the gather's and the rate pass's design steps at the bench shape (the
    # loop's first device batch) and the golden's, the rate kernels' SASS
    g_label = f"the golden's shape (N={N_GOLDEN}, whole box, B=1)"
    g_steps = {"bench": flat_gather_steps("bench", rt, nhi, pos0, reps=20),
               "golden": flat_gather_steps(g_label, rt_g, nhi_g, pos_g,
                                           reps=20)}
    flux_g = torch.tensor([10.0], dtype=dt, device="cuda")
    no_g = rt_g._gather(nhi_g, pos_g)[1]
    r_steps = {"bench": flat_rate_steps("bench", rt, nhi, pos0, cd,
                                        nhi_octa, flux0, reps=20),
               "golden": flat_rate_steps(g_label, rt_g, nhi_g, pos_g,
                                         rt_g.sweep_batch(nhi_g, pos_g, DR),
                                         no_g, flux_g, reps=20)}
    sass = flat_rates_sass(rt, kt.sizes["n_rated"], dev_batch)
    del rt_g, nhi_g, no_g
    # every kept form against its plain version in both types, with and
    # without heat, grey, on the loop's first device batch
    kernel_errs = {}
    for e in flat_variants(N, R_BENCH, B_BENCH):
        errs_e = flat_kernel_check("3d the flat kernels at the bench shape",
                                   e, nhi.to(e.config.dtype), pos0,
                                   flux0.to(e.config.dtype))
        key = f"{e.config.dtype}".replace("torch.", "") + (
            " grey" if e.config.grey_analytic else " heat"
            if e.config.do_heating else "")
        kernel_errs[key] = errs_e
        del e
    steps["device_batches"] = flat_device_batches(rt, nhi,
                                                  pos_b.reshape(-1, 3))
    acc_ms = flat_accumulate_forms(rt, pos_a, phi_a)
    res["flat_sweep"].update(
        design_steps=steps, before_ms=1e-3 * steps["bench"]["a"]["us"],
        after_ms_back_to_back=1e-3 * steps["bench"]["e=f"]["us"],
        before="the first port's form (a), back to back by CUDA events")
    res["flat_gather"].update(
        design_steps=g_steps, before_ms=1e-3 * g_steps["bench"]["a"]["us"],
        after_ms_back_to_back=1e-3 * g_steps["bench"]["c"]["us"],
        before="the grid-order form (a), back to back by CUDA events",
        variants=kernel_errs)
    res["flat_rates"].update(
        design_steps=r_steps, sass=sass,
        before_ms=1e-3 * r_steps["bench"]["a"]["us"],
        after_ms_back_to_back=1e-3 * r_steps["bench"]["engine"]["us"],
        before="the first form (a), back to back by CUDA events",
        variants=kernel_errs)
    res["flat_accumulate"].update(
        before_ms=acc_ms["first_port"], after_ms_alone=acc_ms["kernel"],
        index_add_ms=acc_ms["index_add"],
        before="the first port's atomic form, device time a call")
    # the loop per trace, after and before
    loop_ms = cuda_ms(lambda: rt.trace_batches(nd, xh, pos_b, flux_b, DR), 3)
    b_ms, b_by = least_ms(*work["flat_trace_sweep"], dt)
    res["flat_trace_sweep"] = dict(
        max_abs_err=trace_err, ms=loop_ms, plain_ms=1e3 * t_plain,
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        launches=counts["flat_trace_sweep"], loop_vs_plain_16=errs,
        launches_per_batch=per_batch,
        launches_per_batch_trace=per_batch_trace, idle_share=idle,
        idle_share_unprofiled=idle_trace,
        ns_per_cell=1e9 * t_ray / updates,
        ns_per_cell_before=1e9 * t_plain / updates,
        kernel_tables_s=t_tables)
    log(f"  3d flat_trace_sweep: {loop_ms:.3f} ms per trace of {nbatch} "
        f"batches by CUDA events ({loop_ms / nbatch:.5f} ms per batch), "
        f"the plain loop {1e3 * t_plain:.1f} ms (host clock, once); bound "
        f"{b_ms:.5f} ms ({b_by})")
    rt_cpu = flat_engine(tables, dt, False, device="cpu")
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
    return res


# the box engine's operations (csrc/box_sweep.cuh), a transcendental counted
# as one: per valid cell and source of the sweep beyond shell 0 (4 c*sig,
# 4 max, 4 div, 4 c*w, 6 adds, diag*, /, path*dr, nHI*pdr, +; its five
# divisions a reciprocal each on the MUFU pipe), one product in shell 0;
# per rated cell and source of the rate pass (pdr, dcol, dtau, tau_in, 2
# prefactor products, the mask, clamp, the result's product and division;
# 2 more with heat) and per bin where the cell's cdin is below MAX_COLDENSH
# (2 negated products, exp, expm1, its negation, core, w*core, the add; 2
# more with heat; float32's exp and expm1 one MUFU instruction each, the
# division's reciprocal one a channel)
BOX_SWEEP_OPS = 27
BOX_SWEEP_MUFU = 5
BOX_RATE_OPS = 10
BOX_BIN_OPS = 8
BOX_KERNELS = (("sheet_gather_kernel", "box_gather"),
               ("sheet_sweep_kernel", "box_sweep"),
               ("sheet_rates_kernel", "box_rates"),
               ("accumulate_boxes_kernel", "accumulate_boxes"))
# 3f's design steps of the sweep (box_sweep_steps): (name, kind, threads,
# group, shared, blocks, tag): "first" the first port's kernel (csrc/
# box_probe.cu, shared: its ring form), "engine" the engine's kernel through
# the binding, "group" box_probe.cu's group_sweep_kernel (S sources a
# thread), "persistent" the engine's kernel through the probe (blocks: a
# fraction of those the card holds), "lanes" S sources a block, a thread
# each (box_probe.cu's lanes_sweep_kernel), "cg" / "hot" / "nodiv" / "two"
# group_sweep_kernel with the corners read past L1 / the tables L1-hot / a
# multiply for each division (these two timed only) / two cells a trip;
# "one" marks the forms also run at 4h's one source
BOX_SWEEP_STEPS = (
    ("first global", "first", 256, 1, False, None, ""),
    ("first global", "first", 1024, 1, False, None, "one"),
    ("first ring", "first", 1024, 1, True, None, "one"),
    ("(a) S=1 global", "engine", 128, 1, False, None, ""),
    ("(a) S=1 global", "engine", 256, 1, False, None, "one"),
    ("(a) S=1 global", "engine", 512, 1, False, None, ""),
    ("(a) S=1 global", "engine", 1024, 1, False, None, "one"),
    ("(a) S=1 global, the probe's kernel", "group", 256, 1, False, None, ""),
    ("(a) S=1 global, corners past L1", "cg", 256, 1, False, None, ""),
    ("(a) S=1 global, tables L1-hot", "hot", 256, 1, False, None, ""),
    ("(a) S=1 global, no divisions", "nodiv", 256, 1, False, None, ""),
    ("(a) S=1 global, two cells a trip", "two", 256, 1, False, None, ""),
    ("(a) S=1 global, two cells a trip", "two", 512, 1, False, None, ""),
    ("(b) S=2 a thread", "group", 256, 2, False, None, ""),
    ("(b) S=2 a thread", "group", 512, 2, False, None, ""),
    ("(b) S=4 a thread", "group", 128, 4, False, None, ""),
    ("(b) S=4 a thread", "group", 256, 4, False, None, ""),
    ("(b) S=8 a thread", "group", 128, 8, False, None, ""),
    ("(b) S=8 a thread", "group", 256, 8, False, None, ""),
    ("(b) S=4 a thread, corners past L1", "cg", 256, 4, False, None, ""),
    ("(b) S=4 a thread, tables L1-hot", "hot", 256, 4, False, None, ""),
    ("(b) S=4 a thread, no divisions", "nodiv", 256, 4, False, None, ""),
    ("(b) S=2 a block", "lanes", 512, 2, False, None, ""),
    ("(b) S=4 a block", "lanes", 1024, 4, False, None, ""),
    ("(b) S=8 a block", "lanes", 1024, 8, False, None, ""),
    ("(c) S=1 persistent 1/2", "persistent", 256, 1, False, 2, ""),
    ("(c) S=2 a thread, persistent 1/2", "group", 512, 2, False, 2, ""),
    ("(d) S=1 ring", "engine", 256, 1, True, None, "one"),
    ("(d) S=1 ring", "engine", 512, 1, True, None, "one"),
    ("(d) S=1 ring", "engine", 1024, 1, True, None, "one"),
    ("(d) S=2 ring", "group", 512, 2, True, None, ""))
# csrc/box_probe.cu's sweep forms by kind ("group": 7, its shared ring 8)
BOX_PROBE_FORM = {"cg": 2, "hot": 3, "nodiv": 4, "lanes": 5, "two": 6,
                  "group": 7, "persistent": 9}
# the largest block of box_probe.cu's group_sweep_kernel for S sources
BOX_GROUP_MAX_THREADS = {1: 1024, 2: 512, 4: 256, 8: 256}
# 3f's design steps of the rate pass (box_rate_steps): csrc/box_probe.cu's
# forms: 0 the first port's kernel, 1 to 4 the persistent grid with the bins
# loaded (1, 2) or as parameters (3, 4), one (1, 3) or two (2, 4) a trip;
# 5 the engine's kernel (a pair a thread, the bins as parameters, two a
# trip), 6 a pair a thread, the bins as parameters, one a trip
BOX_RATE_FORMS = ((0, "first port's grid"), (1, "(a) persistent"),
                  (2, "(a)+(c) two bins a trip"),
                  (3, "(a)+(b) bins as parameters"),
                  (4, "(a)+(b)+(c)"), (6, "a pair a thread, (b)"),
                  (5, "a pair a thread, (b)+(c): the engine's"))
BOX_RATE_CHUNKS = (1, 2, 4, 8, 16)    # (d): batches a rate launch
BOX_STEP_SOURCES = 1024   # 3f's kernel checks and design steps: sources


def box_covered(rt, pos, frame):
    """The padded frame's cells (a bool frame) that the octahedra of the
    sources at box corners ``pos`` (n, 3) cover, marked 64 sources at a
    time."""
    kt = rt.kernel_tables()
    voff = kt.tensors[1].long()
    P = kt.sizes["P"]
    cov = torch.zeros(frame.numel(), dtype=torch.bool, device="cuda")
    pos = torch.as_tensor(pos).to("cuda", torch.int64).reshape(-1, 3)
    for k in range(0, pos.shape[0], 64):
        p = pos[k:k + 64]
        base = (p[:, 0] * P + p[:, 1]) * P + p[:, 2]
        cov[(base[:, None] + voff[None, :]).reshape(-1)] = True
    return cov


def box_work(rt, cov, n, cdin_b, B):
    """{kernel: (bytes, operations s, MUFU instructions)} of box engine
    ``rt``'s kernels as the functions need them: the gather and the sweep
    of n sources, the gather reading the frame cells ``cov`` covers
    (``box_covered``) once and writing n n_v values, the sweep its tables
    once, n n_v nHI in and n n_v incoming column densities out (the
    outgoing ones are the sweep's own state: the kernel's stores of them
    are traffic the function does not need); the rate pass of B
    sources whose incoming column densities are ``cdin_b`` (B, n_v): its
    tables once, nHI and cdin at the rated cells in, 1 or 2 values out, the
    bins' work at the rated cells below MAX_COLDENSH (what this data
    needs). Operations in s at the peak of the engine's type."""
    from pyc2ray_torch.constants import MAX_COLDENSH
    kt = rt.kernel_tables()
    sz, heat, dt = kt.sizes, rt.do_heating, rt.dtype
    isz = torch.finfo(dt).bits // 8
    peak = H100_F32_FLOPS if dt == torch.float32 else H100_F64_FLOPS
    n_v, n_r, E = sz["n_v"], sz["n_r"], sz["E"]
    shell0 = int(kt.tensors[0][1])
    rv = kt.tensors[3].long()
    needed = int((cdin_b[:, rv] <= MAX_COLDENSH).sum())
    f32 = dt == torch.float32
    return {
        "box_gather": (isz * (int(cov.sum()) + n * n_v) + 4 * n_v + 12 * n,
                       0.0, 0),
        "box_sweep": (n_v * (16 + 6 * isz) + 4 * (sz["Q"] + 1)
                      + 2 * isz * n * n_v,
                      (BOX_SWEEP_OPS * n * (n_v - shell0) + n * shell0)
                      / peak, BOX_SWEEP_MUFU * n * (n_v - shell0)),
        "box_rates": (n_r * (8 + 2 * isz)
                      + isz * ((2 + 1 + heat) * B * n_r + B + 1
                               + (2 + heat) * E),
                      (B * n_r * (BOX_RATE_OPS + 2 * heat)
                       + needed * E * (BOX_BIN_OPS + 2 * heat)) / peak,
                      needed * ((2 * E if f32 else 0) + 1 + heat))}


def box_kernel_check(label, rt, frame, pos, flux, n_rates):
    """Each box kernel of engine ``rt`` on the sources at box corners
    ``pos`` (n, 3) of the padded frame ``frame``, bit for bit against its
    plain version: the gather and the sweep over all n (their outputs from
    an allocator emptied and then holding only blocks of NaN), the rate pass
    over the first ``n_rates`` with fluxes ``flux`` on NaN boxes (its
    unrated cells must stay NaN) and through the binding (zeros there, the
    whole boxes compared against the plain pass's unsheared boxes).
    Returns ({kernel: max_abs_err}, the plain inputs for timing)."""
    from pyc2ray_torch.ops import box_sweep as bs
    from pyc2ray_torch.ops.raytrace_box import build_kernel_tables
    from pyc2ray_torch.ops.sweep import s_over_dr3
    kt = rt.kernel_tables()
    g, dt, n = rt.geom, rt.dtype, pos.shape[0]
    t = build_kernel_tables(g, rt._tb_np)
    stack = torch.from_numpy((t["vf"] * g.Q + t["vq"]) * g.Dc ** 2
                             + t["vs"]).to("cuda")
    pathdr = rt.tables.path * torch.tensor(DR, dtype=dt).to("cuda")
    sdr3 = s_over_dr3(DR, dt).to("cuda")
    H = rt._sheets(frame, pos)
    cdin = rt._sweep(H, pathdr, DR)
    want_n = H.reshape(n, -1)[:, stack]
    want_c = cdin.reshape(n, -1)[:, stack]
    m = n_rates
    phi, heat = rt._rates(cdin[:m], H[:m], pathdr, flux[:m], sdr3)
    want_r = [rt._unshear(phi)] + ([rt._unshear(heat)] if rt.do_heating
                                   else [])
    del H, cdin, phi, heat
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nv = kt.sizes["n_v"]
    ptrs = {b.data_ptr() for b in [torch.full((n * nv,), float("nan"),
                                              dtype=dt, device="cuda")
                                   for _ in range(3)]}
    nhi = bs.box_gather(kt, frame, pos)
    got_c = bs.box_sweep(kt, nhi, DR)
    on_nan = {nhi.data_ptr(), got_c.data_ptr()} <= ptrs
    errs = {"box_gather": float((nhi - want_n).abs().max()),
            "box_sweep": float((got_c - want_c).abs().max())}
    rated = torch.zeros(g.Dc ** 3, dtype=torch.bool, device="cuda")
    rated[kt.tensors[4].long()] = True
    nan = [torch.full_like(w, float("nan")) for w in want_r]
    bs.box_rates(kt, got_c[:m], nhi[:m], flux[:m].contiguous(), sdr3, DR,
                 out=(nan[0], nan[1] if rt.do_heating else None))
    zeros = bs.box_rates(kt, got_c[:m], nhi[:m], flux[:m].contiguous(),
                         sdr3, DR)
    err, untouched = 0.0, True
    for a, z, w in zip(nan, zeros, want_r):
        a, w = a.reshape(m, -1), w.reshape(m, -1)
        err = max(err, float((a[:, rated] - w[:, rated]).abs().max()),
                  float((z.reshape(m, -1) - w).abs().max()))
        untouched &= bool(torch.isnan(a[:, ~rated]).all())
    errs["box_rates"] = err if untouched else float("nan")
    spectrum = "grey" if rt.num_bins == 1 else f"{rt.num_bins} bins"
    log(f"  {label} {dt} {spectrum}{' with heat' if rt.do_heating else ''}"
        f" (Q {g.Q}, Dc {g.Dc}, {nv} valid sheet cells, {kt.sizes['n_r']} "
        f"rated): the gather and the sweep of {n} sources (on blocks of NaN: "
        f"{on_nan}) max_abs_err={errs['box_gather']:.1e} / "
        f"{errs['box_sweep']:.1e}, the rates of {m} max_abs_err="
        f"{err:.1e} (unrated cells untouched: {untouched})")
    if any(e != 0.0 for e in errs.values()):
        raise RuntimeError(f"{label}: the box kernels differ from their "
                           f"plain versions: {errs}")
    return errs, (nhi, got_c, sdr3)


def box_accumulate_check(rt, frame, pos, boxes):
    """The accumulate at the box shape: one batch's rate boxes ``boxes``
    (B, Dc, Dc, Dc), 0 outside the rated cells, into a zeroed frame at the
    staged corners ``pos[0]`` over the rated cells (the loop's launch):
    bit-equal to ``add_boxes`` (asserted), device ms a launch
    (``device_ms``), the bound of the function (bytes: the boxes' values at
    the rated cells and the list of them read once, the distinct frame
    cells they cover read and written once) and one ``index_add_`` of the
    batch's rated cells (unordered atomics; the port never calls it), its
    device ms likewise."""
    from pyc2ray_torch.ops import trace_loop
    kt = rt.kernel_tables()
    B, Dc, P = boxes.shape[0], kt.sizes["Dc"], kt.sizes["P"]
    rcell, visit = kt.tensors[4], kt.tensors[9].view(Dc, Dc, Dc)
    n_r, isz = kt.sizes["n_r"], boxes.element_size()
    got, want = torch.zeros_like(frame), torch.zeros_like(frame)
    trace_loop.accumulate_boxes(got, boxes, pos, 0, cells=rcell, valid=visit)
    trace_loop.add_boxes(want, boxes, pos[0])
    if not torch.equal(got, want):
        raise RuntimeError("3f: the accumulate at the box shape differs from "
                           "the slice adds")
    ms = device_ms(lambda i: trace_loop.accumulate_boxes(
        got, boxes, pos, 0, cells=rcell, valid=visit), 20)
    r = rcell.long()
    p = pos[0].long()
    idx = (((p[:, 0, None] + r // (Dc * Dc)) * P + p[:, 1, None]
            + (r // Dc) % Dc) * P + p[:, 2, None] + r % Dc).reshape(-1)
    vals = boxes.reshape(B, -1)[:, r].reshape(-1)
    flat = got.view(-1)
    flat.index_add_(0, idx, vals)
    lib_ms = device_ms(lambda i: flat.index_add_(0, idx, vals), 20)
    distinct = int(torch.unique(idx).numel())
    nbytes = isz * B * n_r + 4 * n_r + 2 * isz * distinct + 12 * B
    b_ms, b_by, binds, parts = function_bound(nbytes, 0.0, 0)
    log(f"  3f accumulate_boxes at the box shape (B {B}, Dc {Dc}, {n_r} rated "
        f"cells a box, {distinct} distinct frame cells): device {ms:.5f} ms "
        f"a launch (bit-equal to the slice adds) against one index_add_ of "
        f"the batch's rated cells {lib_ms:.5f} ms; bound {b_ms:.5f} ms "
        f"(bytes, {nbytes / 1e6:.3f} MB): {b_ms / ms:.3f} of it")
    return dict(ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                distinct_cells=distinct)


def box_loop_vs_plain(label, rt, nd, xh, pos_b, flux_b):
    """The loop (one box_trace_sweep call) against the plain loop over the
    batches ``pos_b``: Gamma (and heat) bit for bit; returns the
    max_abs_err."""
    got = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    want = rt.box_trace_sweep_ref(nd, xh, pos_b, flux_b, DR)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want)
              if w is not None)
    if err != 0.0 or not float(want[0].max()) > 0.0 or \
            (want[1] is None) == rt.do_heating:
        raise RuntimeError(f"3f {label}: the box loop differs from the "
                           f"plain loop, max_abs_err {err}")
    log(f"  3f {label}: the loop against the plain loop over "
        f"{pos_b.shape[0]} batches: max_abs_err={err:.1e} (bit-equal"
        f"{', Gamma and heat' if rt.do_heating else ''})")
    return err


def _box_probe_sweep(rt, form, nhi, cdin, scratch, threads, group, blocks):
    """One launch of csrc/box_probe.cu's sweep form ``form`` (0, 1: the
    first port's kernel in the global and shared placement, ``scratch`` its
    (n, n_v) store; 2-9 on ``blocks`` blocks of ``group`` sources,
    ``scratch`` their rings in the global placement)."""
    from pyc2ray_torch.ops import _build
    from pyc2ray_torch.ops import box_sweep as bs
    kt, n = rt.kernel_tables(), nhi.shape[0]
    lib = _build.load("box_probe")
    sfx = "f32" if kt.dtype == torch.float32 else "f64"
    err = getattr(lib, f"box_sweep_probe_{sfx}")(
        form, kt.tabs, kt.dims, bs._vals(kt, DR), nhi.data_ptr(),
        cdin.data_ptr(), None if scratch is None else scratch.data_ptr(), n,
        threads, group, blocks, bs._stream(nhi.device))
    if err:
        raise RuntimeError(f"box_sweep_probe form {form}: CUDA error {err} "
                           f"({lib.error_string(err)!r})")


def _box_probe_held(rt, form, threads, group):
    from pyc2ray_torch.ops import _build
    from pyc2ray_torch.ops import box_sweep as bs
    kt = rt.kernel_tables()
    held = ctypes.c_int(0)
    lib = _build.load("box_probe")
    sfx = "f32" if kt.dtype == torch.float32 else "f64"
    err = getattr(lib, f"box_probe_resident_{sfx}")(
        form, kt.tabs, kt.dims, bs._vals(kt, DR), threads, group,
        ctypes.byref(held))
    if err:
        raise RuntimeError(f"box_probe_resident form {form}: CUDA error "
                           f"{err}")
    return held.value


def box_sweep_steps(label, rt, nhi, cdin, one=False):
    """The sweep of the sources whose nHI is ``nhi`` (n, n_v) in each form
    of BOX_SWEEP_STEPS (those marked "one" with ``one``) whose ring fits
    and whose block the form allows: device ms a launch (CUDA events, back
    to back), us a source and the blocks the card holds at once; every form
    that computes the function bit-equal to ``cdin`` (asserted). The
    persistent forms run on a fraction of the blocks the card holds of
    their form."""
    from pyc2ray_torch.ops import box_sweep as bs
    from pyc2ray_torch.ops.sweep import SMEM_MAX
    kt, dev, n = rt.kernel_tables(), nhi.device, nhi.shape[0]
    out = {}
    for name, kind, T, S, shared, frac, tag in BOX_SWEEP_STEPS:
        if (one and tag != "one") or (kind != "lanes" and T > (
                BOX_GROUP_MAX_THREADS[S])) or (
                shared and S * bs.ring_bytes(kt) > SMEM_MAX):
            continue
        got = torch.full_like(nhi, float("nan"))
        scratch = None
        if kind == "first":
            held = _box_probe_held(rt, int(shared), T, 1)
            scratch = torch.empty_like(nhi)

            def call(o=got, f=int(shared), T=T, sc=scratch):
                _box_probe_sweep(rt, f, nhi, o, sc, T, 1, n)
        elif kind == "engine":
            held = bs._resident(kt, T, shared, dev)

            def call(o=got, T=T, sh=shared):
                bs.box_sweep(kt, nhi, DR, threads=T, ring=sh, out=o)
        else:
            form = BOX_PROBE_FORM[kind] + (kind == "group" and shared)
            held = _box_probe_held(rt, form, T, S)
            blocks = min(-(-n // S), held)
            blocks = max(1, blocks // frac) if frac else blocks
            if not shared:
                scratch = torch.empty(blocks * S * bs.ring_bytes(kt)
                                      // kt.dtype.itemsize, dtype=kt.dtype,
                                      device=dev)

            def call(o=got, f=form, T=T, S=S, b=blocks, sc=scratch):
                _box_probe_sweep(rt, f, nhi, o, sc, T, S, b)
        call()
        exact = kind not in ("hot", "nodiv")
        if exact and not torch.equal(got, cdin):
            raise RuntimeError(f"3f: the sweep's form {name} at {T} threads "
                               f"differs from the plain sweep")
        ms = cuda_ms(call, 5)
        key = f"{name}, {T} threads"
        out[key] = dict(ms=ms, us_a_source=1e3 * ms / n, held=held,
                        bit_equal=exact)
        del got, call
        scratch = None
    log(f"  {label}: the sweep's design steps over a launch of {n} sources "
        f"(bit-equal each where it computes the function; the ring "
        f"{bs.ring_bytes(kt)} B a source): "
        + "; ".join(f"{k} {v['ms']:.4f} ms ({v['us_a_source']:.4f} us a "
                    f"source, {v['held']} blocks held"
                    f"{'' if v['bit_equal'] else ', timed only'})"
                    for k, v in out.items()))
    return out


def box_rate_steps(label, rt, nhi, cdin, flux, sdr3, B):
    """The rate pass of B sources (the first of ``nhi``, ``cdin``, (n, n_v),
    with fluxes ``flux``) in each form of BOX_RATE_FORMS (csrc/
    box_probe.cu), each bit-equal to the engine's binding (asserted; the
    binding is held to the plain pass by box_kernel_check), and the
    engine's kernel over a chunk of k batches (BOX_RATE_CHUNKS), each
    batch's boxes bit-equal to the binding's: device ms a launch
    (``device_ms``: the kernels alone, not the Python call; the probe's
    forms also by CUDA events, back to back) and us a batch;
    for each chunk also the bytes of its rate boxes (the loop's scratch)
    and the device ms of zeroing them, once a trace."""
    from pyc2ray_torch.ops import _build
    from pyc2ray_torch.ops import box_sweep as bs
    kt, dev = rt.kernel_tables(), nhi.device
    sfx = "f32" if kt.dtype == torch.float32 else "f64"
    lib = _build.load("box_probe")
    E = kt.sizes["E"]
    want = bs.box_rates(kt, cdin[:B], nhi[:B], flux[:B].contiguous(), sdr3,
                        DR)
    out = {}
    for form, name in BOX_RATE_FORMS:
        if form >= 3 and E > 32:      # the bins as parameters
            continue
        got = [torch.full_like(w, float("nan")) if w is not None else None
               for w in want]

        def call(i=0, form=form, got=got):
            err = getattr(lib, f"box_rates_probe_{sfx}")(
                form, kt.tabs, kt.dims, bs._vals(kt, DR), kt.bins,
                nhi.data_ptr(), cdin.data_ptr(), flux.data_ptr(),
                sdr3.data_ptr(), got[0].data_ptr(),
                None if got[1] is None else got[1].data_ptr(), B,
                bs._stream(dev))
            if err:
                raise RuntimeError(f"box_rates_probe form {form}: CUDA error "
                                   f"{err} ({lib.error_string(err)!r})")
        for g in got:
            if g is not None:
                g.zero_()
        call()
        if not all(g is None or torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"3f: the rate pass's form {name} differs "
                               f"from the engine's")
        ms = device_ms(call, 20)
        out[name] = dict(ms=ms, us_a_batch=1e3 * ms,
                         ms_events=cuda_ms(call, 20))
        del got
    for k in BOX_RATE_CHUNKS:
        m = k * B
        if m > nhi.shape[0]:
            break
        fl = flux[:m].contiguous()
        got = bs.box_rates(kt, cdin[:m], nhi[:m], fl, sdr3, DR)
        for j in range(k):
            each = bs.box_rates(kt, cdin[j * B:(j + 1) * B],
                                nhi[j * B:(j + 1) * B],
                                fl[j * B:(j + 1) * B].contiguous(), sdr3, DR)
            if not all(g is None or torch.equal(g[j * B:(j + 1) * B], e)
                       for g, e in zip(got, each)):
                raise RuntimeError(f"3f: the rate pass over a chunk of {k} "
                                   f"batches differs batch by batch")
        ms = device_ms(lambda i: bs.box_rates(kt, cdin[:m], nhi[:m], fl, sdr3,
                                              DR, out=got), 10)
        boxes = [g for g in got if g is not None]
        zero_ms = device_ms(lambda i: [g.zero_() for g in boxes], 5)
        out[f"(d) engine, a chunk of {k}"] = dict(
            ms=ms, us_a_batch=1e3 * ms / k, zero_ms=zero_ms,
            scratch_bytes=sum(g.numel() * g.element_size() for g in boxes))
        del got, boxes
    log(f"  {label}: the rate pass's design steps, {B} sources a batch, "
        f"{E} bins (bit-equal each; device time): "
        + "; ".join(f"{k} {v['ms']:.5f} ms a launch ({v['us_a_batch']:.3f} "
                    f"us a batch"
                    + (f"; by CUDA events {v['ms_events']:.5f} ms"
                       if 'ms_events' in v else "")
                    + (f"; its rate boxes {v['scratch_bytes']} B, zeroed "
                       f"in {v['zero_ms']:.5f} ms once a trace"
                       if 'zero_ms' in v else "") + ")"
                    for k, v in out.items()))
    return out


def box_sass(rt, plan):
    """The box kernels' own SASS (``loop_counts``: the shortest path through
    the innermost loop with a MUFU instruction and around it): the engine's
    sweep in ``plan``'s form and the first port's, instructions a trip of
    the cell loop and a cell and source; the engine's rate pass (no heat,
    its bin form) and the first port's, instructions a bin (a trip covers
    the bins of its MUFU.EX2 pairs: exp and expm1 one each) and around the
    bins a pair; each at the issue rate (``sass_issue_s``) over a launch of
    the bench's device batch (the sweep) and batch (the rates)."""
    from pyc2ray_torch.ops import _build
    kt = rt.kernel_tables()
    sz = kt.sizes
    dt = "f" if rt.dtype == torch.float32 else "d"
    param = "1" if sz["E"] <= 32 else "0"
    rows = (("box_sweep", "trace_loop",
             f"sheet_sweep_kernelI{dt}Lb{int(plan.shared)}EE", 1),
            ("box_sweep first", "box_probe", f"first_sweep_kernelI{dt}Lb0E",
             1),
            ("box_rates", "trace_loop",
             f"sheet_rates_kernelI{dt}Lb0ELb{param}EE", None),
            ("box_rates first", "box_probe", f"first_rates_kernelI{dt}Lb0E",
             None))
    out = {}
    for key, lib, want, S in rows:
        funcs = sass_functions(_build._so_path(lib))
        name = next(n for n in funcs if want in n)
        ins = funcs[name]
        c = loop_counts(ins)
        r = {"iter": c["iter"], "mufu_iter": c["mufu_iter"],
             "cell": c["cell"], "iter_static": c["iter_static"]}
        if S is not None:
            r["per_cell_source"] = c["iter"] / S
            cells = plan.dev_batch * sz["n_v"]
            r["issue_ms"] = 1e3 * sass_issue_s(cells, r["per_cell_source"],
                                               [])
        else:
            bins = max(1, c["mufu_iter"] // 2)
            # around the bins: the loop around them, or where a thread
            # takes one pair, the shortest path to the last EXIT
            at = {a: i for i, (a, _, _) in enumerate(ins)}
            last = max(i for i, x in enumerate(ins)
                       if re.match(r"EXIT\b", x[1]))
            around = c["cell"] or _path_counts(ins, at)(0, last)[0]
            r.update(bins_a_trip=bins, per_bin=c["iter"] / bins,
                     around=around)
            pairs = B_BENCH * sz["n_r"]
            r["issue_ms"] = 1e3 * sass_issue_s(
                pairs, around, [(pairs * sz["E"] / bins, c["iter"])])
        out[key] = r
        log(f"  3f SASS {key} ({name[:60]}): {r}")
    return out


def box_bench(src_pos, bins, tmp):
    """Phase 3f: the octahedral sheet engine at the bench configuration in
    float32 with the compressed bins, its trace one box_trace_sweep call
    (csrc/trace_loop.cu, kernels in csrc/box_sweep.cuh): launch counts of
    the whole trace as the loop counts them (asserted against box_plan),
    ns per cell-update after (all 2048 sources) and before (the plain loop,
    over the batches that fit BOX_BUDGET_S at the pace of 16, and at least
    one past the loop's first device batch), the loop against the plain
    loop over those batches (bit-equal; all of them where the plain loop
    fits the budget); the loop against the plain loop over 16 batches with
    and without heat (bit-equal); device launches per batch (at most 3
    over the whole trace, asserted) and the idle share of a profiled window
    of 16 batches, each kernel's launches (asserted against box_plan and
    the loop's count) and median device us a launch in the profiled whole
    trace; each kernel against its plain version (bit-equal) over the
    first BOX_STEP_SOURCES sources (the rates: the plan's chunk of
    batches) with and without heat and at the grey float64 clipped shape
    (N = 64, R beyond the mesh), with its time a launch in the loop, the
    plain version's and the library's (the gather: torch.take on
    precomputed indices) on the same sources and the bound of that work;
    the design steps of the sweep (``box_sweep_steps``) and of the rate
    pass (``box_rate_steps``), the kernels' own SASS (``box_sass``), the
    accumulate at this shape (``box_accumulate_check``); the loop per
    trace (CUDA events)
    against its bound (the covered frame cells of the trace read once, the
    frame written once, the tables once; the sweep's and the rate pass's
    operations over every source, as box_work counts them on the first
    device batch and rate launch: every rated cell is below MAX_COLDENSH at the
    bench's uniform fields; one add a rated cell and source); the trace of
    the first 16 sources against the CPU; the grey case against the flat
    engine. Returns the kernels line's entries."""
    from pyc2ray_torch.diagnostics import device_idle_share, profile_trace
    from pyc2ray_torch.ops import box_sweep as bs
    from pyc2ray_torch.ops import sweep
    from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
    from pyc2ray_torch.ops.raytrace_box import BoxRaytracer, grey_bins
    from pyc2ray_torch.ops.trace_loop import stage_positions
    N, dt = N_BENCH, torch.float32
    t0 = time.time()
    rt = BoxRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH, dtype=dt)
    kt = rt.kernel_tables()
    t_build = time.time() - t0
    g, sz = rt.geom, kt.sizes
    flux = np.ones(NS_BENCH)
    pos_b, flux_b = rt.prepare_sources(src_pos, flux)
    nb = pos_b.shape[0]
    nd = torch.full((N ** 3,), 1e-3, dtype=dt, device="cuda")
    xh = torch.full((N ** 3,), 1.2e-3, dtype=dt, device="cuda")
    # warm-up: a whole trace, so the timed one finds its scratch allocated
    rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    sweep.reset_launches()
    t0 = time.time()
    phi, _ = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    torch.cuda.synchronize()
    t_ray = time.time() - t0
    counts = dict(sweep.launches)
    plan = bs.box_plan(kt, NS_BENCH, B_BENCH, nd.device)
    dev_batch, launches = plan.dev_batch, plan.launches
    want = {k: 0 for k in counts}
    want.update(box_trace_sweep=1, **launches)
    if counts != want:
        raise RuntimeError(f"3f box engine: launches {counts}, expected "
                           f"{want}")
    if not (bool(torch.isfinite(phi).all()) and float(phi.max()) > 0.0):
        raise RuntimeError("3f box engine: Gamma not finite and positive")
    # before: the plain loop over the batches that fit BOX_BUDGET_S
    nwin = 16
    torch.cuda.synchronize()
    t0 = time.time()
    rt.box_trace_sweep_ref(nd, xh, pos_b[:nwin], flux_b[:nwin], DR)
    torch.cuda.synchronize()
    t_win = time.time() - t0
    # (at least one batch past the loop's first device batch, so the check
    # below reaches the second)
    nb_plain = min(nb, max(nwin, dev_batch // B_BENCH + 1,
                           int(BOX_BUDGET_S * nwin / t_win)))
    t0 = time.time()
    phi_plain, _ = rt.box_trace_sweep_ref(nd, xh, pos_b[:nb_plain],
                                          flux_b[:nb_plain], DR)
    torch.cuda.synchronize()
    t_plain = time.time() - t0
    # the loop against the plain loop over those batches, bit for bit
    if nb_plain < nb:
        phi = rt.trace_batches(nd, xh, pos_b[:nb_plain], flux_b[:nb_plain],
                               DR)[0]
    if nb_plain * B_BENCH <= dev_batch or not torch.equal(phi, phi_plain):
        raise RuntimeError(
            f"3f box engine: the loop over {nb_plain} batches ({dev_batch} "
            f"sources a device batch) differs from the plain loop, max_abs_"
            f"err {float((phi - phi_plain).abs().max())}")
    err_plain = float((phi - phi_plain).abs().max())
    del phi_plain
    updates = cell_updates(NS_BENCH, R_BENCH)
    upd_plain = cell_updates(nb_plain * B_BENCH, R_BENCH)
    log(f"box engine N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32 "
        f"{rt.num_bins} bins (Q {g.Q}, Dc {g.Dc}, c {g.c}; {sz['n_v']} "
        f"valid sheet cells a source, {sz['max_shell']} in the largest shell, "
        f"{sz['n_r']} rated; tables {t_build:.2f} s; the sweep in blocks of "
        f"{plan.threads} threads, a source a block, its ring "
        f"{'in shared memory' if plan.shared else 'in global memory'}, "
        f"{plan.blocks} blocks, {dev_batch} sources a launch; a rate launch "
        f"a chunk of {plan.chunk} batches): {nb} batches in "
        f"{t_ray:.4f} s = {1e9 * t_ray / updates:.4f} ns/cell-update, "
        f"{1e3 * t_ray / nb:.4f} ms per batch (one box_trace_sweep call; "
        f"launches " + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f"); before (the plain loop, "
        + (f"all {nb} batches" if nb_plain == nb else
           f"cut to the first {nb_plain} batches by BOX_BUDGET_S")
        + f"): {t_plain:.4f} s = {1e9 * t_plain / upd_plain:.4f} "
        f"ns/cell-update, {1e3 * t_plain / nb_plain:.4f} ms per batch; the "
        f"loop against it over those {nb_plain} batches "
        f"({-(-nb_plain * B_BENCH // dev_batch)} device batches): "
        f"max_abs_err={err_plain:.1e} (bit-equal)")
    # the loop against the plain loop, 16 batches, heat or not
    errs = {"float32": box_loop_vs_plain("float32", rt, nd, xh,
                                         pos_b[:nwin], flux_b[:nwin])}
    rt_h = BoxRaytracer(N, R_BENCH, SIG, bins, batch_size=B_BENCH,
                        dtype=dt, do_heating=True)
    errs["float32 with heat"] = box_loop_vs_plain(
        "float32 with heat", rt_h, nd, xh, pos_b[:nwin], flux_b[:nwin])
    # the device: launches per batch, idle share, each kernel's us
    prof = os.path.join(tmp, "box")
    t0 = time.time()
    with profile_trace(prof) as p:
        p["sync"] = rt.trace_batches(nd, xh, pos_b[:nwin], flux_b[:nwin],
                                     DR)[0]
    t_prof = time.time() - t0
    idle = device_idle_share(prof)
    per_batch = flat_kernel_us(prof, BOX_KERNELS)[1] / nwin
    prof_all = os.path.join(tmp, "box_trace")
    with profile_trace(prof_all) as p:
        p["sync"] = rt.trace_batches(nd, xh, pos_b, flux_b, DR)[0]
    per_k, n_launch = flat_kernel_us(prof_all, BOX_KERNELS)
    per_batch_trace = n_launch / nb
    idle_trace = device_idle_share(prof_all)
    if per_batch_trace > 3.0:
        raise RuntimeError(f"3f box engine: {per_batch_trace:.3f} device "
                           f"launches per batch over the trace: more than 3")
    # each kernel's launches in the profiled trace, as the profiler saw them
    seen = {k: per_k.get(k, (0, 0, 0))[2] for _, k in BOX_KERNELS}
    if seen != launches or any(counts[k] != v for k, v in seen.items()):
        raise RuntimeError(f"3f box engine: the profiled trace's launches "
                           f"{seen}, box_plan's {launches}, the loop's "
                           f"count {counts}")
    busy = 1e-3 * sum(per_k[k][0] * launches[k] / nb
                      for _, k in BOX_KERNELS)
    log(f"  3f box engine, a profiled window of {nwin} batches "
        f"({t_prof:.2f} s): {per_batch:.4f} device launches per batch, idle "
        f"share {idle:.4f}; the profiled trace of {nb}: {per_batch_trace:.4f}"
        f" device launches per batch, idle share {idle_trace:.4f}; " +
        "; ".join(f"{k} {d:.2f} us a launch after a gap of {gp:.2f} us "
                  f"(median of {c})" for k, (d, gp, c) in per_k.items())
        + f"; {busy:.5f} ms of kernels a batch against "
        f"{1e3 * t_ray / nb:.5f} ms by the host clock; launches seen in the "
        f"profiled trace " + ", ".join(f"{k} {v}" for k, v in seen.items())
        + " (box_plan's and the loop's count)")
    # each kernel against its plain version at the shapes the loop gives
    # it: the gather and the sweep on its first device batch, the rates on
    # its first batch of B
    frame = rt.wrap_pad(nd, xh)
    pos = stage_positions(pos_b, frame.shape, g.Dc, "cuda")
    pos0 = pos.reshape(-1, 3)[:dev_batch]
    # the kernels' checks, wrapper timings and design steps over the
    # first BOX_STEP_SOURCES sources, whatever the plan's device batch
    n_steps = min(BOX_STEP_SOURCES, NS_BENCH)
    flux0 = flux_b.reshape(-1)[:n_steps]
    # the rate pass at the loop's launch: a chunk of batches
    m_r = plan.chunk * B_BENCH
    variants = {}
    variants["float32"], (nhi, cdin, sdr3) = box_kernel_check(
        "3f bench", rt, frame, pos.reshape(-1, 3)[:n_steps], flux0, m_r)
    variants["float32 with heat"], _ = box_kernel_check(
        "3f bench", rt_h, frame, pos0[:m_r], flux0[:m_r], m_r)
    del rt_h
    Ng = N_BOX_GREY
    rng = np.random.RandomState(64)
    nd_g = torch.from_numpy(10 ** rng.uniform(-4, -2, Ng ** 3)).to("cuda")
    xh_g = torch.from_numpy(rng.uniform(0.0, 0.9, Ng ** 3)).to("cuda")
    box_g = BoxRaytracer(Ng, 1e9, SIG, grey_bins(), batch_size=B_BENCH,
                         dtype=torch.float64)
    frame_g = box_g.wrap_pad(nd_g, xh_g)
    pos_g = torch.from_numpy(rng.randint(0, Ng, size=(NS_BOX_GREY,
                                                      3))).to("cuda")
    flux_g = torch.from_numpy(rng.uniform(0.5, 2.0, NS_BOX_GREY)).to("cuda")
    variants["float64 grey clipped"], _ = box_kernel_check(
        f"3f grey N={Ng} R=1e9", box_g, frame_g, pos_g, flux_g, NS_BOX_GREY)
    del frame_g
    # times, the library's, the bounds
    cov = box_covered(rt, pos0, frame)
    work = box_work(rt, cov, dev_batch, cdin[:m_r], m_r)
    frame_flat = frame.reshape(-1)
    P = sz["P"]
    base = ((pos0[:, 0].long() * P + pos0[:, 1]) * P + pos0[:, 2])
    idx = base[:, None] + kt.tensors[1].long()[None, :]
    pathdr = rt.tables.path * torch.tensor(DR, dtype=dt).to("cuda")
    Hm = rt._sheets(frame, pos0[:m_r])
    cdm = rt._sweep(Hm, pathdr, DR)
    fm = flux0[:m_r].contiguous()
    timed = {
        "box_gather": (lambda: bs.box_gather(kt, frame, pos0),
                       lambda: rt._sheets(frame, pos0),
                       lambda: torch.take(frame_flat, idx)),
        "box_sweep": (lambda: bs.box_sweep(kt, nhi, DR),
                      lambda: rt._sweep(rt._sheets(frame, pos0), pathdr, DR),
                      None),
        "box_rates": (lambda: bs.box_rates(kt, cdin[:m_r], nhi[:m_r], fm,
                                           sdr3, DR),
                      lambda: [rt._unshear(x) for x in rt._rates(
                          cdm, Hm, pathdr, fm, sdr3) if x is not None],
                      None)}
    res = {}
    for name, (kern, plain, lib) in timed.items():
        b_ms, b_by, binds, parts = function_bound(*work[name])
        res[name] = dict(
            max_abs_err=max(v[name] for v in variants.values()),
            ms=per_k[name][0] * 1e-3, ms_wrapper=cuda_ms(kern, 5),
            plain_ms=cuda_ms(plain, 1),
            library_ms=None if lib is None else cuda_ms(lib, 5),
            bound_ms=b_ms, bound_by=b_by, bound_part=binds,
            bound_parts=parts, launches=seen[name],
            sources_a_launch=m_r if name == "box_rates" else dev_batch,
            variants={k: v[name] for k, v in variants.items()})
        r = res[name]
        log(f"  3f {name}: max_abs_err={r['max_abs_err']:.1e}; device "
            f"{r['ms']:.5f} ms per launch in the loop "
            f"({r['sources_a_launch']} sources a launch; a wrapper call of "
            f"{m_r if name == 'box_rates' else n_steps} sources "
            f"{r['ms_wrapper']:.5f} ms by CUDA events) against the plain "
            f"version {r['plain_ms']:.4f} ms"
            + ("" if lib is None else
               f" and one torch.take {r['library_ms']:.5f} ms")
            + f"; bound {b_ms:.5f} ms ({binds}: bytes {parts['bytes']:.5f}, "
            f"flops {parts['flops']:.5f}, MUFU {parts['mufu']:.5f}); "
            f"{r['launches']} launches in the trace")
    del idx, Hm, cdm
    res["accumulate_boxes_box_shape"] = box_accumulate_check(
        rt, frame, pos, bs.box_rates(kt, cdin[:B_BENCH], nhi[:B_BENCH],
                                     flux0[:B_BENCH].contiguous(), sdr3,
                                     DR)[0])
    res["box_sweep"].update(
        design_steps=box_sweep_steps("3f bench", rt, nhi, cdin),
        plan=plan._asdict())
    res["box_rates"].update(design_steps=box_rate_steps(
        "3f bench", rt, nhi, cdin, flux0, sdr3, B_BENCH))
    sass = box_sass(rt, plan)
    for name in ("box_sweep", "box_rates"):
        res[name].update(sass=sass[name], sass_first=sass[f"{name} first"])
    log(f"  3f own SASS at the issue rate: the sweep "
        f"{sass['box_sweep']['issue_ms']:.5f} ms a launch of {dev_batch} "
        f"(the kernel {res['box_sweep']['ms']:.5f}), the first port's "
        f"{sass['box_sweep first']['issue_ms']:.5f}; the rates "
        f"{sass['box_rates']['issue_ms']:.5f} ms a batch (the kernel "
        f"{res['box_rates']['ms'] / plan.chunk:.5f} a batch of its launch of "
        f"{m_r}), the first port's "
        f"{sass['box_rates first']['issue_ms']:.5f}")
    # the loop per trace, after and before
    loop_ms = cuda_ms(lambda: rt.trace_batches(nd, xh, pos_b, flux_b, DR), 3)
    cov_all = box_covered(rt, pos, frame)
    isz = torch.finfo(dt).bits // 8
    peak = H100_F32_FLOPS if dt == torch.float32 else H100_F64_FLOPS
    scale = {"box_sweep": NS_BENCH / dev_batch, "box_rates": NS_BENCH / m_r}
    loop_ops = (sum(work[k][1] * v for k, v in scale.items())
                + (1 + rt.do_heating) * sz["n_r"] * NS_BENCH / peak)
    loop_mufu = sum(work[k][2] * v for k, v in scale.items())
    loop_bytes = (isz * (int(cov_all.sum()) + frame.numel() + NS_BENCH)
                  + sz["n_v"] * (20 + 6 * isz) + sz["n_r"] * (8 + 3 * isz)
                  + 12 * NS_BENCH)
    b_ms, b_by, binds, parts = function_bound(loop_bytes, loop_ops,
                                              loop_mufu)
    res["box_trace_sweep"] = dict(
        max_abs_err=max(err_plain, *errs.values()), ms=loop_ms,
        plain_ms=1e3 * t_plain, plain_batches=nb_plain, library_ms=None,
        bound_ms=b_ms, bound_by=b_by, bound_part=binds, bound_parts=parts,
        launches=counts["box_trace_sweep"], loop_vs_plain_16=errs,
        loop_vs_plain_whole=err_plain,
        launches_per_batch=per_batch,
        launches_per_batch_trace=per_batch_trace, idle_share=idle,
        idle_share_trace=idle_trace, ns_per_cell=1e9 * t_ray / updates,
        ns_per_cell_before=1e9 * t_plain / upd_plain,
        dev_batch=dev_batch, kernel_tables_s=t_build)
    log(f"  3f box_trace_sweep: {loop_ms:.3f} ms per trace of {nb} batches "
        f"by CUDA events ({loop_ms / nb:.5f} ms per batch), the plain loop "
        f"{1e3 * t_plain:.1f} ms over {nb_plain} batches (host clock, once); "
        f"bound {b_ms:.5f} ms ({binds}: bytes {parts['bytes']:.5f}, flops "
        f"{parts['flops']:.5f}, MUFU {parts['mufu']:.5f})")
    del nhi, cdin, cov, cov_all
    # the first 16 sources against the CPU, and the grey case against the
    # flat engine
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
    flat = Raytracer(RaytraceConfig(N=Ng, R_max_LLS=1e9, sig=SIG,
                                    batch_size=B_BENCH, dtype=torch.float64,
                                    grey_analytic=True), device="cuda")
    nd_gn, xh_gn = (a.cpu().numpy() for a in (nd_g, xh_g))
    pos_gn, flux_gn = pos_g.cpu().numpy(), flux_g.cpu().numpy()
    sweep.reset_launches()
    t0 = time.time()
    phi_b = box_g.trace(nd_gn, xh_gn, pos_gn, flux_gn, DR)
    torch.cuda.synchronize()
    t_box = time.time() - t0
    boxed = {k: v for k, v in sweep.launches.items() if v}
    phi_f = flat.trace(nd_gn, xh_gn, pos_gn, flux_gn, DR)
    torch.testing.assert_close(phi_b, phi_f, rtol=2e-7, atol=0.0)
    log(f"  box engine grey float64 N={Ng} R=1e9 (Q {box_g.geom.Q}, Dc "
        f"{box_g.geom.Dc}), {NS_BOX_GREY} sources in {t_box:.3f} s "
        f"(launches {boxed}): against the flat engine's analytic grey rates "
        f"max rel {max_rel(phi_b, phi_f):.3e} (rtol 2e-7)")
    if boxed.get("box_trace_sweep") != 1:
        raise RuntimeError(f"3f: the grey trace's launches {boxed}")
    return res


def heating_box(heat_4c):
    """Phase 4h: the heating example of 4c on Raytracing.engine box: its
    five checks (``heating_example``), one box_trace_sweep per raytrace
    iteration and each of its kernels' launches as the loop counts them
    where it issues them, asserted against box_plan's count, xh and T
    against 4c's cheb run ``heat_4c`` (xh, T)."""
    from pyc2ray_torch.ops import box_sweep as bs
    sim, n_iter, counts, t_sim = heating_example("box")
    rt = sim.raytracer
    g_b = rt.geom
    log(f"C2Ray_Test heating example N={N_HEATING} (float64, engine box, "
        f"Q={g_b.Q}, Dc={g_b.Dc}, {rt.num_bins} bins): {STEPS_HEATING} "
        f"timesteps, {n_iter} raytrace iterations, {t_sim:.2f} s with "
        f"set-up; kernel launches {counts}")
    if type(rt).__name__ != "BoxRaytracer":
        raise RuntimeError(f"heating example (box): engine "
                           f"{type(rt).__name__}")
    kt = rt.kernel_tables()
    plan = bs.box_plan(kt, rt.batch_size, rt.batch_size,
                       torch.device("cuda"))
    per_trace = plan.launches
    want = {k: 0 for k in counts}
    want.update({k: v * n_iter for k, v in per_trace.items()},
                box_trace_sweep=n_iter, chemistry_pass=n_iter,
                thermal_update=STEPS_HEATING)
    if counts != want or n_iter == 0:
        raise RuntimeError(f"heating example (box): launches {counts}, "
                           f"expected {want}")
    log(f"  box: one box_trace_sweep per raytrace iteration ({n_iter}), "
        f"the loop's launches " + ", ".join(f"{k} {counts[k]}"
                                            for k in per_trace)
        + " (box_plan's, " + ", ".join(f"{k} {v}" for k, v in
                                       per_trace.items())
        + f" a trace); the sweep in blocks of {plan.threads} threads, "
        f"a source a block, its ring "
        + (f"in shared memory ({bs.ring_bytes(kt)} B)"
           if plan.shared else "in global memory")
        + f", {kt.sizes['n_v']} valid sheet cells, {kt.sizes['max_shell']} "
        f"in the largest shell")
    for name, got, want_a in (("xh", sim.xh, heat_4c[0]),
                              ("T", sim.temp, heat_4c[1])):
        got = np.asarray(got)
        log(f"  box against 4c's cheb run: {name} max rel "
            f"{np.max(np.abs(got - want_a) / np.abs(want_a)):.3e}, mean "
            f"{got.mean():.6e} against {want_a.mean():.6e}")
    # the sweep's forms at this shape, its one source on the final fields
    dev = torch.device("cuda")
    frame = rt.wrap_pad(*(torch.as_tensor(np.asarray(a), dtype=rt.dtype,
                                          device=dev)
                          for a in (sim.ndens, sim.xh)))
    pos = torch.tensor([[N_HEATING // 2] * 3], dtype=torch.int32, device=dev)
    _, (nhi, cdin, _) = box_kernel_check(
        f"4h N={N_HEATING}", rt, frame, pos,
        torch.ones(1, dtype=rt.dtype, device=dev), 1)
    box_sweep_steps(f"4h (N={N_HEATING}, float64, one source)", rt, nhi,
                    cdin, one=True)
    return counts


def heating_example(engine):
    """examples/heating_test/run_test.py through C2Ray_Test(<its parameters
    as a dict>, 48, device="cuda") with Raytracing.engine ``engine``: six
    timesteps in float64, then that script's five checks, each printed;
    raises if one fails. Returns the simulation, its raytrace iterations,
    the kernel launch counts of the run and its wall time."""
    from pyc2ray_torch import C2Ray_Test
    from pyc2ray_torch.examples.heating_test import (
        heating_checks, heating_params, profiles)
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
    for line in quiet_log.getvalue().splitlines():
        if "Thermal update took" in line:
            log(f"  {engine}: {line.strip()}")
    temp_h, xh_h = np.asarray(sim.temp), np.asarray(sim.xh)
    if not (np.all(np.isfinite(temp_h)) and np.all(np.isfinite(xh_h))):
        raise RuntimeError(f"heating example ({engine}): non-finite temp or "
                           f"xh")
    checks = heating_checks(temp_h, xh_h, Nh)
    t_prof, x_prof = profiles(temp_h, xh_h, Nh)
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
    72 default bins: one trace as one he_trace_sweep call (launches
    asserted: K1 three per batch, rates_he and the accumulate one per batch,
    the extract of the three species once per chunk) and one
    global_pass_he; the loop against the same trace before the loop in C
    on the trace's frames (trace_extended_plain, the batch loop in Python
    with the plain rate pass; CUDA events), bit-equal, with its bound, and
    its kernels' device us, gaps
    and idle share from one profiled trace; the per-batch device ms of its
    stages beside the plain ones and the matmul form of the rate pass; the
    loop with the heat channel against the plain loop; Gamma_HI of a
    helium-free field against the hydrogen engine at the same bins.
    Returns the launches of the trace and the loop's numbers per trace."""
    from pyc2ray_torch.ops import chemistry_he, sweep
    from pyc2ray_torch.ops.cheb_rates import rates_he_ref
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
    updates = cell_updates(NS_BENCH, R_BENCH)

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
    want.update(he_trace_launches(rt, nbatch))
    if counts != want:
        raise RuntimeError(f"helium trace: launches {counts}, expected "
                           f"{want}")
    for name, t in zip(("G_HI", "G_HeI", "G_HeII"), g):
        if not (bool(torch.isfinite(t).all()) and float(t.max()) > 0.0):
            raise RuntimeError(f"helium trace: {name} not finite and "
                               f"positive")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # before: the batch loop as the engine issued it before the loop in C,
    # on the trace's frames, bit-equal to the loop
    eng = rt.eng
    Dc = eng.geom.Dc
    pads = [eng.wrap_pad(f) for f in rt.species_fields(nd, xh, y1, y2)]
    label = f"helium bench N={N} B={B_BENCH} ({nbatch} batches)"
    k_loop = he_loop_against_plain(label, rt, pads, pos_b, flux_b, reps=1)
    t_plain = k_loop["plain_ms"] / 1e3
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
    conv = int(out[6])
    chemistry_check("helium bench chemistry (256^3 float32, this trace's "
                    "rates)", True, (dt_d, nd, temp, xh, xh, y1, y1, y2, y2,
                                     *g, phe), {}, reps=3)
    del out, out8
    ns_cell, ns_plain = 1e9 * t_ray / updates, 1e9 * t_plain / updates
    NS_PER_CELL["helium bench"] = ns_cell
    log(f"helium engine N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32 "
        f"{bins_he.num_bins} bins: raytrace {t_ray:.4f} s = {ns_cell:.4f} "
        f"ns/cell-update (one he_trace_sweep call; before the loop in C, "
        f"trace_extended_plain on its frames: {t_plain:.4f} s = "
        f"{ns_plain:.4f}, "
        f"{t_plain / t_ray:.2f}x; the rate frames bit-equal), launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f" ({nbatch} batches), peak device memory {peak_gb:.2f} GiB; "
        f"global_pass_he {t_chem:.4f} s, conv_flag {conv}, converged "
        f"within 8 inner iterations: {within8}")

    # the loop's bound, and its kernels on the device from one profiled
    # trace
    nbytes, ops = he_loop_work(rt, pads, pos_b)
    k_loop["bound_ms"], k_loop["bound_by"] = least_ms(nbytes, ops, dt)
    log(f"  {label}: the loop's bound {k_loop['bound_ms']:.4f} ms per trace "
        f"({k_loop['bound_by']}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} "
        f"Gop), the loop at {k_loop['bound_ms'] / k_loop['ms']:.3f} of it")
    k_loop["kernels"] = {k: dict(us=v[0], gap_us=v[1], count=v[2])
                         for k, v in loop_kernel_gaps(
                             label, rt, pads, pos_b, flux_b).items()}

    # per-batch device ms of each stage, CUDA events, first 16 batches:
    # the box kernels (three species in one extract, the three channels in
    # one accumulate over the rated cells, as the loop issues them), the
    # three sweeps and the rate pass's kernel, and on the same batch the
    # plain gathers, rate pass, slice adds and the matmul form of the rate
    # pass; the frames bit-equal to the plain ones and to trace_extended's
    # over the same batches
    from pyc2ray_torch.ops.trace_loop import (accumulate_boxes, add_boxes,
                                              extract_boxes,
                                              extract_boxes_ref,
                                              stage_positions)
    heb, rt_sub, rb0 = rt.he_tables, eng.tables.rt_sub, eng._rb0
    sdr3 = sweep.rate_consts(DR, dt)[1]
    acc = [torch.zeros_like(pads[0]) for _ in range(3)]
    acc_plain = [torch.zeros_like(pads[0]) for _ in range(3)]
    tot = dict.fromkeys(("extract", "K1_HI", "K1_HeI", "K1_HeII",
                         "rates_he", "accumulate", "extract_plain",
                         "rates_he_plain", "rates_matmul",
                         "accumulate_plain"), 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(tot) + 1)]
    nwin, mm_rel = min(16, nbatch), 0.0
    pos_d = stage_positions(pos_b[:nwin], pads[0].shape, Dc, "cuda")
    for k in range(nwin):
        ev[0].record()
        boxes = extract_boxes(pads, pos_d, k, Dc)
        ev[1].record()
        cds = []
        for s in range(3):
            cds.append(eng.sweep_box(boxes[s], DR, rt.sigma_th[s]))
            ev[2 + s].record()
        rates = rt._rates_he(cds, boxes, flux_b[k], DR)
        ev[5].record()
        accumulate_boxes(acc, rates, pos_d, k, rb0, cells=eng.rated_cells,
                         valid=rt_sub[2])
        ev[6].record()
        plain = [extract_boxes_ref(p, pos_b[k].to("cuda"), Dc) for p in pads]
        ev[7].record()
        ref = rates_he_ref(cds, boxes, rt_sub, flux_b[k], heb.se, heb.w_se,
                           DR, sdr3, rb0, cells=eng.rated_cells)
        ev[8].record()
        mm = rates_he_matmul(rt, cds, boxes, flux_b[k], DR)
        ev[9].record()
        for pad, box in zip(acc_plain, ref):
            add_boxes(pad, box, pos_b[k], rb0)
        ev[10].record()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(boxes, plain)):
            raise RuntimeError("helium: extract_boxes differs from the "
                               "plain gather")
        if not all(torch.equal(a, b) for a, b in zip(rates, ref)):
            raise RuntimeError("helium: rates_he differs from the plain "
                               "rate pass")
        mm_rel = max([mm_rel] + [max_rel(a, m, 1e-6)
                                 for a, m in zip(rates, mm)])
        for i, name in enumerate(tot):
            tot[name] += ev[i].elapsed_time(ev[i + 1])
    whole = rt.trace_extended(pads, pos_b[:nwin], flux_b[:nwin], DR)
    if not all(torch.equal(a, b) and torch.equal(a, w)
               for a, b, w in zip(acc, acc_plain, whole)):
        raise RuntimeError("helium: the accumulated rates differ from the "
                           "plain slice adds")
    if not mm_rel < 1e-3:
        raise RuntimeError(f"helium: the matmul form differs from rates_he "
                           f"by {mm_rel:.3e}")
    log("  per-batch device ms: " + ", ".join(
        f"{k} {v / nwin:.4f}" for k, v in tot.items())
        + f"; over {nwin} batches the three rate frames bit-equal to the "
        f"plain loop's and to trace_extended's; the matmul form within "
        f"{mm_rel:.3e} (rel, above 1e-6 of the peak) of rates_he")
    del acc, acc_plain, whole, boxes, cds, rates, plain, ref, mm

    # the heat channel: the loop against the plain loop, 16 batches
    rth = HeRaytracer(N, R_BENCH, bins_he, ABU_HE, batch_size=B_BENCH,
                      dtype=dt, do_heating=True)
    he_loop_against_plain(f"helium bench do_heating N={N} B={B_BENCH} "
                          f"({nwin} batches)", rth, pads, pos_b[:nwin],
                          flux_b[:nwin], reps=1)
    del rth, pads

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
    return dict(launches=counts, loop=k_loop, ns_per_cell=ns_cell,
                ns_per_cell_plain=ns_plain)


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
    out, engines = {}, {}
    for devname in ("cuda", "cpu"):
        rte = engines[devname] = HeRaytracer(
            Ne, R_EVOLVE, bins_he, ABU_HE, batch_size=B_BENCH,
            dtype=torch.float64, device=devname, do_heating=True)
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
    # the loop in float64 with the heat channel against the plain loop, on
    # the timestep's end state
    rte = engines["cuda"]
    fields = [torch.from_numpy(np.asarray(a)).to("cuda", torch.float64)
              for a in (e_nd, out["cuda"][0], out["cuda"][2],
                        out["cuda"][3])]
    pads = [rte.eng.wrap_pad(f) for f in rte.species_fields(*fields)]
    pos_b, flux_b = rte.prepare_sources(e_pos, e_flux)
    he_loop_against_plain(f"evolve3D_he's engine N={Ne} float64 with the "
                          f"heat channel", rte, pads, pos_b, flux_b, reps=3)
    del engines, rte, pads

    N = N_GOLDEN
    params = read_paramfile(os.path.join(GOLDEN_DIR, "parameters.yml"))
    params["Raytracing"]["engine"] = "he"
    params["Photo"]["compute_heating_rates"] = 1
    params["Material"]["isothermal"] = False

    def model_run(plain):
        """The two timesteps, with the plain chemistry pass if ``plain``:
        the simulation, its log per timestep, s per timestep, the launches
        and the state after the first timestep."""
        with tempfile.TemporaryDirectory() as tmp:
            params["Output"]["results_basename"] = tmp + "/"
            text = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(text), \
                    (plain_chemistry() if plain else contextlib.nullcontext()):
                sim = C2Ray_Test(params, N, device="cuda")
                sim.ndens = 1e-3 * np.ones((N,) * 3)
                zreds = sim.generate_redshift_array(2, 1e7)
                dt = sim.set_timestep(zreds[0], zreds[1], STEPS_GOLDEN)
                srcpos = np.array([[3 * N // 4], [3 * N // 4], [N // 2]],
                                  dtype=float)
                steps, t_steps = [], []
                sweep.reset_launches()
                for n in range(2):
                    mark = len(text.getvalue())
                    sim.cosmo_evolve(dt)
                    t1 = time.time()
                    sim.evolve3D(dt, np.array([10.0]), srcpos)
                    torch.cuda.synchronize()
                    t_steps.append(time.time() - t1)
                    steps.append(text.getvalue()[mark:])
                    if n == 0:
                        # phase 5d's single-rank reference
                        first = {k: np.array(getattr(sim, k))
                                 for k in HE_STATE}
            t_sim = time.time() - t0
        return sim, steps, t_steps, t_sim, dict(sweep.launches), first, dt

    def per_pass(steps, what="Chemistry \\(H\\+He\\)"):
        """Mean s of the logged ``what`` (the chemistry pass, or with
        "Raytracing \\(3 species\\)" the trace) per raytrace iteration."""
        return np.mean([float(t) for st in steps for t in re.findall(
            what + r" took ([\d.]+) s", st)])
    ray = "Raytracing \\(3 species\\)"
    sim_p, steps_p, t_steps_p, _, launches_p, first_p, _ = model_run(True)
    sim, steps, t_steps, t_sim, launches, first, dt = model_run(False)
    k1 = launches["cheb_sweep"]
    iters = [s.count("Raytracing (3 species) took") for s in steps]
    loss = [[float(v) for v in re.findall(
        r"photon loss fraction: ([-+\d.e]+)", s)] for s in steps]
    iters_p = [s.count("Raytracing (3 species) took") for s in steps_p]
    loss_p = [[float(v) for v in re.findall(
        r"photon loss fraction: ([-+\d.e]+)", s)] for s in steps_p]
    same = all(np.array_equal(getattr(sim, k), getattr(sim_p, k))
               for k in HE_STATE) and all(
        np.array_equal(first[k], first_p[k]) for k in HE_STATE)
    log(f"helium model N={N}, the plain chemistry pass before the kernel: "
        f"per pass {per_pass(steps_p):.4f} s, raytrace per iteration "
        f"{per_pass(steps_p, ray):.4f} s, per timestep "
        + ", ".join(f"{t:.3f}" for t in t_steps_p)
        + f" s ({iters_p} iterations, {launches_p['chemistry_pass_he']} "
        f"kernel passes); the kernel: per pass {per_pass(steps):.4f} s, "
        f"raytrace per iteration {per_pass(steps, ray):.4f} s, per "
        f"timestep " + ", ".join(f"{t:.3f}" for t in t_steps)
        + f" s ({iters} iterations, {launches['chemistry_pass_he']} kernel "
        f"passes); iterations, photon loss and state bit-equal: "
        f"{iters == iters_p and loss == loss_p and same}")
    if (iters != iters_p or loss != loss_p or not same
            or launches["chemistry_pass_he"] != sum(iters)
            or launches_p["chemistry_pass_he"] != 0):
        raise RuntimeError("helium model: the run with the chemistry kernel "
                           "differs from the plain pass's")
    g = sim.raytracer.geom
    log(f"C2Ray_Test engine he N={N} float64 (heating, non-isothermal, "
        f"{sim.raytracer.bins.num_bins} bins, Dc={g.Dc}, B=1): 2 timesteps "
        f"in {t_sim:.2f} s with set-up; raytrace iterations {iters}, K1 "
        f"launches {k1}, he_trace_sweep {launches['he_trace_sweep']}, "
        f"rates_he {launches['rates_he']}; photon loss at convergence "
        + ", ".join(f"{ls[-1]:.3e}" for ls in loss)
        + f" (bound loss_fraction {sim.loss_fraction:g}); T "
        f"{sim.temp.min():.1f}..{sim.temp.max():.1f} K, xh max "
        f"{sim.xh.max():.4f}, xHeII+xHeIII max "
        f"{(sim.xhe1 + sim.xhe2).max():.4f}")
    # one he_trace_sweep call per raytrace iteration, three sweeps, one
    # rate pass and one accumulate per batch in it (one source: one batch)
    if (k1 != 3 * sum(iters) or min(iters) == 0
            or launches["he_trace_sweep"] != sum(iters)
            or k1 != 3 * launches["rates_he"]
            or launches["accumulate_boxes"] != launches["rates_he"]):
        raise RuntimeError(f"helium model: {k1} K1 launches for {iters} "
                           f"iterations, launches {launches}")
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
    # the helium kernel against its plain version on the model's last state
    # (float64), in the four combinations of its options (the heat channel
    # a photoheating rate of 5e-12 erg per HI ionisation)
    f = [torch.as_tensor(np.asarray(a), dtype=torch.float64,
                         device="cuda").reshape(-1)
         for a in (sim.ndens, sim.temp, sim.xh, sim.xhe1, sim.xhe2,
                   sim.phi_ion, sim.phi_he1, sim.phi_he2)]
    args = (torch.tensor(dt, dtype=torch.float64).to("cuda"), f[0], f[1],
            f[2], f[2], f[3], f[3], f[4], f[4], f[5], f[6], f[7],
            sim.chem_he)
    log(f"helium chemistry on the model's last state ({N}^3 float64):")
    k_he = None
    for heat in (None, 5e-12 * f[5]):
        for rec in (False, True):
            k, _ = chemistry_check(
                f"heat {heat is not None}, recombination photons {rec}",
                True, args, dict(heat=heat, recombination_photons=rec),
                reps=3)
            k_he = k_he or k
    return k1, first, dict(k_he, launches=launches["chemistry_pass_he"])


# ---- phase 7: the user drivers ---------------------------------------------
# Each driver runs in a process of its own as ``python -m`` runs a module
# (runpy, the module as __main__), with the kernel launch counts of
# pyc2ray_torch.ops.sweep printed at its exit: they start at 0 in the
# process, so they are the driver's own.
DRIVER_LAUNCHER = (
    "import atexit, json, runpy, sys\n"
    "from pyc2ray_torch.ops import sweep\n"
    "atexit.register(lambda: print('KERNEL_LAUNCHES', "
    "json.dumps(sweep.launches), flush=True))\n"
    "sys.argv[:] = sys.argv[1:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")
RTB_R100 = "raytracing_benchmark R=100"
DRIVER_LANES = 4             # drivers run at once, besides the harness
_CHEB_LOOP = ("cheb_sweep_rates", "cheb_trace_sweep", "extract_boxes",
              "accumulate_boxes", "chemistry_pass")
_FLAT = ("flat_gather", "flat_sweep", "flat_rates", "flat_accumulate",
         "flat_trace_sweep")
# label, module under pyc2ray_torch, arguments (each driver's defaults
# otherwise), kernels that must launch, the lines of its output to show
DRIVERS = (
    (RTB_R100, "examples.raytracing_benchmark",
     ["-N", "250", "--R", "100", "--numsrc", "100", "--sed", "bb",
      "--json", "rtb.json"],
     ("cheb_sweep_seg", "init_segments", "rates_dense", "cheb_trace_sweep",
      "extract_boxes", "accumulate_boxes"), r"^R=|^CUDA kernels"),
    ("raytracing_benchmark he", "examples.raytracing_benchmark",
     ["--engine", "he", "-N", "256", "--R", "30", "--numsrc", "256"],
     ("cheb_sweep", "rates_he", "he_trace_sweep", "extract_boxes",
      "accumulate_boxes"), r"^R="),
    ("stromgren_ifront", "examples.stromgren_ifront", [],
     ("chemistry_pass",) + _FLAT, r"Max I-front|PASSED|FAILED"),
    ("shadow_test", "examples.shadow_test", [], ("chemistry_pass",) + _FLAT,
     r"^xh |PASSED|FAILED"),
    ("multisource", "examples.multisource", [], _FLAT,
     r"superposition|tolerance|PASSED|FAILED"),
    ("stromgren_cosmo", "examples.stromgren_cosmo", [],
     ("chemistry_pass",) + _FLAT, r"monotonic|final redshift|PASSED|FAILED"),
    ("heating_test", "examples.heating_test", [],
     ("cheb_sweep_rates_heat", "cheb_trace_sweep", "extract_boxes",
      "accumulate_boxes", "chemistry_pass", "thermal_update"),
     r"PASSED|FAILED"),
    ("single_source_test", "examples.single_source_test", [],
     ("chemistry_pass",) + _FLAT, r"Mean ionized|PASSED|FAILED"),
    ("eor_simulation", "examples.eor_simulation", ["--num_slices", "2"],
     _CHEB_LOOP, r"min, mean, max|EoR run complete"),
    ("multihost_pod domain", "examples.multihost_pod", ["--mode", "domain"],
     _CHEB_LOOP, r"process\(es\)|^OK:"),
    ("multihost_pod source", "examples.multihost_pod", ["--mode", "source"],
     _CHEB_LOOP, r"process\(es\)|^OK:"),
    ("make_plots", "examples.make_plots", [], ("chemistry_pass",) + _FLAT,
     r"\.png"),
    ("chemistry_solver", "tutorials.chemistry_solver", [],
     ("chemistry_pass",), r"equilibrium"),
    ("raytracing cheb", "tutorials.raytracing", ["--engine", "cheb"],
     ("cheb_sweep", "rates_dense", "cheb_trace_sweep", "extract_boxes",
      "accumulate_boxes"),
     r"^Gamma field|photon budget"),
    ("raytracing flat", "tutorials.raytracing", ["--engine", "flat"], _FLAT,
     r"^Gamma field|photon budget"),
    ("helium_thermal", "tutorials.helium_thermal", [],
     ("cheb_sweep", "rates_he", "he_trace_sweep", "chemistry_pass_he",
      "thermal_update"), r"front at|temperature raised|^OK"),
)


def run_driver(module, args):
    """One driver on cuda in a temporary --workdir, in a process of its own.
    Returns (exit code, stdout, stderr, wall seconds, its JSON output if it
    wrote rtb.json)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as wd:
        cmd = [sys.executable, "-c", DRIVER_LAUNCHER,
               f"pyc2ray_torch.{module}", *args, "--device", "cuda",
               "--workdir", wd]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=wd, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.time() - t0
        out = os.path.join(wd, "rtb.json")
        extra = None
        if os.path.exists(out):
            with open(out) as f:
                extra = json.load(f)
    return proc.returncode, proc.stdout, proc.stderr, wall, extra


def report_driver(label, module, args, kernels, keep, run):
    """Prints a driver's exit code, wall time, kernel launches and check
    lines; raises when it exited non-zero, printed FAILED or launched none
    of ``kernels``."""
    rc, stdout, stderr, wall, _ = run
    lines = stdout.splitlines()
    counts = {}
    for line in lines:
        if line.startswith("KERNEL_LAUNCHES "):
            counts = json.loads(line.split(" ", 1)[1])
    log(f"7 {label}: python -m pyc2ray_torch.{module} "
        f"{' '.join(args)} --device cuda: exit {rc}, {wall:.1f} s; "
        "launches " + (", ".join(f"{k} {v}" for k, v in counts.items() if v)
                       or "none (plain PyTorch on the card)"))
    for ln in lines:
        if re.search(keep, ln):
            log(f"    {ln.strip()}")
    failed = [ln for ln in lines if "FAILED" in ln]
    missing = [k for k in kernels if not counts.get(k)]
    sweeps = counts.get("cheb_sweep", 0) + counts.get("init_segments", 0)
    if "he_trace_sweep" in kernels and sweeps != 3 * counts.get("rates_he",
                                                                 0):
        # the helium engine's traces: three sweeps a batch
        missing.append("three sweeps per rates_he")
    if rc != 0 or failed or missing or not counts:
        log("\n".join(lines[-40:]))
        log(stderr[-4000:])
        raise RuntimeError(f"phase 7 {label}: exit {rc}, FAILED lines "
                           f"{failed}, kernels never launched {missing}")


def user_drivers():
    """Phase 7: every driver of pyc2ray_torch.examples and
    pyc2ray_torch.tutorials on the card, each as its user runs it (see
    DRIVERS); make_plots only where matplotlib is installed. The harness's
    two rows run alone, one after the other (they time the card); the
    others DRIVER_LANES at a time (each process spends most of its wall in
    its imports and the CUDA context). Returns the R = 100 row's JSON."""
    import importlib.util
    from concurrent.futures import ThreadPoolExecutor
    torch.cuda.empty_cache()
    h5py = importlib.util.find_spec("h5py") is not None
    mpl = importlib.util.find_spec("matplotlib") is not None
    reader = ("installed" if h5py else "absent: the EoR catalogs are read "
              "by pyc2ray_torch/io/catalog.py")
    log(f"7 the user drivers, one process each (the harness alone, the "
        f"others {DRIVER_LANES} at a time): h5py {reader}; matplotlib "
        f"{'installed' if mpl else 'absent'}")
    specs = [d for d in DRIVERS if mpl or d[1] != "examples.make_plots"]
    if not mpl:
        log("7 make_plots: not run, this machine has no matplotlib (the "
            "CPU tests run it)")
    alone = [d for d in specs if d[1] == "examples.raytracing_benchmark"]
    shared = [d for d in specs if d not in alone]
    t0 = time.time()
    runs = [run_driver(d[1], d[2]) for d in alone]
    with ThreadPoolExecutor(DRIVER_LANES) as pool:
        runs += list(pool.map(lambda d: run_driver(d[1], d[2]), shared))
    total = time.time() - t0
    for d, run in zip(alone + shared, runs):
        report_driver(*d, run)
    log(f"7 the user drivers: {len(runs)} runs in {total:.1f} s, "
        f"{sum(r[3] for r in runs[:len(alone)]):.1f} s of it the harness")
    return next(r[4] for d, r in zip(alone + shared, runs)
                if d[0] == RTB_R100)


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
        srcpos, flux = sim.read_sources(os.path.join(
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
        want = {k: 0 for k in a["launches"]}
        from pyc2ray_torch.ops.trace_loop import chunk_size
        want.update(trace_launches(
            FOLD, k3, -(-k3 // chunk_size(k3, B_BENCH, 64, 4))))
        if k3 != NS_BENCH // B_BENCH // P5_RANKS or a["launches"] != want:
            raise RuntimeError(f"5a rank {r}: launches {a['launches']}, "
                               f"expected {want}")
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
        + "; per rank K1, rates_he and he_trace_sweep launches "
        + str([[rr["launches"][k] for k in ("cheb_sweep", "rates_he",
                                            "he_trace_sweep")]
               for rr in res]))
    bounds = dict(xh=1e-10, xhe1=1e-9, xhe2=1e-9, temp=1e-10)
    # every trace one he_trace_sweep call: three K1 per batch
    if any(errs[k] > bounds[k] for k in HE_STATE) or any(
            rr["launches"]["cheb_sweep"] == 0
            or rr["launches"]["cheb_sweep"] != 3 * rr["launches"]["rates_he"]
            or rr["launches"]["he_trace_sweep"] == 0 for rr in res):
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
    _build.load(extra=_build.PROBES)
    log(f"build: {time.time() - t0:.2f} s")
    if "--nccl" in sys.argv[1:]:
        nccl_branch(smi)
        log(f"chip_smoke --nccl wall time: {time.time() - T_START:.1f} s")
        return 0
    log_ptxas()
    barrier_us = barrier_costs(B_BENCH)
    log(f"cluster barrier, {B_BENCH} clusters of 512 threads per block: "
        + ", ".join(f"C={C} {us:.4f} us" for C, us in barrier_us.items()))
    if "--flat" in sys.argv[1:]:
        src_pos = np.random.RandomState(100).randint(0, N_BENCH,
                                                     size=(NS_BENCH, 3))
        with tempfile.TemporaryDirectory() as tmp:
            flat_bench(src_pos, tmp, barrier_us)
        golden_phase()
        log(f"chip_smoke --flat wall time: {time.time() - T_START:.1f} s")
        return 0
    if "--box" in sys.argv[1:]:
        src_pos = np.random.RandomState(100).randint(0, N_BENCH,
                                                     size=(NS_BENCH, 3))
        with tempfile.TemporaryDirectory() as tmp:
            box_bench(src_pos, make_bins(), tmp)
        sim = heating_example("cheb")[0]
        heating_box((np.asarray(sim.xh), np.asarray(sim.temp)))
        log(f"chip_smoke --box wall time: {time.time() - T_START:.1f} s")
        return 0

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

    # ---- 2e. the dense rate pass of the unfused modes vs its plain version
    k_dense = check_rates(N_BENCH, R_BENCH, B_BENCH, torch.float32, seed=5,
                          reps=10, bins=bins, ns_bin=ns_bin)
    k_dense_r100 = check_rates(N_R100, R_R100, B_BENCH, torch.float32,
                               seed=3, reps=3, bins=bins, ns_bin=ns_bin)
    # N=16, R=8 clips the box (with S=3 segments); R=6 rates a subbox
    check_rates(16, 8.0, 2, torch.float64, seed=6, reps=3, bins=bins,
                zero_cell=True, shell_segment=3)
    check_rates(16, 6.0, 2, torch.float64, seed=6, reps=3, bins=bins,
                zero_cell=True)

    # ---- 2d. K1 at the helium engine's three cross sections, and the
    # helium rate pass vs its plain version ---------------------------------
    bins_he = he_bins()
    k_he = check_sweep_he(bins_he, reps=20)
    log("rates_he, the helium engine's three-species rate pass, on K1's "
        "boxes:")
    k_rates_he = check_rates_he(bins_he, ns_bin)
    k_rates_he["f32_error"] = he_rates_f32_error(bins_he)
    k_dense["f32_error"] = rates_f32_error(bins)
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
    its_plain = {}
    for form, fn in (("doric", None), ("the reference's float32 time "
                                       "average", doric_reference_form)):
        t0 = time.time()
        its, _ = inner_iterations(dt_d, ndens, temp, xh, phi, chem, fn)
        torch.cuda.synchronize()
        its_plain[form] = its
        log(f"bench chemistry, {form}: inner iterations up to "
            f"{int(its.max())}, mean {float(its.double().mean()):.3f}, cells "
            f"at the cap of {MAX_INNER_ITER} "
            f"{int((its == MAX_INNER_ITER).sum())}; "
            f"{time.time() - t0:.4f} s")
    counts = dict(sweep.launches)
    want = {k: 0 for k in counts}
    want.update(trace_launches(rt._sweep_mode(), nbatch,
                               extract_chunks(rt, nbatch)), chemistry_pass=1)
    if counts != want:
        raise RuntimeError(f"main path: kernel launches {counts}, expected "
                           f"{want} (one trace loop, one K1, rate pass, "
                           f"extract and accumulate per batch, one "
                           f"chemistry pass)")
    launches = counts["cheb_sweep"]
    dense_launches = counts["rates_dense"]
    sweep_loop_launches = counts["cheb_trace_sweep"]
    boxes_launches = [counts[k] for k in ("extract_boxes",
                                          "accumulate_boxes")]
    # the chemistry kernel against the plain pass on this Gamma; each
    # cell's iterations those of the plain loop
    _, its_k = chemistry_check("bench chemistry (256^3 float32, this "
                               "Gamma)", False,
                               (dt_d, ndens, temp, xh, xh, phi, chem), {})
    if not torch.equal(its_k, its_plain["doric"]):
        raise RuntimeError("bench chemistry: the kernel's iterations per "
                           "cell differ from the plain loop's")
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
        f"{mcell:.2f} Mcell-updates/s, sweep launches {launches}, rate "
        f"passes {dense_launches}, extract and accumulate "
        f"{boxes_launches[0]} each (batches {nbatch}), trace loops "
        f"{sweep_loop_launches}, conv_flag {int(cf)}")
    br = stage_breakdown(rt, ndens, xh, pos_b, flux_b, 16)
    log("per-batch device ms: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in br.items()))
    # the sweep between rate passes (its tables may have left the L2)
    log(f"  K1 in the pipeline {br['sweep']:.4f} ms per batch (the device "
        f"is drained before each batch, so this holds the host's time to "
        f"enqueue), alone {k_bench['ms']:.4f} ms per call "
        f"({plan_text('cheb_sweep')})")
    # the main path's trace loop against the loop before it: on this
    # trace's frame bit for bit with its ms (the kernels line), then the
    # whole trace before and after with its launches and copies per batch
    pad3 = rt.wrap_pad(ndens.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3)))
    k_sweep_loop = loop_against_plain(f"default bench N={N} B={B_BENCH}", rt,
                                      pad3, pos_b, flux_b, reps=2)
    b_ms, b_by = least_ms(*loop_work(rt, pad3, pos_b), dt)
    k_sweep_loop.update(bound_ms=b_ms, bound_by=b_by)
    log(f"  default bench trace loop: bound_ms={b_ms:.4f} ({b_by}) per "
        f"trace of {nbatch} batches (extract, K1, rate pass, accumulate)")
    loop_kernel_gaps(f"default bench N={N} B={B_BENCH}", rt, pad3, pos_b,
                     flux_b)
    del pad3
    with tempfile.TemporaryDirectory() as tmp:
        loop_before_after(
            f"default bench N={N} B={B_BENCH}", [rt],
            lambda: rt.trace_batches(ndens, xh, pos_b, flux_b, DR)[0],
            nbatch, tmp)

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
            trace_launches(rtf._sweep_mode(), nbatch,
                           extract_chunks(rtf, nbatch)),
            f"{mode} N={N} R={R_BENCH} Ns={NS_BENCH} B={B_BENCH} float32",
            chem)
        fused_launches[kname] = counts[kname]
        # the unfused path rebuilds cdin = cd - dcol in float32, which
        # cancels where dcol >> cdin: compare above a floor at the peak
        compare(f"{mode} Gamma vs the unfused Gamma", phi_f, phi, 1e-4,
                1e-6)
        if mode == "fuse_fold":
            k3_phi = phi_f.cpu()        # phase 5a's single-rank reference
        with tempfile.TemporaryDirectory() as tmp:
            loop_before_after(
                f"{mode} bench N={N} B={B_BENCH}", [rtf],
                lambda: rtf.trace_batches(ndens, xh, pos_b, flux_b, DR)[0],
                nbatch, tmp)
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
        label = (f"R=100 harness N={nh} Ns={NS_R100} B={B_BENCH} float32 "
                 f"shell_segment={seg!r} (S={rth.seg_S}, K={rth.seg_K})")
        h_phi[seg], _, counts = run_path(
            rth, h_nd, h_xh, hp, hf, cell_updates(NS_R100, R_R100),
            trace_launches(rth._sweep_mode(), nb, extract_chunks(rth, nb)),
            label)
        if seg == "auto":
            seg_launches = counts["cheb_sweep_seg"]
            init_launches = counts["init_segments"]
        with tempfile.TemporaryDirectory() as tmp:
            loop_before_after(
                label, [rth],
                lambda: rth.trace_batches(h_nd, h_xh, hp, hf, DR)[0], nb,
                tmp)
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
            trace_launches(rth._sweep_mode(), nbatch,
                           extract_chunks(rth, nbatch)), label, chem)
        if fold:
            heat_launches = counts[kname]
        else:
            with tempfile.TemporaryDirectory() as tmp:
                loop_before_after(
                    f"do_heating bench N={N} B={B_BENCH} (Gamma and heat)",
                    [rth], lambda: torch.stack(rth.trace_batches(
                        ndens, xh, pos_b, flux_b, DR)), nbatch, tmp)
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
        f"{t_therm:.4f} s = {1e9 * t_therm / N ** 3:.3f} ns/cell (host "
        f"clock, one call), T range {t_lo:.1f}..{t_hi:.1f} K, "
        f"{int((t_new > 1e3).sum())} cells above 1e3 K")
    regs = log_ptxas("thermal_kernel", quiet=True)   # logged at the start
    pair = thermal_pair_check()
    log(f"  the pow pair against powf and pow at (p, p - 1) for p in "
        f"{PAIR_EXPONENTS}: " + "; ".join(
            f"{k} {b} results differ over {n} bases"
            for k, (n, b) in pair.items()))
    if any(b for _, b in pair.values()):
        raise RuntimeError(f"3c: the pow pair differs from pow: {pair}")
    k_thermal = {}
    for tag, cast, reps in (("f32", torch.float32, 10),
                            ("f64", torch.float64, 3)):
        args = (dt_d.to(cast), t_cold.to(cast), ndens.to(cast),
                xh.to(cast), heat_f[True].to(cast), thermal)
        k, want = thermal_check(f"thermal update N={N} {cast} from 100 K",
                                args, dict(z=9.0), reps=reps)
        k["design_steps"] = thermal_design_steps(tag, args, dict(z=9.0),
                                                 want, max(reps, 5))
        k["registers"] = {n: r for n, r in regs.items()
                          if ("float" if tag == "f32" else "double") in n}
        k["pow_pair_bases_differing"] = pair[tag]
        del want, args
        if tag == "f32":
            k_thermal.update(k)
        else:
            k_thermal["f64"] = k
    # the hydrogen pass on phase 3's Gamma with these temperatures, one of
    # its own in every cell
    k_chem_3c, _ = chemistry_check(
        "bench chemistry (256^3 float32, phase 3's Gamma, 3c's updated T)",
        False, (dt_d, ndens, t_new, xh, xh, phi, chem), {})
    del heat_f, t_new, t_cold

    # ---- 3d. the table-exact flat engine at the bench configuration -------
    with tempfile.TemporaryDirectory() as tmp:
        k_flat = flat_bench(src_pos, tmp, barrier_us)

    # ---- 3e. the helium engine at full width ------------------------------
    k_he_bench = helium_bench(bins_he, src_pos, chem)
    he_launches = k_he_bench["launches"]["cheb_sweep"]

    # ---- 3f. the octahedral sheet engine at the bench configuration -------
    with tempfile.TemporaryDirectory() as tmp:
        k_box = box_bench(src_pos, bins, tmp)

    # ---- 3g. the trace loop's kernels and the C++ loop vs plain ----------
    k_rated, k_chunks = check_trace_loop(bins, src_pos)

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
        with tempfile.TemporaryDirectory() as tmp:
            out[devname] = evolve3D(DT, DR, e_flux, e_pos, rte, chem, e_cold,
                                    e_nd, e_xh, quiet=True, thermal=thermal,
                                    zred=9.0, logfile=tmp + "/4b.log")
            for line in open(tmp + "/4b.log"):
                if "Thermal update took" in line:
                    log(f"  {devname}: {line.strip()}")
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
    n_loop = counts.pop("cheb_trace_sweep")
    n_box = [counts.pop(k) for k in ("extract_boxes", "accumulate_boxes")]
    n_chem = counts.pop("chemistry_pass")
    n_thermal = counts.pop("thermal_update")
    g_h = sim.raytracer.geom
    log(f"C2Ray_Test heating example N={N_HEATING} (float64, engine cheb, "
        f"fuse_fold, Dc={g_h.Dc}, R1={g_h.r_max + 1}, "
        f"{sim.raytracer.num_bins} bins): {STEPS_HEATING} timesteps, "
        f"{n_iter} raytrace iterations, {t_sim:.2f} s with set-up, K3h "
        f"launches {n_k3h}, trace loops {n_loop}, extract and accumulate "
        f"{n_box}, chemistry passes {n_chem}, thermal updates {n_thermal}")
    if (n_k3h == 0 or n_k3h != n_iter or n_loop != n_iter
            or n_box != [n_iter] * 2 or n_chem != n_iter
            or n_thermal != STEPS_HEATING or any(counts.values())):
        raise RuntimeError(f"heating example: {n_k3h} K3h launches, "
                           f"{n_loop} loops and {n_box} box launches for "
                           f"{n_iter} single-source iterations, other "
                           f"kernels {counts}")
    heat_4c = (np.asarray(sim.xh), np.asarray(sim.temp))

    # ---- 4d. the adaptive engine at the bench mix ------------------------
    adaptive_bench(bins)

    # ---- 4e. the production EoR run on the committed inputs --------------
    eor_counts, eor_device_ms, eor_first, k_loop, k_chem = eor_run(bins, smi)
    k_eor.update(ms=eor_device_ms["A"] + eor_device_ms["B"],
                 ms_back_to_back=k_eor["ms"])

    # ---- 4f. the golden: examples/single_source_test at N=128 -------------
    g_counts, g_errs = golden_phase()

    # ---- 4g. helium end to end ---------------------------------------------
    _, he_first, k_chem_he = helium_evolve(e_pos, e_flux, e_nd, bins_he,
                                           chem)

    # ---- 4h. the heating example on the octahedral sheet engine -----------
    heating_box(heat_4c)

    # ---- 5. the multi-GPU paths: a world of ranks ----------------------
    del sim
    k3_5b = multi_rank(bins, smi, dict(k3_phi=k3_phi, phi3=phi_cpu,
                                       eor=eor_first, he=he_first))

    # ---- 7. the user drivers ------------------------------------------
    rtb = user_drivers()
    row = rtb["timings"][f"R={R_R100},Ns={NS_R100}"]
    r100_3b = [v for k, v in NS_PER_CELL.items()
               if k.startswith("R=100 harness") and "'auto'" in k]
    log(f"7 the R = 100 row through the harness: "
        f"{row['ns_per_cell']:.4f} ns/cell-update (min of {rtb['nreps']}, "
        f"B={row['batch']}, {rtb['num_bins']} bins), phase 3b's "
        f"auto-segmented trace {r100_3b[0]:.4f}; {rtb['device']}")

    # ---- 6. kernels line and result -----------------------------------
    # launches: each kernel's count over its own path's run (phases 3 and
    # 3e for K1: the hydrogen and the helium trace at the bench shape, 3b
    # for K1f and K2, 3c for K3h, 4e for K3: the EoR run's timesteps);
    # the other numbers from phases 2, 2b and 2c at that path's shapes (K3:
    # the EoR run's small bucket, B=16, Dc=24, where back-to-back calls are
    # bounded by the host's enqueue: its ms is the device time per call in
    # 4e's profiled trace, ms_back_to_back the CUDA-event time). No single
    # PyTorch call computes any of the five sweep kernels; the box kernels'
    # library_ms is torch.take / index_add_ on precomputed indices (4e).
    src = "pyc2ray_torch/ops/csrc/"
    tpu = "pyc2ray_tpu/ops/pallas_sweep.py:"
    jax_rt = "pyc2ray_tpu/ops/raytrace_cheb.py:"
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
             replaces=tpu + "669", launches=eor_counts["cheb_sweep_rates"],
             launches_per_rank_5b=k3_5b, **k_eor),
        dict(name="cheb_sweep_rates_heat", source=src + "cheb_sweep_rates.cu",
             replaces=tpu + "669", launches=heat_launches, **k_heat),
        # the port's own kernels (no TPU kernel: XLA's gather and
        # dynamic_update_slice scan in the JAX engine), launches over the
        # EoR run's timesteps, every other number per call on the inputs of
        # 4e's profiled trace (eor_trace_kernels): device times
        dict(name="extract_boxes", source=src + "trace_loop.cu",
             replaces=jax_rt + "1082",
             launches=eor_counts["extract_boxes"], **k_loop["extract"],
             chunk_at_bench=k_chunks["bench"], chunk_at_eor=k_chunks["EoR"]),
        dict(name="accumulate_boxes", source=src + "trace_loop.cu",
             replaces=jax_rt + "1223",
             launches=eor_counts["accumulate_boxes"],
             **k_loop["accumulate"], launches_default_bench=boxes_launches[1],
             rated_at_bench=k_rated),
        # the port's own kernels of the unfused modes (no TPU kernel: XLA's
        # fusion of _rates, the code around the segments of
        # _sweep_pallas_segmented): launches over phase 3's main path
        # (init_segments: 3b's auto-segmented R = 100 trace, its own path),
        # every other number per call at the bench shape from 2e
        # (init_segments at the R = 100 shape), the heat channel's and the
        # R = 100 shape's beside
        dict(name="rates_dense", source=src + "cheb_rates.cu",
             replaces=jax_rt + "1028", launches=dense_launches,
             **k_dense["photo"], with_heat=k_dense["heat"],
             f32_error=k_dense["f32_error"],
             at_r100=k_dense_r100["photo"],
             with_heat_at_r100=k_dense_r100["heat"]),
        dict(name="init_segments", source=src + "cheb_sweep.cu",
             replaces=jax_rt + "681", launches=init_launches,
             **k_dense_r100["init"]),
        # the trace loop (no TPU kernel: the JAX engine's jit + lax.scan
        # batch loop), one call per trace in every mode: its launches over
        # phase 3's main path (the default mode) and the EoR run's
        # timesteps (fuse_fold), every other number per trace of phase 3's
        # frame (CUDA events), and per call on the inputs of 4e's profiled
        # trace beside them
        dict(name="cheb_trace_sweep", source=src + "trace_loop.cu",
             replaces=jax_rt + "346",
             launches=sweep_loop_launches + eor_counts["cheb_trace_sweep"],
             launches_default_bench=sweep_loop_launches,
             launches_fuse_fold_eor=eor_counts["cheb_trace_sweep"],
             **k_sweep_loop, fuse_fold_eor=k_loop["loop"]),
        # the helium engine's (no TPU kernel: the XLA einsums of
        # HeRaytracer._rates_he, its jit + lax.fori_loop batch loop): the
        # launches over phase 3e's main path (its bench trace), every other
        # number of rates_he per call on one bench batch (2d), with the heat
        # channel beside; the loop's per trace of 3e's frames (CUDA events)
        dict(name="rates_he", source=src + "cheb_rates_he.cuh",
             replaces="pyc2ray_tpu/ops/raytrace_he.py:98",
             launches=k_he_bench["launches"]["rates_he"],
             **k_rates_he["photo"], with_heat=k_rates_he["heat"],
             f32_error=k_rates_he["f32_error"]),
        dict(name="he_trace_sweep", source=src + "trace_loop.cu",
             replaces="pyc2ray_tpu/ops/raytrace_he.py:92",
             launches=k_he_bench["launches"]["he_trace_sweep"],
             **k_he_bench["loop"]),
        # the chemistry passes (no TPU kernel: the JAX package's jitted
        # lax.while_loop), launches over the EoR run's timesteps (4e) and
        # the helium model's (4g), every other number per pass on the EoR
        # run's last state (250^3, float32) and on the helium model's
        # (128^3, float64, its options: no heat channel, no recycling)
        dict(name="chemistry_pass", source=src + "chemistry.cu",
             replaces="pyc2ray_tpu/ops/chemistry.py:122",
             launches=eor_counts["chemistry_pass"], **k_chem,
             at_3c_temperatures=k_chem_3c),
        dict(name="chemistry_pass_he", source=src + "chemistry.cu",
             replaces="pyc2ray_tpu/ops/chemistry_he.py:406", **k_chem_he),
        # the thermal update (no TPU kernel: the JAX package's fori_loop),
        # launches over the heating example's timesteps (4c, one a
        # timestep), every other number per update at 3c's 256^3 float32
        # fields from 100 K, float64 beside
        dict(name="thermal_update", source=src + "thermal.cu",
             replaces="pyc2ray_tpu/ops/thermal.py:132", launches=n_thermal,
             **k_thermal),
        # the flat engine's (no TPU kernel: the XLA code of the JAX
        # engine's jit program, its shell fori_loop, _rates and batch scan):
        # launches over phase 3d's bench trace (float64), with the golden's
        # (4f) beside; each kernel's ms its median device time per launch in
        # 3d's profiled window, every other number per call on 3d's first
        # batch; the loop's per trace of 3d (CUDA events; the plain loop
        # once by the host clock)
        *[dict(name=name, source=src + "flat_sweep.cu" + (
                   "" if name == "flat_trace_sweep" else "h"),
               replaces="pyc2ray_tpu/ops/raytrace.py:" + line,
               launches_golden=g_counts.get(name, 0),
               **({} if name not in g_errs else
                  {"max_abs_err_golden": g_errs[name]}), **k_flat[name])
          for name, line in (("flat_gather", "299"), ("flat_sweep", "172"),
                             ("flat_rates", "224"), ("flat_accumulate", "288"),
                             ("flat_trace_sweep", "153"))],
        # the box engine's (no TPU kernel: the XLA code of the JAX engine's
        # jit program, its shell fori_loop, _rates and batch scan): launches
        # over phase 3f's bench trace (float32), the kernels' as its profiled
        # trace shows them; each kernel's ms its median
        # device time per launch in 3f's profiled trace, every other number
        # per call on the loop's first device batch (the rates: its first
        # batch); the loop's per trace of 3f (CUDA events; the plain loop
        # once by the host clock over the batches BOX_BUDGET_S allows)
        *[dict(name=name, source=src + ("trace_loop.cu"
                                        if name == "box_trace_sweep"
                                        else "box_sweep.cuh"),
               replaces="pyc2ray_tpu/ops/raytrace_box.py:" + line,
               **k_box[name])
          for name, line in (("box_gather", "153"), ("box_sweep", "196"),
                             ("box_rates", "280"),
                             ("box_trace_sweep", "356"))]]
    kernels = [dict(name=k.pop("name"), route="cuda",
                    **{"library_ms": None, **k}) for k in kernels]
    log(f"chip_smoke wall time: {time.time() - T_START:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
