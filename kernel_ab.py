#!/usr/bin/env python3
"""The trace loop's box and rate-pass kernels of one checkout of the port,
on one NVIDIA GPU, in a form two checkouts can be compared by.

    python3 kernel_ab.py [--root DIR] [--label NAME] [--traces]
                         [--chemistry [--state FILE]] [--chemistry-only]
                         [--chunks K,K,...] [--box]

Imports ``pyc2ray_torch`` from DIR (default: the directory of this script;
DIR may hold another checkout, the package builds its kernels under DIR)
and, with chip_smoke.py's helpers from this script's directory, measures
through entry points that every checkout since the trace loop has:

- the dense rate pass (``ChebRaytracer._rates``, one kernel launch) at the
  bench shape (N = 256, R = 30, B = 8, Dc = 64) and the R = 100 shape
  (N = 250, B = 8, Dc = 208), float32, 14 compressed bins, with and
  without the heat channel, on the engine's own sweep boxes: ms per call
  (CUDA events), bit-equal to the plain pass (asserted);
- extract_boxes and accumulate_boxes at the bench shape and the EoR run's
  (B = 16, Dc = 24) on a clustered batch (chip_smoke's
  ``check_box_kernels``: kernel, plain and library device ms, bound);
- the bench default trace (chip_smoke phase 3's configuration and fields,
  one ``cheb_trace_sweep`` call of 256 batches), the same with
  ``fuse_fold`` (K3), the EoR run's small bucket over 128 random
  batches, the first clustered (phase 3g's, K3), and the helium engine's
  bench trace (phase 3e's: ``HeRaytracer``, 72 bins, 256 batches; one
  ``he_trace_sweep`` call in a checkout that has it, bit-equal to its
  ``trace_extended_plain``, asserted, where the engine has one):
  ms per trace (CUDA events, the least of 3) and, from one profiled
  trace, each kernel's median device us and the gap before it
  (``loop_kernel_gaps``);
- the flat engine's bench trace (phase 3d's configuration and fields:
  ``Raytracer``, float64, 256 batches of B = 8, one ``flat_trace_sweep``
  call), bit-equal to its plain loop over the first 16 batches
  (asserted): ms per trace (CUDA events, the least of 3) and, from one
  profiled trace, each flat kernel's median device us a launch, the gap
  before it, its device us a batch (median times launches over batches)
  and the device launches a batch (chip_smoke's ``flat_kernel_us``);
- the helium rate pass alone (the engine's ``_rates_he``, one launch of
  ``cheb_rates.rates_he``) at the bench shape (one batch, B = 8, Dc = Ds =
  64, 72 bins, float32, chip_smoke phase 2d's boxes), with and without the
  heat channel: ms per call (CUDA events, back to back), bit-equal to
  ``rates_he_ref`` (asserted), chip_smoke's bound of the function
  (``function_bound`` of ``he_work``) and the time of the kernel's own
  SASS at the issue rate (``he_rates_sass``);
- with ``--chemistry``, the hydrogen chemistry pass (``global_pass``, one
  kernel launch) on phase 3's Gamma (256^3 float32, chip_smoke's bench
  fields) and on the EoR run's last state (250^3, both slices of
  examples/eor_simulation with one timestep each, float32 and float64):
  ms per pass (CUDA events), bit-equal to ``global_pass_ref`` (asserted),
  iterations per cell and lane efficiency; and the helium pass
  (``global_pass_he``) on phase 3e's state (the helium bench fields and
  the rates of its trace, 256^3) in float32 and float64, each with and
  without the heat channel and the recombination photons (chip_smoke's
  ``chemistry_check``: bit-equal to ``global_pass_he_ref`` and one launch
  a pass, asserted; ms per pass, the bound of the function and the time of
  the kernel's own SASS at the issue rate). ``--state FILE`` keeps
  the EoR state in FILE (.npz) and the helium state beside it (FILE's name
  with ``_he``): each made by the first run that finds none, read by the
  others, so that every checkout of a call passes the same inputs.

``--chemistry-only`` measures the hydrogen pass alone (the sets above and
phase 3's Gamma with a temperature of its own in every cell, random or
from the thermal update below) and the
thermal update (``update_temperature`` over 256^3 cells from 100 K,
z = 9, heated by phase 3's Gamma times 5e-12 erg, in float32 and in
float64: ms per update by CUDA events, bit-equal to
``update_temperature_ref`` where the checkout has one, and its launches a
call).

``--box`` measures the box engine's bench trace alone (phase 3f's
configuration and fields: ``BoxRaytracer``, float32, 14 compressed bins,
256 batches of B = 8): ms per trace of ``rt.trace_batches`` (CUDA events,
the least of 3) and its ns per cell-update; where the checkout has the
plain loop ``box_trace_sweep_ref``, the trace bit-equal to it over the
first 16 batches (asserted), and from one profiled trace each box kernel's
median device us a launch, the gap before it, its us a batch and the device
launches a batch (a checkout whose box trace is plain PyTorch is timed
only).

``--chunks`` measures the bench default and EoR-bucket traces again with
the loop's extract forced to each chunk of batches K (a checkout with the
chunked extract, ``trace_loop.chunk_size``). ``--traces`` measures
``rates_he`` and the traces (and, with ``--chemistry``, the passes) alone.
Prints the card's name and power limit, then one line per measurement and
last a JSON object of the numbers under ``label``. Run two checkouts in
turns in one call (A, B, B, A) to compare them on one card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rate_pass(cs, N, R, heat, bins, reps):
    """ms per ``_rates`` call of an engine at (N, R) on its own sweep boxes
    of random densities, bit-equal to the plain pass."""
    from pyc2ray_torch.ops.cheb_rates import rates_dense_ref
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    from pyc2ray_torch.ops.sweep import rate_consts
    dt = torch.float32
    rt = ChebRaytracer(N, R, cs.SIG, bins, batch_size=cs.B_BENCH, dtype=dt,
                       do_heating=heat, shell_segment=0)
    tb = rt.tables
    nhi = cs.random_nhi(rt, cs.B_BENCH, dt, seed=5)
    cd = rt.sweep_box(nhi, cs.DR, cs.SIG)
    flux = torch.linspace(0.5, 2.0, cs.B_BENCH, dtype=dt, device="cuda")
    got = rt._rates(cd, nhi, flux, cs.DR)
    want = rates_dense_ref(cd, nhi, tb.rt_sub, flux, tb.bins_s, tb.bins_w,
                           cs.DR, cs.SIG, rate_consts(cs.DR, dt)[1], rt._rb0,
                           bins_wh=tb.bins_wh if heat else None)
    torch.cuda.synchronize()
    if not all(torch.equal(a, w) for a, w in zip(got, want)
               if w is not None):
        raise RuntimeError(f"rates N={N} R={R} heat={heat}: the kernel "
                           f"differs from the plain pass")
    del got, want
    ms = cs.cuda_ms(lambda: rt._rates(cd, nhi, flux, cs.DR), reps)
    cs.log(f"rates_dense N={N} R={R:g} B={cs.B_BENCH} Dc={rt.geom.Dc} "
           f"Ds={rt.Ds}{' heat' if heat else ''}: {ms:.4f} ms per call "
           f"(bit-equal to the plain pass)")
    return ms


def eor_state(cs, path):
    """The EoR run's state after both slices of one timestep each (ndens,
    temp, xh, phi_ion as float64 arrays, dt), read from ``path`` where it
    exists, else made by the model and written there (``path`` may be
    None)."""
    import contextlib
    import io
    import tempfile
    if path and os.path.exists(path):
        z = np.load(path)
        return {k: z[k] for k in z.files}
    from pyc2ray_torch import C2Ray_CubeP3M
    from pyc2ray_torch.utils.paramutils import read_paramfile
    params = read_paramfile(os.path.join(cs.EOR_DIR, "parameters.yml"))
    with tempfile.TemporaryDirectory() as tmp:
        params["Output"]["results_basename"] = tmp + "/"
        params["Output"]["inputs_basename"] = os.path.join(
            cs.EOR_DIR, "inputs") + "/"
        with contextlib.redirect_stdout(io.StringIO()):
            sim = C2Ray_CubeP3M(params, cs.N_EOR, device="cuda")
        for k in range(2):
            r = cs.eor_slice(sim, k)[2]
    out = {k: np.asarray(getattr(sim, k), dtype=np.float64).reshape(-1)
           for k in ("ndens", "temp", "xh", "phi_ion")}
    out["dt"] = np.array(r["dt"])
    out.update({f"chem_{k}": np.array(v)
                for k, v in sim.chem._asdict().items()})
    if path:
        np.savez(path, **out)
    return out


# the numbers of a chemistry_check kept per pass
CHEM_KEYS = ("ms", "bound_ms", "bound_binds", "bound_share",
             "issue_ms_at_own_sass", "iterations_per_cell", "lane_efficiency")


def chem_pass(cs, label, dt, nd, temp, xh, phi, chem, reps=20):
    """ms per global_pass (CUDA events), bit-equal to global_pass_ref and
    one launch a pass (asserted), with the iterations per cell, the lane
    efficiency, the bound of its function and the time of its own SASS
    (chip_smoke's ``chemistry_check``)."""
    k, _ = cs.chemistry_check(label, False, (dt, nd, temp, xh, xh, phi,
                                             chem), {}, reps=reps)
    return {key: k[key] for key in CHEM_KEYS}


def he_rate_pass(cs, reps=20):
    """ms per rate pass of the helium engine (``_rates_he``: one
    ``rates_he`` launch; CUDA events, back to back, with its zeroed
    outputs) at the bench shape on chip_smoke phase 2d's boxes, with and
    without the heat channel, bit-equal to ``rates_he_ref`` (asserted),
    with the bound of its function and the time of the kernel's own SASS at
    the issue rate."""
    from pyc2ray_torch.ops.cheb_rates import rates_he_ref
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    from pyc2ray_torch.ops.sweep import rate_consts
    dt, out = torch.float32, {}
    for heat in (False, True):
        rt = HeRaytracer(cs.N_BENCH, cs.R_BENCH, cs.he_bins(), cs.ABU_HE,
                         batch_size=cs.B_BENCH, dtype=dt, do_heating=heat)
        eng, heb = rt.eng, rt.he_tables
        cds, nb, flux = cs.he_boxes(rt, cs.B_BENCH, dt, seed=13)
        got = rt._rates_he(cds, nb, flux, cs.DR)
        want = rates_he_ref(cds, nb, eng.tables.rt_sub, flux, heb.se,
                            heb.w_se, cs.DR, rate_consts(cs.DR, dt)[1],
                            eng._rb0, wh_se=heb.wh_se if heat else None,
                            cells=eng.rated_cells)
        torch.cuda.synchronize()
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise RuntimeError(f"rates_he heat={heat}: the kernel differs "
                               f"from the plain pass")
        del got, want
        ms = cs.cuda_ms(lambda: rt._rates_he(cds, nb, flux, cs.DR), reps)
        nbytes, ops, rated, n_mufu = cs.he_work(rt, cds, nb, heat)
        bound = cs.function_bound(nbytes, ops / cs.H100_F32_FLOPS,
                                  n_mufu)[0]
        t_sass, sass, _ = cs.he_rates_sass(rt, rated, heat)
        issue = 1e3 * t_sass
        key = "rates_he_heat" if heat else "rates_he"
        cs.log(f"{key} bench B={cs.B_BENCH} Dc={rt.geom.Dc} Ds={eng.Ds} "
               f"E={heb.se.shape[1]}: {ms:.4f} ms per call back to back "
               f"(bit-equal to the plain pass); bound {bound:.5f} ms, the "
               f"kernel at {bound / ms:.3f} of it; its own SASS at the issue "
               f"rate {issue:.5f} ms, the kernel at {issue / ms:.3f} of it; "
               f"SASS bin loops "
               + str([(lp["iter"], lp["static"], lp["bins"])
                      for lp in sass["loops"]]) + " (shortest path without "
               f"spills, static, bins a pass)")
        out[f"{key}_ms"] = ms
        out[f"{key}_bound_ms"] = bound
        out[f"{key}_issue_ms_at_own_sass"] = issue
    return out


def he_state(cs, path, he):
    """Phase 3e's helium state: the helium bench fields (n_H 1e-3, x 1.2e-3,
    y1 1e-3, y2 0, T 1e4 on 256^3 cells) and the three rates of one trace
    of the helium bench (float32, as float64 arrays in memory), read from
    ``path`` where it exists, else traced by ``he`` (a float32
    HeRaytracer) and written there (``path`` may be None)."""
    if path and os.path.exists(path):
        z = np.load(path)
        return [z[f"g{s}"] for s in range(3)]
    N = cs.N_BENCH
    src = np.random.RandomState(100).randint(0, N, size=(cs.NS_BENCH, 3))
    pos_b, flux_b = he.prepare_sources(src, np.ones(cs.NS_BENCH))
    f = [torch.full((N,) * 3, v, dtype=torch.float32, device="cuda")
         for v in (1e-3, 1.2e-3, 1e-3, 0.0)]
    g = [t.cpu().numpy() for t in he.trace_batches(*f, pos_b, flux_b,
                                                    cs.DR)[:3]]
    if path:
        np.savez(path, **{f"g{s}": a for s, a in enumerate(g)})
    return g


def he_chemistry(cs, state_path):
    """The helium pass on phase 3e's state in float32 and float64, with
    and without the heat channel (a photoheating rate of 5e-12 erg per HI
    ionisation) and the recombination photons: chip_smoke's
    ``chemistry_check`` (bit-equal, one launch a pass, asserted)."""
    from pyc2ray_torch.ops.chemistry_he import HeChemistryParams
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    path = None
    if state_path:
        root, ext = os.path.splitext(state_path)
        path = f"{root}_he{ext or '.npz'}"
    he = HeRaytracer(cs.N_BENCH, cs.R_BENCH, cs.he_bins(), cs.ABU_HE,
                     batch_size=cs.B_BENCH, dtype=torch.float32)
    g = he_state(cs, path, he)
    del he
    phe = HeChemistryParams(chem=cs.chem_params(), abu_he=cs.ABU_HE)
    n, out = cs.N_BENCH ** 3, {}
    for t, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        def grid(v):
            return torch.full((n,), v, dtype=t, device="cuda")
        nd, temp, xh, y1, y2 = (grid(v) for v in (1e-3, 1e4, 1.2e-3, 1e-3,
                                                  0.0))
        rates = [torch.from_numpy(a.reshape(-1)).to("cuda", t) for a in g]
        args = (torch.tensor(cs.DT, dtype=t).to("cuda"), nd, temp, xh, xh,
                y1, y1, y2, y2, *rates, phe)
        for heat in (False, True):
            for rec in (False, True):
                kw = dict(heat=5e-12 * rates[0] if heat else None,
                          recombination_photons=rec)
                k, _ = cs.chemistry_check(
                    f"chemistry_he 3e's state 256^3 {tag} heat {heat} "
                    f"recombination photons {rec}", True, args, kw, reps=10)
                out[f"chem_he_{tag}{'_heat' if heat else ''}"
                    f"{'_rec' if rec else ''}"] = {
                        key: k[key] for key in CHEM_KEYS}
    return out


def thermal(cs, dt_d, nd, xh, phi, reps=5):
    """ms per update_temperature over phase 3's fields from 100 K, heated
    by its Gamma times 5e-12 erg (z = 9, 16 substeps; CUDA events), in
    float32 and in float64, each bit-equal to update_temperature_ref where
    the checkout has one (asserted), and its kernel launches a call; and
    the float32 update's temperatures."""
    from pyc2ray_torch.ops import sweep, thermal as th
    c = cs.chem_params()
    p = th.ThermalParams(bh00=c.bh00, albpow=c.albpow, colh0=c.colh0,
                         temph0=c.temph0, abu_c=c.abu_c)
    out, updated = {}, None
    for t, tag in ((torch.float32, ""), (torch.float64, "_f64")):
        args = [a.to(t) for a in (dt_d, torch.full_like(nd, 100.0), nd, xh,
                                  phi * 5e-12)]
        sweep.reset_launches()
        got = th.update_temperature(*args, p, z=9.0)
        n_launch = sweep.launches.get("thermal_update", 0)
        equal = None
        if hasattr(th, "update_temperature_ref"):
            want = th.update_temperature_ref(*args, p, z=9.0)
            equal = bool(torch.equal(got, want))
            if not equal:
                raise RuntimeError(f"update_temperature {t} differs from its "
                                   f"plain version")
            del want
        ms = cs.cuda_ms(lambda: th.update_temperature(*args, p, z=9.0),
                        reps if tag == "" else max(2, reps // 2))
        cs.log(f"update_temperature 256^3 {t} from 100 K: {ms:.4f} ms per "
               f"update, {n_launch} thermal_update launch(es), bit-equal to "
               f"the plain version: {equal}; T {float(got.min()):.1f}.."
               f"{float(got.max()):.1f} K")
        out[f"thermal{tag}_ms"] = ms
        out[f"thermal{tag}_launches"] = n_launch
        if tag == "":
            updated = got
        del args, got
    return out, updated


def chemistry(cs, bins, state_path, thermal_too=False):
    """The hydrogen pass on phase 3's Gamma (with its one temperature and
    with a temperature a cell) and on the EoR run's state; with
    ``thermal_too`` the thermal update on phase 3's fields."""
    from pyc2ray_torch.ops.chemistry import ChemistryParams
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    N, dt = cs.N_BENCH, torch.float32
    rt = ChebRaytracer(N, cs.R_BENCH, cs.SIG, bins, batch_size=cs.B_BENCH,
                       dtype=dt)
    src = np.random.RandomState(100).randint(0, N, size=(cs.NS_BENCH, 3))
    pos_b, flux_b = rt.prepare_sources(src, np.ones(cs.NS_BENCH))

    def grid(v):
        return torch.full((N ** 3,), v, dtype=dt, device="cuda")
    nd, temp, xh = grid(1e-3), grid(1e4), grid(1.2e-3)
    phi, _ = rt.trace_batches(nd, xh, pos_b, flux_b, cs.DR)
    dt_d = torch.tensor(cs.DT, dtype=dt).to("cuda")
    out = {"chem_bench_f32": chem_pass(
        cs, "chemistry bench 256^3 float32 (phase 3's Gamma)", dt_d, nd,
        temp, xh, phi, cs.chem_params())}
    # the same Gamma with a temperature of its own in every cell
    rng = np.random.RandomState(19)
    temp_mixed = torch.from_numpy(10 ** rng.uniform(3.0, 4.5, N ** 3)).to(
        "cuda", dt)
    out["chem_bench_mixed_f32"] = chem_pass(
        cs, "chemistry bench 256^3 float32 (phase 3's Gamma, T = 10^U(3, "
        "4.5) a cell)", dt_d, nd, temp_mixed, xh, phi, cs.chem_params())
    if thermal_too:
        # the update's temperatures (the same bits in every checkout: its
        # kernel equals the plain version) as a third set
        k_th, temp_3c = thermal(cs, dt_d, nd, xh, phi)
        out.update(k_th)
        out["chem_bench_updated_f32"] = chem_pass(
            cs, "chemistry bench 256^3 float32 (phase 3's Gamma, the "
            "updated T)", dt_d, nd, temp_3c, xh, phi, cs.chem_params())
        del temp_3c
    del rt, phi, nd, temp, xh, temp_mixed
    st = eor_state(cs, state_path)
    chem = ChemistryParams(**{k[5:]: float(v) for k, v in st.items()
                              if k.startswith("chem_")})
    for t, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        f = [torch.from_numpy(st[k]).to("cuda", t)
             for k in ("ndens", "temp", "xh", "phi_ion")]
        out[f"chem_eor_{tag}"] = chem_pass(
            cs, f"chemistry EoR 250^3 {t} (the run's last state)",
            torch.tensor(float(st["dt"]), dtype=t).to("cuda"), *f, chem,
            reps=20 if tag == "f32" else 5)
    return out


def trace(cs, label, rt, pad, pos_b, flux_b):
    """The trace bit for bit against ``trace_extended_plain`` with its
    launch counts (chip_smoke's ``loop_against_plain``), ms per trace of
    ``rt.trace_extended`` (least of 3 after a warm-up) and its per-kernel
    device us and gaps."""
    cs.loop_against_plain(label, rt, pad, pos_b, flux_b, reps=1)
    ms = min(cs.cuda_ms(lambda: rt.trace_extended(pad, pos_b, flux_b, cs.DR),
                        1) for _ in range(3))
    cs.log(f"{label}: {ms:.3f} ms per trace of {pos_b.shape[0]} batches")
    return dict(ms=ms, kernels=cs.loop_kernel_gaps(label, rt, pad, pos_b,
                                                   flux_b))


def he_trace(cs, label, rt, pads, pos_b, flux_b):
    """The helium trace: bit for bit against ``trace_extended_plain`` with
    its launch counts (chip_smoke's ``he_loop_against_plain``) where the
    engine has one, ms per trace of ``rt.trace_extended`` (least of 3 after
    a warm-up) and its per-kernel device us and gaps."""
    if hasattr(rt, "trace_extended_plain"):
        cs.he_loop_against_plain(label, rt, pads, pos_b, flux_b, reps=1)
    ms = min(cs.cuda_ms(lambda: rt.trace_extended(pads, pos_b, flux_b,
                                                  cs.DR), 1)
             for _ in range(3))
    cs.log(f"{label}: {ms:.3f} ms per trace of {pos_b.shape[0]} batches")
    return dict(ms=ms, kernels=cs.loop_kernel_gaps(label, rt, pads, pos_b,
                                                   flux_b))


def helium_bench(cs, src):
    """The helium bench trace (``he_trace``) of phase 3e's configuration
    and fields: 256 batches of B = 8 at R = 30, 72 bins, float32."""
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    N, dt = cs.N_BENCH, torch.float32
    he = HeRaytracer(N, cs.R_BENCH, cs.he_bins(), cs.ABU_HE,
                     batch_size=cs.B_BENCH, dtype=dt)
    he_pos, he_flux = he.prepare_sources(src, np.ones(cs.NS_BENCH))
    he_pads = [he.eng.wrap_pad(f) for f in he.species_fields(
        *(torch.full((N,) * 3, v, dtype=dt, device="cuda")
          for v in (1e-3, 1.2e-3, 1e-3, 0.0)))]
    return he_trace(cs, f"helium bench N={N} B={cs.B_BENCH}", he, he_pads,
                    he_pos, he_flux)


def flat_bench(cs, src):
    """The flat engine's bench trace (phase 3d's): bit for bit against the
    plain loop over its first 16 batches, ms per trace of
    ``rt.trace_batches`` (least of 3 after a warm-up) and, from one profiled
    trace, each flat kernel's median device us, the gap before it and the
    device launches a batch."""
    from pyc2ray_torch.diagnostics import profile_trace
    N, dt = cs.N_BENCH, torch.float64
    rt = cs.flat_engine(cs.flat_tables(), dt, False)
    pos_b, flux_b = rt.prepare_sources(src, np.ones(cs.NS_BENCH))
    nd = torch.full((N ** 3,), 1e-3, dtype=dt, device="cuda")
    xh = torch.full((N ** 3,), 1.2e-3, dtype=dt, device="cuda")
    label = f"flat bench N={N} B={cs.B_BENCH} float64"
    cs.flat_loop_vs_plain(label, rt, nd, xh, pos_b[:16], flux_b[:16])
    ms = min(cs.cuda_ms(lambda: rt.trace_batches(nd, xh, pos_b, flux_b,
                                                 cs.DR), 1)
             for _ in range(3))
    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "flat")
        with profile_trace(prof) as p:
            p["sync"] = rt.trace_batches(nd, xh, pos_b, flux_b, cs.DR)[0]
        per_k, n_launch = cs.flat_kernel_us(prof)
    nb = pos_b.shape[0]
    per_batch = {k: d * n / nb for k, (d, _, n) in per_k.items()}
    cs.log(f"{label}: {ms:.3f} ms per trace of {nb} batches; "
           f"{n_launch / nb:.4f} device launches a batch; " + "; ".join(
               f"{k} {d:.2f} us a launch after a gap of {g:.2f} us (median "
               f"of {n}), {per_batch[k]:.2f} us a batch"
               for k, (d, g, n) in per_k.items()))
    return dict(ms=ms, kernels=per_k, us_per_batch=per_batch,
                launches_per_batch=n_launch / nb)


def box_bench(cs, src, bins):
    """The box engine's bench trace (phase 3f's): bit for bit against the
    plain loop over its first 16 batches where the checkout has one, ms per
    trace of ``rt.trace_batches`` (least of 3 after a warm-up) and, where
    the trace is the kernel loop, from one profiled trace each box kernel's
    median device us a launch, the gap before it, its us a batch (the
    median times its launches over the batches) and the device launches a
    batch."""
    from pyc2ray_torch.diagnostics import profile_trace
    from pyc2ray_torch.ops.raytrace_box import BoxRaytracer
    N, dt = cs.N_BENCH, torch.float32
    rt = BoxRaytracer(N, cs.R_BENCH, cs.SIG, bins, batch_size=cs.B_BENCH,
                      dtype=dt)
    pos_b, flux_b = rt.prepare_sources(src, np.ones(cs.NS_BENCH))
    nd = torch.full((N ** 3,), 1e-3, dtype=dt, device="cuda")
    xh = torch.full((N ** 3,), 1.2e-3, dtype=dt, device="cuda")
    label = f"box bench N={N} B={cs.B_BENCH} float32"
    loop = hasattr(rt, "box_trace_sweep_ref")
    if loop:
        cs.box_loop_vs_plain(label, rt, nd, xh, pos_b[:16], flux_b[:16])
    ms = min(cs.cuda_ms(lambda: rt.trace_batches(nd, xh, pos_b, flux_b,
                                                 cs.DR), 1)
             for _ in range(3))
    nb = pos_b.shape[0]
    ns = 1e6 * ms / cs.cell_updates(cs.NS_BENCH, cs.R_BENCH)
    out = dict(ms=ms, ns_per_cell=ns)
    text = ""
    if loop:
        with tempfile.TemporaryDirectory() as tmp:
            prof = os.path.join(tmp, "box")
            with profile_trace(prof) as p:
                p["sync"] = rt.trace_batches(nd, xh, pos_b, flux_b,
                                             cs.DR)[0]
            per_k, n_launch = cs.flat_kernel_us(prof, cs.BOX_KERNELS)
        per_batch = {k: d * n / nb for k, (d, g, n) in per_k.items()}
        out.update(kernels=per_k, us_per_batch=per_batch,
                   launches_per_batch=n_launch / nb)
        text = f"; {n_launch / nb:.4f} device launches a batch; " + "; ".join(
            f"{k} {d:.2f} us a launch after a gap of {g:.2f} us (median of "
            f"{n}), {per_batch[k]:.2f} us a batch"
            for k, (d, g, n) in per_k.items())
    cs.log(f"{label}: {ms:.3f} ms per trace of {nb} batches, {ns:.5f} "
           f"ns/cell-update{text}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose pyc2ray_torch is measured")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--traces", action="store_true",
                    help="measure the rate pass rates_he and the traces only")
    ap.add_argument("--chemistry", action="store_true",
                    help="also the chemistry passes")
    ap.add_argument("--state", default=None,
                    help="the .npz file of the EoR state the passes share")
    ap.add_argument("--chemistry-only", action="store_true",
                    help="the hydrogen pass and the thermal update alone")
    ap.add_argument("--chunks", default="",
                    help="chunks of batches the extract is forced to")
    ap.add_argument("--box", action="store_true",
                    help="the box engine's bench trace alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    cs = _chip_smoke()
    import pyc2ray_torch
    from pyc2ray_torch.ops import _build
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"{args.label}: pyc2ray_torch from "
           f"{os.path.dirname(pyc2ray_torch.__file__)}; {smi}")
    t0 = time.time()
    _build.load()
    cs.log(f"build: {time.time() - t0:.2f} s")
    bins = cs.make_bins()
    out = dict(label=args.label, device=smi)
    if args.chemistry_only:
        cs.log_ptxas("hydrogen")
        cs.log_ptxas("thermal")
        out.update(chemistry(cs, bins, args.state, thermal_too=True))
        cs.log(json.dumps(out))
        return 0
    if args.box:
        src = np.random.RandomState(100).randint(0, cs.N_BENCH,
                                                 size=(cs.NS_BENCH, 3))
        out["box_bench"] = box_bench(cs, src, bins)
        cs.log(json.dumps(out))
        return 0
    cs.log_ptxas("rates_he")
    cs.log_ptxas("helium")
    out.update(he_rate_pass(cs))
    dt, N = torch.float32, cs.N_BENCH
    src = np.random.RandomState(100).randint(0, N, size=(cs.NS_BENCH, 3))
    for heat in () if args.traces else (False, True):
        for N, R, key in ((cs.N_BENCH, cs.R_BENCH, "bench"),
                          (cs.N_R100, cs.R_R100, "r100")):
            out[f"rates_{key}{'_heat' if heat else ''}_ms"] = rate_pass(
                cs, N, R, heat, bins, reps=10 if key == "bench" else 3)
    for B, Dc, tag in () if args.traces else ((cs.B_BENCH, 64, "bench"),
                                              (cs.B_EOR, 24, "EoR")):
        side = (cs.N_BENCH if tag == "bench" else cs.N_EOR) + Dc - 1
        cs.check_box_kernels(f"{tag} B={B} Dc={Dc} frame {side}^3",
                             (side,) * 3, B, Dc, torch.float32, seed=12,
                             reps=20)
    rt = ChebRaytracer(N, cs.R_BENCH, cs.SIG, bins, batch_size=cs.B_BENCH,
                       dtype=dt)
    pos_b, flux_b = rt.prepare_sources(src, np.ones(cs.NS_BENCH))
    nhi = torch.full((N,) * 3, 1e-3 * (1.0 - 1.2e-3), dtype=dt,
                     device="cuda")
    default = (rt, rt.wrap_pad(nhi), pos_b, flux_b)
    out["bench_default"] = trace(cs, f"default bench N={N} B={cs.B_BENCH}",
                                 *default)
    rt = ChebRaytracer(N, cs.R_BENCH, cs.SIG, bins, batch_size=cs.B_BENCH,
                       dtype=dt, fuse_fold=True)
    out["bench_fuse_fold"] = trace(cs, f"fuse_fold bench N={N} "
                                   f"B={cs.B_BENCH}", rt, rt.wrap_pad(nhi),
                                   pos_b, flux_b)
    rt = ChebRaytracer(cs.N_EOR, cs.R_EOR[0], cs.SIG, bins,
                       batch_size=cs.B_EOR, dtype=dt, fuse_fold=True)
    rng = np.random.RandomState(16)
    nb = 128
    pos = rng.randint(0, cs.N_EOR, size=(nb * cs.B_EOR, 3))
    pos[:cs.B_EOR] = (pos[0] + rng.randint(0, 3, (cs.B_EOR, 3))) % cs.N_EOR
    field = 10 ** np.random.RandomState(17).uniform(-4, -2, (cs.N_EOR,) * 3)
    pad = rt.wrap_pad(torch.from_numpy(field).to("cuda", dt))
    pos_b, flux_b = rt.prepare_sources(pos, 10 ** rng.uniform(
        -1, 0, nb * cs.B_EOR))
    out["eor_bucket"] = trace(cs, f"EoR bucket R={cs.R_EOR[0]:.2f} "
                              f"B={cs.B_EOR} (K3), {nb} batches", rt, pad,
                              pos_b, flux_b)
    out["helium_bench"] = helium_bench(cs, src)
    out["flat_bench"] = flat_bench(cs, src)
    if args.chunks:
        from pyc2ray_torch.ops import trace_loop
        rule = trace_loop.chunk_size
        for k in (int(v) for v in args.chunks.split(",")):
            trace_loop.chunk_size = lambda n, *_, k=k: min(k, n)
            for key, t in (("bench_default", default), ("eor_bucket",
                                                        (rt, pad, pos_b,
                                                         flux_b))):
                out[f"{key}_chunk{k}"] = trace(cs, f"{key} chunk={k}", *t)
        trace_loop.chunk_size = rule
    if args.chemistry:
        out.update(chemistry(cs, bins, args.state))
        out.update(he_chemistry(cs, args.state))
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
