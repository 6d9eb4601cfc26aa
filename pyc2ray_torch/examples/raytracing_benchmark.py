"""Raytracing kernel benchmark harness on the port.

The counterpart of examples/raytracing_benchmark/run_test.py, the
reference's Figure-8 methodology (test/paper_tests/raytracing_benchmark/
run_test.py:45-113): sweep source counts and octahedron radii on an N^3
grid, time the raw raytrace call, and store timings normalized as
t/(Ns * 4 pi R^3 / 3) (seconds per cell-update per source), as a pickle
with the JAX harness's fields (and JSON with ``--json``).

    python -m pyc2ray_torch.examples.raytracing_benchmark [-N 250]
        [--numsrc 10 100 1000] [--R 10 30 50 100] [--reps 3] [--batch 8]
        [--engine cheb|pallas|flat|he] [--sed grey|bb] [--device cuda|cpu]

Engines: ``cheb`` and ``pallas`` both build the port's ChebRaytracer in
its default mode (the sweep kernel K1, or K2 shell-segmented where the
auto rule segments, as at R = 100, plus the rate pass); ``he`` the
three-species HeRaytracer (K1 three times per batch); ``flat`` the
table-exact octahedral engine with the grey analytic rates (on the card
one call of the kernel loop of csrc/flat_sweep.cu a trace). After each
call the harness synchronizes the card. The first call's time
(``compile_s``) is the warm-up; the kernels' build, which the first use of
a fresh checkout pays, is done and printed before it. The port has no
window accumulate: ``window`` is None.
"""

import json
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

from ._common import add_port_arguments, driver_parser, setup


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=250)
    parser.add_argument("--numsrc", type=int, nargs="+",
                        default=[10, 100, 1000, 10000])
    parser.add_argument("--R", type=float, nargs="+",
                        default=[10.0, 30.0, 50.0, 100.0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--engine", default="cheb",
                        choices=["cheb", "pallas", "flat", "he"],
                        help="he = the three-species (H+He) engine "
                             "(72-bin 3-band default); cheb and pallas "
                             "are the same engine on the port")
    parser.add_argument("--sed", default="grey", choices=["grey", "bb"],
                        help="grey analytic bins or the production "
                             "black-body quadrature (bench.py config)")
    parser.add_argument("--compress", type=float, default=-1.0,
                        help="sum-of-exponentials bin compression target "
                             "(radiation/bins_compress). Default: 1e-3 "
                             "for --sed bb (the production default), "
                             "off for grey/he; 0 disables")
    parser.add_argument("-o", default="timings.pkl")
    parser.add_argument("--json", default=None,
                        help="also write results as JSON to this path")
    add_port_arguments(parser, ".", "the pickle and the JSON")
    return parser


def describe_device(device):
    """The card's name and power limit as nvidia-smi gives them
    (``name, power.limit``), else its name; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(index)


def make_bins(engine, sed, comp):
    """The spectral bins of run_test.py:68-93."""
    from ..constants import ev2fr
    from ..radiation import BlackBodySource
    if engine == "he":
        from ..radiation.helium import make_spectral_bins_he
        return make_spectral_bins_he(
            BlackBodySource(5e4, False, ev2fr * 13.598, 2.8))
    if sed == "bb":
        from ..radiation.spectral_bins import make_spectral_bins
        fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
        if comp > 0:
            from ..radiation.bins_compress import compress_bins
            dense = make_spectral_bins(
                BlackBodySource(5e4, False, fmin, 2.8), fmin, fmax,
                panels=48, nodes=16)
            return compress_bins(dense, target_rel=comp)
        return make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                                  fmin, fmax, panels=4, nodes=8)
    from ..ops.raytrace_box import grey_bins
    return grey_bins()


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, workdir = setup(args)
    from ..ops.raytrace import RaytraceConfig, Raytracer
    from ..ops.raytrace_cheb import ChebRaytracer

    dtype = torch.float32 if args.dtype == "float32" else torch.float64
    N = args.N
    rng = np.random.RandomState(100)
    ndens = torch.full((N ** 3,), 1e-3, dtype=dtype, device=device)
    xh = torch.full((N ** 3,), 1.2e-3, dtype=dtype, device=device)
    dr = 6.7e20

    comp = args.compress
    if comp < 0:
        comp = 1e-3 if (args.sed == "bb" and args.engine != "he") else 0.0
    bins = make_bins(args.engine, args.sed, comp)

    results = {"N": N, "batch_size": args.batch, "nreps": args.reps,
               "ASORA": "pyc2ray-torch", "engine": args.engine,
               "sed": args.sed, "num_bins": int(bins.num_bins),
               "compress": comp, "timings": {}}
    card = describe_device(device)
    cuda = device.type == "cuda"
    if cuda:
        from ..ops import _build
        t0 = time.time()
        _build.load()
        print(f"CUDA kernels built and loaded in {time.time() - t0:.1f} s "
              f"({card})", flush=True)

    def sync(x):
        if cuda:
            torch.cuda.synchronize(device)
        return x

    he = args.engine == "he"
    if he:
        from ..ops.raytrace_he import HeRaytracer
        sh3 = (N,) * 3
        nd3 = ndens.reshape(sh3)
        xh3 = xh.reshape(sh3)
        y13 = torch.full(sh3, 1e-3, dtype=dtype, device=device)
        y23 = torch.zeros(sh3, dtype=dtype, device=device)

    for R in args.R:
        if he:
            rt = HeRaytracer(N, R, bins, 0.074, batch_size=args.batch,
                             dtype=dtype, device=device)
        elif args.engine in ("cheb", "pallas"):
            rt = ChebRaytracer(N, R, 6.30e-18, bins, batch_size=args.batch,
                               dtype=dtype, device=device)
        else:
            cfg = RaytraceConfig(N=N, R_max_LLS=R, sig=6.30e-18,
                                 batch_size=args.batch, dtype=dtype,
                                 grey_analytic=True)
            rt = Raytracer(cfg, device=device)

        def call(pos_b, flux_b):
            if he:
                return rt.trace_batches(nd3, xh3, y13, y23,
                                        pos_b, flux_b, dr)[0]
            return rt.trace_batches(ndens, xh, pos_b, flux_b, dr)[0]

        for ns in args.numsrc:
            pos_b, flux_b = rt.prepare_sources(
                rng.randint(0, N, size=(ns, 3)), np.ones(ns))
            b_used = int(getattr(rt, "batch_size", args.batch))
            t0 = time.time()
            sync(call(pos_b, flux_b))           # warm-up
            t_compile = time.time() - t0
            ts = []
            for _ in range(args.reps):
                t0 = time.time()
                sync(call(pos_b, flux_b))
                ts.append(time.time() - t0)
            t = min(ts)
            norm = t / (ns * 4.0 / 3.0 * np.pi * R ** 3)
            results["timings"][(R, ns)] = {
                "t": t, "ns_per_cell": 1e9 * norm, "batch": b_used,
                "window": None, "compile_s": round(t_compile, 1)}
            print(f"R={R:6.1f} Ns={ns:7d}: {t:8.3f} s  "
                  f"{1e9*norm:8.3f} ns/cell-update  "
                  f"(B={b_used} compile {t_compile:.0f}s)", flush=True)
            _save(results, args, workdir, card)
    print("sweep complete")
    return 0


def _save(results, args, workdir, card):
    with open(workdir / args.o, "wb") as f:
        pickle.dump(results, f)
    if args.json:
        jres = dict(results)
        jres["timings"] = {f"R={R},Ns={ns}": v
                           for (R, ns), v in results["timings"].items()}
        jres["device"] = card
        with open(workdir / args.json, "w") as f:
            json.dump(jres, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
