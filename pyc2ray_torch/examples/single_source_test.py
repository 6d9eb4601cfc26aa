"""Single black-body source regression test on the port (the golden).

The counterpart of examples/single_source_test/run_test.py (the
reference's test/unit_tests_hackathon/1_single_black_body/run_test.py): a
uniform grid ionized by one 1e49 photons/s black-body source for 2
redshift slices x 10 timesteps, through C2Ray_Test on that example's
parameters.yml (``engine: flat``, table-exact, float64). The reference
solution comes from the sequential C2Ray-faithful C++ oracle
(native_ext: native/c2ray_native.cpp, built with g++ at first use)
running the same evolve loop; the per-cell error statistics and
tolerances are the reference's (run_test.py:89-118). ``--engine cheb``
(or ``pallas``, the same engine on the port) runs the production
spectral-bin path in float32, fuse_fold (K3 on the card), against the
documented bins-vs-table budget.

    python -m pyc2ray_torch.examples.single_source_test [-N 32] [--full]
        [--numreds 2] [--steps 10] [--engine flat|cheb|pallas]
        [--device cuda|cpu] [--workdir DIR]
"""

import sys
import time

import numpy as np

from ._common import add_port_arguments, driver_parser, load_params, setup

# run_test.py:190-210: name, tolerance
TABLE_TOLERANCES = (("Absolute mean", 1e-8), ("Absolute std", 3e-7),
                    ("Absolute max", 5e-6), ("Absolute min", 5e-6),
                    ("Relative mean", 1e-7), ("Relative std", 3e-6),
                    ("Relative max", 2e-5), ("Relative min", 2e-5))
BINS_TOLERANCES = (("Absolute mean", 5e-5), ("Absolute std", 3e-5),
                   ("Absolute max", 4e-4), ("Absolute min", 3e-5),
                   ("Relative mean", 3e-2), ("Relative std", 1.5e-2),
                   ("Relative max", 5e-2), ("Relative min", 1e-3))


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=32)
    parser.add_argument("--full", action="store_true",
                        help="run the full 128^3 configuration")
    parser.add_argument("--numreds", type=int, default=2)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--engine", default=None,
                        choices=["flat", "cheb", "pallas"],
                        help="override Raytracing.engine. flat (default) "
                        "is the table-exact f64 path judged against the "
                        "golden 2e-5 tolerances; cheb/pallas are the "
                        "production f32 spectral-bin path judged against "
                        "the documented bins-vs-table budget")
    add_port_arguments(parser, ".", "results/ (the log)")
    return parser


def oracle_evolve_loop(sim, pos0, flux0, dt, dr, xh, ndens, temp):
    """One timestep of the sequential C++ oracle, to convergence as
    run_test.py:104-128 writes it; returns the new ionized fraction."""
    from ..native_ext import chemistry_global_native, oracle_sweep_native
    tables = (sim.photo_thin_table, sim.photo_thick_table,
              sim.heat_thin_table, sim.heat_thick_table,
              sim.minlogtau, sim.dlogtau)
    num_cells = xh.size
    conv_criterion = min(int(1e-4 * num_cells), 0)
    prev1 = prev0 = 2.0 * num_cells
    xh_av = xh.copy()
    xh_int = xh.copy()
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
        converged = (conv_flag < conv_criterion) or (rel1 < 1e-4 and
                                                     rel0 < 1e-4)
        prev1, prev0 = s1, s0
    return xh_int


def statistics(xh, xh_oracle, tolerances):
    """The eight error statistics of run_test.py:168-210:
    [(name, value, tolerance)]."""
    abserr = xh - xh_oracle
    relerr = abserr / xh_oracle
    values = (abserr.mean(), abserr.std(), abserr.max(), abserr.min(),
              relerr.mean(), relerr.std(), relerr.max(), relerr.min())
    return [(name, v, tol) for (name, tol), v in zip(tolerances, values)]


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, workdir = setup(args)
    import pyc2ray_torch as pc2r
    from ..native_ext import load_native
    from ..utils.sourceutils import format_sources

    N = 128 if args.full else args.N
    num_steps_between_slices = args.steps
    numzred = args.numreds
    params = load_params("single_source_test", workdir / "results")
    if args.engine:
        params["Raytracing"]["engine"] = args.engine
        if args.engine != "flat":
            # the production engines run float32; the comparison budget
            # below accounts for it
            params["Raytracing"]["dtype"] = "float32"

    sim = pc2r.C2Ray_Test(params, N, device=device)

    zred_array = sim.generate_redshift_array(numzred, 1e7)

    # single source at the grid center region (1-indexed convention)
    srcpos = np.array([[3 * N // 4], [3 * N // 4], [N // 2]], dtype=float)
    srcflux = np.array([1e49 / 1e48])

    avgdens = 1e-3
    ndens = avgdens * np.ones((N, N, N))
    sim.ndens = ndens.copy()

    # the oracle's library, built with g++ at first use; its error stands
    load_native()
    pos0, flux0 = format_sources(srcpos, srcflux)

    xh_oracle = sim.xh.copy()
    xh_initial = sim.xh.copy()
    temp = sim.temp.copy()
    tinit = time.time()

    steps_executed = 0
    for k in range(len(zred_array) - 1):
        zi, zf = zred_array[k], zred_array[k + 1]
        dt = sim.set_timestep(zi, zf, num_steps_between_slices)
        pc2r.printlog(f"Doing redshift {zi:.3f} to {zf:.3f}", sim.logfile)
        for _ in range(num_steps_between_slices):
            sim.cosmo_evolve(dt)
            sim.evolve3D(dt, srcflux, srcpos)
            xh_oracle = oracle_evolve_loop(sim, pos0, flux0, dt, sim.dr,
                                           xh_oracle, sim.ndens, temp)
            steps_executed += 1

    pc2r.printlog(f"Done. Final time: {time.time()-tinit:.3f} s",
                  sim.logfile)

    # Guard against vacuous passes: the error statistics below are only
    # meaningful if the run actually evolved the field (e.g. --numreds 1
    # yields len(zred_array)-1 == 0 slices and would trivially "pass").
    if steps_executed == 0:
        print("ERROR: zero timesteps executed (need --numreds >= 2); "
              "no comparison was performed")
        return 2
    if np.array_equal(np.asarray(sim.xh), xh_initial):
        print("ERROR: ionized fraction did not change over "
              f"{steps_executed} steps; the run did not evolve")
        return 2

    xfrac = np.asarray(sim.xh)
    print("\n \n TEST RESULTS \n")
    print(f"Mean ionized fraction (oracle): {xh_oracle.mean():.12e}")
    print(f"Mean ionized fraction (port):   {xfrac.mean():.12e}")

    if args.engine in ("cheb", "pallas"):
        # the spectral bins against the oracle's NumTau=2000 table: the
        # table's own interpolation error dominates (README "Accuracy
        # hierarchy"), hence the budget of run_test.py:176-199
        print(f"(engine {args.engine}: bins-vs-table budget tolerances)")
        checks = statistics(xfrac, xh_oracle, BINS_TOLERANCES)
    else:
        checks = statistics(xfrac, xh_oracle, TABLE_TOLERANCES)
    nfail = 0
    for name, val, tol in checks:
        ok = abs(val) <= tol
        print(f"{name:16s}: {val: .7e}   {'PASSED' if ok else 'FAILED'}")
        nfail += 0 if ok else 1

    print("\nALL TESTS PASSED" if nfail == 0 else f"\n{nfail} TEST(S) FAILED")
    return 0 if nfail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
