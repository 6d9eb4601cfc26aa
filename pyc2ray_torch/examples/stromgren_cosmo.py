"""Cosmological I-front test on the port.

The counterpart of examples/stromgren_cosmo/run_test.py (the reference's
test/paper_tests/test2_Ifront_cosmo): a single source in an expanding
universe through C2Ray_Test on examples/single_source_test/parameters.yml
with ``cosmological: 1`` and ``NumTau: 500``. The density dilutes and the
proper cell size grows between timesteps following the C2Ray half-step
redshift convention (c2ray_base.py:229-257). Checks that the ionized
volume grows monotonically, and prints the redshift reached.

    python -m pyc2ray_torch.examples.stromgren_cosmo [-N 32]
        [--device cuda|cpu] [--workdir DIR]
"""

import sys

import numpy as np

from ._common import (EXAMPLES, add_port_arguments, driver_parser,
                      load_params, setup)


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=32)
    add_port_arguments(parser, EXAMPLES / "stromgren_cosmo",
                       "results/ (the log)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, workdir = setup(args)
    import pyc2ray_torch as pc2r
    N = args.N

    params = load_params("single_source_test", workdir / "results")
    params["Cosmology"]["cosmological"] = 1
    params["Photo"]["NumTau"] = 500

    sim = pc2r.C2Ray_Test(params, N, device=device)
    sim.ndens = None
    sim.density_init(sim.zred_0)          # avg_dens * (1+z0)^3

    srcpos = np.array([[N // 2], [N // 2], [N // 2]], dtype=float)
    srcflux = np.array([1e51 / 1e48])

    zreds = sim.generate_redshift_array(3, 5e6)
    vols = []
    for k in range(len(zreds) - 1):
        dt = sim.set_timestep(zreds[k], zreds[k + 1], 2)
        for _ in range(2):
            sim.cosmo_evolve(dt)
            sim.evolve3D(dt, srcflux, srcpos)
            vols.append(sim.xh.sum())
            pc2r.printlog(f"z={sim.zred:.4f} dr={sim.dr:.4e} "
                          f"<n>={sim.ndens.mean():.4e} V_ion={vols[-1]:.4e}",
                          sim.logfile)

    if len(vols) < 2:
        print(f"ERROR: only {len(vols)} timesteps executed; "
              "monotonicity check needs at least 2 (vacuous pass guard)")
        return 2
    ok = all(b >= a for a, b in zip(vols, vols[1:]))
    print("ionized volume monotonic:", ok)
    print("final redshift:", f"{sim.zred:.4f}", "(from", f"{zreds[0]:.4f})")
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
