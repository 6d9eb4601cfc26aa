"""Production EoR run driver on the port.

The counterpart of examples/eor_simulation/run_test.py (the reference's
test/paper_eor_simulation/run_test.py): C2Ray_CubeP3M on that example's
parameters.yml (``engine: adaptive``, float32, B = 16: on the card one
trace loop per flux bucket and raytrace iteration, with K3 and the box
kernels, and the chemistry pass) loops over redshift slices of CubeP3M
density fields and halo catalogs, doing ``num_steps`` timesteps per slice.
It reads examples/eor_simulation/inputs/ (coarser_densities/<z>n_all.dat,
sources/*.hdf5; without h5py where the machine has none) and writes
results/ under ``--workdir``. ``--synthetic`` writes a random input set
instead, to inputs_synthetic/ under ``--workdir``; it needs h5py.

    python -m pyc2ray_torch.examples.eor_simulation [-N 250]
        [--num_steps 2] [--num_slices 3] [--synthetic] [--numsrc 200]
        [--device cuda|cpu] [--workdir DIR]

The committed inputs hold the slices 21.062 and 20.134: the default three
slices stop at 19.284's missing catalog, as the JAX script does; pass
``--num_slices 2``.
"""

import os
import sys

import numpy as np

from ._common import (EXAMPLES, add_port_arguments, driver_parser,
                      load_params, setup)


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=250)
    parser.add_argument("--num_steps", type=int, default=2)
    parser.add_argument("--num_slices", type=int, default=3)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--numsrc", type=int, default=200,
                        help="sources per slice for --synthetic")
    add_port_arguments(parser, EXAMPLES / "eor_simulation",
                       "results/ and, with --synthetic, inputs_synthetic/")
    return parser


def make_synthetic_inputs(N, basedir, zlist, ns=200):
    """A synthetic density + source input set (the role of
    archive/fake_cosmo_for_report in the reference), as
    run_test.py:18-35 writes it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("--synthetic writes HDF5 halo catalogs and needs "
                          "h5py, which is not installed") from e
    os.makedirs(os.path.join(basedir, "coarser_densities"), exist_ok=True)
    os.makedirs(os.path.join(basedir, "sources"), exist_ok=True)
    rng = np.random.RandomState(1)
    for z in zlist:
        rho = (1.0 + 0.3 * rng.standard_normal((N, N, N))).clip(0.1)
        rho = (rho * 1.0e-28).astype(np.float32)  # g/cm^3 comoving-ish
        fn = os.path.join(basedir, "coarser_densities", f"{z:.3f}n_all.dat")
        with open(fn, "wb") as f:
            np.asarray([N, N, N], dtype=np.int32).tofile(f)
            rho.flatten(order="F").tofile(f)
        with h5py.File(os.path.join(basedir, "sources",
                                    f"{z:.3f}-sources.hdf5"), "w") as f:
            f["sources_positions"] = rng.randint(1, N + 1, size=(ns, 3))
            f["sources_mass"] = 10 ** rng.uniform(9, 11, ns)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, workdir = setup(args)
    import pyc2ray_torch as pc2r

    zlist = np.array([21.062, 20.134, 19.284, 18.501, 17.778, 17.108])
    zlist = zlist[: args.num_slices + 1]
    params = load_params("eor_simulation", workdir / "results")
    if args.synthetic:
        # never write into examples/eor_simulation/inputs: it holds the
        # committed CubeP3M example data
        inputs = str(workdir / "inputs_synthetic")
        make_synthetic_inputs(args.N, inputs, zlist, ns=args.numsrc)
    else:
        inputs = str(EXAMPLES / "eor_simulation" / "inputs")
    params["Output"]["inputs_basename"] = inputs + "/"

    sim = pc2r.C2Ray_CubeP3M(params, args.N, device=device)

    xh_initial = np.asarray(sim.xh).copy()
    steps_executed = 0
    for k in range(len(zlist) - 1):
        zi, zf = zlist[k], zlist[k + 1]
        pc2r.printlog(f"=== slice z = {zi:.3f} -> {zf:.3f} ===", sim.logfile)
        sim.read_density(zi)
        srcfile = f"{inputs}/sources/{zi:.3f}-sources.hdf5"
        srcpos, normflux = sim.read_sources(srcfile)
        dt = sim.set_timestep(zi, zf, args.num_steps)
        for _ in range(args.num_steps):
            sim.cosmo_evolve(dt)
            sim.evolve3D(dt, normflux, srcpos)
            steps_executed += 1
        sim.write_output(zf)

    if steps_executed == 0:
        raise SystemExit("ERROR: zero timesteps executed "
                         "(num_slices/num_steps too small)")
    if np.array_equal(np.asarray(sim.xh), xh_initial):
        raise SystemExit(f"ERROR: ionized fraction unchanged after "
                         f"{steps_executed} steps; the run did not evolve")
    pc2r.printlog(f"EoR run complete ({steps_executed} steps).", sim.logfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
