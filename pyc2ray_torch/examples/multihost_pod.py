"""Multi-process driver on the port: the distributed deployment pattern.

The counterpart of examples/multihost_pod/run_test.py (the analog of the
reference's MPI test, test/unit_tests_hackathon/4_multiple_sources_mpi/
run_test.py): every process runs this same program over torch.distributed
with a domain mesh (``--mode domain``) or a source-parallel mesh
(``--mode source``) of ranks, C2Ray_Test on that example's parameters.yml
(``engine: cheb``, float64, B = 4). In one process
``multihost.initialize()`` does nothing and the mesh has one rank; under
torchrun it joins the world from torchrun's environment (nccl when every
rank has a card of its own, gloo when ranks share one). Outputs are
written by the primary rank only.

    python -m pyc2ray_torch.examples.multihost_pod [-N 64] [--steps 2]
        [--numsrc 20] [--mode domain|source] [--device cuda|cpu]
    torchrun --nproc_per_node=K -m pyc2ray_torch.examples.multihost_pod
"""

import sys

import numpy as np

from ._common import (EXAMPLES, add_port_arguments, driver_parser,
                      load_params, setup)


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=64)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--numsrc", type=int, default=20)
    parser.add_argument("--mode", default="domain",
                        choices=["domain", "source"])
    add_port_arguments(parser, EXAMPLES / "multihost_pod",
                       "results/ (the log and the outputs)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    import pyc2ray_torch as pc2r
    from ..parallel import multihost
    from ..parallel.mesh import device_count, world

    # a no-op in one process; under torchrun it joins the world and makes
    # the rank's card the current device, which "cuda" then names
    multihost.initialize()
    device, workdir = setup(args)
    mesh = (multihost.global_domain_mesh(device=device)
            if args.mode == "domain"
            else multihost.global_source_mesh(device=device))
    if multihost.is_primary():
        print(f"{world()[1]} process(es), {device_count()} device(s), "
              f"mesh = {mesh.describe()}")

    N = args.N
    sim = pc2r.C2Ray_Test(load_params("multihost_pod", workdir / "results"),
                          N, mesh=mesh)
    sim.ndens = 1e-3 * np.ones((N, N, N))

    rng = np.random.RandomState(7)
    srcpos = rng.randint(1, N + 1, size=(3, args.numsrc)).astype(float)
    srcflux = rng.uniform(1.0, 10.0, args.numsrc)

    zreds = sim.generate_redshift_array(2, 1e6)
    dt = sim.set_timestep(zreds[0], zreds[1], args.steps)
    xh0 = sim.xh.mean()
    for _ in range(args.steps):
        sim.cosmo_evolve(dt)
        sim.evolve3D(dt, srcflux, srcpos)

    if sim.xh.mean() <= xh0:
        raise SystemExit("ERROR: field did not evolve")
    if multihost.is_primary():
        sim.write_output(sim.zred)
        print(f"OK: mean xHII {xh0:.3e} -> {sim.xh.mean():.3e} over "
              f"{args.steps} steps on the {args.mode} mesh")
    return 0


if __name__ == "__main__":
    sys.exit(main())
