"""Shadowing test on the port: a dense clump between source and grid must
cast a sharp neutral shadow.

The counterpart of examples/shadow_test/run_test.py (the reference's
test/paper_tests/test4_shadow, whose dense sphere is built
programmatically, shadow.py:33-45), on the flat engine in float64 and
evolve3D. Checks: (1) cells behind the clump (in its geometric shadow
cone) stay neutral; (2) unshadowed cells at the same radius ionize.

    python -m pyc2ray_torch.examples.shadow_test [-N 64] [--device cuda|cpu]
"""

import sys

import numpy as np
import torch

from ._common import add_port_arguments, driver_parser, setup


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=64)
    add_port_arguments(parser, ".")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, _ = setup(args)
    from ..evolve import evolve3D
    from ..ops.chemistry import ChemistryParams
    from ..ops.raytrace import RaytraceConfig, Raytracer

    N = args.N
    dr = 2.0e21
    nH = 2.0e-4
    chem = ChemistryParams(bh00=2.59e-13, albpow=-0.7,
                           colh0=1.3e-8 * 0.83 / 13.598 ** 2,
                           temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
    cfg = RaytraceConfig(N=N, R_max_LLS=1e9, sig=6.30e-18, batch_size=1,
                         dtype=torch.float64, grey_analytic=True)
    rt = Raytracer(cfg, device=device)

    # uniform medium + dense spherical clump on the +x axis
    ndens = nH * np.ones((N, N, N))
    clump_center = np.array([N // 2 + N // 8, N // 2, N // 2])
    clump_r = N // 16
    ii = np.arange(N)
    DI, DJ, DK = np.meshgrid(ii - clump_center[0], ii - clump_center[1],
                             ii - clump_center[2], indexing="ij")
    clump = DI ** 2 + DJ ** 2 + DK ** 2 <= clump_r ** 2
    ndens[clump] = 500.0 * nH

    temp = 1e4 * np.ones((N, N, N))
    xh = 1.2e-3 * np.ones((N, N, N))
    src = np.array([[N // 2, N // 2, N // 2]])
    flux = np.array([5e50 / 1e48])

    t_evo = 5e14
    for _ in range(5):
        xh, phi = evolve3D(t_evo / 5, dr, flux, src, rt, chem, temp, ndens,
                           xh, convergence_fraction=1e-4, quiet=True)

    # deep-shadow probe: on-axis behind the clump; control: same distance +y
    probe_x = clump_center[0] + clump_r + N // 8
    shadow_val = xh[probe_x, N // 2, N // 2]
    d = probe_x - N // 2
    control_val = xh[N // 2, N // 2 + d, N // 2]
    print(f"xh behind clump   : {shadow_val:.3e}")
    print(f"xh control (no clump, same distance): {control_val:.3e}")
    ok = shadow_val < 0.1 and control_val > 0.9
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
