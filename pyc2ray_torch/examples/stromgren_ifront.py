"""Stromgren-sphere I-front expansion test on the port.

The counterpart of examples/stromgren_ifront/run_test.py (the reference's
test/paper_tests/test1_Ifront): a single source in a uniform medium; the
ionization-front radius is compared against the analytic solution
r(t) = R_S (1 - exp(-t/t_rec))^(1/3) at every output time, on the flat
engine in float64 (on the card the kernel loop of csrc/flat_sweep.cu) and
evolve3D, whose chemistry pass is the ``chemistry_pass`` kernel on the
card.

    python -m pyc2ray_torch.examples.stromgren_ifront [-N 64] [--steps 20]
        [--device cuda|cpu]
"""

import sys

import numpy as np
import torch

from ._common import add_port_arguments, driver_parser, setup


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=64)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--t_end_trec", type=float, default=2.0,
                        help="end time in units of the recombination time")
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
    nH = 1.0e-3
    temp_val = 1.0e4
    alphaB = 2.59e-13
    t_rec = 1.0 / (alphaB * nH)
    R_S_cells = N / 4.0
    R_S = R_S_cells * dr
    ndot = (4.0 * np.pi / 3.0) * alphaB * nH ** 2 * R_S ** 3

    chem = ChemistryParams(bh00=alphaB, albpow=-0.7,
                           colh0=1.3e-8 * 0.83 / 13.598 ** 2,
                           temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
    cfg = RaytraceConfig(N=N, R_max_LLS=1e9, sig=6.30e-18, batch_size=1,
                         dtype=torch.float64, grey_analytic=True)
    rt = Raytracer(cfg, device=device)

    ndens = nH * np.ones((N, N, N))
    temp = temp_val * np.ones((N, N, N))
    xh = 1.2e-3 * np.ones((N, N, N))
    src_pos = np.array([[N // 2, N // 2, N // 2]])
    flux = np.array([ndot / 1e48])

    t_end = args.t_end_trec * t_rec
    dt = t_end / args.steps
    print(f"N={N}, R_S={R_S_cells:.1f} cells, t_rec={t_rec:.3e} s, "
          f"Ndot={ndot:.3e} /s")
    print(f"{'t/trec':>8} {'r_num':>8} {'r_ana':>8} {'err %':>7}")

    max_err = 0.0
    for i in range(args.steps):
        xh, phi = evolve3D(dt, dr, flux, src_pos, rt, chem, temp, ndens, xh,
                           convergence_fraction=1e-4, quiet=True)
        t = (i + 1) * dt
        V_ion = xh.sum() * dr ** 3
        r_num = (3.0 * V_ion / (4.0 * np.pi)) ** (1.0 / 3.0) / dr
        r_ana = R_S_cells * (1.0 - np.exp(-t / t_rec)) ** (1.0 / 3.0)
        err = abs(r_num - r_ana) / r_ana * 100
        max_err = max(max_err, err)
        print(f"{t/t_rec:8.3f} {r_num:8.3f} {r_ana:8.3f} {err:7.3f}")

    print(f"\nMax I-front radius error: {max_err:.3f} %")
    ok = max_err < 5.0
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
