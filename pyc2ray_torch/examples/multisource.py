"""Multi-source test on the port: many random sources on a uniform grid;
checks the superposition of Gamma against per-source runs and prints
overlap statistics.

The counterpart of examples/multisource/run_test.py (the reference's
test/paper_tests/test3_multisource and the unit_tests_hackathon
multi-source cases), on the flat engine in float64. The source file is
written under ``--workdir`` (by default the temporary directory). The
tolerance follows the device: 1e-10 on the CPU, where the batched and the
per-source sums are bit-equal, 1e-6 on the card, whose scatter-adds run
in no fixed order.

    python -m pyc2ray_torch.examples.multisource [-N 64] [-numsrc 32]
        [-R 1e9] [--device cuda|cpu] [--workdir DIR]
"""

import sys
import tempfile

import numpy as np
import torch

from ._common import add_port_arguments, driver_parser, setup


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=64)
    parser.add_argument("-numsrc", type=int, default=32)
    parser.add_argument("-R", type=float, default=1e9)
    add_port_arguments(parser, tempfile.gettempdir(),
                       "its source file _multisource_test.txt")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, workdir = setup(args)
    from ..ops.raytrace import RaytraceConfig, Raytracer
    from ..utils.sourceutils import (generate_test_sourcefile,
                                     read_test_sources)

    N, ns = args.N, args.numsrc
    srcfile = str(workdir / "_multisource_test.txt")
    generate_test_sourcefile(srcfile, N, ns, 1e50, seed=100)
    src_pos_1idx, src_flux = read_test_sources(srcfile, ns)
    src_pos = (src_pos_1idx.T - 1).astype(np.int32)

    dr = 2.0e21
    ndens = 1e-3 * np.ones((N, N, N))
    xh = 1.2e-3 * np.ones((N, N, N))
    cfg = RaytraceConfig(N=N, R_max_LLS=args.R, sig=6.30e-18, batch_size=8,
                         dtype=torch.float64, grey_analytic=True)
    rt = Raytracer(cfg, device=device)

    phi_all = rt.trace(ndens, xh, src_pos, src_flux, dr).cpu().numpy()

    # superposition: sum of single-source runs must equal the batched run
    phi_sum = np.zeros_like(phi_all)
    for i in range(ns):
        phi_sum += rt.trace(ndens, xh, src_pos[i:i + 1], src_flux[i:i + 1],
                            dr).cpu().numpy()

    rel = np.abs(phi_all - phi_sum) / np.maximum(phi_sum, 1e-300)
    print(f"{ns} sources on {N}^3; max superposition error: {rel.max():.3e}")
    print(f"Gamma min/mean/max: {phi_all.min():.3e} {phi_all.mean():.3e} "
          f"{phi_all.max():.3e}")
    tol = 1e-10 if device.type == "cpu" else 1e-6
    ok = rel.max() < tol
    print(f"tolerance {tol:.0e} ({device.type} backend)")
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
