"""Tutorial: standalone raytracing, on the port.

The counterpart of tutorials/raytracing.py (the reference's raytracing
tutorials): compute the photoionization-rate field of a few sources in a
clumpy medium and show the expected 1/r^2 x attenuation behavior along a
ray, then the photon budget. ``--engine cheb`` builds the Chebyshev-face
engine in its default mode (the sweep kernel K1 plus the rate pass on the
card), ``flat`` the table-exact octahedral engine with the grey analytic
rates (on the card the kernel loop of csrc/flat_sweep.cu); both in
float64.

    python -m pyc2ray_torch.tutorials.raytracing [--engine cheb|flat]
        [--device cuda|cpu]
"""

import sys

import numpy as np
import torch

from ..examples._common import add_port_arguments, driver_parser, setup


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("--engine", default="cheb", choices=["cheb", "flat"])
    add_port_arguments(parser, ".")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, _ = setup(args)
    from ..diagnostics import photon_budget

    N = 64
    dr = 2.0e21
    sig = 6.30e-18
    rng = np.random.RandomState(1)
    ndens = 10 ** rng.uniform(-3.5, -2.5, (N, N, N))
    xh = 1.2e-3 * np.ones((N, N, N))
    src_pos = np.array([[32, 32, 32], [10, 50, 20]])
    src_flux = np.array([10.0, 3.0])   # units of S_star = 1e48 photons/s

    if args.engine == "cheb":
        from ..ops.raytrace_box import grey_bins
        from ..ops.raytrace_cheb import ChebRaytracer
        rt = ChebRaytracer(N, 1e9, sig, grey_bins(), batch_size=2,
                           dtype=torch.float64, device=device)
    else:
        from ..ops.raytrace import RaytraceConfig, Raytracer
        cfg = RaytraceConfig(N=N, R_max_LLS=1e9, sig=sig, batch_size=2,
                             dtype=torch.float64, grey_analytic=True)
        rt = Raytracer(cfg, device=device)

    phi = rt.trace(ndens, xh, src_pos, src_flux, dr).cpu().numpy()
    print(f"Gamma field: min {phi.min():.3e}  mean {phi.mean():.3e}  "
          f"max {phi.max():.3e}  [1/s]")

    # profile along +x from the first source
    print("\n r [cells]   Gamma [1/s]   Gamma * 4 pi r^2 dr^2 "
          "(attenuated flux)")
    for r in range(1, 20):
        g = phi[32 + r, 32, 32]
        print(f"{r:10d}   {g:10.3e}   {g * 4 * np.pi * (r * dr) ** 2:10.3e}")

    budget = photon_budget(phi, ndens, xh, src_flux, dr)
    print(f"\nphoton budget: emitted {budget['emitted_per_s']:.3e}/s, "
          f"absorbed {budget['absorbed_per_s']:.3e}/s, "
          f"loss fraction {budget['loss_fraction']:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
