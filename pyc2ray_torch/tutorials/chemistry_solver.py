"""Tutorial: the standalone chemistry solver, on the port.

The counterpart of tutorials/chemistry_solver.py (the reference's
tutorials/chemistry_solver.ipynb): evolve the ionized fraction of a
uniform medium under a fixed photoionization rate with ``hydrogenODE``
(float64; the ``chemistry_pass`` kernel on the card) and compare against
the analytic photoionization-equilibrium limit.

    python -m pyc2ray_torch.tutorials.chemistry_solver [--device cuda|cpu]
"""

import sys

import numpy as np

from ..examples._common import add_port_arguments, driver_parser, setup


def build_parser():
    parser = driver_parser(__doc__)
    add_port_arguments(parser, ".")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, _ = setup(args)
    from .. import hydrogenODE

    # A uniform box: hydrogen density, temperature, initial neutral state
    N = 32
    ndens = 1e-3 * np.ones((N, N, N))      # cm^-3
    temp = 1e4 * np.ones((N, N, N))        # K
    xh = 1.2e-3 * np.ones((N, N, N))       # initial ionized fraction

    # A photoionization rate typical of the ionized EoR IGM
    gamma = 3e-13 * np.ones((N, N, N))     # 1/s

    # Evolve in ten steps of 1 Myr
    dt = 3.156e13
    for step in range(10):
        # the pass-level convergence flag counts cells whose x_av moved
        # by >1e-3 (always true on the first steps of a big transition),
        # so lift the assert threshold for this demonstration
        xh = hydrogenODE(dt, ndens, temp, xh, gamma,
                         max_nonconverged_fraction=1.01, device=device)
        print(f"t = {(step + 1) * dt / 3.156e13:5.1f} Myr   "
              f"<x_HII> = {xh.mean():.6f}")

    # Analytic equilibrium: Gamma (1 - x) = alpha_B n_e x  (collisions tiny)
    alpha_B = 2.59e-13
    g, nH = 3e-13, 1e-3
    # solve g(1-x) = a nH x^2  ->  quadratic in x
    a = alpha_B * nH
    x_eq = (-g + np.sqrt(g * g + 4 * a * g)) / (2 * a)
    print(f"\nanalytic photoionization equilibrium: x_eq = {x_eq:.6f}")
    print(f"solver equilibrium:                   <x>  = {xh.mean():.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
