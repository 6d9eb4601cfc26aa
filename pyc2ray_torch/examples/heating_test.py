"""Photoheating test on the port (beyond the reference test suite).

The counterpart of examples/heating_test/run_test.py: a single black-body
source ionizes AND heats an initially cold uniform medium
(``Material.isothermal: false``) through C2Ray_Test on
examples/single_source_test/parameters.yml with ``NumTau: 500``, the
heating rates on, ``temp0: 1e2`` and ``engine: cheb``. The model layer
builds the engine with fuse_fold: on the card one trace loop per raytrace
iteration, K3h (the sweep with the heating output), the box extract and
accumulate, the chemistry pass and the thermal update. Checks:

* the temperature profile T(r) declines monotonically (binned) away
  from the source,
* the ionized core is photoheated to ~1e4 K scale while distant gas
  stays near the initial temperature,
* temperature and ionization fronts track each other.

    python -m pyc2ray_torch.examples.heating_test [-N 48] [--steps 6]
        [--device cuda|cpu] [--workdir DIR]
"""

import sys

import numpy as np

from ._common import add_port_arguments, driver_parser, load_params, setup


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=48)
    parser.add_argument("--steps", type=int, default=6)
    add_port_arguments(parser, ".", "results/ (the log)")
    return parser


def heating_params(results):
    """The parameters of the run as a dict: those of
    examples/single_source_test with the changes run_test.py:34-40 makes
    to its text."""
    params = load_params("single_source_test", results)
    params["Photo"]["NumTau"] = 500
    params["Photo"]["compute_heating_rates"] = 1
    params["Material"]["temp0"] = 1e2
    params["Material"] = {"isothermal": False, **params["Material"]}
    params["Raytracing"]["engine"] = "cheb"
    return params


def profiles(temp, xh, N):
    """Radially binned <T> and <x> about the grid's centre, one bin per
    cell of radius."""
    c = N // 2
    i, j, k = np.indices((N, N, N))
    r = np.sqrt((i - c) ** 2 + (j - c) ** 2 + (k - c) ** 2)
    rb = np.arange(0, N // 2)
    t_prof = np.array([temp[(r >= a) & (r < a + 1)].mean() for a in rb])
    x_prof = np.array([xh[(r >= a) & (r < a + 1)].mean() for a in rb])
    return t_prof, x_prof


def heating_checks(temp, xh, N):
    """The five checks of run_test.py:79-94 on the final fields, as
    {name: bool} in its order."""
    t_prof, x_prof = profiles(temp, xh, N)
    core, edge = t_prof[1], t_prof[-1]
    # T peaks near the I-front (spectral hardening deposits more energy per
    # ionization deeper in), then falls steeply: monotone beyond the front.
    r_front = int(np.argmin(np.abs(x_prof - 0.5)))
    post = t_prof[r_front:]
    # ionized gas is hot; a preheated partially-ionized shell beyond the
    # front (hard photons) is expected and physical
    return {
        "core photoheated above 5e3 K": bool(core > 5e3),
        "distant gas within 3x of initial 100 K": bool(edge < 300.0),
        "T profile monotone non-increasing beyond the I-front (tol 1%)":
            bool(np.all(np.diff(post) <= 0.01 * post[:-1] + 1e-9)),
        "T peak sits at/inside the I-front":
            int(np.argmax(t_prof)) <= r_front + 1,
        "ionized gas (x>0.9) is photoheated (median T > 5e3 K)":
            bool(float(np.median(temp[xh > 0.9])) > 5e3),
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, workdir = setup(args)
    import pyc2ray_torch as pc2r

    N = args.N
    sim = pc2r.C2Ray_Test(heating_params(workdir / "results"), N,
                          device=device)
    sim.ndens = 1e-3 * np.ones((N, N, N))
    srcpos = np.array([[N // 2 + 1], [N // 2 + 1], [N // 2 + 1]],
                      dtype=float)
    srcflux = np.array([50.0])

    zreds = sim.generate_redshift_array(2, 2e6)
    dt = sim.set_timestep(zreds[0], zreds[1], args.steps)
    for _ in range(args.steps):
        sim.evolve3D(dt, srcflux, srcpos)

    temp = np.asarray(sim.temp).reshape(N, N, N)
    xh = np.asarray(sim.xh).reshape(N, N, N)
    t_prof, x_prof = profiles(temp, xh, N)

    print("\n r [cells]   <T> [K]      <x>")
    for a in range(0, N // 2, 3):
        print(f"  {a:3d}      {t_prof[a]:10.1f}  {x_prof[a]:.3e}")

    checks = heating_checks(temp, xh, N)
    for name, cond in checks.items():
        print(f"{name:55s} {'PASSED' if cond else 'FAILED'}")
    ok = all(checks.values())
    print("\nALL TESTS PASSED" if ok else "\nSOME TESTS FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
