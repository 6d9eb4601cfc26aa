"""Visual-comparison walkthrough for the physics examples, on the port.

The counterpart of examples/make_plots.py: it re-runs small
configurations of the Stromgren and shadow tests inline (the flat engine
in float64 and evolve3D) and renders the reference notebooks' three
figures with the port's plot helpers (pyc2ray_torch.visualization):
ifront_radius.png, ifront_slices.png and shadow.png. matplotlib (Agg) is
imported inside ``main``; the GPU machine has none, so this driver runs
where matplotlib is installed (``--device cpu`` there if it has no card).

    python -m pyc2ray_torch.examples.make_plots [-N 48] [--steps 12]
        [-o plots] [--device cuda|cpu] [--workdir DIR]
"""

import sys

import numpy as np
import torch

from ._common import EXAMPLES, add_port_arguments, driver_parser, setup


def chem_params():
    from ..ops.chemistry import ChemistryParams
    return ChemistryParams(bh00=2.59e-13, albpow=0.0,
                           colh0=1.3e-8 * 0.83 / (13.598 ** 2),
                           temph0=13.598 / 8.617e-05, abu_c=0.0)


def grey_flat(N, device):
    from ..ops.raytrace import RaytraceConfig, Raytracer
    cfg = RaytraceConfig(N=N, R_max_LLS=1e9, sig=6.30e-18, batch_size=1,
                         dtype=torch.float64, grey_analytic=True)
    return Raytracer(cfg, device=device)


def run_stromgren(N, steps, device, t_end_trec=1.5):
    """Single grey source in a uniform medium; returns (t, r_front,
    analytic, R_S, final xh cube)."""
    from ..evolve import evolve3D
    from ..utils.sourceutils import format_sources
    dr = 2.0e21
    nH = 1.0e-3
    alphaB = 2.59e-13
    t_rec = 1.0 / (alphaB * nH)
    ndot = 1.0e48
    R_S = (3 * ndot / (4 * np.pi * alphaB * nH ** 2)) ** (1 / 3)
    rt = grey_flat(N, device)
    chem = chem_params()
    c = N // 2
    src_pos = np.array([[c], [c], [c]], dtype=np.int64) + 1
    src_flux = np.array([1.0])
    ndens = np.full(N ** 3, nH)
    temp = np.full(N ** 3, 1e4)
    xh = np.full(N ** 3, 1.2e-3)
    dt = t_end_trec * t_rec / steps
    ts, rads, refs = [], [], []
    t = 0.0
    pos, flux = format_sources(src_pos, src_flux)
    for _ in range(steps):
        xh, phi = evolve3D(dt, dr, flux, pos, rt, chem, temp, ndens, xh,
                           quiet=True)
        t += dt
        vol_ion = float((xh.reshape(N, N, N) > 0.5).sum()) * dr ** 3
        r_front = (3 * vol_ion / (4 * np.pi)) ** (1 / 3)
        ts.append(t / t_rec)
        rads.append(r_front / R_S)
        refs.append((1.0 - np.exp(-t / t_rec)) ** (1 / 3))
    return np.array(ts), np.array(rads), np.array(refs), R_S / dr, \
        xh.reshape(N, N, N)


def run_shadow(N, device, steps=5):
    """Central source + dense clump (the shadow_test configuration);
    returns the final xh slice through the clump axis, the source and the
    clump centre."""
    from ..evolve import evolve3D
    dr = 2.0e21
    nH = 2.0e-4
    rt = grey_flat(N, device)
    chem = chem_params()
    c = N // 2
    nd3 = np.full((N, N, N), nH)
    cl = (N // 2 + N // 8, c, c)
    ii, jj, kk = np.indices((N, N, N))
    rcl2 = (ii - cl[0]) ** 2 + (jj - cl[1]) ** 2 + (kk - cl[2]) ** 2
    nd3[rcl2 <= (N // 16) ** 2] = 500.0 * nH
    ndens = nd3.reshape(-1)
    temp = np.full(N ** 3, 1e4)
    xh = np.full(N ** 3, 1.2e-3)
    pos = np.array([[c, c, c]], dtype=np.int32)
    flux = np.array([500.0])
    for _ in range(steps):
        xh, phi = evolve3D(5e14 / steps, dr, flux, pos, rt, chem, temp,
                           ndens, xh, quiet=True)
    return xh.reshape(N, N, N)[:, :, c], pos[0], cl


def build_parser():
    parser = driver_parser(__doc__)
    parser.add_argument("-N", type=int, default=48)
    parser.add_argument("--steps", type=int, default=12)
    parser.add_argument("-o", default="plots")
    add_port_arguments(parser, EXAMPLES, "the figures (under -o)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, workdir = setup(args)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..visualization.common import xfrac_plot

    out = workdir / args.o
    out.mkdir(parents=True, exist_ok=True)

    ts, rads, refs, rs_cells, xh3 = run_stromgren(args.N, args.steps,
                                                  device)

    fig, ax = plt.subplots(figsize=(5.5, 4))
    ax.plot(ts, refs, "k-", label=r"analytic $(1-e^{-t/t_{rec}})^{1/3}$")
    ax.plot(ts, rads, "o", ms=4, label="pyc2ray-torch I-front")
    ax.set_xlabel(r"$t / t_{rec}$")
    ax.set_ylabel(r"$r_{front} / R_S$")
    ax.set_title("Stromgren I-front expansion (reference test1_Ifront)")
    ax.legend()
    fig.tight_layout()
    p1 = out / "ifront_radius.png"
    fig.savefig(p1, dpi=130)
    err = np.abs(rads - refs).max()
    print(f"{p1}  (max |r - analytic| = {err:.3f} R_S)")

    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    c = args.N // 2
    im = xfrac_plot(xh3[:, :, c], axes[0])
    fig.colorbar(im, ax=axes[0])
    axes[1].contour(xh3[:, :, c], levels=[0.5], colors="w")
    axes[1].imshow(xh3[:, :, c], origin="lower", cmap="magma")
    circ = plt.Circle((c, c), rs_cells, fill=False, color="cyan", ls="--")
    axes[1].add_patch(circ)
    axes[1].set_title("xh slice + $R_S$ (dashed)")
    fig.tight_layout()
    p2 = out / "ifront_slices.png"
    fig.savefig(p2, dpi=130)
    print(p2)

    sl, spos, cl = run_shadow(args.N, device)
    fig, ax = plt.subplots(figsize=(5.5, 4.5))
    im = xfrac_plot(sl, ax)
    ax.plot(spos[1], spos[0], "w*", ms=12, label="source")
    ax.plot(cl[1], cl[0], "co", ms=8, mfc="none", label="dense clump")
    ax.set_title("Shadowing (reference test4_shadow)")
    ax.legend(loc="lower right")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    p3 = out / "shadow.png"
    fig.savefig(p3, dpi=130)
    print(p3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
