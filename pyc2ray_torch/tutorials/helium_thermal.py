"""Tutorial: helium (H+He) radiative transfer with photoheating, on the
port.

The counterpart of tutorials/helium_thermal.py. The reference declares
helium, multi-frequency and heating-coupled chemistry as TODO (reference
README.md:81-87); here they are one parameter file away. This walks the
low-level API in float64: the three-species HeRaytracer (the sweep kernel
K1 once per species on the card), evolve3D_he (the ``chemistry_pass_he``
kernel) and the thermal update. The model layer does the same from YAML
with ``Raytracing.engine: he``, ``Material.isothermal: 0`` and
``Photo.compute_heating_rates: 1``.

    python -m pyc2ray_torch.tutorials.helium_thermal [--device cuda|cpu]
"""

import sys

import numpy as np
import torch

from ..examples._common import add_port_arguments, driver_parser, setup


def build_parser():
    parser = driver_parser(__doc__)
    add_port_arguments(parser, ".")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, _ = setup(args)
    from ..constants import ev2fr
    from ..evolve import evolve3D_he
    from ..ops.chemistry import ChemistryParams
    from ..ops.chemistry_he import HeChemistryParams
    from ..ops.raytrace_he import HeRaytracer
    from ..ops.thermal import ThermalParams
    from ..radiation import BlackBodySource
    from ..radiation.helium import HE_EDGES_EV, make_spectral_bins_he

    N = 24
    ABU_HE = 0.074                       # He/H by number

    # --- three-band spectral bins over the HI / HeI / HeII edges --------
    bb = BlackBodySource(1e5, False, ev2fr * HE_EDGES_EV[0], 2.8)
    bins = make_spectral_bins_he(bb, panels_per_band=3, nodes=4)

    # --- engine + chemistry + thermal parameters ------------------------
    chem = ChemistryParams(bh00=2.59e-13, albpow=-0.7,
                           colh0=1.3e-8 * 0.83 / (13.598 ** 2),
                           temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
    phe = HeChemistryParams(chem=chem, abu_he=ABU_HE)
    thermal = ThermalParams(bh00=chem.bh00, albpow=chem.albpow,
                            colh0=chem.colh0, temph0=chem.temph0,
                            abu_c=chem.abu_c)
    rt = HeRaytracer(N, 1e9, bins, abu_he=ABU_HE, batch_size=1,
                     dtype=torch.float64, device=device, do_heating=True)

    # --- fields + one hard source ---------------------------------------
    nd = 1e-3 * np.ones((N, N, N))
    temp = 1e2 * np.ones((N, N, N))
    xh = 1e-3 * np.ones((N, N, N))
    y1 = 1e-3 * np.ones((N, N, N))       # xHeII
    y2 = np.zeros((N, N, N))             # xHeIII
    src = np.array([[N // 2] * 3])
    flux = np.array([30.0])              # units of S_star = 1e48 photons/s

    out = evolve3D_he(1e13, 2.0e21, flux, src, rt, phe, temp, nd,
                      xh, y1, y2, quiet=True, thermal=thermal, zred=9.0)
    xh_n, gH, y1_n, y2_n, gHe1, gHe2, temp_n = out

    c = N // 2

    def line(f):
        return np.asarray(f)[c, c, c:]

    print("radial profiles from the source (cell index along +z):")
    print("  xHII   :", np.array2string(line(xh_n)[:8], precision=3))
    print("  xHeII  :", np.array2string(line(y1_n)[:8], precision=3))
    print("  xHeIII :", np.array2string(line(y2_n)[:8], precision=3))
    print("  T [K]  :", np.array2string(line(temp_n)[:8], precision=0))
    r_h = int(np.sum(line(xh_n) > 0.5))
    r_he3 = int(np.sum(line(y2_n) > 0.5))
    print(f"HII front at ~{r_h} cells; HeIII front at ~{r_he3} cells "
          f"(HeIII ionized only near the hard source)")
    print(f"temperature raised from 100 K to {float(line(temp_n)[0]):.0f} K "
          f"at the source by photoheating")
    if not (r_h > 0 and np.asarray(temp_n).max() > 1e3):
        raise AssertionError("no HII front or no photoheating")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
