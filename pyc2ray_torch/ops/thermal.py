"""Non-isothermal extension: photoheating-coupled temperature evolution.

PyTorch twin of pyc2ray_tpu/ops/thermal.py. The raytracer's heating
channel accumulates the per-atom photoheating rate H (erg/s per HI atom);
here it drives the gas temperature

    (3/2) k_B d(n_tot T)/dt = n_HI H  -  Lambda(T, n_e, n_HI, n_HII)

for a hydrogen-only gas (n_tot = n_H (1 + x) + the electron contribution
of the metal abundance abu_c, consistent with ops/chemistry.py).

Cooling Lambda (erg/s/cm^3), the standard minimal set (rate fits from
Cen 1992 / Black 1981, with the recombination and collisional-ionization
channels built from the same coefficients the ionization solver uses):

* case-B recombination:  0.75 k_B T alpha_B(T) n_e n_HII with
  alpha_B(T) = bh00 (T/1e4)^albpow                (ChemistryParams)
* collisional ionization: E_HI * colh0 sqrt(T) exp(-temph0/T) n_e n_HI
* Ly-alpha collisional excitation:
  7.50e-19 exp(-118348/T) / (1 + sqrt(T/1e5)) n_e n_HI
* bremsstrahlung: 1.42e-27 g_ff sqrt(T) n_e n_HII  (g_ff = 1.3)
* Compton scattering off the CMB (optional, z >= 0):
  5.65e-36 (1+z)^4 (T - T_cmb(z)) n_e

Integration: the timestep is operator-split from the ionization update
(the evolve loop converges x with T frozen, then T advances with the
converged rates). The ODE is stiff wherever the cooling time is short
against dt, so each of the ``nsub`` substeps uses exponential Euler:
Lambda is linearized at the current state with the exact Jacobian
dLambda/dT (one torch.func.jvp of cooling_rate: forward-mode AD, no hand
derivative) and the linear relaxation equation is solved exactly:

    dT/dt = r0 - b (T - T_n)   ->   T_{n+1} = T_n + r0 h phi1(-b h),
    phi1(x) = (e^x - 1)/x

L-stable, exact at equilibria and for linear cooling, reduces to explicit
Euler as b -> 0.

The JAX package has no hand kernel here, so this module is plain PyTorch
ops on the device of its tensors.
"""

from typing import NamedTuple

import torch

__all__ = ["ThermalParams", "cooling_rate", "update_temperature",
           "KB", "EV2ERG", "E_HI_ERG", "T_CMB0"]

KB = 1.380649e-16          # erg/K
EV2ERG = 1.602176634e-12
E_HI_ERG = 13.598 * EV2ERG
T_CMB0 = 2.725


class ThermalParams(NamedTuple):
    """Scalar parameters of the thermal solver.

    The first five mirror ChemistryParams (ops/chemistry.py) so both
    solvers use identical recombination / collisional coefficients."""
    bh00: float
    albpow: float
    colh0: float
    temph0: float
    abu_c: float
    gaunt_ff: float = 1.3
    compton: bool = True
    t_floor: float = 1.0
    t_cap: float = 1.0e9


def cooling_rate(T, ndens, xh, p: ThermalParams, z=0.0):
    """Volumetric cooling rate Lambda (erg/s/cm^3); elementwise."""
    ne = ndens * (xh + p.abu_c)
    nHII = ndens * xh
    nHI = ndens * (1.0 - xh)
    sqT = torch.sqrt(T)
    # recombination (case B), consistent with doric's brech0
    alphaB = p.bh00 * (T / 1.0e4) ** p.albpow
    L_rec = 0.75 * KB * T * alphaB * ne * nHII
    # collisional ionization, consistent with doric's acolh0
    L_coll = E_HI_ERG * p.colh0 * sqT * torch.exp(-p.temph0 / T) * ne * nHI
    # Ly-alpha excitation (Cen 1992)
    L_lya = 7.50e-19 * torch.exp(-118348.0 / T) \
        / (1.0 + torch.sqrt(T / 1.0e5)) * ne * nHI
    # free-free
    L_ff = 1.42e-27 * p.gaunt_ff * sqT * ne * nHII
    L = L_rec + L_coll + L_lya + L_ff
    if p.compton:
        tcmb = T_CMB0 * (1.0 + z)
        L = L + 5.65e-36 * (1.0 + z) ** 4 * (T - tcmb) * ne
    return L


def update_temperature(dt, temp, ndens, xh, heat_rate, p: ThermalParams,
                       z=0.0, nsub=16):
    """Advance T over dt with fixed-rate photoheating and T-dependent
    cooling, using ``nsub`` exponential-Euler substeps (see the module
    docstring: linearized Lambda via AD, exact relaxation solve).

    heat_rate: per-HI-atom photoheating rate (erg/s), as returned by the
    raytracer's heating channel. xh is held at its (time-averaged) value
    over the step. All tensors share temp's shape, dtype and device; dt is
    a float or a 0-dim tensor."""
    dt = torch.as_tensor(dt, dtype=temp.dtype, device=temp.device)
    heat_vol = ndens * (1.0 - xh) * heat_rate          # erg/s/cm^3
    ntot = ndens * (1.0 + xh + p.abu_c)
    inv_heat_capacity = 1.0 / (1.5 * KB * ntot)
    h = dt / nsub

    def lam_fn(T):
        return cooling_rate(T, ndens, xh, p, z)

    T = temp
    one = torch.ones_like(T)
    for _ in range(nsub):
        lam, dlam = torch.func.jvp(lam_fn, (T,), (one,))
        r0 = (heat_vol - lam) * inv_heat_capacity      # rhs at T
        b = dlam * inv_heat_capacity                   # -d(rhs)/dT
        x = b * h
        # phi1(-x) = (1 - e^{-x}) / x, -> 1 as x -> 0
        phi = torch.where(torch.abs(x) > 1e-8,
                          -torch.expm1(-x) / torch.where(x == 0.0, one, x),
                          one)
        T = torch.clamp(T + r0 * h * phi, p.t_floor, p.t_cap)
    return T
