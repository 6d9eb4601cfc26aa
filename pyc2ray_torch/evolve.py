"""Timestep evolution: the raytrace/chemistry convergence loop.

PyTorch twin of pyc2ray_tpu/evolve.py::evolve3D on the hydrogen-only path
(reference: pyc2ray/evolve.py:38-245). Iterate (raytrace -> chemistry ->
global convergence test) until the time-averaged ionization field stops
changing; in the non-isothermal mode the temperature then advances over
the timestep with the converged photoheating rates. All grid state lives on
the raytracer's device for the duration of the loop; only the scalar
convergence metrics come back to the host, in one transfer per iteration.
"""

import time

import numpy as np
import torch

from .constants import S_STAR_REF
from .evolve_loop import IterationResult, force, run_convergence_loop
from .ops.chemistry import ChemistryParams, global_pass
from .utils.logutils import printlog

__all__ = ["evolve3D", "evolve3D_he", "prepare_for_engine"]


def _absorbed_rate(phi_ion, ndens, xh_av):
    """sum(Gamma * nHI), the absorbed photon rate WITHOUT the dr^3 volume
    factor (inverse of the photon-conserving division, raytracing.f90:531).
    The caller applies dr^3 in host float64: dr^3 ~ 1e62 cm^3 overflows
    float32."""
    nhi = ndens * (1.0 - xh_av)
    return (phi_ion.reshape(-1) * nhi.reshape(-1)).to(torch.float32).sum()


def _absorbed_rate_he(gh, ghe1, ghe2, ndens, xh_av, y1_av, y2_av, abu_he):
    """Three-species sum(Gamma_s * n_s) over HI, HeI, HeII, without the
    dr^3 factor (applied on the host in float64, see _absorbed_rate).
    ndens is the hydrogen density; n_He = abu_he * n_H."""
    def r(a):
        return a.reshape(-1).to(torch.float32)
    nhi = r(ndens) * (1.0 - r(xh_av))
    nhe = abu_he * r(ndens)
    nhe1 = nhe * (1.0 - r(y1_av) - r(y2_av))
    nhe2 = nhe * r(y1_av)
    return (r(gh) * nhi + r(ghe1) * nhe1 + r(ghe2) * nhe2).sum()


def _host_scalars(*scalars):
    """The 0-dim tensors ``scalars`` as Python floats, in one transfer from
    their device."""
    return torch.stack([s.to(torch.float64) for s in scalars]).tolist()


def prepare_for_engine(raytracer, src_pos, src_flux, dr, ndens_d):
    """Uniform source staging: fixed-radius engines take (pos, flux);
    flux-bucketing engines (ops/adaptive.py) also need the cell size and the
    mean density for the Stromgren-radius policy."""
    if getattr(raytracer, "needs_flux_bucketing", False):
        avg_dens = float(ndens_d.mean())
        return raytracer.prepare_sources(src_pos, src_flux, dr=float(dr),
                                         avg_dens=avg_dens)
    return raytracer.prepare_sources(src_pos, src_flux)


def evolve3D(dt, dr, src_flux, src_pos, raytracer,
             chem: ChemistryParams, temp, ndens, xh,
             convergence_fraction=1e-4, logfile=None, quiet=False,
             max_iterations=100, thermal=None, zred=0.0,
             loss_fraction=None):
    """Evolve the ionized fraction over one timestep until convergence.

    Parameters
    ----------
    dt : timestep in seconds
    dr : proper cell size in cm
    src_flux : (NumSrc,) normalized fluxes (units of S_star)
    src_pos : (NumSrc, 3) int 0-indexed grid positions
    raytracer : configured ops.raytrace_cheb.ChebRaytracer or
        ops.adaptive.AdaptiveRaytracer; the loop runs on its device and in
        its dtype
    chem : ChemistryParams
    temp, ndens, xh : (N,N,N) grids (K, cm^-3, ionized fraction)
    convergence_fraction : fraction of cells allowed to remain unconverged
        (reference evolve.py:127)
    thermal : ops.thermal.ThermalParams, optional
        Non-isothermal mode: after the ionization convergence loop the
        temperature advances over dt using the converged photoheating
        rates (requires a raytracer built with do_heating). zred enters
        the Compton cooling term.
    loss_fraction : float, optional
        Raytracing.loss_fraction: a per-iteration photon loss above it
        logs a warning.

    Returns
    -------
    xh_new : (N,N,N) numpy array, updated ionized fraction
    phi_ion : (N,N,N) numpy array, photoionization rates of the last
        iteration
    temp_new : (N,N,N) numpy array, only when ``thermal`` is given
    """
    cfg = raytracer.config
    N = cfg.N
    num_cells = N ** 3
    num_src = int(np.asarray(src_flux).shape[0])

    dtype, dev = cfg.dtype, raytracer.device

    def grid(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).reshape(-1)

    temp_d, ndens_d, xh_d = grid(temp), grid(ndens), grid(xh)
    pos_b, flux_b = prepare_for_engine(raytracer, src_pos, src_flux, dr,
                                       ndens_d)
    dt_d = torch.tensor(dt, dtype=dtype).to(dev)
    emitted = float(np.sum(np.asarray(src_flux, dtype=np.float64))) \
        * S_STAR_REF

    printlog("Calling evolve3D...", logfile, quiet)
    printlog(f"dr [Mpc]: {dr/3.086e24:.3e}", logfile, quiet)
    printlog(f"dt [years]: {dt/3.15576e7:.3e}", logfile, quiet)
    printlog(f"Running on {num_src:n} source(s), total normalized flux: "
             f"{float(np.sum(src_flux)):.2e}", logfile, quiet)
    if getattr(raytracer, "needs_flux_bucketing", False):
        printlog(raytracer.describe_buckets(pos_b), logfile, quiet)

    if thermal is not None and not cfg.do_heating:
        raise ValueError("thermal evolution requires a raytracer with "
                         "do_heating=True (Photo.compute_heating_rates)")

    state = {"xh_av": xh_d, "xh_intermed": xh_d,
             "phi_ion": None, "phi_heat": None}

    def iteration(niter):
        t0 = time.time()
        xh_av_seen = state["xh_av"]
        phi_ion, phi_heat = raytracer.trace_batches(
            ndens_d, xh_av_seen, pos_b, flux_b, dr)
        force(phi_ion)
        printlog(f"Raytracing took {time.time()-t0:.3f} s.", logfile, quiet)
        state["phi_ion"], state["phi_heat"] = phi_ion, phi_heat

        t0 = time.time()
        xh_intermed, xh_av, conv_flag = global_pass(
            dt_d, ndens_d, temp_d, xh_d, xh_av_seen, phi_ion, chem)
        conv_flag, sum_xh1, sum_xh0, absorbed = _host_scalars(
            conv_flag, xh_intermed.sum(), (1.0 - xh_intermed).sum(),
            _absorbed_rate(phi_ion, ndens_d, xh_av_seen))
        printlog(f"Chemistry took {time.time()-t0:.3f} s.", logfile, quiet)
        state["xh_av"], state["xh_intermed"] = xh_av, xh_intermed
        absorbed_rate = absorbed * float(dr) ** 3
        loss = (1.0 - absorbed_rate / emitted) if emitted > 0 else 0.0
        return IterationResult(int(conv_flag), sum_xh1, sum_xh0,
                               photon_loss=loss)

    run_convergence_loop(iteration, num_cells, num_src,
                         convergence_fraction, max_iterations,
                         logfile, quiet, loss_fraction=loss_fraction)

    shape3 = (N, N, N)
    out = (state["xh_intermed"].cpu().numpy().reshape(shape3),
           state["phi_ion"].cpu().numpy().reshape(shape3))
    if thermal is not None:
        from .ops.thermal import update_temperature
        t0 = time.time()
        temp_new = update_temperature(dt_d, temp_d, ndens_d, state["xh_av"],
                                      state["phi_heat"], thermal,
                                      z=float(zred))
        temp_np = temp_new.cpu().numpy().reshape(shape3)
        printlog(f"Thermal update took {time.time()-t0:.3f} s "
                 f"(T range {temp_np.min():.1f}..{temp_np.max():.1f} K).",
                 logfile, quiet)
        out = out + (temp_np,)
    return out


def evolve3D_he(dt, dr, src_flux, src_pos, raytracer, phe,
                temp, ndens, xh, y1, y2, convergence_fraction=1e-4,
                logfile=None, quiet=False, max_iterations=100,
                thermal=None, zred=0.0, loss_fraction=None):
    """Coupled H+He evolve loop (beyond the reference, where helium is
    TODO, README.md:81-87).

    The convergence structure of evolve3D, with the three-species
    ops.raytrace_he.HeRaytracer and the coupled
    ops.chemistry_he.global_pass_he. Convergence is tested on the hydrogen
    field (the reference criterion); helium shares the iteration through
    the electron density. The scalars of an iteration come to the host in
    one transfer.

    With ``thermal`` (requires HeRaytracer(do_heating=True)) the
    temperature advances after convergence with the total three-species
    photoheating (scaled by the secondary-ionization heat fraction where
    secondary ionizations are on), and temp_new is appended.

    Returns (xh, phi_HI, y1, y2, phi_HeI, phi_HeII[, temp_new]), (N,N,N)
    numpy arrays.
    """
    from .ops.chemistry_he import (global_pass_he, secondary_enabled,
                                   thermal_heat_rate)

    N = raytracer.N
    num_cells = N ** 3
    num_src = int(np.asarray(src_flux).shape[0])
    dtype, dev = raytracer.dtype, raytracer.device
    sh3 = (N, N, N)

    def grid(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).reshape(sh3)

    temp_d, ndens_d = grid(temp), grid(ndens)
    xh_d, y1_d, y2_d = grid(xh), grid(y1), grid(y2)
    pos_b, flux_b = raytracer.prepare_sources(src_pos, src_flux)
    dt_d = torch.tensor(dt, dtype=dtype).to(dev)
    emitted = float(np.sum(np.asarray(src_flux, dtype=np.float64))) \
        * S_STAR_REF

    printlog(f"Calling evolve3D_he (H+He) on {num_src:n} source(s)...",
             logfile, quiet)
    if thermal is not None and not raytracer.do_heating:
        raise ValueError("thermal evolution requires HeRaytracer("
                         "do_heating=True) (Photo.compute_heating_rates)")
    secondary = secondary_enabled(phe, raytracer.do_heating)
    state = {"xh_av": xh_d, "y1_av": y1_d, "y2_av": y2_d,
             "xh_int": xh_d, "y1_int": y1_d, "y2_int": y2_d,
             "g": (None,) * 3}

    def iteration(niter):
        t0 = time.time()
        xh_av_seen = state["xh_av"]
        g = raytracer.trace_batches(ndens_d, xh_av_seen, state["y1_av"],
                                    state["y2_av"], pos_b, flux_b, dr)
        force(g[0])
        printlog(f"Raytracing (3 species) took {time.time()-t0:.3f} s.",
                 logfile, quiet)
        state["g"] = g
        t0 = time.time()
        (xh_int, xh_av, y1_int, y1_av, y2_int, y2_av,
         conv_flag) = global_pass_he(
            dt_d, ndens_d, temp_d, xh_d, xh_av_seen,
            y1_d, state["y1_av"], y2_d, state["y2_av"],
            g[0], g[1], g[2], phe,
            heat=g[3] if secondary else None,
            recombination_photons=bool(phe.recombination_photons))
        conv_flag, sum1, sum0, absorbed = _host_scalars(
            conv_flag, xh_int.sum(), (1.0 - xh_int).sum(),
            _absorbed_rate_he(g[0], g[1], g[2], ndens_d, xh_av_seen,
                              state["y1_av"], state["y2_av"], phe.abu_he))
        printlog(f"Chemistry (H+He) took {time.time()-t0:.3f} s.",
                 logfile, quiet)
        state.update(xh_av=xh_av, y1_av=y1_av, y2_av=y2_av,
                     xh_int=xh_int, y1_int=y1_int, y2_int=y2_int)
        absorbed_rate = absorbed * float(dr) ** 3
        loss = (1.0 - absorbed_rate / emitted) if emitted > 0 else None
        return IterationResult(int(conv_flag), sum1, sum0,
                               photon_loss=loss)

    run_convergence_loop(iteration, num_cells, num_src,
                         convergence_fraction, max_iterations,
                         logfile, quiet, loss_fraction=loss_fraction)

    g = state["g"]

    def host(t):
        return t.cpu().numpy().reshape(sh3)
    out = (host(state["xh_int"]), host(g[0]), host(state["y1_int"]),
           host(state["y2_int"]), host(g[1]), host(g[2]))
    if thermal is not None:
        from .ops.thermal import update_temperature
        heat_rate = thermal_heat_rate(phe, g[3].reshape(-1),
                                      state["xh_av"].reshape(-1), secondary)
        temp_new = update_temperature(
            dt_d, temp_d.reshape(-1), ndens_d.reshape(-1),
            state["xh_av"].reshape(-1), heat_rate, thermal, z=float(zred))
        out = out + (host(temp_new),)
    return out
