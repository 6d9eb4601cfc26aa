"""Timestep evolution: the raytrace/chemistry convergence loop.

PyTorch twin of pyc2ray_tpu/evolve.py::evolve3D on the hydrogen-only,
isothermal path (reference: pyc2ray/evolve.py:38-245). Iterate (raytrace
-> chemistry -> global convergence test) until the time-averaged
ionization field stops changing. All grid state lives on the raytracer's
device for the duration of the loop; only the scalar convergence metrics
come back to the host each iteration.
"""

import time

import numpy as np
import torch

from .constants import S_STAR_REF
from .evolve_loop import IterationResult, force, run_convergence_loop
from .ops.chemistry import ChemistryParams, global_pass
from .utils.logutils import printlog

__all__ = ["evolve3D"]


def _absorbed_rate(phi_ion, ndens, xh_av):
    """sum(Gamma * nHI), the absorbed photon rate WITHOUT the dr^3 volume
    factor (inverse of the photon-conserving division, raytracing.f90:531).
    The caller applies dr^3 in host float64: dr^3 ~ 1e62 cm^3 overflows
    float32."""
    nhi = ndens * (1.0 - xh_av)
    return (phi_ion.reshape(-1) * nhi.reshape(-1)).to(torch.float32).sum()


def evolve3D(dt, dr, src_flux, src_pos, raytracer,
             chem: ChemistryParams, temp, ndens, xh,
             convergence_fraction=1e-4, logfile=None, quiet=False,
             max_iterations=100, thermal=None):
    """Evolve the ionized fraction over one timestep until convergence.

    Parameters
    ----------
    dt : timestep in seconds
    dr : proper cell size in cm
    src_flux : (NumSrc,) normalized fluxes (units of S_star)
    src_pos : (NumSrc, 3) int 0-indexed grid positions
    raytracer : configured ops.raytrace_cheb.ChebRaytracer; the loop runs
        on its device and in its dtype
    chem : ChemistryParams
    temp, ndens, xh : (N,N,N) grids (K, cm^-3, ionized fraction)
    convergence_fraction : fraction of cells allowed to remain unconverged
        (reference evolve.py:127)
    thermal : must be None; the non-isothermal mode is not ported yet

    Returns
    -------
    xh_new : (N,N,N) numpy array, updated ionized fraction
    phi_ion : (N,N,N) numpy array, photoionization rates of the last
        iteration
    """
    if thermal is not None:
        raise NotImplementedError(
            "thermal evolution is not ported yet: it arrives with the "
            "heating/thermal slice of the port")
    cfg = raytracer.config
    N = cfg.N
    num_cells = N ** 3
    num_src = int(np.asarray(src_flux).shape[0])

    dtype, dev = cfg.dtype, raytracer.device

    def grid(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=dev).reshape(-1)

    temp_d, ndens_d, xh_d = grid(temp), grid(ndens), grid(xh)
    pos_b, flux_b = raytracer.prepare_sources(src_pos, src_flux)
    dt_d = torch.tensor(dt, dtype=dtype).to(dev)
    emitted = float(np.sum(np.asarray(src_flux, dtype=np.float64))) \
        * S_STAR_REF

    printlog("Calling evolve3D...", logfile, quiet)
    printlog(f"dr [Mpc]: {dr/3.086e24:.3e}", logfile, quiet)
    printlog(f"dt [years]: {dt/3.15576e7:.3e}", logfile, quiet)
    printlog(f"Running on {num_src:n} source(s), total normalized flux: "
             f"{float(np.sum(src_flux)):.2e}", logfile, quiet)

    state = {"xh_av": xh_d, "xh_intermed": xh_d, "phi_ion": None}

    def iteration(niter):
        t0 = time.time()
        xh_av_seen = state["xh_av"]
        phi_ion, _ = raytracer.trace_batches(ndens_d, xh_av_seen, pos_b,
                                             flux_b, dr)
        force(phi_ion)
        printlog(f"Raytracing took {time.time()-t0:.3f} s.", logfile, quiet)
        state["phi_ion"] = phi_ion

        t0 = time.time()
        xh_intermed, xh_av, conv_flag = global_pass(
            dt_d, ndens_d, temp_d, xh_d, xh_av_seen, phi_ion, chem)
        sum_xh1 = float(xh_intermed.sum())
        sum_xh0 = float((1.0 - xh_intermed).sum())
        absorbed = float(_absorbed_rate(phi_ion, ndens_d, xh_av_seen))
        conv_flag = int(conv_flag)
        printlog(f"Chemistry took {time.time()-t0:.3f} s.", logfile, quiet)
        state["xh_av"], state["xh_intermed"] = xh_av, xh_intermed
        absorbed_rate = absorbed * float(dr) ** 3
        loss = (1.0 - absorbed_rate / emitted) if emitted > 0 else 0.0
        return IterationResult(conv_flag, sum_xh1, sum_xh0,
                               photon_loss=loss)

    run_convergence_loop(iteration, num_cells, num_src,
                         convergence_fraction, max_iterations,
                         logfile, quiet)

    shape3 = (N, N, N)
    return (state["xh_intermed"].cpu().numpy().reshape(shape3),
            state["phi_ion"].cpu().numpy().reshape(shape3))
