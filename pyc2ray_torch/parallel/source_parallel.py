"""Multi-GPU source-parallel raytracing + cell-parallel chemistry.

PyTorch twin of pyc2ray_tpu/parallel/source_parallel.py, which replaces the
reference's MPI path (pyc2ray/evolve.py:249-498):

=======================  ==============================================
reference (mpi4py)       this module (torch.distributed)
=======================  ==============================================
source-range split       batches of sources split over the mesh's ranks
Reduce(SUM)+Bcast Gamma  one all-reduce of Gamma (and heat)
chemistry on rank 0      chemistry on a slice of the cells, every rank,
                         then an all-gather of x and <x>
xh/flag Bcasts           the all-gather, and one all-reduce of the
                         convergence scalars
=======================  ==============================================

Each rank traces exactly the batches the JAX device of the same index
sweeps (the same zero-flux padding, the adaptive engine's bucket-major
lockstep). A rank's partial Gamma sums its own batches in order and the
all-reduce adds the partials: the same terms as one device, in another
association, so the sums agree to rounding, not bit for bit; a world of
one rank is bit-equal to the single-device path.
"""

import time

import numpy as np
import torch

from ..constants import S_STAR_REF
from ..evolve import _absorbed_rate, _absorbed_rate_he
from ..evolve_loop import IterationResult, run_convergence_loop
from ..ops.chemistry import ChemistryParams, global_pass
from ..utils.logutils import printlog

__all__ = ["trace_sharded", "global_pass_sharded", "evolve3D_sharded",
           "evolve3D_he_sharded", "prepare_sources_sharded",
           "make_sharded_step", "make_sharded_step_he"]


def _pad_batches_to_devices(pos, flx, n_dev):
    """Pad (nb, B, ...) batch arrays to a multiple of n_dev batches with
    batches that repeat the last positions at zero flux (swept, adding
    nothing): the remainder handling of the reference's per-rank split
    (evolve.py:361-371) without giving the remainder to the last rank."""
    nb = pos.shape[0]
    nbp = -(-nb // n_dev) * n_dev
    if nbp > nb:
        pos = np.concatenate(
            [pos, np.repeat(pos[-1:], nbp - nb, axis=0)], axis=0)
        flx = np.concatenate(
            [flx, np.zeros((nbp - nb, flx.shape[1]), flx.dtype)], axis=0)
    return pos, flx


def _batches(src_pos, src_flux, B):
    """The catalog as (nb, B, 3) / (nb, B) numpy batches, zero-flux
    sources at the origin in the last one (the engines' prepare_sources)."""
    ns = np.asarray(src_flux).shape[0]
    nb = -(-ns // B)
    pos = np.zeros((nb * B, 3), dtype=np.int64)
    flx = np.zeros((nb * B,), dtype=np.float64)
    pos[:ns] = np.asarray(src_pos, dtype=np.int64)
    flx[:ns] = np.asarray(src_flux, dtype=np.float64)
    return pos.reshape(nb, B, 3), flx.reshape(nb, B)


def _local(pos, flx, mesh, device, dtype):
    """This rank's contiguous block of the (n_dev * k) batches (the JAX
    shard of the leading axis): positions as an int64 CPU tensor, fluxes
    on ``device`` in ``dtype``."""
    k = pos.shape[0] // mesh.size
    sl = slice(mesh.index * k, (mesh.index + 1) * k)
    return (torch.from_numpy(np.ascontiguousarray(pos[sl])),
            torch.from_numpy(np.ascontiguousarray(flx[sl])).to(device,
                                                                dtype))


def _prepare_adaptive_sharded(raytracer, mesh, src_pos, src_flux, dr,
                              avg_dens):
    """Bucket-major staging for the adaptive engine.

    Sources are bucketed by the Stromgren policy exactly as on one device;
    then every bucket's batches are padded to a whole number per rank, so
    all ranks sweep the same radius bucket in lockstep with that bucket's
    batches split between them (per-rank batches never mix radii). An empty
    bucket stages one zero-flux batch per rank, so the structure does not
    change with the bucket occupancy."""
    if dr is None or avg_dens is None:
        raise ValueError(
            "adaptive engine staging needs dr and avg_dens (the mean of "
            "the traced density grid) for the Stromgren bucketing policy")
    src_pos = np.asarray(src_pos)
    src_flux = np.asarray(src_flux)
    buckets = raytracer.assign_buckets(src_flux, float(dr), float(avg_dens))
    pos_t, flux_t = [], []
    for k, eng in enumerate(raytracer.engines):
        B = eng.batch_size
        sel = np.nonzero(buckets == k)[0]
        if sel.size:
            pos, flx = _batches(src_pos[sel], src_flux[sel], B)
        else:
            pos = np.zeros((1, B, 3), np.int64)
            flx = np.zeros((1, B), np.float64)
        pos, flx = _pad_batches_to_devices(pos, flx, mesh.size)
        p, f = _local(pos, flx, mesh, eng.device, eng.dtype)
        pos_t.append(p)
        flux_t.append(f)
    return tuple(pos_t), tuple(flux_t)


def prepare_sources_sharded(raytracer, mesh, src_pos, src_flux, dr=None,
                            avg_dens=None):
    """This rank's batches of the catalog: (pos_b, flux_b), the rows of
    the zero-flux-padded (n_dev * k, B) batch arrays the JAX device of this
    rank's index gets.

    The adaptive engine returns per-bucket tuples (bucket-major: every rank
    sweeps the same radius bucket in lockstep); it needs ``dr`` and
    ``avg_dens`` for the Stromgren bucketing policy."""
    mesh.require_member()
    if getattr(raytracer, "needs_flux_bucketing", False):
        return _prepare_adaptive_sharded(raytracer, mesh, src_pos,
                                         src_flux, dr, avg_dens)
    # hydrogen engines carry (batch_size, dtype) on .config; the helium
    # engine has them itself
    cfg = getattr(raytracer, "config", raytracer)
    B = cfg.batch_size
    n_dev = mesh.size
    ns = np.asarray(src_flux).shape[0]
    per_dev_batches = -(-ns // (B * n_dev))
    pos, flx = _batches(src_pos, src_flux, B)
    pad = per_dev_batches * n_dev - pos.shape[0]
    if pad:
        pos = np.concatenate([pos, np.zeros((pad, B, 3), np.int64)])
        flx = np.concatenate([flx, np.zeros((pad, B))])
    return _local(pos, flx, mesh, raytracer.device, cfg.dtype)


def _check_cells(n_cells, mesh):
    """The chemistry takes n_cells / n_ranks cells per rank; a remainder
    would go without chemistry, so it is refused before any collective.
    (The JAX package slices n_cells // n_dev cells per device and then
    fails on the shapes of the gathered fields.)"""
    if n_cells % mesh.size:
        raise ValueError(
            f"{n_cells} cells do not split evenly over the {mesh.size} "
            f"ranks of the source mesh {mesh.describe()}: the chemistry "
            f"takes N^3 / ranks cells per rank (choose a rank count that "
            f"divides N^3, or the domain mesh)")


def _cell_slice(mesh, n_cells):
    shard = n_cells // mesh.size
    lo = mesh.index * shard
    return lambda a: a.reshape(-1)[lo:lo + shard]


def make_sharded_step(raytracer, mesh, chem: ChemistryParams):
    """One (raytrace + chemistry) iteration on this rank.

    step(ndens, temp, xh, xh_av, pos_b, flux_b, dt, dr) -> (xh_intermed,
    xh_av_new, phi_ion[, heat], conv_flag, sum_xh1, sum_xh0, absorbed):
    the fields flat over all N^3 cells on every rank, the scalars Python
    numbers summed over the mesh. The rank traces its batches, Gamma (and
    heat) is all-reduced, the chemistry runs on the rank's slice of the
    cells and x, <x> are all-gathered."""
    heating = bool(getattr(raytracer.config, "do_heating", False))

    def step(ndens, temp, xh, xh_av, pos_b, flux_b, dt, dr):
        n_cells = ndens.numel()
        _check_cells(n_cells, mesh)
        phi, heat = raytracer.shard_trace(ndens, xh_av, pos_b, flux_b, dr)
        phi = mesh.all_reduce(phi, "gamma")
        if heating:
            heat = mesh.all_reduce(heat, "gamma")
        sl = _cell_slice(mesh, n_cells)
        xi_s, xav_s, cf_s = global_pass(dt, sl(ndens), sl(temp), sl(xh),
                                        sl(xh_av), sl(phi), chem)
        # the absorbed rate without dr^3 (dr^3 ~ 1e62 overflows float32;
        # the volume factor is applied on the host in float64)
        scal = mesh.sum_scalars(cf_s, xi_s.sum(), (1.0 - xi_s).sum(),
                                _absorbed_rate(sl(phi), sl(ndens),
                                               sl(xh_av)))
        xi, xav = mesh.all_gather(torch.stack([xi_s, xav_s]), dim=1,
                                  kind="fields")
        if heating:
            return (xi, xav, phi, heat, *scal)
        return (xi, xav, phi, *scal)

    return step


def trace_sharded(raytracer, mesh, ndens, xh_av, src_pos, src_flux, dr):
    """Standalone multi-rank Gamma: every rank traces its batches, one
    all-reduce. Returns the (N, N, N) Gamma on this rank's device."""
    cfg = raytracer.config
    dev = raytracer.device
    nd = torch.as_tensor(ndens, dtype=cfg.dtype, device=dev).reshape(-1)
    xh = torch.as_tensor(xh_av, dtype=cfg.dtype, device=dev).reshape(-1)
    pos_b, flux_b = prepare_sources_sharded(
        raytracer, mesh, src_pos, src_flux, dr=float(dr),
        avg_dens=float(nd.mean()))
    phi, _ = raytracer.shard_trace(nd, xh, pos_b, flux_b, dr)
    return mesh.all_reduce(phi, "gamma").reshape((cfg.N,) * 3)


def global_pass_sharded(mesh, dt, ndens, temp, xh, xh_av, phi_ion,
                        chem: ChemistryParams):
    """Standalone cell-split chemistry pass: every rank takes its slice of
    the (flat, full) fields; returns the full xh_intermed, xh_av and the
    non-convergence count summed over the ranks."""
    mesh.require_member()
    n = ndens.numel()
    _check_cells(n, mesh)
    sl = _cell_slice(mesh, n)
    xi, xa, cf = global_pass(dt, sl(ndens), sl(temp), sl(xh), sl(xh_av),
                             sl(phi_ion), chem)
    xi, xa = mesh.all_gather(torch.stack([xi, xa]), dim=1, kind="fields")
    return xi, xa, int(mesh.sum_scalars(cf)[0])


def evolve3D_sharded(dt, dr, src_flux, src_pos, raytracer, mesh,
                     chem: ChemistryParams, temp, ndens, xh,
                     convergence_fraction=1e-4, logfile=None, quiet=False,
                     max_iterations=100, thermal=None, zred=0.0,
                     loss_fraction=None):
    """Multi-rank evolve3D: the reference's evolve3D_MPI (evolve.py:249)
    over a source mesh, with the convergence semantics of the single-device
    path. Every rank of the mesh calls it with the same arguments; each
    returns the (N,N,N) numpy (xh, phi_ion[, temp_new]). With ``thermal``
    (a heating engine) the temperature advances after convergence on the
    replicated fields."""
    mesh.require_member()
    cfg = raytracer.config
    N = cfg.N
    num_cells = N ** 3
    _check_cells(num_cells, mesh)
    num_src = int(np.asarray(src_flux).shape[0])
    dtype, dev = cfg.dtype, raytracer.device
    logfile, quiet = mesh.log_args(logfile, quiet)

    def grid(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).reshape(-1)

    temp_d, ndens_d, xh_d = grid(temp), grid(ndens), grid(xh)
    pos_b, flux_b = prepare_sources_sharded(
        raytracer, mesh, src_pos, src_flux, dr=float(dr),
        avg_dens=float(ndens_d.mean()))
    step = make_sharded_step(raytracer, mesh, chem)
    dt_d = torch.tensor(dt, dtype=dtype).to(dev)
    emitted = float(np.sum(np.asarray(src_flux, dtype=np.float64))) \
        * S_STAR_REF

    heating = bool(getattr(cfg, "do_heating", False))
    if thermal is not None and not heating:
        raise ValueError("thermal evolution requires a raytracer with "
                         "do_heating=True (Photo.compute_heating_rates)")

    printlog(f"Calling evolve3D over mesh {mesh.describe()}...",
             logfile, quiet)
    state = {"xh_av": xh_d, "xh_intermed": xh_d, "phi_ion": None,
             "phi_heat": None}

    def iteration(niter):
        t0 = time.time()
        out = step(ndens_d, temp_d, xh_d, state["xh_av"], pos_b, flux_b,
                   dt_d, dr)
        if heating:
            (xh_intermed, xh_av, phi_ion, phi_heat, conv_flag, sum_xh1,
             sum_xh0, absorbed) = out
        else:
            (xh_intermed, xh_av, phi_ion, conv_flag, sum_xh1, sum_xh0,
             absorbed) = out
            phi_heat = None
        printlog(f"Iteration {niter} took {time.time()-t0:.3f} s.",
                 logfile, quiet)
        state.update(xh_av=xh_av, xh_intermed=xh_intermed,
                     phi_ion=phi_ion, phi_heat=phi_heat)
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
        from ..ops.thermal import update_temperature
        temp_new = update_temperature(dt_d, temp_d, ndens_d, state["xh_av"],
                                      state["phi_heat"], thermal,
                                      z=float(zred))
        out = out + (temp_new.cpu().numpy().reshape(shape3),)
    return out


# ---------------------------------------------------------------------------
# Helium (three-species) source-parallel path
# ---------------------------------------------------------------------------

def make_sharded_step_he(raytracer, mesh, phe):
    """Three-species iteration on this rank (engine =
    ops.raytrace_he.HeRaytracer): the rank sweeps its batches of all three
    absorber fields, one all-reduce of the stacked rate fields, the coupled
    H+He chemistry on the rank's slice of the cells.

    step(ndens, temp, xh0, xh_av, y1_0, y1_av, y2_0, y2_av, pos_b, flux_b,
    dt, dr) -> (xi, xav, y1i, y1a, y2i, y2a, gH, gHe1, gHe2[, heat], cf,
    s1, s0, absorbed), the fields (N, N, N) on every rank."""
    from ..ops.chemistry_he import global_pass_he, secondary_enabled
    heating = raytracer.do_heating
    secondary = secondary_enabled(phe, heating)

    def step(ndens, temp, xh0, xh_av, y1_0, y1_av, y2_0, y2_av, pos_b,
             flux_b, dt, dr):
        sh = ndens.shape
        n_cells = ndens.numel()
        _check_cells(n_cells, mesh)
        gs = raytracer.trace_batches(ndens, xh_av, y1_av, y2_av, pos_b,
                                     flux_b, dr)
        gs = mesh.all_reduce(torch.stack(gs), "gamma").unbind(0)
        sl = _cell_slice(mesh, n_cells)
        (xi_s, xav_s, y1i_s, y1a_s, y2i_s, y2a_s, cf_s) = global_pass_he(
            dt, sl(ndens), sl(temp), sl(xh0), sl(xh_av),
            sl(y1_0), sl(y1_av), sl(y2_0), sl(y2_av),
            sl(gs[0]), sl(gs[1]), sl(gs[2]), phe,
            heat=sl(gs[3]) if secondary else None,
            recombination_photons=bool(phe.recombination_photons))
        scal = mesh.sum_scalars(
            cf_s, xi_s.sum(), (1.0 - xi_s).sum(),
            _absorbed_rate_he(sl(gs[0]), sl(gs[1]), sl(gs[2]), sl(ndens),
                              sl(xh_av), sl(y1_av), sl(y2_av), phe.abu_he))
        fields = mesh.all_gather(torch.stack(
            [xi_s, xav_s, y1i_s, y1a_s, y2i_s, y2a_s]), dim=1, kind="fields")
        return (tuple(f.reshape(sh) for f in fields) + tuple(gs)
                + tuple(scal))

    return step


def evolve3D_he_sharded(dt, dr, src_flux, src_pos, raytracer, mesh, phe,
                        temp, ndens, xh, y1, y2,
                        convergence_fraction=1e-4, logfile=None,
                        quiet=False, max_iterations=100, thermal=None,
                        zred=0.0, loss_fraction=None):
    """Source-parallel coupled H+He evolve loop: the reference's MPI source
    split (evolve.py:361-371) applied to the three-species engine. Returns
    (xh, phi_HI, y1, y2, phi_HeI, phi_HeII[, temp]) as (N,N,N) numpy arrays
    on every rank."""
    from ..ops.chemistry_he import secondary_enabled, thermal_heat_rate
    mesh.require_member()
    N = raytracer.N
    num_cells = N ** 3
    _check_cells(num_cells, mesh)
    num_src = int(np.asarray(src_flux).shape[0])
    dtype, dev = raytracer.dtype, raytracer.device
    sh3 = (N, N, N)
    logfile, quiet = mesh.log_args(logfile, quiet)

    def grid(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).reshape(sh3)

    temp_d, ndens_d = grid(temp), grid(ndens)
    xh_d, y1_d, y2_d = grid(xh), grid(y1), grid(y2)
    pos_b, flux_b = prepare_sources_sharded(raytracer, mesh, src_pos,
                                            src_flux)
    step = make_sharded_step_he(raytracer, mesh, phe)
    dt_d = torch.tensor(dt, dtype=dtype).to(dev)
    emitted = float(np.sum(np.asarray(src_flux, dtype=np.float64))) \
        * S_STAR_REF
    heating = raytracer.do_heating
    if thermal is not None and not heating:
        raise ValueError("thermal evolution requires HeRaytracer("
                         "do_heating=True)")
    secondary = secondary_enabled(phe, heating)
    ng = 10 if heating else 9

    printlog(f"Calling evolve3D_he over mesh {mesh.describe()} on "
             f"{num_src:n} source(s)...", logfile, quiet)
    state = {"xh_av": xh_d, "y1_av": y1_d, "y2_av": y2_d,
             "xh_int": xh_d, "y1_int": y1_d, "y2_int": y2_d, "g": None}

    def iteration(niter):
        t0 = time.time()
        out = step(ndens_d, temp_d, xh_d, state["xh_av"], y1_d,
                   state["y1_av"], y2_d, state["y2_av"], pos_b, flux_b,
                   dt_d, dr)
        (xi, xav, y1i, y1a, y2i, y2a) = out[:6]
        cf, s1, s0, ab = out[ng:]
        printlog(f"Iteration {niter} took {time.time()-t0:.3f} s.",
                 logfile, quiet)
        state.update(xh_av=xav, y1_av=y1a, y2_av=y2a,
                     xh_int=xi, y1_int=y1i, y2_int=y2i, g=out[6:ng])
        ab_rate = ab * float(dr) ** 3
        loss = (1.0 - ab_rate / emitted) if emitted > 0 else None
        return IterationResult(int(cf), s1, s0, photon_loss=loss)

    run_convergence_loop(iteration, num_cells, num_src,
                         convergence_fraction, max_iterations,
                         logfile, quiet, loss_fraction=loss_fraction)

    g = state["g"]

    def host(t):
        return t.cpu().numpy().reshape(sh3)
    out = (host(state["xh_int"]), host(g[0]), host(state["y1_int"]),
           host(state["y2_int"]), host(g[1]), host(g[2]))
    if thermal is not None:
        from ..ops.thermal import update_temperature
        heat_rate = thermal_heat_rate(phe, g[3].reshape(-1),
                                      state["xh_av"].reshape(-1), secondary)
        temp_new = update_temperature(
            dt_d, temp_d.reshape(-1), ndens_d.reshape(-1),
            state["xh_av"].reshape(-1), heat_rate, thermal, z=float(zred))
        out = out + (host(temp_new),)
    return out
