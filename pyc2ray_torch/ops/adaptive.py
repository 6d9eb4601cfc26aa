"""Adaptive per-source raytracing radii, PyTorch port.

Twin of pyc2ray_tpu/ops/adaptive.py. The reference's CPU raytracer grows a
cubic subbox around each source until the photon loss drops below
loss_fraction (raytracing.f90:183-226). Here sources are assigned a
raytracing radius from their flux by the Stromgren scaling

    r_S = (3 F S* / (4 pi alpha_B <n>^2 C)) ^ (1/3)          [cm]
    R_src = clip(safety * r_S / dr, R_min, R_max)            [cells]

and binned into a few fixed-radius engines, one port ``ChebRaytracer`` per
bucket (no kernel of its own: every bucket runs its engine's sweep mode,
K3/K3h with ``fuse_fold``). The per-iteration photon-loss log of the evolve
loop (evolve_loop.run_convergence_loop) quantifies the truncation and warns
above Raytracing.loss_fraction.

The mean density of the Stromgren policy is that of the density grid being
traced (passed by the evolve loop / ``prepare_sources``), not a constant
fixed at construction.

Under a source mesh the engine traces bucket-major (``shard_trace``, staged
by parallel/source_parallel.py), under a domain mesh owner-local
(parallel/domain.py). Not ported: the JAX engine's window accumulate, whose
batch-size rule (``bucket_batch``) therefore does not apply: every bucket
keeps ``batch_size``, as the JAX engine does with ``accumulate="scan"``.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .raytrace_cheb import ChebRaytracer

__all__ = ["stromgren_radius_cells", "AdaptiveRaytracer", "AdaptiveBatches"]


def stromgren_radius_cells(flux, dr, avg_dens, alpha_B=2.59e-13,
                           clumping=1.0, s_star=1e48):
    """Stromgren radius in cell units for normalized source flux."""
    flux = np.asarray(flux, dtype=np.float64)
    r_cm = (3.0 * flux * s_star
            / (4.0 * np.pi * alpha_B * clumping * avg_dens ** 2)) ** (1 / 3)
    return r_cm / dr


class AdaptiveBatches(NamedTuple):
    """Per-bucket prepared sources; None for an empty bucket."""
    pos: tuple        # per-bucket (nb, B, 3) int64 CPU positions
    flux: tuple       # per-bucket (nb, B) fluxes on the engine's device
    counts: tuple     # per-bucket source counts
    avg_dens: float   # mean density the bucketing used (for the log)


class AdaptiveRaytracer:
    """Multi-engine raytracer with flux-dependent per-source radii.

    The engine API of ``ChebRaytracer`` (prepare_sources / trace_batches /
    trace), so evolve3D drives it as a fixed-radius engine. ``radii`` are
    the bucket radii in cells (ascending); each source uses the smallest
    bucket with R_bucket >= its clipped Stromgren radius * safety.
    ``device``, ``dtype``, ``do_heating`` and ``fuse_fold`` are passed to
    every bucket's engine."""

    needs_flux_bucketing = True

    def __init__(self, N, R_max_LLS, sig, bins, radii=None, batch_size=8,
                 dtype=torch.float32, device="cuda", safety=2.0,
                 alpha_B=2.59e-13, R_min=4.0, do_heating=False,
                 fuse_fold=False):
        self.N = int(N)
        self.R_max = float(R_max_LLS)
        self.safety = float(safety)
        self.alpha_B = float(alpha_B)
        self.R_min = float(R_min)
        self.do_heating = bool(do_heating)
        self.device = resolve_device(device)
        if radii is None:
            # geometric ladder: R_max, R_max/2, R_max/4 (>= R_min)
            radii = []
            r = float(min(R_max_LLS, N))
            while r >= max(R_min, 4.0) and len(radii) < 4:
                radii.append(r)
                r /= 2.0
            if not radii:
                # R_max below the minimum bucket: one bucket at R_max, a
                # plain fixed-radius engine
                radii = [float(min(R_max_LLS, N))]
            radii = sorted(radii)
        self.radii = [float(r) for r in radii]
        self.engines = [
            ChebRaytracer(N, r, sig, bins, batch_size=batch_size,
                          dtype=dtype, device=self.device,
                          do_heating=do_heating, fuse_fold=fuse_fold)
            for r in self.radii]
        self.dtype = dtype
        self.config = self.engines[-1].config

    def assign_buckets(self, src_flux, dr, avg_dens):
        """Bucket index per source from the Stromgren policy."""
        r_s = stromgren_radius_cells(src_flux, float(dr), float(avg_dens),
                                     self.alpha_B)
        r_need = np.clip(self.safety * r_s, self.R_min, self.R_max)
        idx = np.searchsorted(np.asarray(self.radii), r_need - 1e-9)
        return np.minimum(idx, len(self.radii) - 1)

    def prepare_sources(self, src_pos, src_flux, dr=None, avg_dens=None):
        """Bucket sources and stage per-bucket batches.

        Returns (AdaptiveBatches, None), an opaque (pos_b, flux_b) pair for
        the evolve loop. ``dr`` [cm] and ``avg_dens`` [cm^-3] feed the
        Stromgren policy; avg_dens is the mean of the density grid being
        traced (the evolve loop passes it)."""
        if dr is None or avg_dens is None:
            raise ValueError(
                "AdaptiveRaytracer.prepare_sources needs dr and avg_dens "
                "(the mean of the traced density grid) for the Stromgren "
                "bucketing policy")
        src_pos = np.asarray(src_pos)
        src_flux = np.asarray(src_flux)
        buckets = self.assign_buckets(src_flux, dr, avg_dens)
        pos_t, flux_t, counts = [], [], []
        for k, eng in enumerate(self.engines):
            sel = np.nonzero(buckets == k)[0]
            counts.append(int(sel.size))
            if sel.size == 0:
                pos_t.append(None)
                flux_t.append(None)
                continue
            pos_b, flux_b = eng.prepare_sources(src_pos[sel], src_flux[sel])
            pos_t.append(pos_b)
            flux_t.append(flux_b)
        return AdaptiveBatches(tuple(pos_t), tuple(flux_t), tuple(counts),
                               float(avg_dens)), None

    def describe_buckets(self, batches: AdaptiveBatches):
        pairs = ", ".join(f"R={r:g}: {c}" for r, c
                          in zip(self.radii, batches.counts))
        return (f"Adaptive radii (Stromgren policy, <n> = "
                f"{batches.avg_dens:.3e} cm^-3, safety = {self.safety:g}): "
                f"{pairs} sources")

    def trace_batches(self, nd, xh, batches: AdaptiveBatches, _flux, dr):
        """Trace over all buckets with flat-grid IO, as
        ChebRaytracer.trace_batches; Gamma (and heat, with do_heating)
        summed over the buckets in ascending order, zeros when every bucket
        is empty."""
        phi = None
        heat = None
        for eng, pos_b, flux_b in zip(self.engines, batches.pos,
                                      batches.flux):
            if pos_b is None:
                continue
            p, h = eng.trace_batches(nd, xh, pos_b, flux_b, dr)
            phi = p if phi is None else phi + p
            if self.do_heating:
                heat = h if heat is None else heat + h
        if phi is None:
            phi = torch.zeros(self.N ** 3, dtype=self.dtype,
                              device=self.device)
            heat = torch.zeros_like(phi) if self.do_heating else None
        return phi, heat

    def shard_trace(self, nd, xh, pos_b, flux_b, dr):
        """A rank's partial Gamma (and heat) bucket-MAJOR, with no reduce.

        ``pos_b``/``flux_b`` are per-bucket tuples staged by
        parallel.source_parallel.prepare_sources_sharded: every bucket is
        padded to a whole number of batches per rank (zero-flux padding,
        one batch for an empty bucket), so all ranks sweep the same radius
        bucket in lockstep and per-rank batches never mix radii. Summed
        over the buckets in ascending order; the caller all-reduces."""
        phi = None
        heat = None
        for eng, pk, fk in zip(self.engines, pos_b, flux_b):
            p, h = eng.shard_trace(nd, xh, pk, fk, dr)
            phi = p if phi is None else phi + p
            if self.do_heating:
                heat = h if heat is None else heat + h
        return phi, heat

    def trace(self, ndens, xh_av, src_pos, src_flux, dr, avg_dens=None,
              stats=False):
        """Gamma over all buckets (N, N, N) on the engine's device; with
        ``stats`` the pair (phi, {bucket_radii, bucket_counts, avg_dens}),
        else with ``do_heating`` the pair (phi, heat). ``ndens`` and
        ``xh_av`` are numpy arrays or tensors; a tensor already on the
        engine's device is used where it is."""
        nd = torch.as_tensor(ndens, dtype=self.dtype,
                             device=self.device).reshape(-1)
        xh = torch.as_tensor(xh_av, dtype=self.dtype,
                             device=self.device).reshape(-1)
        if avg_dens is None:
            avg_dens = float(nd.mean())
        batches, _ = self.prepare_sources(src_pos, src_flux, dr=float(dr),
                                          avg_dens=avg_dens)
        phi, heat = self.trace_batches(nd, xh, batches, None, float(dr))
        sh = (self.N,) * 3
        if stats:
            return phi.reshape(sh), {"bucket_radii": self.radii,
                                     "bucket_counts": list(batches.counts),
                                     "avg_dens": batches.avg_dens}
        if self.do_heating:
            return phi.reshape(sh), heat.reshape(sh)
        return phi.reshape(sh)
