"""Multi-species (HI / HeI / HeII) raytracer — the helium extension.

PyTorch twin of pyc2ray_tpu/ops/raytrace_he.py (helium RT is declared TODO
in the reference, README.md:81-87). The Chebyshev-face sweep is
species-agnostic: a column-density sweep of any absorber field whose own
threshold cross section enters the interpolation weights
1/max(0.6, cd sigma) (raytracing.f90:807-813). So per batch the engine runs
three sweeps of the port's ChebRaytracer (``sweep_box``: kernel K1 on a
CUDA tensor, K2 where the engine segments), one per species at its sigma_th,
and couples the species only in the rate pass, where the composite optical
depth of spectral bin e is

    tau_e = sum_s N_s sigma_s(nu_e)

and the photons absorbed in a cell are shared between the species by
opacity fraction dtau_s/dtau (photon conserving by construction).

The rate pass (``_rates_he``) is plain PyTorch over the rates subbox: the
per-cell optical depths and the per-species sums over bins are matrix
products (torch.matmul) around one elementwise block over (cells, bins).
Each source's rate boxes are added into the padded grids source by source
in batch order (the JAX engine's scan accumulate); the JAX engine's window
accumulate is a TPU layout device and is not copied.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..constants import MAX_COLDENSH
from ..radiation.helium import HeSpectralBins
from ..radiation.spectral_bins import SpectralBins
from .raytrace_cheb import ChebRaytracer
from .sweep import s_over_dr3

__all__ = ["HeRaytracer", "HeBinTables"]


class HeBinTables(NamedTuple):
    """The three-species bins on the engine's device."""
    se: torch.Tensor        # (3, E) sigma_s(nu_e) = s[s, e] sigma_th[s]
    w_se: torch.Tensor      # (3, E) w_e se[s, e]
    wh_se: torch.Tensor     # (3, E) w_heat[s, e] se[s, e]


class HeRaytracer:
    """Batched multi-source, three-species raytracer.

    trace(nd, xh, y1, y2, pos, flux, dr) -> (G_HI, G_HeI, G_HeII), each
    (N,N,N) per-atom photoionization rates (and with ``do_heating`` a
    fourth field: the per-HI-atom equivalent of the total three-species
    photoheating). ``device`` as in ChebRaytracer."""

    def __init__(self, N, R_max_LLS, bins: HeSpectralBins, abu_he,
                 batch_size=8, dtype=torch.float32, device="cuda",
                 do_heating=False):
        self.abu_he = float(abu_he)
        self.do_heating = bool(do_heating)
        self.bins = bins
        self.sigma_th = tuple(float(v) for v in bins.sigma_th)
        # the host engine supplies the geometry, the sweep, the box
        # extraction and the accumulate; its own hydrogen bins are unused
        placeholder = SpectralBins(s=np.ones(1), w_photo=np.ones(1),
                                   w_heat=np.zeros(1), num_bins=1)
        self.eng = ChebRaytracer(N, R_max_LLS, self.sigma_th[0], placeholder,
                                 batch_size=batch_size, dtype=dtype,
                                 device=device)
        self.N = self.eng.N
        self.batch_size = self.eng.batch_size
        self.dtype = dtype
        self.device = self.eng.device

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(
                self.device, dtype)
        # in the engine's dtype, formed as the JAX engine forms them
        se = dev(bins.s) * dev(self.sigma_th)[:, None]
        self.he_tables = HeBinTables(se=se, w_se=dev(bins.w_photo)[None] * se,
                                     wh_se=dev(bins.w_heat) * se)

    @property
    def geom(self):
        return self.eng.geom

    def prepare_sources(self, src_pos, src_flux):
        return self.eng.prepare_sources(src_pos, src_flux)

    # ------------------------------------------------------------------
    def _rates_he(self, cds, nboxes, flux, dr):
        """Multi-species rate pass over the central rates subbox.

        ``cds`` / ``nboxes``: three (B, Dc, Dc, Dc) coldensh_out and absorber
        boxes; ``dr`` a 0-dim tensor. Returns the (B, Ds, Ds, Ds) channels
        (G_HI, G_HeI, G_HeII[, heat]) to accumulate at box position + rb0."""
        eng, heb = self.eng, self.he_tables
        dt = self.dtype
        b0, b1 = eng._rb0, eng._rb1
        sub = (slice(None),) + (slice(b0, b1),) * 3
        cds = [c[sub] for c in cds]
        nboxes = [n[sub] for n in nboxes]
        rt_sub = eng.tables.rt_sub
        path = rt_sub[0][None] * dr

        dcol = [nboxes[s] * path for s in range(3)]
        cdin = [cds[s] - dcol[s] for s in range(3)]
        prefact = (flux[:, None, None, None]
                   * s_over_dr3(dr, dt).to(dr.device) * rt_sub[1][None])

        tiny = 1e-30 if dt == torch.float32 else 1e-280
        # per cell, the composite tau of every bin is one (cells, 3) x
        # (3, E) product; the per-species sums over bins one (cells, E) x
        # (E, 3) product
        A = torch.stack([c.reshape(-1) for c in cdin], 1)     # (n, 3)
        Dm = torch.stack([d.reshape(-1) for d in dcol], 1)    # (n, 3)
        tau_in = A @ heb.se
        dtau_e = Dm @ heb.se
        core = torch.exp(-tau_in) * (-torch.expm1(-dtau_e))
        inv = core / torch.clamp(dtau_e, min=tiny)            # (n, E)
        del tau_in, dtau_e, core
        wv = inv @ heb.w_se.T                                 # (n, 3)
        sh4 = cds[0].shape
        acc = [(Dm[:, s] * wv[:, s]).reshape(sh4) for s in range(3)]
        if self.do_heating:
            acc.append((Dm * (inv @ heb.wh_se.T)).sum(dim=1).reshape(sh4))

        mask = (rt_sub[2] > 0.5)[None] & (cdin[0] <= MAX_COLDENSH)
        zero = torch.zeros_like(acc[0])
        # the heat channel is per HI atom: the thermal update multiplies it
        # by n_HI and recovers sum_s Gamma_heat_s n_s
        dens = nboxes + nboxes[:1]
        return [torch.where(mask & (n > 0),
                            prefact * a / torch.clamp(n, min=tiny), zero)
                for a, n in zip(acc, dens)]

    # ------------------------------------------------------------------
    def species_fields(self, nd3, xh3, y13, y23):
        """Absorber number densities (n_HI, n_HeI, n_HeII) from the
        hydrogen density and the ionized fractions."""
        return (nd3 * (1.0 - xh3),                      # HI
                self.abu_he * nd3 * (1.0 - y13 - y23),  # HeI
                self.abu_he * nd3 * y13)                # HeII

    def trace_extended(self, pads, pos_b, flux_b, dr):
        """The batched three-species sweep over the wrap-padded absorber
        fields ``pads`` (tuple of 3); returns the padded accumulators
        (G_HI, G_HeI, G_HeII[, heat])."""
        eng = self.eng
        dr_t = torch.tensor(dr, dtype=self.dtype).to(self.device)
        out = [torch.zeros_like(pads[0])
               for _ in range(4 if self.do_heating else 3)]
        for pos, flux in zip(pos_b, flux_b):
            pos_d = pos.to(self.device)
            boxes = [eng._extract_boxes(p, pos_d) for p in pads]
            cds = [eng.sweep_box(boxes[s], dr, self.sigma_th[s])
                   for s in range(3)]
            for pad, rate_box in zip(out, self._rates_he(cds, boxes, flux,
                                                         dr_t)):
                eng.add_boxes(pad, rate_box, pos)
        return out

    # -- uniform engine API ----------------------------------------------
    def trace_batches(self, nd, xh, y1, y2, pos_b, flux_b, dr):
        """Batched trace on prepared sources; the fields are tensors on the
        engine's device, (N,N,N) or flat. Returns (G_HI, G_HeI,
        G_HeII[, heat]) as (N,N,N) tensors."""
        sh = (self.N,) * 3
        fields = self.species_fields(*(a.reshape(sh)
                                       for a in (nd, xh, y1, y2)))
        pads = tuple(self.eng.wrap_pad(f) for f in fields)
        return tuple(self.eng._fold_padding(p) for p in
                     self.trace_extended(pads, pos_b, flux_b, float(dr)))

    def trace(self, ndens, xh, y1, y2, src_pos, src_flux, dr):
        """Public API: per-atom (G_HI, G_HeI, G_HeII[, heat]) on the
        engine's device; the fields are numpy arrays or tensors."""
        args = [torch.as_tensor(a, dtype=self.dtype, device=self.device)
                for a in (ndens, xh, y1, y2)]
        pos_b, flux_b = self.prepare_sources(src_pos, src_flux)
        return self.trace_batches(*args, pos_b, flux_b, dr)
