"""Multi-species (HI / HeI / HeII) raytracer — the helium extension.

PyTorch twin of pyc2ray_tpu/ops/raytrace_he.py (helium RT is declared TODO
in the reference, README.md:81-87). The Chebyshev-face sweep is
species-agnostic: a column-density sweep of any absorber field whose own
threshold cross section enters the interpolation weights
1/max(0.6, cd sigma) (raytracing.f90:807-813). So per batch the engine runs
three sweeps of the host ChebRaytracer's kernels (K1, or K2 where the host
engine segments), one per species at its sigma_th, and couples the species
only in the rate pass, where the composite optical depth of spectral bin e
is

    tau_e = sum_s N_s sigma_s(nu_e)

and the photons absorbed in a cell are shared between the species by
opacity fraction dtau_s/dtau (photon conserving by construction).

What runs where. A trace is one call of ``trace_loop.he_trace_sweep``, the
counterpart of the JAX engine's jit + lax.fori_loop over batches: on CUDA
frames a loop in C (csrc/trace_loop.cu) issues per chunk of batches one
extract of the three species' boxes and per batch the three sweeps, the
three-species rate pass (``cheb_rates.rates_he``, the kernel of
csrc/cheb_rates_he.cuh, over the host engine's rated cells) and one
accumulate of the 3-4 rate channels into the padded grids, source by source
in batch order (the JAX engine's scan accumulate), with no host sync; on
CPU frames its plain version, the loop in Python. ``trace_extended_plain``
keeps that Python loop on either device: the reference the card holds the
loop against. The JAX engine's window accumulate is a TPU layout device and
is not copied.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..radiation.helium import HeSpectralBins
from ..radiation.spectral_bins import SpectralBins
from .cheb_rates import HeBands, he_bands, rates_he
from .raytrace_cheb import ChebRaytracer
from .sweep import rate_consts
from .trace_loop import he_trace_sweep, he_trace_sweep_ref, stage_positions

__all__ = ["HeRaytracer", "HeBinTables"]


class HeBinTables(NamedTuple):
    """The three-species bins on the engine's device."""
    se: torch.Tensor        # (3, E) sigma_s(nu_e) = s[s, e] sigma_th[s]
    w_se: torch.Tensor      # (3, E) w_e se[s, e]
    wh_se: torch.Tensor     # (3, E) w_heat[s, e] se[s, e]
    bands: HeBands          # the rate kernel's records of them, with wh_se
                            # where the engine heats (cheb_rates.he_bands)


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
        # the host engine supplies the geometry, the sweep's tables and
        # segmentation and the rated cells; its own hydrogen bins are unused
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
        w_se, wh_se = dev(bins.w_photo)[None] * se, dev(bins.w_heat) * se
        self.he_tables = HeBinTables(
            se=se, w_se=w_se, wh_se=wh_se,
            bands=he_bands(se, w_se, wh_se if self.do_heating else None))

    @property
    def geom(self):
        return self.eng.geom

    def prepare_sources(self, src_pos, src_flux):
        return self.eng.prepare_sources(src_pos, src_flux)

    # ------------------------------------------------------------------
    def _rates_he(self, cds, nboxes, flux, dr):
        """The three-species rate pass over the central rates subbox
        (ops/cheb_rates.py::rates_he: the plain version for CPU boxes, the
        kernel for CUDA ones, at the host engine's rated cells). ``cds`` /
        ``nboxes``: three (B, Dc, Dc, Dc) coldensh_out and absorber boxes,
        ``flux`` (B,), ``dr`` a float. Returns the (B, Ds, Ds, Ds) channels
        (G_HI, G_HeI, G_HeII[, heat]) to accumulate at box position +
        rb0."""
        eng, heb = self.eng, self.he_tables
        return rates_he(cds, nboxes, eng.tables.rt_sub, flux, heb.se,
                        heb.w_se, float(dr), rate_consts(dr, self.dtype)[1],
                        eng._rb0, wh_se=heb.wh_se if self.do_heating else None,
                        cells=eng.rated_cells, bands=heb.bands)

    # ------------------------------------------------------------------
    def species_fields(self, nd3, xh3, y13, y23):
        """Absorber number densities (n_HI, n_HeI, n_HeII) from the
        hydrogen density and the ionized fractions."""
        return (nd3 * (1.0 - xh3),                      # HI
                self.abu_he * nd3 * (1.0 - y13 - y23),  # HeI
                self.abu_he * nd3 * y13)                # HeII

    def _loop_args(self):
        """The arguments of ``he_trace_sweep`` after the positions and
        fluxes: the host engine's tables, the bin tables, the geometry and
        its sweep and rate pass (with the host engine's rated cells)."""
        eng = self.eng
        return (eng.tables, self.he_tables), dict(
            c=eng.geom.c, sigmas=self.sigma_th, seg=(eng.seg_S, eng.seg_K),
            rb0=eng._rb0, heat=self.do_heating, cells=eng.rated_cells)

    def trace_extended(self, pads, pos_b, flux_b, dr):
        """The batched three-species sweep over the wrap-padded absorber
        fields ``pads`` (tuple of 3; or any frames that hold every box, as
        a domain's halo-extended blocks); returns the accumulated rate frames
        [G_HI, G_HeI, G_HeII(, heat)]. The positions go to the frames' device
        once, and the batch loop is one ``he_trace_sweep`` call."""
        pads = tuple(pads)
        pos = stage_positions(pos_b, pads[0].shape, self.eng.geom.Dc,
                              pads[0].device)
        tables, kw = self._loop_args()
        return he_trace_sweep(pads, pos, flux_b, *tables, float(dr), **kw)

    def trace_extended_plain(self, pads, pos_b, flux_b, dr):
        """``trace_extended`` as the batch loop was issued before the loop
        in C: per batch a copy of the positions to the device, the PyTorch
        gathers, the three sweeps, the plain rate pass and one slice add per
        source and channel (``he_trace_sweep_ref``). The same result bit for
        bit; on the card the plain reference of the loop and its
        kernels."""
        tables, kw = self._loop_args()
        return he_trace_sweep_ref(tuple(pads), pos_b, flux_b, *tables,
                                  float(dr), **kw)

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
