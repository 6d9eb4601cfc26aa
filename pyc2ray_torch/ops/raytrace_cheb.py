"""Chebyshev-face raytracing engine, PyTorch port.

Twin of pyc2ray_tpu/ops/raytrace_cheb.py::ChebRaytracer with the Pallas
sweep (per-source scan accumulate, no lane packing). Per batch of B
sources:

  1. cut the (Dc, Dc, Dc) HI-density box of every source out of the
     wrap-padded grid (``_extract_boxes``);
  2. compute the rate box, by one of the JAX engine's four sweep modes
     (each a CUDA kernel on the GPU and its plain version on the CPU, see
     ops/sweep.py):
       - default: sweep the cube shells to the coldensh_out box (K1,
         ``sweep.cheb_sweep``), then evaluate the spectral-bin
         photoionization rates densely over the central rates subbox
         (``_rates``);
       - ``shell_segment``: the same sweep as K segments of S shells with
         carried planes (K2, ``_sweep_segmented``), then ``_rates``;
       - ``fuse_rates``: the sweep evaluates the Gamma of every face cell
         (K1f), the source cell by its closed form
         (``sweep.source_cell_rate``), in one call;
       - ``fuse_fold``: sweep, box assembly and rates with the flux and the
         source cell's closed form in one kernel (K3);
  3. add each source's rate box into the padded Gamma grid, source by
     source in batch order (the JAX engine's scan accumulate).

After the last batch the padding is folded back onto the periodic grid
(``_fold_padding``).

With ``do_heating`` every mode also returns the photoheating rate per HI
atom: the rate pass and ``fuse_fold`` (K3h) sum the heating weights
``bins_wh`` over the same per-bin attenuation factors, a second padded
grid accumulates the heat boxes, and ``fuse_rates`` falls back to the
default mode (its kernel has no heat output, as in the JAX engine).

The JAX engine's window accumulate (one-hot matmul placement, its tuner
and ``PackedPositions``), its multi-source lane packing and its stack fold
are layout devices of the TPU and are not copied: on the GPU the
accumulate is a slice add, and the sweep kernel writes the cartesian box
directly.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..constants import S_STAR_REF, MAX_COLDENSH
from ..device import resolve_device
from ..radiation.spectral_bins import SpectralBins
from .cheb_geometry import (ChebGeometry, box_dims, build_cheb_geometry,
                            pack_rates_tables)
from .geometry import max_q_for
from .raytrace import RaytraceConfig
from .sweep import cheb_sweep, cheb_sweep_rates, cheb_sweep_seg, init_planes

__all__ = ["ChebRaytracer", "ChebTables", "shell_segmentation",
           "wrap_pad", "add_boxes", "fold_padding"]

FOURPI = 12.566370614359172463991853874177


# The extended frame of a box engine: every source's (Dc)^3 box starts at
# its position in the (N, N, N) grid wrap-padded by c cells below and
# Dc - 1 - c above on every axis (c: the source's index in its box). The
# Chebyshev and the octahedral sheet engines share it.

def wrap_pad(field3, c, Dc):
    """The (N, N, N) field wrap-padded to the extended frame."""
    N = field3.shape[0]
    wrap = torch.arange(-c, N + Dc - 1 - c, device=field3.device) % N
    return field3[wrap][:, wrap][:, :, wrap]


def add_boxes(pad, boxes, pos, shift=0):
    """Add each source's box of ``boxes`` (B, D, D, D) into the extended
    grid ``pad`` at its box corner ``pos`` (B, 3) plus ``shift`` on every
    axis, source by source in batch order (a fixed order of the adds on
    either device)."""
    D = boxes.shape[-1]
    for (p0, p1, p2), box in zip(pos.tolist(), boxes):
        p0, p1, p2 = p0 + shift, p1 + shift, p2 + shift
        pad[p0:p0 + D, p1:p1 + D, p2:p2 + D] += box


def fold_padding(padded, c, Dc):
    """Fold the padding of the extended frame back onto the periodic
    (N, N, N) grid (low pad onto the top, high pad onto the bottom, one
    axis after the other)."""
    N = padded.shape[0] - (Dc - 1)
    padL, padR = c, Dc - 1 - c
    out = padded
    for axis in range(3):
        core = out.narrow(axis, padL, N).clone()
        if padR > 0:
            core.narrow(axis, 0, padR).add_(out.narrow(axis, padL + N, padR))
        if padL > 0:
            core.narrow(axis, N - padL, padL).add_(out.narrow(axis, 0, padL))
        out = core
    return out


def shell_segmentation(N, R_max_LLS, batch_size, dtype,
                       shell_segment="auto", fused=False):
    """(seg_S, seg_K): shells per segment and segments per batch of the
    sweep, by the JAX engine's rule. "auto" segments when the JAX
    kernel's face stacks, 3 B (r_max+1) Dc 2Dc words, would exceed
    768 MB, at S shells per segment that keep a segment's stacks within
    192 MB (at least 8); an int forces S; 0 disables; S >= r_max+1 turns
    segmentation off. The port's sweep keeps two shells of planes, not
    stacks, so on the card this rule is about parity, not memory: the
    configuration that makes the JAX engine launch its segmented kernel
    launches this port's (K2).

    Unlike the JAX engine, "auto" resolves to 0 with a fused mode (there
    it raises at large R); an explicit S with a fused mode raises, as
    there."""
    r_cube = int(np.ceil(min(float(R_max_LLS), float(N))))
    _, _, _, Dc, r_max = box_dims(int(N), max_q_for(R_max_LLS, N), r_cube)
    stack_bytes = (3 * batch_size * (r_max + 1) * Dc * 2 * Dc
                   * (torch.finfo(dtype).bits // 8))
    if shell_segment == "auto":
        seg_S = 0
        if not fused and stack_bytes > 768 * 1024 * 1024:
            per_shell = stack_bytes // (r_max + 1)
            seg_S = max(8, int((192 * 1024 * 1024) // per_shell))
    else:
        seg_S = int(shell_segment or 0)
    if seg_S >= r_max + 1:
        seg_S = 0
    if seg_S and fused:
        raise ValueError("shell segmentation does not compose with "
                         "fuse_rates/fuse_fold")
    return seg_S, (-(-r_max // seg_S) if seg_S else 0)


class ChebTables(NamedTuple):
    """Device tables of the engine (see ops/cheb_geometry.py)."""
    sw: torch.Tensor        # (3, 4, R1, Dc, Dc) corner weights
    path: torch.Tensor      # (3, R1, Dc, Dc)
    diag: torch.Tensor      # (3, R1, Dc, Dc)
    mask_p: torch.Tensor    # (3, R1, Dc, Dc) bool
    mask_m: torch.Tensor    # (3, R1, Dc, Dc) bool
    rt_sub: torch.Tensor    # (3, Ds, Ds, Ds) rates-subbox channels
                            # (path3, geominv, valid), see _build_rt_sub
    rt_tab: torch.Tensor    # (Dc, 2, Dc, Dc) per-plane (dist2, valid) of
                            # the fused modes (pack_rates_tables)
    bins_s: torch.Tensor    # (E,) spectral bins
    bins_w: torch.Tensor
    bins_wh: torch.Tensor

    def to(self, device, dtype):
        """Move to ``device``; float tables become ``dtype``."""
        return ChebTables(*[
            t.to(device=device,
                 dtype=(torch.bool if t.dtype == torch.bool else dtype))
            for t in self])


class ChebRaytracer:
    """Batched multi-source raytracer, Chebyshev-face formulation.

    Same ``trace`` contract as the JAX engine. ``device`` defaults to the
    GPU; ``device="cpu"`` runs the plain PyTorch sweep. ``fuse_rates``,
    ``fuse_fold`` and ``shell_segment`` select the sweep mode with the JAX
    engine's names and defaults (see the module docstring); ``fuse_fold``
    wins over ``fuse_rates``. ``do_heating`` adds the photoheating channel:
    ``trace`` then returns (phi, heat)."""

    def __init__(self, N, R_max_LLS, sig, bins: SpectralBins,
                 batch_size=8, dtype=torch.float32, device="cuda",
                 do_heating=False, fuse_rates=False, fuse_fold=False,
                 shell_segment="auto"):
        self.N = int(N)
        self.R_max_LLS = float(R_max_LLS)
        self.sig = float(sig)
        self.batch_size = int(batch_size)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.do_heating = bool(do_heating)
        self.fuse_rates = bool(fuse_rates)
        self.fuse_fold = bool(fuse_fold)
        self.config = RaytraceConfig(
            N=self.N, R_max_LLS=self.R_max_LLS, sig=self.sig,
            batch_size=self.batch_size, dtype=dtype,
            grey_analytic=(bins.num_bins == 1), do_heating=self.do_heating)
        # Box half-extent: ceil(R) in Chebyshev metric (every rated cell
        # and all its stencil parents live inside); the L1 octahedron
        # membership bound stays at the reference's sqrt(3)R.
        r_cube = int(np.ceil(min(float(R_max_LLS), float(N))))
        self.geom: ChebGeometry = build_cheb_geometry(
            self.N, max_q_for(R_max_LLS, N), r_cube=r_cube)
        g = self.geom
        self.num_bins = bins.num_bins
        # Rates subbox: every rated cell (Euclidean dist <= R) lies in the
        # central (2 ceil(R)+1)^3 cube; the rate pass runs there only when
        # that is a real saving over the full box (the JAX engine's rule,
        # kept so both evaluate the same cells).
        rs = int(np.ceil(min(float(R_max_LLS), float(N))))
        b0 = max(0, g.c - rs)
        b1 = min(g.Dc, g.c + rs + 1)
        if (b1 - b0) ** 3 > 0.7 * g.Dc ** 3:
            b0, b1 = 0, g.Dc
        self._rb0 = b0
        self._rb1 = b1
        self.Ds = b1 - b0
        self.seg_S, self.seg_K = shell_segmentation(
            self.N, self.R_max_LLS, self.batch_size, dtype, shell_segment,
            fused=self.fuse_rates or self.fuse_fold)
        self.tables = ChebTables(
            sw=torch.from_numpy(g.sw),
            path=torch.from_numpy(g.path),
            diag=torch.from_numpy(g.diag),
            mask_p=torch.from_numpy(g.mask_p),
            mask_m=torch.from_numpy(g.mask_m),
            rt_sub=torch.from_numpy(self._build_rt_sub()),
            rt_tab=torch.from_numpy(pack_rates_tables(
                g, self.R_max_LLS ** 2, np.float64)),
            bins_s=torch.from_numpy(np.asarray(bins.s, np.float64)),
            bins_w=torch.from_numpy(np.asarray(bins.w_photo, np.float64)),
            bins_wh=torch.from_numpy(np.asarray(bins.w_heat, np.float64)),
        ).to(self.device, dtype)

    def _build_rt_sub(self):
        """Host-side build of the stacked rates-subbox tables: channels
        (path3, geominv, valid) where geominv = 1/(4 pi dist2 path3) with
        the source cell set to 1 and valid folds the octahedron/clip mask
        and the R_max_LLS cutoff. Built in float64."""
        g = self.geom
        sub3 = (slice(self._rb0, self._rb1),) * 3
        path3 = np.asarray(g.path3[sub3], np.float64)
        dist2 = np.asarray(g.dist2[sub3], np.float64)
        valid = (np.asarray(g.rate_valid[sub3])
                 & (dist2 <= float(self.R_max_LLS) ** 2))
        cs = g.c - self._rb0
        with np.errstate(divide="ignore"):
            geominv = 1.0 / (dist2 * path3 * FOURPI)
        geominv[cs, cs, cs] = 1.0     # source cell: vol = dr^3, tau_in=0
        return np.stack([path3, geominv, valid]).astype(np.float64)

    # ------------------------------------------------------------------
    def prepare_sources(self, src_pos, src_flux):
        """Pad the catalog to whole batches (zero-flux sources at the
        origin). Returns (pos_b, flux_b): int64 CPU positions (nb, B, 3)
        and fluxes (nb, B) on the engine's device."""
        B = self.batch_size
        ns = np.asarray(src_flux).shape[0]
        nb = -(-ns // B)
        pos = np.zeros((nb * B, 3), dtype=np.int64)
        flx = np.zeros((nb * B,), dtype=np.float64)
        pos[:ns] = np.asarray(src_pos, dtype=np.int64)
        flx[:ns] = np.asarray(src_flux, dtype=np.float64)
        return (torch.from_numpy(pos.reshape(nb, B, 3)),
                torch.from_numpy(flx.reshape(nb, B)).to(self.device,
                                                        self.dtype))

    def _extract_boxes(self, padded, pos):
        """(B, Dc, Dc, Dc) boxes of ``padded`` starting at ``pos`` (B, 3)."""
        ar = torch.arange(self.geom.Dc, device=padded.device)
        i, j, k = (pos[:, ax, None] + ar for ax in range(3))
        return padded[i[:, :, None, None], j[:, None, :, None],
                      k[:, None, None, :]]

    def _rates(self, cd, nhi_box, flux, dr):
        """Dense spectral-bin rate pass over the central rates subbox.

        Inputs are full (B, Dc, Dc, Dc) boxes and ``dr`` a 0-dim tensor of
        the engine's dtype; returns (phi, heat) of shape (B, Ds, Ds, Ds), to
        be accumulated at box position + rb0; heat is None without
        ``do_heating``."""
        tb = self.tables
        dt, dev = self.dtype, self.device
        sig = torch.tensor(self.sig, dtype=dt).to(dev)
        b0, b1 = self._rb0, self._rb1
        cd = cd[:, b0:b1, b0:b1, b0:b1]
        nhi_box = nhi_box[:, b0:b1, b0:b1, b0:b1]
        path3, geominv = tb.rt_sub[0], tb.rt_sub[1]
        dcol = nhi_box * (path3[None] * dr)
        cdin = cd - dcol
        tau_in = cdin * sig
        dtau = dcol * sig

        s_over_dr3 = torch.exp(
            torch.tensor(np.log(S_STAR_REF), dtype=dt).to(dev)
            - 3.0 * torch.log(dr))
        prefact = flux[:, None, None, None] * s_over_dr3 * geominv[None]

        acc = torch.zeros_like(cd)
        acc_h = torch.zeros_like(cd) if self.do_heating else None
        for e in range(self.num_bins):
            se = tb.bins_s[e]
            core = torch.exp(-tau_in * se) * (-torch.expm1(-dtau * se))
            acc = acc + tb.bins_w[e] * core
            if self.do_heating:
                acc_h = acc_h + tb.bins_wh[e] * core

        mask = ((tb.rt_sub[2] > 0.5)[None]
                & (cdin <= torch.tensor(MAX_COLDENSH, dtype=dt).to(dev)))
        # Guard the photon-conserving division: a zero-density cell
        # absorbs nothing (acc = 0), so Gamma-per-atom is 0, not 0/0. The
        # floor is the smallest normal float, a no-op for any physical
        # density.
        nhi_safe = torch.clamp(nhi_box, min=torch.finfo(dt).tiny)
        zero = torch.zeros_like(acc)
        phi = torch.where(mask, prefact * acc / nhi_safe, zero)
        heat = (torch.where(mask, prefact * acc_h / nhi_safe, zero)
                if self.do_heating else None)
        return phi, heat

    def _sweep_segmented(self, boxes, dr, sig):
        """The coldensh_out box by K segments of seg_S shells, each
        starting from the previous segment's last planes, all storing into
        one box; then the source cell."""
        g, tb = self.geom, self.tables
        planes = init_planes(boxes, g.c, dr)
        src_cd = planes[:, 0, 0, g.c, g.c].clone()
        box = torch.zeros_like(boxes)
        for k in range(self.seg_K):
            box, planes = cheb_sweep_seg(
                boxes, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p, dr,
                g.c, sig, planes, 1 + k * self.seg_S, self.seg_S, box)
        box[:, g.c, g.c, g.c] = src_cd
        return box

    def sweep_box(self, boxes, dr, sig):
        """The coldensh_out box of (B, Dc, Dc, Dc) absorber boxes at the
        threshold cross section ``sig``: K1, or K2 in seg_K segments where
        the engine segments (the helium engine sweeps each species
        through this)."""
        if self.seg_S:
            return self._sweep_segmented(boxes, dr, sig)
        tb = self.tables
        return cheb_sweep(boxes, tb.sw, tb.path, tb.diag, tb.mask_m,
                          tb.mask_p, dr, self.geom.c, sig)

    def _batch_rates(self, boxes, flux, dr, dr_t):
        """One batch's (phi, heat) rate boxes by the engine's sweep mode:
        the (Dc)^3 box for the fused modes, else the (Ds)^3 rates subbox.
        heat is None without ``do_heating``; with it, ``fuse_rates`` takes
        the unfused path."""
        g, tb = self.geom, self.tables
        geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
        c = g.c
        if self.fuse_fold:
            out = cheb_sweep_rates(
                boxes, *geo, tb.rt_tab, flux, dr, c, self.sig, tb.bins_s,
                tb.bins_w, bins_wh=tb.bins_wh if self.do_heating else None)
            return out if self.do_heating else (out, None)
        if self.fuse_rates and not self.do_heating:
            return cheb_sweep(boxes, *geo, dr, c, self.sig,
                              bins=(tb.bins_s, tb.bins_w), rt_tab=tb.rt_tab,
                              R2=self.R_max_LLS ** 2, flux=flux), None
        return self._rates(self.sweep_box(boxes, dr, self.sig), boxes, flux,
                           dr_t)

    def _fold_padding(self, padded):
        """The extended grid folded onto the periodic N^3 grid."""
        return fold_padding(padded, self.geom.c, self.geom.Dc)

    def trace_extended(self, nhi_pad, pos_b, flux_b, dr):
        """Batched sweep over the wrap-padded field; returns (phi, heat)
        accumulated in the same extended frame, heat None without
        ``do_heating``."""
        phi_pad = torch.zeros_like(nhi_pad)
        heat_pad = torch.zeros_like(nhi_pad) if self.do_heating else None
        dr_t = torch.tensor(dr, dtype=self.dtype).to(self.device)
        for pos, flux in zip(pos_b, flux_b):
            boxes = self._extract_boxes(nhi_pad, pos.to(self.device))
            phi_box, heat_box = self._batch_rates(boxes, flux, dr, dr_t)
            self.add_boxes(phi_pad, phi_box, pos)
            if heat_pad is not None:
                self.add_boxes(heat_pad, heat_box, pos)
        return phi_pad, heat_pad

    def add_boxes(self, pad, rate_boxes, pos):
        """Add each source's rate box into the padded grid ``pad``, source
        by source in batch order: the (Dc)^3 box at the source's box
        corner ``pos`` (B, 3), a (Ds)^3 rates subbox rb0 further in."""
        shift = self._rb0 if rate_boxes.shape[-1] == self.Ds else 0
        add_boxes(pad, rate_boxes, pos, shift)

    def wrap_pad(self, field3):
        """The (N, N, N) field wrap-padded to the extended frame."""
        return wrap_pad(field3, self.geom.c, self.geom.Dc)

    def trace_batches(self, nd, xh, pos_b, flux_b, dr):
        """Batched trace on prepared sources with flat-grid IO; returns
        (phi, heat), heat None without ``do_heating``."""
        N = self.N
        nhi3 = nd.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3))
        phi_pad, heat_pad = self.trace_extended(self.wrap_pad(nhi3), pos_b,
                                                flux_b, float(dr))
        phi = self._fold_padding(phi_pad).reshape(-1)
        if heat_pad is None:
            return phi, None
        return phi, self._fold_padding(heat_pad).reshape(-1)

    def shard_trace(self, nd, xh, pos_b, flux_b, dr):
        """A rank's partial Gamma (and heat) over its own batches, folded
        onto the whole grid with flat IO and no reduce: the body of the
        source-parallel step (parallel/source_parallel.py), which
        all-reduces it. Returns (phi, heat), heat None without
        ``do_heating``."""
        return self.trace_batches(nd, xh, pos_b, flux_b, dr)

    def trace(self, ndens, xh_av, src_pos, src_flux, dr):
        """Public API (0-indexed positions, (NumSrc, 3)); returns the
        (N, N, N) photoionization rate on the engine's device, and with
        ``do_heating`` the pair (phi, heat). ``ndens`` and ``xh_av`` are
        numpy arrays or tensors; a tensor already on the engine's device is
        used where it is."""
        sh = (self.N,) * 3
        nd = torch.as_tensor(ndens, dtype=self.dtype,
                             device=self.device).reshape(sh)
        xh = torch.as_tensor(xh_av, dtype=self.dtype,
                             device=self.device).reshape(sh)
        pos_b, flux_b = self.prepare_sources(src_pos, src_flux)
        phi, heat = self.trace_batches(nd, xh, pos_b, flux_b, dr)
        if self.do_heating:
            return phi.reshape(sh), heat.reshape(sh)
        return phi.reshape(sh)
