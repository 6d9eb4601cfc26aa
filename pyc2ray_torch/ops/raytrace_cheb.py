"""Chebyshev-face raytracing engine, PyTorch port.

Twin of pyc2ray_tpu/ops/raytrace_cheb.py::ChebRaytracer with the Pallas
sweep (per-source scan accumulate, no lane packing). Per batch of B
sources:

  1. cut the (Dc, Dc, Dc) HI-density box of every source out of the
     wrap-padded grid (``trace_loop.extract_boxes``);
  2. compute the rate box, by one of the JAX engine's four sweep modes
     (each a CUDA kernel on the GPU and its plain version on the CPU, see
     ops/sweep.py):
       - default: sweep the cube shells to the coldensh_out box (K1,
         ``sweep.cheb_sweep``), then evaluate the spectral-bin
         photoionization rates over the central rates subbox (``_rates``:
         the kernel of ops/cheb_rates.py, at the subbox's rated cells,
         ``rated_cells``, listed once per engine);
       - ``shell_segment``: the same sweep as K segments of S shells with
         carried planes (K2, ``sweep.cheb_sweep_segmented``), then
         ``_rates``;
       - ``fuse_rates``: the sweep evaluates the Gamma of every face cell
         (K1f), the source cell by its closed form
         (``sweep.source_cell_rate``), in one call;
       - ``fuse_fold``: sweep, box assembly and rates with the flux and the
         source cell's closed form in one kernel (K3);
  3. add each source's rate box into the padded Gamma grid, source by
     source in batch order (the JAX engine's scan accumulate;
     ``trace_loop.accumulate_boxes``).

After the last batch the padding is folded back onto the periodic grid
(``_fold_padding``). A trace copies its positions to the device once, and
its whole batch loop is one call of ``trace_loop.cheb_trace_sweep`` in
every mode (``fuse_fold`` is what the model layer builds), the counterpart
of the JAX engine's jitted ``lax.scan``; on the card a loop in C issues the
launches of every batch.
``trace_extended_plain`` keeps the loop as it was issued before (a gather,
the sweep mode with the plain rate pass, one slice add per source), the
reference the card holds the loop against.

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

from ..device import resolve_device
from ..radiation.spectral_bins import SpectralBins
from .cheb_geometry import (ChebGeometry, box_dims, build_cheb_geometry,
                            pack_rates_tables)
from .cheb_rates import rated_cells, rates_dense
from .geometry import max_q_for
from .raytrace import RaytraceConfig
from .sweep import cheb_sweep, cheb_sweep_segmented, rate_consts
from .trace_loop import (cheb_trace_sweep, cheb_trace_sweep_ref, fold_padding,
                         stage_positions, wrap_pad)

__all__ = ["ChebRaytracer", "ChebTables", "shell_segmentation"]

FOURPI = 12.566370614359172463991853874177


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

    @property
    def tables(self):
        """The engine's device tables (ChebTables)."""
        return self._tables

    @tables.setter
    def tables(self, tables):
        """Set the tables (the engine's own, or the JAX engine's through
        ``convert.state_from_jax`` moved with ``ChebTables.to``) and list
        the cells their ``rt_sub`` rates once, in ``rated_cells`` (int32,
        ascending, on the tables' device; one wait for the device): the
        cells the rate pass's kernel evaluates, in every trace."""
        self._tables = tables
        self.rated_cells = rated_cells(tables.rt_sub)

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

    def _rates(self, cd, nhi_box, flux, dr):
        """The dense spectral-bin rate pass over the central rates subbox
        (ops/cheb_rates.py::rates_dense: the plain version for CPU boxes,
        the kernel for CUDA ones). ``cd`` and ``nhi_box`` are full (B, Dc,
        Dc, Dc) boxes, ``flux`` (B,) and ``dr`` a float; returns (phi, heat)
        of shape (B, Ds, Ds, Ds), to be accumulated at box position + rb0;
        heat is None without ``do_heating``."""
        tb = self.tables
        return rates_dense(cd, nhi_box, tb.rt_sub, flux, tb.bins_s, tb.bins_w,
                           dr, self.sig, rate_consts(dr, self.dtype)[1],
                           self._rb0,
                           bins_wh=tb.bins_wh if self.do_heating else None,
                           cells=self.rated_cells)

    def sweep_box(self, boxes, dr, sig):
        """The coldensh_out box of (B, Dc, Dc, Dc) absorber boxes at the
        threshold cross section ``sig``: K1, or K2 in seg_K segments where
        the engine segments (the helium engine sweeps each species
        through this)."""
        tb = self.tables
        geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
        if self.seg_S:
            return cheb_sweep_segmented(boxes, *geo, dr, self.geom.c, sig,
                                        self.seg_S, self.seg_K)
        return cheb_sweep(boxes, *geo, dr, self.geom.c, sig)

    def _fold_padding(self, padded):
        """The extended grid folded onto the periodic N^3 grid."""
        return fold_padding(padded, self.geom.c, self.geom.Dc)

    def trace_extended(self, nhi_pad, pos_b, flux_b, dr):
        """Batched sweep over the wrap-padded field ``nhi_pad`` (or any
        frame that holds every box, as a domain's halo-extended block);
        returns (phi, heat) accumulated in the same frame, heat None without
        ``do_heating``. The positions go to the frame's device once, and
        the batch loop is one ``cheb_trace_sweep`` call."""
        g = self.geom
        pos = stage_positions(pos_b, nhi_pad.shape, g.Dc, nhi_pad.device)
        return cheb_trace_sweep(nhi_pad, pos, flux_b, self.tables, dr, g.c,
                                self.sig, cells=self.rated_cells,
                                **self._sweep_mode())

    def trace_extended_plain(self, nhi_pad, pos_b, flux_b, dr):
        """``trace_extended`` as the batch loop was issued before the trace
        loop: per batch a copy of the positions to the device, the PyTorch
        gather (``extract_boxes_ref``), the sweep mode with the plain rate
        pass and one slice add per source (``add_boxes``):
        ``cheb_trace_sweep_ref``. The same result bit for bit; on the card
        the plain reference of the loop and its kernels."""
        return cheb_trace_sweep_ref(nhi_pad, pos_b, flux_b, self.tables, dr,
                                    self.geom.c, self.sig,
                                    **self._sweep_mode())

    def _sweep_mode(self):
        """The sweep mode of a trace, as ``cheb_trace_sweep`` takes it:
        fuse_fold (K3, K3h with do_heating), fuse_rates (K1f) without
        do_heating, else K1 or K2 and the rate pass."""
        fuse = ("fold" if self.fuse_fold else
                "rates" if self.fuse_rates and not self.do_heating else None)
        return dict(R2=self.R_max_LLS ** 2, seg=(self.seg_S, self.seg_K),
                    rb0=self._rb0, fuse=fuse, heat=self.do_heating)

    def box_shift(self, rate_boxes):
        """Where a batch's rate boxes start inside a source's box: 0 for
        the (Dc)^3 box, rb0 for a (Ds)^3 rates subbox."""
        return self._rb0 if rate_boxes.shape[-1] == self.Ds else 0

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
