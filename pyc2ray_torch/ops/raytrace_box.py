"""The octahedral sheet ("box") raytracing engine, PyTorch port.

Twin of pyc2ray_tpu/ops/raytrace_box.py::BoxRaytracer (``engine: box``):
the same short-characteristics physics as the flat engine (ops/raytrace.py)
over the L1 octahedron around each source, laid out as two 2D sheets per
shell q (ops/sheet_geometry.py), and the spectral-bin rates of the
Chebyshev engine. The neutral density is wrap-padded once per trace; per
batch of B sources:

  1. extract and shear: one gather cuts every source's sheet stack
     (B, 2, Q, Dc, Dc) out of the padded grid (the box around the source,
     sheared along z by the tables' ``zidx``);
  2. sweep: shell after shell, q = 1 .. Q-1. The four interpolation
     corners of every cell of the two sheets lie in shells q-1 .. q-3 at
     (i, j) or one step toward the source axis (``corner_idx``, built from
     the tables' ``in_z``/``in_y`` selectors), then the reference's weights
     s / max(0.6, c sigma), their two sums added in the JAX engine's order.
     The shell's incoming column density is kept for the rate pass;
  3. rate pass: the spectral-bin sum, the photoheating channel with
     ``do_heating``;
  4. unshear (the top sheet for z >= the source's plane) and accumulate:
     each source's (Dc)^3 box is added into the padded grid in batch order.

The padding is folded back once at the end of the trace. The frame and its
helpers (``wrap_pad``, ``fold_padding``, the ordered slice adds
``add_boxes`` and the accumulate kernel that matches them) are those of the
Chebyshev engine (ops/trace_loop.py).

On the CPU ``trace_batches`` runs the plain loop ``box_trace_sweep_ref``
(the functions ``_sheets``, ``_sweep``, ``_rates``, ``_unshear`` and the
slice adds, batch after batch); on the card one call of
ops/box_sweep.py::box_trace_sweep, the counterpart of the JAX engine's jit
program: a loop in C of hand-written kernels that visit the octahedron's
valid sheet cells only (``kernel_tables``), the gather, the sweep (a block a
source, a barrier a shell), the rate pass over the rated cells straight
into the rate boxes, and the accumulate over those cells.

Two faults of the JAX engine are not copied. Its rate pass divides by the
cell's nHI without a floor, so a zero-density cell inside the octahedron
gets 0/0 = NaN; here nHI is floored at the dtype's smallest normal number,
as in ChebRaytracer._rates, and the cell gets 0. It also rebuilds the
incoming column density as coldensh_out - nHI path dr, which cancels in
float32 at cells behind a thick column; here the sweep's own value is
used.

The engine has no ``shard_trace`` and no ``trace_extended``, as in the JAX
package, so the model layer refuses it under a mesh.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..constants import MAX_COLDENSH
from ..device import resolve_device
from ..radiation.spectral_bins import SpectralBins
from .geometry import max_q_for
from .raytrace import RaytraceConfig
from .raytrace_cheb import FOURPI
from .sheet_geometry import SheetGeometry, build_sheet_geometry
from . import box_sweep as bs
from .sweep import s_over_dr3
from .trace_loop import add_boxes, fold_padding, stage_positions, wrap_pad

__all__ = ["BoxRaytracer", "BoxTables", "build_box_tables",
           "build_kernel_tables", "grey_bins"]


def grey_bins():
    """Single-bin spectrum: exactly the reference grey test case
    (photoion_rates_test, photorates.f90:13-57)."""
    return SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                        w_heat=np.array([0.0]), num_bins=1)


class BoxTables(NamedTuple):
    """Device tables of the engine; S = Dc * Dc cells per sheet."""
    shear_idx: torch.Tensor    # (2 Q S,) int64 offset in the padded grid of
                               #   sheet cell (f, q, i, j) from the box corner
    corner_idx: torch.Tensor   # (Q, 4, S) int64 index into the (Q S) cells
                               #   of a sheet stack of the corners c1..c4
    sw: torch.Tensor           # (Q, 4, S) corner weights
    path: torch.Tensor         # (Q, S) path in cell units
    diag: torch.Tensor         # (Q, S) diagonal factor
    valid: torch.Tensor        # (Q, 2, S) bool sweep validity
    geominv: torch.Tensor      # (Q, S) 1 / (4 pi dist2 path), 1 at the source
    rated: torch.Tensor        # (2, Q, S) bool rate validity & dist2 <= R^2
    unshear_idx: torch.Tensor  # (Dc^3,) int64 index into the (2 Q S) cells
    unshear_valid: torch.Tensor  # (Dc^3,) bool box cell in the octahedron
    bins_s: torch.Tensor       # (E,) spectral bins
    bins_w: torch.Tensor
    bins_wh: torch.Tensor


def build_box_tables(g: SheetGeometry, N, R_max_LLS):
    """The engine's tables from the sheet geometry, in numpy (float64 and
    int64), without the bins."""
    Dc, Q, c = g.Dc, g.Q, g.c
    S = Dc * Dc
    P = N + Dc - 1                              # side of the padded grid
    ij = np.arange(Dc)
    I, J = np.meshgrid(ij, ij, indexing="ij")   # (Dc, Dc)
    # shear: sheet (f, q) cell (i, j) is box cell (i, j, zidx[i, j, f Q + q])
    z = np.transpose(g.zidx.reshape(Dc, Dc, 2, Q), (2, 3, 0, 1))
    shear_idx = (I * P * P + J * P + z.astype(np.int64)).reshape(-1)
    # one step toward the source axis along i (SX) and j (SY), clamped at
    # the box edge as the JAX engine's concatenated shifts are
    step = np.where(ij >= c, np.maximum(ij - 1, 0), np.minimum(ij + 1, Dc - 1))
    SX, SY = step[I], step[J]
    in_z, in_y = g.in_z, g.in_y                 # (Q, Dc, Dc)
    cell = I * Dc + J
    c1 = np.broadcast_to(SX * Dc + SY, in_z.shape)
    c2 = np.where(in_z | in_y, I * Dc + SY, SX * Dc + J)
    c3 = np.where(in_z, SX * Dc + J, SX * Dc + SY)
    c4 = np.where(in_z, cell, np.where(in_y, I * Dc + SY, SX * Dc + J))
    q = np.arange(Q)[:, None, None]
    sheets = [np.maximum(q - k, 0) for k in (3, 2, 2, 1)]
    corner_idx = np.stack([sh * S + ci for sh, ci in
                           zip(sheets, (c1, c2, c3, c4))], axis=1)
    # unshear: box cell (i, j, z) is sheet (z < c, qidx) cell (i, j)
    face = np.where(g.k_nonneg, 0, 1).astype(np.int64)
    unshear_idx = (face * Q * S + g.qidx.astype(np.int64) * S
                   + cell[:, :, None])
    is_src = np.zeros((Q, Dc, Dc), dtype=bool)
    is_src[0, c, c] = True
    with np.errstate(divide="ignore"):
        geominv = np.where(is_src, 1.0, 1.0 / (g.dist2 * g.path * FOURPI))
    rated = (np.stack([g.rate_top, g.rate_bot])
             & (g.dist2 <= float(R_max_LLS) ** 2))
    return dict(
        shear_idx=shear_idx,
        corner_idx=corner_idx.reshape(Q, 4, S).astype(np.int64),
        sw=np.transpose(g.sw, (1, 0, 2, 3)).reshape(Q, 4, S),
        path=g.path.reshape(Q, S), diag=g.diag.reshape(Q, S),
        valid=np.stack([g.valid_top, g.valid_bot], axis=1).reshape(Q, 2, S),
        geominv=geominv.reshape(Q, S), rated=rated.reshape(2, Q, S),
        unshear_idx=unshear_idx.reshape(-1),
        unshear_valid=g.unshear_valid.reshape(-1))


def build_kernel_tables(g: SheetGeometry, tb):
    """The kernels' index tables (numpy int64) over the octahedron's valid
    sheet cells, from the sheet geometry and ``tb``, build_box_tables' dict:

    * ``vq``, ``vf``, ``vs``: shell, sheet and cell (i Dc + j) of each valid
      sheet cell, in the order (q, f, s); ``shell`` (Q + 1,): the first
      valid cell of each shell;
    * ``voff``: each valid cell's offset in the padded grid from its box
      corner;
    * ``corner`` (4, n_v): the valid cell of each corner of each valid cell
      of shells q >= 1, -1 where the corner lies outside the octahedron
      (the plain stack holds 0 there); -1 in shell 0;
    * ``rv``: the rated valid cells, ``rcell``: their box cells, ascending
      (each rated sheet cell is one box cell; checked against the unshear
      map).
    """
    Dc, Q = g.Dc, g.Q
    S = Dc * Dc
    vq, vf, vs = np.nonzero(tb["valid"])                  # (Q, 2, S)
    n_v = vq.size
    cmap = np.full((2, Q * S), -1, dtype=np.int64)
    cmap[vf, vq * S + vs] = np.arange(n_v)
    corner = cmap[vf[None, :], tb["corner_idx"][vq, :, vs].T]
    corner[:, vq == 0] = -1
    # corner k lies in shell max(q - lag, 0), lag 3, 2, 2, 1 (the sweep's
    # ring reads it there)
    for k, lag in enumerate((3, 2, 2, 1)):
        c = corner[k] >= 0
        if np.any(vq[corner[k][c]] != np.maximum(vq[c] - lag, 0)):
            raise AssertionError("box engine: a corner outside its shell")
    shell = np.searchsorted(vq, np.arange(Q + 1))
    stack = (vf * Q + vq) * S + vs
    rv = np.flatnonzero(tb["rated"].reshape(-1)[stack])
    i, j = vs[rv] // Dc, vs[rv] % Dc
    z = g.zidx[i, j, vf[rv] * Q + vq[rv]].astype(np.int64)
    box = (i * Dc + j) * Dc + z
    order = np.argsort(box, kind="stable")
    rv, rcell = rv[order], box[order]
    if (np.any(np.diff(rcell) <= 0) or not tb["unshear_valid"][rcell].all()
            or np.any(tb["unshear_idx"][rcell] != stack[rv])):
        raise AssertionError("box engine: the rated sheet cells are not "
                             "one box cell each")
    return dict(vq=vq, vf=vf, vs=vs, shell=shell,
                voff=tb["shear_idx"][stack], corner=corner, rv=rv,
                rcell=rcell)


class BoxRaytracer:
    """Batched multi-source raytracer, octahedral sheet formulation.

    Parameters
    ----------
    N : mesh size
    R_max_LLS : photon horizon in cell units (sets the octahedron size)
    sig : HI cross section at threshold (cm^2)
    bins : SpectralBins (``grey_bins()`` for the grey test case)
    batch_size : sources swept concurrently
    dtype : torch.float32 or torch.float64
    do_heating : accumulate the photoheating rates too
    device : where the engine runs, the GPU by default; "cpu" runs the same
        plain PyTorch code there
    """

    def __init__(self, N, R_max_LLS, sig, bins: SpectralBins,
                 batch_size=8, dtype=torch.float32, do_heating=False,
                 device="cuda"):
        self.N = int(N)
        self.R_max_LLS = float(R_max_LLS)
        self.sig = float(sig)
        self.batch_size = int(batch_size)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.do_heating = bool(do_heating)
        self.num_bins = bins.num_bins
        self.geom: SheetGeometry = build_sheet_geometry(
            self.N, max_q_for(R_max_LLS, N))
        self.config = RaytraceConfig(
            N=self.N, R_max_LLS=self.R_max_LLS, sig=self.sig,
            batch_size=self.batch_size, dtype=dtype,
            grey_analytic=(bins.num_bins == 1), do_heating=self.do_heating)
        tb = build_box_tables(self.geom, self.N, self.R_max_LLS)
        tb.update(bins_s=np.asarray(bins.s, np.float64),
                  bins_w=np.asarray(bins.w_photo, np.float64),
                  bins_wh=np.asarray(bins.w_heat, np.float64))

        def dev(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if t.dtype == torch.float64:
                t = t.to(dtype)
            return t.to(self.device)
        self.tables = BoxTables(**{k: dev(v) for k, v in tb.items()})
        self._tb_np = tb
        self._kernel_tables = None

    def kernel_tables(self):
        """The kernels' tables (ops/box_sweep.py's BoxKernelTables), made
        once, on the engine's device: ``build_kernel_tables``' index tables
        as int32 and, in the engine's dtype, each valid cell's corner
        weights, path and diag and each rated cell's geominv (the engine's
        own tables at those cells), the rated cells as the accumulate's
        visit (a (Dc, Dc, Dc) 1 at each), and the bins."""
        if self._kernel_tables is None:
            g, tb = self.geom, self.tables
            kt = build_kernel_tables(g, self._tb_np)
            P = self.N + g.Dc - 1
            if g.Dc * P * P >= 2 ** 31:
                raise ValueError(f"box engine: a padded grid of {P}^3 cells "
                                 "needs 64-bit offsets")
            dev = self.device

            def idx(k):
                return torch.from_numpy(kt[k]).to(dev)
            vq, vs, rv = idx("vq"), idx("vs"), idx("rv")
            visit = torch.zeros(g.Dc ** 3, dtype=self.dtype, device=dev)
            visit[idx("rcell")] = 1.0

            def i32(k):
                return idx(k).to(torch.int32)
            self._kernel_tables = bs.pack_tables(
                ints=(i32("shell"), i32("voff"), i32("corner"), i32("rv"),
                      i32("rcell")),
                floats=(tb.sw[vq, :, vs].T, tb.path[vq, vs], tb.diag[vq, vs],
                        tb.geominv[vq[rv], vs[rv]], visit, tb.bins_s,
                        tb.bins_w, tb.bins_wh),
                sizes=dict(n_v=int(kt["vq"].size), Q=g.Q, Dc=g.Dc,
                           n_r=int(kt["rv"].size), E=self.num_bins, P=P,
                           max_shell=int(np.diff(kt["shell"]).max())),
                sig=self.sig, dtype=self.dtype, heat=self.do_heating)
        return self._kernel_tables

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

    # ------------------------------------------------------------------
    def _sheets(self, nhi_pad, pos):
        """(B, 2, Q, S) HI-density sheet stacks of the sources at box
        corners ``pos`` (B, 3) on the frame's device, cut and sheared in one
        gather."""
        P = nhi_pad.shape[0]
        pos = pos.to(torch.int64)
        base = (pos[:, 0] * P + pos[:, 1]) * P + pos[:, 2]
        idx = base[:, None] + self.tables.shear_idx
        g = self.geom
        return nhi_pad.reshape(-1)[idx].view(
            pos.shape[0], 2, g.Q, g.Dc * g.Dc)

    def _sweep(self, H_nhi, pathdr, dr):
        """The causal shell sweep over the sheet stacks (B, 2, Q, S);
        returns the incoming column density of every cell (0 at the
        source, unmasked elsewhere). The outgoing one lives in a working
        stack, 0 outside the octahedron."""
        tb, g = self.tables, self.geom
        B, Q = H_nhi.shape[0], g.Q
        S = g.Dc * g.Dc
        H_cd = torch.zeros_like(H_nhi)
        cdin = torch.zeros_like(H_nhi)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        src = g.c * g.Dc + g.c
        # q = 0: the source cell, coldensh_out = nHI dr/2 in both sheets
        H_cd[:, :, 0, src] = H_nhi[:, :, 0, src] * (0.5 * dr)
        flat = H_cd.view(B, 2, Q * S)
        for q in range(1, Q):
            cor = flat[:, :, tb.corner_idx[q]]            # (B, 2, 4, S)
            w = cor * self.sig
            w.clamp_(min=0.6)
            torch.div(tb.sw[q], w, out=w)
            cor.mul_(w)
            # the two sums in the JAX engine's order, c1 w1 + .. + c4 w4
            # and w1 + .. + w4 (a reduction's order is the library's)
            num = torch.mul(tb.diag[q], cor[:, :, 0] + cor[:, :, 1]
                            + cor[:, :, 2] + cor[:, :, 3])
            torch.div(num, w[:, :, 0] + w[:, :, 1] + w[:, :, 2] + w[:, :, 3],
                      out=cdin[:, :, q])
            cdout = cdin[:, :, q] + H_nhi[:, :, q] * pathdr[q]
            torch.where(tb.valid[q], cdout, zero, out=H_cd[:, :, q])
        return cdin

    def _rates(self, cdin, H_nhi, pathdr, flux, s_dr3):
        """Spectral-bin rate pass over the sheet stacks:
        Gamma = prefact sum_e w_e e^(-tau_in s_e) (-expm1(-dtau s_e)) / nHI,
        and the heat with the weights ``bins_wh``. Returns (phi, heat)
        stacks, heat None without ``do_heating``."""
        tb = self.tables
        dt = self.dtype
        tau_in = cdin * self.sig
        dtau = (H_nhi * pathdr) * self.sig
        prefact = flux[:, None, None, None] * s_dr3 * tb.geominv
        acc = torch.zeros_like(cdin)
        acc_h = torch.zeros_like(cdin) if self.do_heating else None
        for e in range(self.num_bins):
            se = tb.bins_s[e]
            core = torch.exp(-tau_in * se) * (-torch.expm1(-dtau * se))
            acc = acc + tb.bins_w[e] * core
            if self.do_heating:
                acc_h = acc_h + tb.bins_wh[e] * core
        mask = tb.rated & (cdin <= MAX_COLDENSH)
        # a zero-density cell absorbs nothing (acc = 0): its Gamma per atom
        # is 0, not 0/0
        nhi_safe = torch.clamp(H_nhi, min=torch.finfo(dt).tiny)
        zero = torch.zeros((), dtype=dt, device=self.device)
        phi = torch.where(mask, prefact * acc / nhi_safe, zero)
        heat = (torch.where(mask, prefact * acc_h / nhi_safe, zero)
                if self.do_heating else None)
        return phi, heat

    def _unshear(self, H):
        """Sheet stacks (B, 2, Q, S) -> boxes (B, Dc, Dc, Dc)."""
        tb = self.tables
        B, Dc = H.shape[0], self.geom.Dc
        box = H.reshape(B, -1)[:, tb.unshear_idx]
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.where(tb.unshear_valid, box, zero).view(B, Dc, Dc, Dc)

    def _batch_rates(self, nhi_pad, pos, flux, dr, pathdr, s_dr3):
        """One batch's (phi, heat) rate boxes (B, Dc, Dc, Dc); heat None
        without ``do_heating``."""
        H_nhi = self._sheets(nhi_pad, pos)
        cdin = self._sweep(H_nhi, pathdr, dr)
        phi, heat = self._rates(cdin, H_nhi, pathdr, flux, s_dr3)
        return (self._unshear(phi),
                None if heat is None else self._unshear(heat))

    def wrap_pad(self, nd, xh):
        """The padded nHI frame of the density and ionized fraction grids
        ((N^3,) or (N, N, N))."""
        g, N = self.geom, self.N
        nhi3 = nd.reshape((N,) * 3) * (1.0 - xh.reshape((N,) * 3))
        return wrap_pad(nhi3, g.c, g.Dc)

    def box_trace_sweep_ref(self, nd, xh, pos_b, flux_b, dr):
        """The plain loop: the trace of the batches ``pos_b`` (nb, B, 3),
        ``flux_b`` (nb, B) over the grids ``nd``, ``xh``, batch after
        batch the sheets, the sweep, the rate pass, the unshear and the
        slice adds (``add_boxes``, on either device). Returns (phi, heat) as
        (N^3,) tensors, heat None without ``do_heating``."""
        g = self.geom
        dr = float(dr)
        nhi_pad = self.wrap_pad(nd, xh)
        pads = [torch.zeros_like(nhi_pad)
                for _ in range(1 + self.do_heating)]
        dr_t = torch.tensor(dr, dtype=self.dtype).to(self.device)
        pathdr = self.tables.path * dr_t
        s_dr3 = s_over_dr3(dr, self.dtype).to(self.device)
        pos = stage_positions(pos_b, nhi_pad.shape, g.Dc, nhi_pad.device)
        for k in range(pos.shape[0]):
            boxes = self._batch_rates(nhi_pad, pos[k], flux_b[k], dr, pathdr,
                                      s_dr3)
            for pad, box in zip(pads, boxes):
                add_boxes(pad, box, pos[k])
        out = [fold_padding(p, g.c, g.Dc).reshape(-1) for p in pads]
        return out[0], (out[1] if self.do_heating else None)

    def trace_batches(self, nd, xh, pos_b, flux_b, dr):
        """Batched trace on prepared sources with flat-grid IO; returns
        (phi, heat) as (N^3,) tensors, heat None without ``do_heating``.
        The plain loop ``box_trace_sweep_ref`` on the CPU; on the card one
        call of ops/box_sweep.py::box_trace_sweep, the kernel loop, between
        the padding and its fold."""
        if nd.device.type == "cpu":
            return self.box_trace_sweep_ref(nd, xh, pos_b, flux_b, dr)
        g = self.geom
        nhi_pad = self.wrap_pad(nd, xh)
        sdr3 = s_over_dr3(float(dr), self.dtype).to(nd.device)
        pads = bs.box_trace_sweep(self.kernel_tables(), nhi_pad, pos_b,
                                  flux_b, sdr3, dr)
        out = [None if p is None else fold_padding(p, g.c, g.Dc).reshape(-1)
               for p in pads]
        return out[0], out[1]

    def trace(self, ndens, xh_av, src_pos, src_flux, dr):
        """Public API (0-indexed positions, (NumSrc, 3)); returns the
        (N, N, N) photoionization rate on the engine's device, and with
        ``do_heating`` the pair (phi, heat)."""
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
