"""The table-exact octahedral raytracer (the ``flat`` engine).

PyTorch twin of pyc2ray_tpu/ops/raytrace.py, the functional equivalent of
the ASORA raytracer (reference: src/asora/raytracing.cu:79-339,
rates.cu:16-83) with the reference's log-linear rate tables:

* Per source, cells are swept in octahedral shells of constant L1 distance
  q (ops/geometry.py's flat layout), each shell's cells interpolating the
  4 corner column densities of earlier shells and extending them. Shells
  are exact (the JAX engine pads them to fixed-shape buckets).
* Sources run in batches of B, each with a private column-density buffer
  in the octahedral layout. After the sweep, the photoionization (and
  heating) rates are one dense pass over the octahedron, which recovers
  the incoming column density from the outgoing one.
* Each source's rates are added into the flat N^3 grid, one source at a
  time in batch order. Within one source every cell index is unique (one
  periodic image).

A batch is four steps, each a plain function here: the octahedral gather of
nHI (``_gather``), the causal sweep (``_sweep``, one Python iteration per
shell), the rate pass (``_rates``) and the ordered accumulate
(``_accumulate``, one ``index_add_`` per source). ``trace_batches`` runs a
trace: on CPU tensors the plain loop of these functions
(``flat_trace_sweep_ref``), on the card one call of the loop of
hand-written kernels of csrc/flat_sweep.cu (ops/flat_sweep.py::
flat_trace_sweep: sweep, rates and accumulate per batch, no host sync), bit
for bit the plain loop's result. ``gather_batch``, ``sweep_batch``,
``rates_batch`` and ``accumulate_batch`` are the steps alone, each one
kernel launch on the card (the sweep's binding launches the gather
first). The kernels read the engine's tables as ``kernel_tables`` makes
them, once per engine. The engine has no Pallas kernel in the JAX package
(its sweep is XLA code, run as one jit program).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..constants import S_STAR_REF, TAU_PHOTO_LIMIT, MAX_COLDENSH
from ..device import resolve_device
from . import flat_sweep as fs
from .geometry import OctaGeometry, build_geometry, max_q_for

__all__ = ["RaytraceConfig", "Raytracer", "FlatTables"]

FOURPI = 12.566370614359172463991853874177  # value used by raytracing.cu:12


class RaytraceConfig(NamedTuple):
    """Static raytracer configuration.

    Attributes
    ----------
    N : mesh size (N^3 periodic grid)
    R_max_LLS : maximum photon travel distance in cell units (type-3 LLS,
        c2ray_base.py:460-462); also sets the octahedron size.
    sig : HI photoionization cross section at the threshold (cm^2)
    batch_size : number of sources swept concurrently (ASORA's
        ``source_batch_size``)
    dtype : working dtype for grid fields (torch.float64 or torch.float32)
    grey_analytic : the flat engine uses the analytic grey-opacity rates
        instead of tables (reference GREY_NOTABLES, rates.cu:48-64); the
        Chebyshev engines set it for a single grey bin
    do_heating : also accumulate photo-heating rates
    """
    N: int
    R_max_LLS: float
    sig: float
    batch_size: int = 8
    dtype: object = torch.float64
    grey_analytic: bool = False
    do_heating: bool = False


class FlatTables(NamedTuple):
    """Device tables of the flat engine, over the C in-clip cells of the
    octahedron (the JAX engine's padding to Cp is dropped)."""
    offsets: torch.Tensor   # (3, C) int64 cell offsets from the source
    nbr: torch.Tensor       # (4, C) int64 corner indices in the layout
    sw: torch.Tensor        # (4, C) geometric corner weights
    path: torch.Tensor      # (C,) path length through the cell, cell units
    diag: torch.Tensor      # (C,) diagonal correction
    geom: torch.Tensor      # (C,) 1 / (4 pi dist2 path), 1 at the source
    rated: torch.Tensor     # (C,) bool: dist2 <= R_max_LLS^2
    photo_thin: torch.Tensor    # (NumTau+1,) tables / S_star (or (1,) 0)
    photo_thick: torch.Tensor
    heat_thin: torch.Tensor
    heat_thick: torch.Tensor


CHUNKS = 16    # chunks of a shell in the corners' codes (csrc/flat_sweep.cuh)


def corner_codes(g):
    """The corners' codes of the sweep kernel over the geometry ``g``'s C
    cells, with the ring's depth and the largest chunk length: (code (4, C)
    int32, depth, max_u). Shell q is cut into CHUNKS chunks of u_q =
    ceil(n_q / CHUNKS) cells; a corner of nonzero weight is cell chunk u +
    off of the shell lag shells back and has the code off | chunk << 16 |
    lag << 20, a corner of zero weight -1 (the kernel reads 0 there). The
    depth is the largest lag + 1: the shells the ring holds. Asserts that
    every weighted corner lies in an earlier shell and that the fields
    fit."""
    C = g.num_cells
    size = g.shell_size.astype(np.int64)
    start = g.shell_start.astype(np.int64)
    shell_of = np.repeat(np.arange(size.shape[0]), size)
    assert shell_of.shape[0] == C
    nbr, sw = g.nbr[:, :C].astype(np.int64), g.sw[:, :C]
    qj = shell_of[nbr]
    lag = shell_of[None, :] - qj
    weighted = sw != 0.0
    u = (size + CHUNKS - 1) // CHUNKS
    local = nbr - start[qj]
    chunk = local // u[qj]
    off = local - chunk * u[qj]
    w_lag = lag[weighted]
    assert w_lag.size == 0 or int(w_lag.min()) >= 1, \
        "a weighted corner in the cell's own shell or a later one"
    depth = int(w_lag.max()) + 1 if w_lag.size else 2
    max_u = int(u.max())
    assert depth <= 128 and max_u < 1 << 16, (depth, max_u)
    code = np.where(weighted, off | chunk << 16 | lag << 20, -1)
    return code.astype(np.int32), depth, max_u


GATHER_BAND = 32         # rows d1 of a gather block (at most)
GATHER_CELLS = 8192      # values a gather block stages (at most)


def gather_runs(g, lo, hi, band=GATHER_BAND):
    """The gather kernel's map of the geometry ``g``'s C cells (offsets in
    the clip cube [lo, hi]^3): (blocks (n_blk, 10) int32, runs (n_run, 3)
    int32, places (C,) uint16, the most values a block stages).

    A block is one slab d0 and a band of at most ``band`` rows d1 (fewer
    where a row of the slab is wide: at most GATHER_CELLS values a block):
    d0, d1a, nd1, the rows' first d2 d2lo and their pitch (the slab's d2 in
    the octahedron and the clip cube), its first run and its number of
    runs, where its cells' places start and how many there are, 0. Within
    shell q the cells of a block are one run of the
    octahedral layout (lexicographic order inside a shell), listed as its
    first cell, its cells and where their places start in ``places``: each
    cell's place (d1 - d1a) pitch + d2 - d2lo among the values the block
    stages, in the runs' order. Blocks go slab after slab, bands in
    ascending d1, their runs by shell; every cell lies in exactly one run
    (asserted)."""
    C = g.num_cells
    d = g.offsets[:, :C].astype(np.int64)
    shell = np.abs(d).sum(axis=0)
    rad = g.max_q - np.abs(np.arange(lo, hi + 1))          # per slab
    d1lo, d1hi = np.maximum(lo, -rad), np.minimum(hi, rad)
    d2lo = d1lo                      # the rows' d2 span the same interval
    pitch = d1hi - d1lo + 1
    w = np.maximum(1, np.minimum(band, GATHER_CELLS // pitch))
    n_band = -(-(d1hi - d1lo + 1) // w)
    first = np.concatenate([[0], np.cumsum(n_band)])
    s = d[0] - lo                                         # each cell's slab
    blk = first[s] + (d[1] - d1lo[s]) // w[s]
    n_blk = int(first[-1])
    slab = np.repeat(np.arange(hi - lo + 1), n_band)
    d1a = d1lo[slab] + (np.arange(n_blk) - first[slab]) * w[slab]
    nd1 = np.minimum(w[slab], d1hi[slab] - d1a + 1)
    place = (d[1] - d1a[blk]) * pitch[s] + d[2] - d2lo[s]
    # the cells block after block, in the layout's order inside a block
    by = np.argsort(blk, kind="stable")
    key_b, key_q = blk[by], shell[by]
    new = np.ones(C, dtype=bool)
    new[1:] = (key_b[1:] != key_b[:-1]) | (key_q[1:] != key_q[:-1])
    starts = np.flatnonzero(new)
    lengths = np.diff(np.concatenate([starts, [C]]))
    cells = by[starts]
    run_of = np.cumsum(new) - 1
    assert np.array_equal(by, cells[run_of] + np.arange(C) - starts[run_of]), \
        "a block's cells of one shell are not one run of the layout"
    run_blk = key_b[starts]
    run0 = np.searchsorted(run_blk, np.arange(n_blk))
    nrun = np.bincount(run_blk, minlength=n_blk)
    assert nrun.min() >= 1
    cells_of = np.bincount(blk, minlength=n_blk)
    place0 = np.cumsum(cells_of) - cells_of
    blocks = np.stack([slab + lo, d1a, nd1, d2lo[slab], pitch[slab], run0,
                       nrun, place0, cells_of,
                       np.zeros(n_blk, dtype=np.int64)], axis=1)
    runs = np.stack([cells, lengths, starts], axis=1)
    staged = int((nd1 * pitch[slab]).max())
    assert staged <= GATHER_CELLS or int(w.min()) == 1
    assert staged < 1 << 16
    return (blocks.astype(np.int32), runs.astype(np.int32),
            place[by].astype(np.uint16), staged)


class Raytracer:
    """Batched multi-source raytracer over a periodic N^3 grid.

    Usage::

        rt = Raytracer(config, photo_thin, photo_thick, minlogtau, dlogtau)
        phi_ion = rt.trace(ndens, xh_av, src_pos, src_flux, dr)

    ``src_pos`` is (NumSrc, 3) 0-indexed; ``src_flux`` is the source rate
    normalized by S_star = 1e48 photons/s (reference convention).
    ``device`` defaults to the GPU, where a trace is one call of the
    kernel loop of csrc/flat_sweep.cu; ``device="cpu"`` runs the plain
    PyTorch loop.
    """

    def __init__(self, config: RaytraceConfig,
                 photo_thin_table=None, photo_thick_table=None,
                 minlogtau=None, dlogtau=None,
                 heat_thin_table=None, heat_thick_table=None,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dt = config.dtype
        self.geom_np: OctaGeometry = build_geometry(
            config.N, max_q_for(config.R_max_LLS, config.N))
        g = self.geom_np
        C = g.num_cells
        # shell q's cells are [shell_start[q], shell_start[q+1])
        self.shells = [(int(g.shell_start[q]), int(g.shell_start[q + 1]))
                       for q in range(1, g.max_q + 1)
                       if g.shell_size[q] > 0]

        def dev(a, dtype=dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=self.device, dtype=dtype)

        path = dev(g.path[:C])
        dist2 = dev(g.dist2[:C])
        # volume factor of a cell at distance r: 1 / (4 pi r^2 path), in
        # the engine's dtype as the JAX engine forms it; the source cell's
        # volume is dr^3 (raytracing.cu:290-307)
        geom = 1.0 / (dist2 * path * FOURPI)
        geom[0] = 1.0
        zero = torch.zeros(1, dtype=dt, device=self.device)
        tb = dict(offsets=dev(g.offsets[:, :C], torch.int64),
                  nbr=dev(g.nbr[:, :C], torch.int64),
                  sw=dev(g.sw[:, :C]), path=path, diag=dev(g.diag[:C]),
                  geom=geom,
                  rated=dist2 <= torch.tensor(config.R_max_LLS,
                                              dtype=dt) ** 2,
                  photo_thin=zero, photo_thick=zero,
                  heat_thin=zero, heat_thick=zero)
        # Tables are stored normalized by S_star so they are O(1) and fit
        # float32; the S_star factor returns in the volume prefactor.
        if not config.grey_analytic:
            if photo_thin_table is None or photo_thick_table is None:
                raise ValueError("the table engine needs the photo tables")
            tb["photo_thin"] = dev(np.asarray(photo_thin_table) / S_STAR_REF)
            tb["photo_thick"] = dev(np.asarray(photo_thick_table)
                                    / S_STAR_REF)
            self.num_tau = int(np.asarray(photo_thin_table).shape[0]) - 1
            self.minlogtau = float(minlogtau)
            self.dlogtau = float(dlogtau)
        if config.do_heating:
            tb["heat_thin"] = dev(np.asarray(heat_thin_table) / S_STAR_REF)
            tb["heat_thick"] = dev(np.asarray(heat_thick_table) / S_STAR_REF)
        self.tables = FlatTables(**tb)
        self._kernel_tables = None

    def kernel_tables(self):
        """The engine's tables as the kernels of csrc/flat_sweep.cu read
        them, on its device, made at the first call: the cell offsets and
        corner cells as int32, the weights, path, diag and volume factors,
        the rated cells as uint8, the first cell of each shell, the inverse
        table of the clip cube (each offset's cell, -1 off the octahedron),
        the rate tables, the corners' codes (``corner_codes``), the cells
        in grid order (the inverse table's cells in its lexicographic order)
        and their offsets packed 10 bits an axis, the gather's blocks, runs
        and places (``gather_runs``; the places as int16 bits) and the
        rated cells in ascending order (ops/flat_sweep.py::KernelTables)."""
        if self._kernel_tables is not None:
            return self._kernel_tables
        g, tb, cfg = self.geom_np, self.tables, self.config
        C, N, max_q = g.num_cells, cfg.N, g.max_q
        n_shells = len(self.shells)
        if self.shells != [(int(g.shell_start[q]), int(g.shell_start[q + 1]))
                           for q in range(1, n_shells + 1)]:
            raise ValueError("flat engine: the shells are not consecutive")
        lo = max(-(N // 2), -max_q)
        side = min(N // 2 - 1 + N % 2, max_q) - lo + 1
        off = g.offsets[:, :C].astype(np.int64) - lo
        inv = np.full(side ** 3, -1, dtype=np.int32)
        inv[(off[0] * side + off[1]) * side + off[2]] = np.arange(
            C, dtype=np.int32)

        code, depth, max_u = corner_codes(g)
        # the cells in grid order (lexicographic in their offsets) and their
        # offsets packed 10 bits an axis
        order = inv[inv >= 0]
        lex = g.offsets[:, order].astype(np.int64) - lo
        assert side <= 1024
        order_off = lex[0] | lex[1] << 10 | lex[2] << 20
        blocks, runs, places, staged = gather_runs(g, lo, lo + side - 1)
        rated = np.flatnonzero(tb.rated.cpu().numpy())

        def i32(a):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=np.int32)).to(self.device)
        tensors = (i32(g.offsets[:, :C]), i32(g.nbr[:, :C]), tb.sw, tb.path,
                   tb.diag, tb.geom, tb.rated.to(torch.uint8),
                   i32(g.shell_start[:n_shells + 2]), i32(inv),
                   tb.photo_thin, tb.photo_thick, tb.heat_thin,
                   tb.heat_thick, i32(code), i32(order),
                   i32(order_off), i32(blocks), i32(runs),
                   torch.from_numpy(places.view(np.int16)).to(self.device),
                   i32(rated))
        grey = cfg.grey_analytic
        sizes = dict(C=C, n_shells=n_shells, N=N, max_q=max_q, lo=lo,
                     side=side, num_tau=0 if grey else self.num_tau,
                     grey=int(grey), depth=depth, max_u=max_u,
                     n_blk=blocks.shape[0], g_cells=staged,
                     n_rated=rated.shape[0])
        consts = (cfg.sig, 0.0 if grey else self.minlogtau,
                  1.0 if grey else self.dlogtau)
        self._kernel_tables = fs.pack_tables(tensors, sizes, consts,
                                             cfg.dtype, cfg.do_heating)
        return self._kernel_tables

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------
    def _lin_idx(self, src_pos):
        """(B, C) flat C-order grid indices of the octahedron cells of each
        source; ``src_pos`` (B, 3) int64 on the engine's device. Applies the
        periodic wrap (raytracing.cu:269-272); offsets are pre-clipped to one
        periodic image (raytracing.cu:241)."""
        N = self.config.N
        p = torch.remainder(src_pos[:, :, None] + self.tables.offsets[None],
                            N)
        return (p[:, 0] * N + p[:, 1]) * N + p[:, 2]

    def _gather(self, nhi_flat, src_pos):
        """The octahedral gather: (lin, nhi_octa), the (B, C) grid indices of
        the cells of each source (``_lin_idx``) and the HI density there."""
        lin = self._lin_idx(src_pos)
        return lin, nhi_flat[lin]

    def _sweep(self, nhi_octa, dr):
        """Causal shell sweep: (B, C) outgoing HI column density per cell
        (raytracing.cu:310-312) from the (B, C) HI density in the
        octahedral layout; ``dr`` a 0-dim tensor of the engine's dtype."""
        tb = self.tables
        sig = self.config.sig
        cdo = torch.zeros_like(nhi_octa)
        pdr = tb.path * dr
        # source cell: coldensh_in = 0, path = dr/2 (raytracing.cu:285-294)
        cdo[:, 0] = nhi_octa[:, 0] * pdr[0]
        for lo, hi in self.shells:
            # gather the 4 corner column densities (cinterp_gpu,
            # raytracing.cu:416-419)
            c = cdo[:, tb.nbr[:, lo:hi]]                      # (B, 4, S)
            w = tb.sw[:, lo:hi] / torch.clamp(c * sig, min=0.6)
            cdin = tb.diag[lo:hi] * (c * w).sum(dim=1) / w.sum(dim=1)
            cdo[:, lo:hi] = cdin + nhi_octa[:, lo:hi] * pdr[lo:hi]
        return cdo

    def _dr(self, dr, device):
        """``dr`` as a 0-dim tensor of the engine's dtype on ``device``."""
        return torch.tensor(float(dr), dtype=self.config.dtype).to(device)

    def _s_over_dr3(self, dr):
        """S_star / dr^3 as a 0-dim tensor on dr's device: dr^3 in cgs
        (~1e62) overflows float32, so it is formed in log space
        (raytracing.cu:290-307)."""
        return torch.exp(
            torch.tensor(np.log(S_STAR_REF), dtype=self.config.dtype).to(
                dr.device) - 3.0 * torch.log(dr))

    def _lookup(self, table, tau):
        """Log-linear table interpolation (rates.cu:70-83)."""
        logtau = torch.log10(torch.clamp(tau, min=1.0e-20))
        real_i = torch.clamp(1.0 + (logtau - self.minlogtau) / self.dlogtau,
                             0.0, float(self.num_tau))
        i0 = real_i.to(torch.int64)
        resid = real_i - i0.to(real_i.dtype)
        i1 = torch.clamp(i0 + 1, max=self.num_tau)
        t0 = table[i0]
        return t0 + resid * (table[i1] - t0)

    def _rates(self, cdo, nhi_octa, flux, dr):
        """Dense photoionization (and heating) rate pass over the octahedron
        (photoion_rates, src/c2ray/photorates.f90:13-149), vectorized over
        (B, C). Returns (phi, heat), each already divided by nHI (the
        photon-conserving prescription, raytracing.f90:531); heat is None
        without do_heating."""
        cfg, tb = self.config, self.tables
        sig = cfg.sig
        dcol = nhi_octa * (tb.path * dr)       # exact nHI * path
        cdin = cdo - dcol
        tau_in = cdin * sig
        tau_out = cdo * sig
        dtau = dcol * sig

        prefact = flux[:, None] * self._s_over_dr3(dr) * tb.geom
        thick_cell = dtau > TAU_PHOTO_LIMIT

        heat_cell = None
        if cfg.grey_analytic:
            ein = torch.exp(-tau_in)
            phi_cell = torch.where(thick_cell,
                                   prefact * (ein - torch.exp(-tau_out)),
                                   prefact * dtau * ein)
        else:
            lk = self._lookup
            phi_cell = torch.where(
                thick_cell,
                prefact * (lk(tb.photo_thick, tau_in)
                           - lk(tb.photo_thick, tau_out)),
                prefact * dtau * lk(tb.photo_thin, tau_in))
            if cfg.do_heating:
                heat_cell = torch.where(
                    thick_cell,
                    prefact * (lk(tb.heat_thick, tau_in)
                               - lk(tb.heat_thick, tau_out)),
                    prefact * dtau * lk(tb.heat_thin, tau_in))

        # LLS / max-column-density cutoffs (raytracing.cu:315). A
        # zero-density cell absorbs nothing: its rate per atom is 0, not
        # 0/0 (the floor is the smallest normal float, a no-op for any
        # physical density).
        mask = (cdin <= MAX_COLDENSH) & tb.rated
        nhi_safe = torch.clamp(nhi_octa, min=torch.finfo(cfg.dtype).tiny)
        zero = torch.zeros_like(phi_cell)
        phi = torch.where(mask, phi_cell / nhi_safe, zero)
        heat = (None if heat_cell is None
                else torch.where(mask, heat_cell / nhi_safe, zero))
        return phi, heat

    @staticmethod
    def _accumulate(grid, lin, vals):
        """The ordered accumulate: each source's (C,) ``vals`` added into the
        flat ``grid`` at its cells ``lin`` with ``index_add_``, source after
        source in batch order."""
        for b in range(lin.shape[0]):
            grid.index_add_(0, lin[b], vals[b])

    # ------------------------------------------------------------------
    # the steps of a batch: the plain functions on CPU tensors, one kernel
    # launch of csrc/flat_sweep.cu on CUDA tensors
    # ------------------------------------------------------------------
    def gather_batch(self, nhi_flat, pos):
        """The (B, C) HI density in the octahedral layout of the sources at
        ``pos`` (B, 3) over the flat HI density grid ``nhi_flat`` (N^3,):
        the plain gather, or the gather kernel."""
        if nhi_flat.device.type == "cpu":
            return self._gather(nhi_flat, pos)[1]
        return fs.flat_gather(self.kernel_tables(), nhi_flat, pos)

    def sweep_batch(self, nhi_flat, pos, dr, cluster=None, shared=None):
        """The (B, C) outgoing column density of the sources at ``pos``
        (B, 3) over the flat HI density grid ``nhi_flat`` (N^3,): the plain
        gather and sweep, or the sweep kernel in clusters of ``cluster``
        blocks with its column densities in distributed shared memory
        (``shared``) or in global memory (ops/flat_sweep.py::flat_plan's
        where None)."""
        if nhi_flat.device.type == "cpu":
            return self._sweep(self._gather(nhi_flat, pos)[1],
                               self._dr(dr, "cpu"))
        return fs.flat_sweep(self.kernel_tables(), nhi_flat, pos, dr,
                             cluster, shared)

    def rates_batch(self, cdo, nhi_octa, flux, dr):
        """(phi, heat), the (B, C) rates per HI atom of B sources with
        fluxes ``flux`` (B,) from their column densities ``cdo`` and their
        HI densities in the octahedral layout ``nhi_octa`` (B, C), heat
        None without do_heating: the plain rate pass, or the rate kernel
        (over the rated cells; the others +0)."""
        dr_t = self._dr(dr, cdo.device)
        if cdo.device.type == "cpu":
            return self._rates(cdo, nhi_octa, flux, dr_t)
        return fs.flat_rates(self.kernel_tables(), cdo, nhi_octa, flux,
                             self._s_over_dr3(dr_t), dr)

    def accumulate_batch(self, phi_grid, heat_grid, pos, phi, heat):
        """Adds the (B, C) rates ``phi`` (and ``heat``) of the sources at
        ``pos`` (B, 3) into the flat grids ``phi_grid`` (and ``heat_grid``)
        in place, source after source: the plain ``_accumulate``, or the
        ordered accumulate kernel."""
        if phi_grid.device.type == "cpu":
            lin = self._lin_idx(pos)
            self._accumulate(phi_grid, lin, phi)
            if heat_grid is not None:
                self._accumulate(heat_grid, lin, heat)
            return
        fs.flat_accumulate(self.kernel_tables(), phi_grid, heat_grid, pos,
                           phi, heat)

    # ------------------------------------------------------------------
    # full trace
    # ------------------------------------------------------------------
    def flat_trace_sweep_ref(self, nd, xh, pos_b, flux_b, dr):
        """The plain loop: the trace of the batches ``pos_b`` (nb, B, 3),
        ``flux_b`` (nb, B) over the grids ``nd``, ``xh`` ((N^3,) or
        (N, N, N)), batch after batch the gather, the sweep, the rate pass
        and the ordered accumulate. Returns (phi, heat) as (N^3,) tensors,
        heat None without do_heating."""
        dr_t = self._dr(dr, self.device)
        nhi_flat = nd.reshape(-1) * (1.0 - xh.reshape(-1))
        phi_grid = torch.zeros_like(nhi_flat)
        heat_grid = (torch.zeros_like(nhi_flat) if self.config.do_heating
                     else None)
        for pos, flux in zip(pos_b, flux_b):
            lin, nhi_octa = self._gather(nhi_flat, pos.to(self.device))
            cdo = self._sweep(nhi_octa, dr_t)
            phi, heat = self._rates(cdo, nhi_octa, flux, dr_t)
            self._accumulate(phi_grid, lin, phi)
            if heat_grid is not None:
                self._accumulate(heat_grid, lin, heat)
        return phi_grid, heat_grid

    def trace_batches(self, nd, xh, pos_b, flux_b, dr):
        """Batched trace on prepared sources with flat-grid IO: ``nd``,
        ``xh`` are (N^3,) (or (N,N,N)) tensors on the engine's device;
        returns (phi, heat) as (N^3,) tensors, heat None without
        do_heating. The plain loop ``flat_trace_sweep_ref`` on the CPU; on
        the card one call of ops/flat_sweep.py::flat_trace_sweep, the
        kernel loop."""
        if nd.device.type == "cpu":
            return self.flat_trace_sweep_ref(nd, xh, pos_b, flux_b, dr)
        nhi_flat = nd.reshape(-1) * (1.0 - xh.reshape(-1))
        sdr3 = self._s_over_dr3(self._dr(dr, nd.device))
        return fs.flat_trace_sweep(self.kernel_tables(), nhi_flat, pos_b,
                                   flux_b, sdr3, dr)

    def shard_trace(self, nd, xh, pos_b, flux_b, dr):
        """A rank's partial Gamma (and heat) over its own batches, on the
        whole grid with flat IO and no reduce: the body of the
        source-parallel step (parallel/source_parallel.py), which
        all-reduces it. Returns (phi, heat), heat None without
        do_heating."""
        return self.trace_batches(nd, xh, pos_b, flux_b, dr)

    def prepare_sources(self, src_pos, src_flux):
        """Pad the catalog to whole batches (zero-flux sources at the
        origin, which contribute nothing). Returns (pos_b, flux_b): int64
        positions (nb, B, 3) and fluxes (nb, B) on the engine's device."""
        B = self.config.batch_size
        ns = np.asarray(src_flux).shape[0]
        nb = -(-ns // B)
        pos = np.zeros((nb * B, 3), dtype=np.int64)
        flx = np.zeros((nb * B,), dtype=np.float64)
        pos[:ns] = np.asarray(src_pos, dtype=np.int64)
        flx[:ns] = np.asarray(src_flux, dtype=np.float64)
        return (torch.from_numpy(pos.reshape(nb, B, 3)).to(self.device),
                torch.from_numpy(flx.reshape(nb, B)).to(self.device,
                                                        self.dtype))

    def trace(self, ndens, xh_av, src_pos, src_flux, dr):
        """Public API: the (N, N, N) photoionization rate on the engine's
        device, and with do_heating the pair (phi, heat). ``ndens`` and
        ``xh_av`` are numpy arrays or tensors, (N,N,N) or flat."""
        cfg = self.config
        sh = (cfg.N,) * 3
        nd = torch.as_tensor(ndens, dtype=cfg.dtype, device=self.device)
        xh = torch.as_tensor(xh_av, dtype=cfg.dtype, device=self.device)
        pos_b, flux_b = self.prepare_sources(src_pos, src_flux)
        phi, heat = self.trace_batches(nd, xh, pos_b, flux_b, dr)
        if cfg.do_heating:
            return phi.reshape(sh), heat.reshape(sh)
        return phi.reshape(sh)

    # -- test helper ---------------------------------------------------
    def sweep_coldens(self, ndens, xh_av, src_pos_single, dr):
        """Outgoing column density grid (N, N, N) of a single source, as a
        numpy array (testing): the sweep kernel on the card, the plain
        gather and sweep on the CPU."""
        cfg = self.config
        nd = torch.as_tensor(ndens, dtype=cfg.dtype,
                             device=self.device).reshape(-1)
        xh = torch.as_tensor(xh_av, dtype=cfg.dtype,
                             device=self.device).reshape(-1)
        pos = torch.as_tensor(np.asarray(src_pos_single, dtype=np.int64)
                              [None, :], device=self.device)
        lin = self._lin_idx(pos)
        cdo = self.sweep_batch(nd * (1.0 - xh), pos, dr)
        out = torch.zeros_like(nd)
        out[lin[0]] = cdo[0]
        return out.cpu().numpy().reshape((cfg.N,) * 3)
