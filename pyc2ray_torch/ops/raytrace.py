"""The table-exact octahedral raytracer (the ``flat`` engine).

PyTorch twin of pyc2ray_tpu/ops/raytrace.py, the functional equivalent of
the ASORA raytracer (reference: src/asora/raytracing.cu:79-339,
rates.cu:16-83) with the reference's log-linear rate tables:

* Per source, cells are swept in octahedral shells of constant L1 distance
  q (ops/geometry.py's flat layout): one Python iteration per shell, each
  a few dense tensor operations over the shell's cells (gather the 4
  corner column densities, interpolate, extend). Shells are sliced exactly
  (the JAX engine pads them to fixed-shape buckets).
* Sources run in batches of B, each with a private column-density buffer
  in the octahedral layout. After the sweep, the photoionization (and
  heating) rates are one dense pass over the octahedron, which recovers
  the incoming column density from the outgoing one.
* Each source's rates are added into the flat N^3 grid with ``index_add_``,
  one source at a time in batch order. Within one source every cell index
  is unique (one periodic image), so the sum on the card is deterministic.

The engine has no Pallas kernel in the JAX package (its sweep is XLA
code), and none here: the sweep is plain PyTorch on either device.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..constants import S_STAR_REF, TAU_PHOTO_LIMIT, MAX_COLDENSH
from ..device import resolve_device
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


class Raytracer:
    """Batched multi-source raytracer over a periodic N^3 grid.

    Usage::

        rt = Raytracer(config, photo_thin, photo_thick, minlogtau, dlogtau)
        phi_ion = rt.trace(ndens, xh_av, src_pos, src_flux, dr)

    ``src_pos`` is (NumSrc, 3) 0-indexed; ``src_flux`` is the source rate
    normalized by S_star = 1e48 photons/s (reference convention).
    ``device`` defaults to the GPU; ``device="cpu"`` runs on the CPU (the
    same PyTorch code: the engine has no kernel of its own).
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

        # S_star / dr^3: dr^3 in cgs (~1e62) overflows float32, so it is
        # formed in log space (raytracing.cu:290-307)
        s_over_dr3 = torch.exp(
            torch.tensor(np.log(S_STAR_REF), dtype=cfg.dtype).to(dr.device)
            - 3.0 * torch.log(dr))
        prefact = flux[:, None] * s_over_dr3 * tb.geom
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

    # ------------------------------------------------------------------
    # full trace
    # ------------------------------------------------------------------
    def trace_batches(self, nd, xh, pos_b, flux_b, dr):
        """Batched trace on prepared sources with flat-grid IO: ``nd``,
        ``xh`` are (N^3,) (or (N,N,N)) tensors on the engine's device;
        returns (phi, heat) as (N^3,) tensors, heat None without
        do_heating."""
        cfg = self.config
        dr_t = torch.tensor(float(dr), dtype=cfg.dtype).to(self.device)
        nhi_flat = nd.reshape(-1) * (1.0 - xh.reshape(-1))
        phi_grid = torch.zeros_like(nhi_flat)
        heat_grid = torch.zeros_like(nhi_flat) if cfg.do_heating else None
        for pos, flux in zip(pos_b, flux_b):
            lin = self._lin_idx(pos.to(self.device))
            nhi_octa = nhi_flat[lin]
            cdo = self._sweep(nhi_octa, dr_t)
            phi, heat = self._rates(cdo, nhi_octa, flux, dr_t)
            for b in range(lin.shape[0]):
                phi_grid.index_add_(0, lin[b], phi[b])
                if heat_grid is not None:
                    heat_grid.index_add_(0, lin[b], heat[b])
        return phi_grid, heat_grid

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
        numpy array (testing)."""
        cfg = self.config
        nd = torch.as_tensor(ndens, dtype=cfg.dtype,
                             device=self.device).reshape(-1)
        xh = torch.as_tensor(xh_av, dtype=cfg.dtype,
                             device=self.device).reshape(-1)
        pos = torch.as_tensor(np.asarray(src_pos_single, dtype=np.int64)
                              [None, :], device=self.device)
        lin = self._lin_idx(pos)
        cdo = self._sweep((nd * (1.0 - xh))[lin],
                          torch.tensor(float(dr), dtype=cfg.dtype)
                          .to(self.device))
        out = torch.zeros_like(nd)
        out[lin[0]] = cdo[0]
        return out.cpu().numpy().reshape((cfg.N,) * 3)
