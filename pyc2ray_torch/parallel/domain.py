"""3D domain decomposition with halo exchange, on torch.distributed.

PyTorch twin of pyc2ray_tpu/parallel/domain.py. The reference never
decomposes the grid: every MPI rank holds all N^3 cells and pays an O(N^3)
Reduce+Bcast of Gamma per convergence iteration (reference:
pyc2ray/evolve.py:361-371,433-437). Here the grid is split over a
("di", "dj", "dk") mesh of ranks along its (i, j, k) axes, and a rank
holds one block of every field:

  1. ``halo_gather``: each rank extends its block with ``ceil(R)``-wide
     halos of its neighbours' data, point to point around the ring of each
     decomposed axis (multi-hop where the halo is wider than a block); an
     axis of one rank is wrap-padded locally. The ring makes the grid
     periodic.
  2. Every rank sweeps the sources it owns (a source's whole box lies in
     its extended block). Sources whose box lies inside the block
     ("interior" sources) are swept from the block itself, without the
     exchange; here the two sweeps run one after the other.
  3. ``halo_reduce``: Gamma accumulated in halo cells goes back to the
     ranks that own them and is added there: the exact adjoint of the
     gather.

A rank moves O(L^2 R) cells per iteration instead of O(N^3); the bytes it
sends are counted in ``mesh.traffic["halo"]``.

Mesh sizes need not divide N: a non-divisible axis stores ceil(N/p) rows
per rank (the last rank's dead rows padded), and its halo exchange is an
all-gather over the line of ranks along it and a mod-N window, O(N * face).

Chemistry is elementwise and runs on the block with no communication;
the convergence sums are one all-reduce of four scalars.
"""

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import S_STAR_REF
from ..evolve import _absorbed_rate, _absorbed_rate_he
from ..evolve_loop import IterationResult, run_convergence_loop
from ..ops.chemistry import ChemistryParams, global_pass
from ..utils.logutils import printlog
from .mesh import Mesh, device_count

__all__ = ["make_domain_mesh", "DomainDecomposition", "evolve3D_domain",
           "evolve3D_he_domain"]

AXES = ("di", "dj", "dk")


def make_domain_mesh(pi=None, pj=1, pk=1, device=None):
    """("di", "dj", "dk") mesh of ranks splitting the grid's (i, j, k)
    axes, over the first pi*pj*pk ranks of the world. ``pi`` defaults to
    every rank: pi = world // (pj * pk). Every rank of the world calls it
    (it makes the process groups of the lines of ranks)."""
    n_dev = device_count()
    if pi is None:
        pi = n_dev // (pj * pk)
    if pi * pj * pk > n_dev:
        raise ValueError(f"mesh {pi}x{pj}x{pk} > {n_dev} ranks")
    return Mesh((pi, pj, pk), AXES, device=device, line_groups=True)


class _Axis(NamedTuple):
    name: str
    p: int          # ranks along this axis
    Lp: int         # rows per rank (ceil(N/p); last rank padded)
    Np: int         # padded global extent = p * Lp
    divisible: bool


def _halo_pieces(h, L):
    """Split a halo of width ``h`` into per-hop widths (hop 1 = adjacent
    neighbour). Hop s contributes min(L, h-(s-1)L) rows."""
    out = []
    s = 1
    while h > 0:
        w = min(L, h)
        out.append((s, w))
        h -= w
        s += 1
    return out


def _wrap(f, dim, lo, hi):
    """``f`` wrap-padded by ``lo`` / ``hi`` rows along ``dim``."""
    n = f.shape[dim]
    idx = torch.arange(-lo, n + hi, device=f.device) % n
    return f.index_select(dim, idx)


def _zero_pad(f, dim, lo, hi):
    """``f`` zero-padded by ``lo`` / ``hi`` rows along ``dim``."""
    parts = []
    for w in (lo, None, hi):
        if w is None:
            parts.append(f)
        elif w:
            shp = list(f.shape)
            shp[dim] = w
            parts.append(f.new_zeros(shp))
    return torch.cat(parts, dim)


class DomainDecomposition:
    """Grid decomposition bound to a raytracing engine's geometry.

    Parameters
    ----------
    engine : ops.raytrace_cheb.ChebRaytracer, ops.adaptive.AdaptiveRaytracer
        or ops.raytrace_he.HeRaytracer
        Supplies N and the box geometry (halo widths = box padding).
    mesh : a mesh of parallel/mesh.py with axes from ("di", "dj", "dk")
        (absent axes have size 1); axis sizes need not divide N. This rank
        must be in it.

    Fields of the decomposed paths are this rank's blocks,
    (Lp_i, Lp_j, Lp_k) tensors on the engine's device (``local_block``);
    ``assemble`` gathers the (N, N, N) grid on every rank.
    """

    def __init__(self, engine, mesh):
        # adaptive engine: owner-local bucketing: every rank buckets the
        # sources it owns by the Stromgren policy and sweeps bucket-major
        # on ONE halo exchange sized for the largest bucket
        self._adaptive = bool(getattr(engine, "needs_flux_bucketing",
                                      False))
        probe = engine.engines[-1] if self._adaptive else engine
        if not hasattr(probe, "trace_extended"):
            raise TypeError(
                "domain decomposition requires the cheb/pallas engine "
                "(ops.raytrace_cheb.ChebRaytracer); got "
                f"{type(engine).__name__}. Set Raytracing.engine: cheb "
                "in the parameter file.")
        mesh.require_member()
        self.engine = engine
        self.mesh = mesh
        self.N = engine.N
        g = probe.geom                 # the largest bucket sets the halo
        self.hlo = g.c                 # low-side halo width
        self.hhi = g.Dc - 1 - g.c      # high-side halo width
        N = self.N
        self.axes = []
        for name in AXES:
            p = mesh.axis_size(name)
            Lp = -(-N // p)
            self.axes.append(_Axis(name, p, Lp, p * Lp,
                                   divisible=(N % p == 0)))
        self.padded = any(not a.divisible for a in self.axes)
        self.pi, self.pj, self.pk = (a.p for a in self.axes)
        self.Li, self.Lj, self.Lk = (a.Lp for a in self.axes)
        self.coords = tuple(mesh.axis_coord(a.name) for a in self.axes)
        self.n_interior = 0

    # -- blocks ----------------------------------------------------------
    def pad_global(self, arr, fill=0.0):
        """(N,N,N) -> (Np_i, Np_j, Np_k) with ``fill`` in the dead rows."""
        if not self.padded:
            return arr
        pads = []
        for a in reversed(self.axes):
            pads += [0, a.Np - self.N]
        return F.pad(arr, pads, value=fill)

    def strip_global(self, arr):
        if not self.padded:
            return arr
        return arr[:self.N, :self.N, :self.N]

    def local_block(self, arr, fill=0.0):
        """This rank's block of the (N, N, N) tensor ``arr``, the dead rows
        of a non-divisible axis filled with ``fill``."""
        glob = self.pad_global(arr, fill)
        sl = tuple(slice(c * a.Lp, (c + 1) * a.Lp)
                   for c, a in zip(self.coords, self.axes))
        return glob[sl].contiguous()

    def assemble(self, block):
        """The (N, N, N) tensor from every rank's block, on every rank."""
        m = self.mesh
        if m.size == 1:
            return self.strip_global(block)
        allb = m.all_gather(block.reshape(1, -1), dim=0, kind="output")
        Li, Lj, Lk = self.Li, self.Lj, self.Lk
        glob = allb.reshape(self.pi, self.pj, self.pk, Li, Lj, Lk) \
            .permute(0, 3, 1, 4, 2, 5) \
            .reshape(self.pi * Li, self.pj * Lj, self.pk * Lk)
        return self.strip_global(glob)

    def _valid_mask(self):
        """Per-cell validity of the block (False in the dead rows of the
        last rank along a non-divisible axis); None when no axis is
        padded."""
        if not self.padded:
            return None
        m = None
        for dim, (ax, c) in enumerate(zip(self.axes, self.coords)):
            if ax.divisible:
                continue
            rows = c * ax.Lp + torch.arange(ax.Lp,
                                            device=self.engine.device)
            shape = [1, 1, 1]
            shape[dim] = ax.Lp
            v = (rows < self.N).reshape(shape)
            m = v if m is None else m & v
        return m.expand(self.Li, self.Lj, self.Lk)

    # -- halo exchange ---------------------------------------------------
    # The spatial axes are a field's last three dims; leading dims stack
    # several fields into one exchange.
    def _pull(self, piece, ax, s, items):
        """The value of ``piece`` on the rank ``s`` hops LEFT (lower index,
        periodic) along ``ax``: the piece itself when that is this rank,
        else a slot (int) in the exchange ``items``."""
        if ax.p == 1 or s % ax.p == 0:
            return piece
        items.append((piece, self.mesh.shifted(ax.name, s),
                      self.mesh.shifted(ax.name, -s)))
        return len(items) - 1

    def _exchange(self, slots, items):
        recv = self.mesh.exchange(items, "halo")
        return [recv[s] if isinstance(s, int) else s for s in slots]

    def _gather_axis_ring(self, f, dim, ax):
        """Extend ``f`` along ``dim`` with halos from the ring neighbours
        (low side ``hlo``, high side ``hhi``), multi-hop; N % p == 0."""
        L = ax.Lp
        items, lows, highs = [], [], []
        for s, w in _halo_pieces(self.hlo, L):
            # rows [-(s-1)L - w, -(s-1)L) before my first = the LAST w
            # rows of the rank s hops left
            lows.append(self._pull(f.narrow(dim, L - w, w), ax, s, items))
        for s, w in _halo_pieces(self.hhi, L):
            highs.append(self._pull(f.narrow(dim, 0, w), ax, -s, items))
        got = self._exchange(lows + highs, items)
        lows, highs = got[:len(lows)], got[len(lows):]
        return torch.cat(lows[::-1] + [f] + highs, dim)

    def _reduce_axis_ring(self, fx, dim, ax):
        """Adjoint of ``_gather_axis_ring``: add my halo rows into the
        owners' blocks and return my block with what came back."""
        L = ax.Lp
        core = fx.narrow(dim, self.hlo, L).clone()
        items, slots, where = [], [], []
        off = self.hlo
        for s, w in _halo_pieces(self.hlo, L):
            off -= w
            # my rows [off, off+w) are the LAST w rows of the rank s hops
            # left; it receives them from s hops right
            slots.append(self._pull(fx.narrow(dim, off, w), ax, -s, items))
            where.append((L - w, w))
        off = self.hlo + L
        for s, w in _halo_pieces(self.hhi, L):
            slots.append(self._pull(fx.narrow(dim, off, w), ax, s, items))
            where.append((0, w))
            off += w
        for piece, (o, w) in zip(self._exchange(slots, items), where):
            core.narrow(dim, o, w).add_(piece)
        return core

    def _gather_axis_compat(self, f, dim, ax, c):
        """Halo extension along a NON-divisible axis: all-gather the padded
        global axis over the line of ranks and take the mod-N window
        [g0-hlo, g0+Lp+hhi)."""
        ag = self.mesh.all_gather(f, dim=dim, axis=ax.name, kind="halo")
        g0 = c * ax.Lp
        ext = self.hlo + ax.Lp + self.hhi
        idx = (g0 - self.hlo + torch.arange(ext, device=f.device)) % self.N
        return ag.index_select(dim, idx)

    def _reduce_axis_compat(self, fx, dim, ax, c):
        """Adjoint of ``_gather_axis_compat``: scatter-add the extended rows
        into a global-length axis (mod N), sum over the line of ranks, take
        my rows back."""
        g0 = c * ax.Lp
        E = fx.shape[dim]
        idx = (g0 - self.hlo + torch.arange(E, device=fx.device)) % self.N
        moved = fx.movedim(dim, 0)
        glob = moved.new_zeros((self.N,) + moved.shape[1:])
        glob.index_add_(0, idx, moved)
        glob = self.mesh.all_reduce(glob, "halo", axis=ax.name)
        if ax.Np > self.N:
            glob = _zero_pad(glob, 0, 0, ax.Np - self.N)
        return glob.narrow(0, g0, ax.Lp).movedim(0, dim).contiguous()

    def _fold_axis(self, fx, dim):
        """Fold the wrap padding of a one-rank axis back onto its N rows
        (the engine's ``_fold_padding`` along one axis)."""
        N = self.N
        core = fx.narrow(dim, self.hlo, N).clone()
        if self.hhi > 0:
            core.narrow(dim, 0, self.hhi).add_(
                fx.narrow(dim, self.hlo + N, self.hhi))
        if self.hlo > 0:
            core.narrow(dim, N - self.hlo, self.hlo).add_(
                fx.narrow(dim, 0, self.hlo))
        return core

    def _gather_axis(self, f, a):
        dim = f.dim() - 3 + a
        ax, c = self.axes[a], self.coords[a]
        if ax.p == 1:
            return _wrap(f, dim, self.hlo, self.hhi)
        if ax.divisible:
            return self._gather_axis_ring(f, dim, ax)
        return self._gather_axis_compat(f, dim, ax, c)

    def _reduce_axis(self, fx, a):
        dim = fx.dim() - 3 + a
        ax, c = self.axes[a], self.coords[a]
        if ax.p == 1:
            return self._fold_axis(fx, dim)
        if ax.divisible:
            return self._reduce_axis_ring(fx, dim, ax)
        return self._reduce_axis_compat(fx, dim, ax, c)

    def halo_gather(self, f):
        """Block -> extended block: neighbour halos along decomposed axes,
        wrap padding along one-rank axes."""
        for a in range(3):
            f = self._gather_axis(f, a)
        return f

    def halo_reduce(self, fx):
        """Extended accumulator -> block, halo contributions added to their
        owners (the exact adjoint of ``halo_gather``)."""
        for a in (2, 1, 0):
            fx = self._reduce_axis(fx, a)
        return fx

    def _pad_local(self, f):
        """Extend the block to the extended frame WITHOUT communication
        (wrap-pad one-rank axes, zeros along decomposed ones): the frame of
        the interior sources."""
        for a, ax in enumerate(self.axes):
            dim = f.dim() - 3 + a
            if ax.p == 1:
                f = _wrap(f, dim, self.hlo, self.hhi)
            else:
                f = _zero_pad(f, dim, self.hlo, self.hhi)
        return f

    def _strip_local(self, fx):
        """Extended accumulator -> block, no communication: the adjoint of
        ``_pad_local`` for accumulators that never wrote into
        decomposed-axis halos (interior sweeps). One-rank axes fold their
        wrap halos in the engine's order (i, j, k), so one rank gives the
        single-device Gamma bit for bit."""
        for a, ax in enumerate(self.axes):
            dim = fx.dim() - 3 + a
            if ax.p == 1:
                fx = self._fold_axis(fx, dim)
            else:
                fx = fx.narrow(dim, self.hlo, ax.Lp)
        return fx.contiguous()

    # -- source bucketing (host side) ------------------------------------
    def prepare_sources(self, src_pos, src_flux, dr=None, avg_dens=None):
        """Bucket sources by owning rank and split interior/boundary.

        Interior sources are those whose box lies entirely inside the
        owner's block along every decomposed axis; they are swept from the
        block itself. Returns this rank's ``(pos_int, flux_int, pos_bnd,
        flux_bnd)``: (nb, B, 3) int64 CPU box-start positions in the
        extended frame and (nb, B) fluxes on the engine's device, with the
        same nb on every rank (zero-flux padding); a pair is ``(None,
        None)`` when that class is empty on every rank. For the largest
        bucket's halo the box starts are the block's cell coordinates;
        smaller adaptive buckets carry the constant shift hlo - c_k.

        With the adaptive engine each of the four slots is a per-bucket
        tuple (owner-local bucketing: the Stromgren policy assigns radii
        exactly as on one device, then each bucket is staged per owner in
        lockstep; an empty bucket stages one zero-flux interior batch);
        ``dr`` and ``avg_dens`` feed the policy. Sets ``n_interior``, the
        catalog's sources swept without the exchange."""
        self.n_interior = 0
        if self._adaptive:
            if dr is None or avg_dens is None:
                raise ValueError(
                    "adaptive engine under the domain mesh needs dr and "
                    "avg_dens (mean of the traced density grid) for the "
                    "Stromgren bucketing policy")
            buckets = self.engine.assign_buckets(
                np.asarray(src_flux), float(dr), float(avg_dens))
            pos = np.asarray(src_pos)
            flx = np.asarray(src_flux)
            slots = [[], [], [], []]
            for k, eng in enumerate(self.engine.engines):
                sel = np.nonzero(buckets == k)[0]
                if sel.size == 0:
                    # empty bucket: one zero-flux interior batch per rank
                    # keeps the structure static when the occupancy
                    # changes between timesteps
                    B = eng.batch_size
                    shift = self.hlo - eng.geom.c
                    out = (torch.full((1, B, 3), shift, dtype=torch.int64),
                           torch.zeros((1, B), dtype=eng.dtype,
                                       device=eng.device), None, None)
                else:
                    out = self._prepare_engine_sources(eng, pos[sel],
                                                       flx[sel])
                for s, o in zip(slots, out):
                    s.append(o)
            return tuple(
                None if all(e is None for e in s) else tuple(s)
                for s in slots)
        return self._prepare_engine_sources(self.engine, src_pos, src_flux)

    def _prepare_engine_sources(self, engine, src_pos, src_flux):
        """Stage one engine's sources per owning rank (see
        ``prepare_sources``). ``engine`` may be a smaller adaptive bucket
        than the one that sized the halo; its box starts carry the constant
        shift ``hlo - c_k`` into the max-halo frame."""
        B = engine.batch_size
        g = engine.geom
        c_k = g.c
        hhi_k = g.Dc - 1 - c_k
        shift = self.hlo - c_k
        pos = np.asarray(src_pos, dtype=np.int64).reshape(-1, 3)
        flx = np.asarray(src_flux, dtype=np.float64).reshape(-1)
        ai, aj, ak = self.axes
        oi = pos[:, 0] // ai.Lp
        oj = pos[:, 1] // aj.Lp
        ok = pos[:, 2] // ak.Lp
        owner = (oi * aj.p + oj) * ak.p + ok
        loc = pos.copy()
        loc[:, 0] -= oi * ai.Lp
        loc[:, 1] -= oj * aj.Lp
        loc[:, 2] -= ok * ak.Lp
        # interior test per decomposed axis: the box [l-c_k, l+hhi_k] must
        # stay within [0, L_valid) of the block, i.e.
        # c_k <= l <= L_valid - 1 - hhi_k (L_valid < Lp on the last rank)
        interior = np.ones(len(pos), dtype=bool)
        for dim, ax in enumerate(self.axes):
            if ax.p == 1:
                continue
            o = pos[:, dim] // ax.Lp
            l = loc[:, dim]
            L_valid = np.minimum(ax.Lp, self.N - o * ax.Lp)
            interior &= (l >= c_k) & (l <= L_valid - 1 - hhi_k)
        loc += shift
        self.n_interior += int(np.count_nonzero(flx[interior] > 0))
        n_dev = ai.p * aj.p * ak.p
        me = self.mesh.index

        def bucket(sel_mask):
            sel_all = np.nonzero(sel_mask)[0]
            if len(sel_all) == 0:
                return None, None
            counts = np.bincount(owner[sel_all], minlength=n_dev)
            nb = max(1, -(-int(counts.max()) // B))
            sel = sel_all[owner[sel_all] == me]
            out_pos = np.full((nb * B, 3), shift, dtype=np.int64)
            out_flx = np.zeros((nb * B,), dtype=np.float64)
            out_pos[:len(sel)] = loc[sel]
            out_flx[:len(sel)] = flx[sel]
            return (torch.from_numpy(out_pos.reshape(nb, B, 3)),
                    torch.from_numpy(out_flx.reshape(nb, B)).to(
                        engine.device, engine.dtype))

        pos_i, flux_i = bucket(interior)
        pos_b, flux_b = bucket(~interior)
        return pos_i, flux_i, pos_b, flux_b

    def _bucket_views(self, pos, flux):
        """A source slot as (engine, pos, flux) triples: per bucket for the
        adaptive engine, one otherwise."""
        if not self._adaptive:
            return [(self.engine, pos, flux)]
        return [(eng, pk, fk) for eng, pk, fk
                in zip(self.engine.engines, pos, flux) if pk is not None]

    # -- the trace of a rank ---------------------------------------------
    def _trace_shard(self, nd_loc, xh_loc, srcs, dr):
        """Gamma (and heat) on the block from the sources this rank owns:
        the interior ones over the block padded without communication, the
        boundary ones over the halo-extended block, whose accumulators go
        back to their owners. With the adaptive engine every bucket sweeps
        the SAME extended frame (one exchange sized for the largest
        bucket)."""
        pos_i, flux_i, pos_b, flux_b = srcs
        eng = self.engine
        nhi = nd_loc * (1.0 - xh_loc)
        do_heat = eng.do_heating

        def sweep_frame(frame, pos, flux):
            acc = None
            for ek, pk, fk in self._bucket_views(pos, flux):
                p, h = ek.trace_extended(frame, pk, fk, dr)
                out = torch.stack([p, h]) if do_heat else p[None]
                acc = out if acc is None else acc + out
            return acc

        res = None
        if pos_i is not None:
            res = self._strip_local(sweep_frame(self._pad_local(nhi),
                                                pos_i, flux_i))
        if pos_b is not None:
            red = self.halo_reduce(sweep_frame(self.halo_gather(nhi),
                                               pos_b, flux_b))
            res = red if res is None else res + red
        if res is None:
            res = nhi.new_zeros((2 if do_heat else 1,) + nhi.shape)
        return res[0], (res[1] if do_heat else None)

    def trace(self, ndens, xh_av, src_pos, src_flux, dr):
        """Domain-decomposed Gamma: ``ndens``/``xh_av`` are (N,N,N) arrays
        or tensors (the same on every rank); returns the (N,N,N) Gamma on
        every rank, on the engine's device."""
        eng = self.engine
        sh = (self.N,) * 3
        nd = torch.as_tensor(ndens, dtype=eng.dtype,
                             device=eng.device).reshape(sh)
        xh = torch.as_tensor(xh_av, dtype=eng.dtype,
                             device=eng.device).reshape(sh)
        avg_dens = float(nd.mean()) if self._adaptive else None
        srcs = self.prepare_sources(src_pos, src_flux, dr=float(dr),
                                    avg_dens=avg_dens)
        phi, _ = self._trace_shard(self.local_block(nd, 1.0),
                                   self.local_block(xh, 0.5), srcs,
                                   float(dr))
        return self.assemble(phi)

    # -- the evolve steps --------------------------------------------------
    def _sums(self, xi3, mask):
        """sum(x) and sum(1 - x) over the block's real cells."""
        if mask is None:
            return xi3.sum(), (1.0 - xi3).sum()
        w = mask.to(xi3.dtype)
        return (xi3 * w).sum(), ((1.0 - xi3) * w).sum()

    def make_step(self, chem: ChemistryParams, srcs):
        """One domain-decomposed (raytrace + chemistry) iteration on the
        blocks. step(ndens, temp, xh, xh_av, dt, dr) -> (xh_intermed,
        xh_av_new, phi[, heat], conv_flag, sum_xh1, sum_xh0, absorbed):
        blocks, then Python numbers summed over the mesh (the absorbed
        rate without dr^3). ``srcs`` is the tuple of ``prepare_sources``."""
        heating = self.engine.do_heating

        def step(ndens, temp, xh, xh_av, dt, dr):
            phi, heat = self._trace_shard(ndens, xh_av, srcs, dr)
            sh = phi.shape
            mask = self._valid_mask()
            xi, xav, cf = global_pass(
                dt, ndens.reshape(-1), temp.reshape(-1), xh.reshape(-1),
                xh_av.reshape(-1), phi.reshape(-1), chem,
                mask=None if mask is None else mask.reshape(-1))
            xi3 = xi.reshape(sh)
            scal = self.mesh.sum_scalars(cf, *self._sums(xi3, mask),
                                         _absorbed_rate(phi, ndens, xh_av))
            if heating:
                return (xi3, xav.reshape(sh), phi, heat, *scal)
            return (xi3, xav.reshape(sh), phi, *scal)

        return step

    def _trace_shard_he(self, nd, xh, y1, y2, srcs, dr):
        """The three-species trace of the block's owned sources (engine =
        ops.raytrace_he.HeRaytracer): the structure of ``_trace_shard``, the
        three absorber fields stacked into one exchange."""
        pos_i, flux_i, pos_b, flux_b = srcs
        eng = self.engine
        fields = torch.stack(eng.species_fields(nd, xh, y1, y2))
        n_out = 4 if eng.do_heating else 3
        res = None
        if pos_i is not None:
            ext = self._pad_local(fields)
            res = self._strip_local(torch.stack(eng.trace_extended(
                tuple(ext), pos_i, flux_i, dr)))
        if pos_b is not None:
            ext = self.halo_gather(fields)
            red = self.halo_reduce(torch.stack(eng.trace_extended(
                tuple(ext), pos_b, flux_b, dr)))
            res = red if res is None else res + red
        if res is None:
            res = nd.new_zeros((n_out,) + nd.shape)
        return tuple(res.unbind(0))

    def make_step_he(self, phe, srcs):
        """One domain-decomposed three-species iteration (raytrace_he +
        chemistry_he), the mirror of ``make_step``.

        step(ndens, temp, xh0, xh_av, y1_0, y1_av, y2_0, y2_av, dt, dr)
        -> (xi, xav, y1i, y1a, y2i, y2a, gH, gHe1, gHe2[, heat], cf, s1,
        s0, absorbed)."""
        from ..ops.chemistry_he import global_pass_he, secondary_enabled
        eng = self.engine
        secondary = secondary_enabled(phe, eng.do_heating)

        def step(ndens, temp, xh0, xh_av, y1_0, y1_av, y2_0, y2_av, dt, dr):
            g = self._trace_shard_he(ndens, xh_av, y1_av, y2_av, srcs, dr)
            sh = g[0].shape
            mask = self._valid_mask()

            def r(a):
                return a.reshape(-1)
            (xi, xav, y1i, y1a, y2i, y2a, cf) = global_pass_he(
                dt, r(ndens), r(temp), r(xh0), r(xh_av),
                r(y1_0), r(y1_av), r(y2_0), r(y2_av),
                r(g[0]), r(g[1]), r(g[2]), phe,
                mask=None if mask is None else r(mask),
                heat=r(g[3]) if secondary else None,
                recombination_photons=bool(phe.recombination_photons))
            xi3 = xi.reshape(sh)
            scal = self.mesh.sum_scalars(
                cf, *self._sums(xi3, mask),
                _absorbed_rate_he(g[0], g[1], g[2], ndens, xh_av, y1_av,
                                  y2_av, phe.abu_he))
            outs = tuple(a.reshape(sh) for a in
                         (xi, xav, y1i, y1a, y2i, y2a))
            return outs + tuple(g) + tuple(scal)

        return step

    def make_thermal_step(self, thermal, zred=0.0, nsub=16):
        """The post-convergence temperature update on the block (local,
        no communication; see ops/thermal.py)."""
        from ..ops.thermal import update_temperature

        def tstep(dt, temp, ndens, xh_av, heat):
            return update_temperature(dt, temp, ndens, xh_av, heat,
                                      thermal, z=zred, nsub=nsub)
        return tstep


def evolve3D_domain(dt, dr, src_flux, src_pos, decomp: DomainDecomposition,
                    chem: ChemistryParams, temp, ndens, xh,
                    convergence_fraction=1e-4, logfile=None, quiet=False,
                    max_iterations=100, thermal=None, zred=0.0,
                    loss_fraction=None):
    """Domain-decomposed evolve3D: the convergence loop of the reference's
    evolve3D_MPI (evolve.py:249) with halo exchange instead of replicated
    Reduce+Bcast, and the chemistry on each rank's block. Every rank of the
    mesh calls it with the same (N,N,N) inputs; each returns the (N,N,N)
    numpy (xh, phi_ion[, temp_new]). With ``thermal`` the temperature
    advances after convergence (on the blocks, no communication)."""
    eng = decomp.engine
    N = decomp.N
    num_cells = N ** 3
    num_src = int(np.asarray(src_flux).shape[0])
    dtype, dev = eng.dtype, eng.device
    sh3 = (N, N, N)
    logfile, quiet = decomp.mesh.log_args(logfile, quiet)

    def grid(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).reshape(sh3)

    ndens_g = grid(ndens)
    avg_dens = float(ndens_g.mean()) if decomp._adaptive else None
    temp_d = decomp.local_block(grid(temp), 1e4)
    ndens_d = decomp.local_block(ndens_g, 1.0)
    xh_d = decomp.local_block(grid(xh), 0.5)
    srcs = decomp.prepare_sources(src_pos, src_flux, dr=float(dr),
                                  avg_dens=avg_dens)
    step = decomp.make_step(chem, srcs)
    dt_d = torch.tensor(dt, dtype=dtype).to(dev)
    emitted = float(np.sum(np.asarray(src_flux, dtype=np.float64))) \
        * S_STAR_REF

    heating = eng.do_heating
    if thermal is not None and not heating:
        raise ValueError("thermal evolution requires a heating engine")

    printlog(f"Calling evolve3D over domain mesh "
             f"{decomp.pi}x{decomp.pj}x{decomp.pk} "
             f"(halo {decomp.hlo}/{decomp.hhi}, "
             f"{decomp.n_interior}/{num_src} interior sources swept without "
             f"the exchange)...", logfile, quiet)
    state = {"xh_av": xh_d, "xh_intermed": xh_d,
             "phi_ion": None, "phi_heat": None}
    halo0 = decomp.mesh.traffic.get("halo", {}).get("bytes", 0)

    def iteration(niter):
        t0 = time.time()
        out = step(ndens_d, temp_d, xh_d, state["xh_av"], dt_d, float(dr))
        if heating:
            (xh_intermed, xh_av, phi_ion, phi_heat,
             conv_flag, sum_xh1, sum_xh0, absorbed) = out
        else:
            (xh_intermed, xh_av, phi_ion,
             conv_flag, sum_xh1, sum_xh0, absorbed) = out
            phi_heat = None
        printlog(f"Iteration {niter} took {time.time()-t0:.3f} s.",
                 logfile, quiet)
        state.update(xh_av=xh_av, xh_intermed=xh_intermed,
                     phi_ion=phi_ion, phi_heat=phi_heat)
        absorbed_rate = absorbed * float(dr) ** 3
        loss = (1.0 - absorbed_rate / emitted) if emitted > 0 else 0.0
        return IterationResult(int(conv_flag), sum_xh1, sum_xh0,
                               photon_loss=loss)

    niter = run_convergence_loop(iteration, num_cells, num_src,
                                 convergence_fraction, max_iterations,
                                 logfile, quiet, loss_fraction=loss_fraction)
    halo = decomp.mesh.traffic.get("halo", {}).get("bytes", 0) - halo0
    printlog(f"Halo exchange: {halo / max(niter, 1):.0f} bytes sent per "
             f"iteration by this rank", logfile, quiet)

    def out3(block):
        return decomp.assemble(block).cpu().numpy().reshape(sh3)

    out = (out3(state["xh_intermed"]), out3(state["phi_ion"]))
    if thermal is not None:
        tstep = decomp.make_thermal_step(thermal, zred=float(zred))
        temp_new = tstep(dt_d, temp_d, ndens_d, state["xh_av"],
                         state["phi_heat"])
        out = out + (out3(temp_new),)
    return out


def evolve3D_he_domain(dt, dr, src_flux, src_pos,
                       decomp: DomainDecomposition, phe, temp, ndens,
                       xh, y1, y2, convergence_fraction=1e-4,
                       logfile=None, quiet=False, max_iterations=100,
                       thermal=None, zred=0.0, loss_fraction=None):
    """Domain-decomposed coupled H+He evolve loop (engine =
    ops.raytrace_he.HeRaytracer bound to the decomposition): the
    convergence semantics of evolve.evolve3D_he; the three absorber fields
    are halo-exchanged per iteration and the coupled chemistry runs on the
    blocks.

    Returns (xh, phi_HI, y1, y2, phi_HeI, phi_HeII[, temp_new]) as (N,N,N)
    numpy arrays on every rank."""
    from ..ops.chemistry_he import secondary_enabled, thermal_heat_rate
    eng = decomp.engine
    N = decomp.N
    num_cells = N ** 3
    num_src = int(np.asarray(src_flux).shape[0])
    dtype, dev = eng.dtype, eng.device
    sh3 = (N, N, N)
    logfile, quiet = decomp.mesh.log_args(logfile, quiet)

    def block(a, fill):
        return decomp.local_block(
            torch.as_tensor(a, dtype=dtype, device=dev).reshape(sh3), fill)

    temp_d = block(temp, 1e4)
    ndens_d = block(ndens, 1.0)
    xh_d = block(xh, 0.5)
    y1_d = block(y1, 0.1)
    y2_d = block(y2, 0.1)
    srcs = decomp.prepare_sources(src_pos, src_flux)
    step = decomp.make_step_he(phe, srcs)
    dt_d = torch.tensor(dt, dtype=dtype).to(dev)
    emitted = float(np.sum(np.asarray(src_flux, dtype=np.float64))) \
        * S_STAR_REF
    heating = eng.do_heating
    if thermal is not None and not heating:
        raise ValueError("thermal evolution requires HeRaytracer("
                         "do_heating=True)")
    secondary = secondary_enabled(phe, heating)
    ng = 10 if heating else 9

    printlog(f"Calling evolve3D_he over domain mesh "
             f"{decomp.pi}x{decomp.pj}x{decomp.pk} on {num_src:n} "
             f"source(s)...", logfile, quiet)
    state = {"xh_av": xh_d, "y1_av": y1_d, "y2_av": y2_d,
             "xh_int": xh_d, "y1_int": y1_d, "y2_int": y2_d, "g": None}

    def iteration(niter):
        t0 = time.time()
        out = step(ndens_d, temp_d, xh_d, state["xh_av"], y1_d,
                   state["y1_av"], y2_d, state["y2_av"], dt_d, float(dr))
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

    def out3(b):
        return decomp.assemble(b).cpu().numpy().reshape(sh3)

    g = state["g"]
    out = (out3(state["xh_int"]), out3(g[0]), out3(state["y1_int"]),
           out3(state["y2_int"]), out3(g[1]), out3(g[2]))
    if thermal is not None:
        tstep = decomp.make_thermal_step(thermal, zred=float(zred))
        heat_rate = thermal_heat_rate(phe, g[3], state["xh_av"], secondary)
        temp_new = tstep(dt_d, temp_d, ndens_d, state["xh_av"], heat_rate)
        out = out + (out3(temp_new),)
    return out
