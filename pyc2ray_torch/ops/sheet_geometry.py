"""Sheet-layout geometry of the octahedral sheet ("box") raytracing engine.

NumPy copy of pyc2ray_tpu/ops/sheet_geometry.py on the port's
ops/geometry.py::_corner_tables; the tests hold every field bit-equal to
the JAX package's tables.

The octahedron around a source is organized as, per shell q, two 2D
"sheets" indexed by (i, j): the top sheet holds the cell (i, j, k) with
k = +(q - |i| - |j|) and the bottom sheet its mirror k = -(q - |i| - |j|).
In this layout every short-characteristics corner lives at the SAME (i, j)
or at (i -> i-sgn(i)) / (j -> j-sgn(j)) in one of the sheets q-1, q-2, q-3
(the k coordinate is implicit), so corner fetches are static +-1 shifts.
The z <-> -z mirror symmetry makes all geometric quantities (weights,
path, diagonal factor, distance) shared between the two sheets.

This module precomputes, on the host, dense [Q, Dc, Dc] tables of the
cinterp geometry (weights s1..s4, path, diag, dist2, branch selectors,
validity masks) plus the shear/unshear index maps between the cartesian
box [Dc]^3 around the source and the sheet stack [2, Q, Dc, Dc].

Corner -> shifted-sheet mapping (derivation from raytracing.f90:576-815,
with X = shift toward the source axis):
    z-branch: c1=SxSy(F[q-3]) c2=Sy(F[q-2]) c3=Sx(F[q-2]) c4=F[q-1]
    y-branch: c1=SxSy(F[q-3]) c2=Sy(F[q-2]) c3=SxSy(F[q-2]) c4=Sy(F[q-1])
    x-branch: c1=SxSy(F[q-3]) c2=Sx(F[q-2]) c3=SxSy(F[q-2]) c4=Sx(F[q-1])
"""

from functools import lru_cache
from typing import NamedTuple

import numpy as np

from .geometry import _corner_tables

__all__ = ["SheetGeometry", "build_sheet_geometry"]


class SheetGeometry(NamedTuple):
    N: int
    max_q: int
    Dc: int                  # box side (= hi - lo + 1)
    c: int                   # array index of the source in the box (= -lo)
    Q: int                   # number of shells (max_q + 1)
    sw: np.ndarray           # (4, Q, Dc, Dc) f64 corner weights
    path: np.ndarray         # (Q, Dc, Dc) f64 (path in cell units; [0,c,c]=0.5)
    diag: np.ndarray         # (Q, Dc, Dc) f64 diagonal factor
    dist2: np.ndarray        # (Q, Dc, Dc) f64 |offset|^2 in cell units
    in_z: np.ndarray         # (Q, Dc, Dc) bool dominant-axis selectors
    in_y: np.ndarray         # (Q, Dc, Dc) bool
    valid_top: np.ndarray    # (Q, Dc, Dc) bool sweep validity (m<=q & clip)
    valid_bot: np.ndarray    # (Q, Dc, Dc) bool (includes equator duplicate)
    rate_top: np.ndarray     # (Q, Dc, Dc) bool rate validity
    rate_bot: np.ndarray     # (Q, Dc, Dc) bool (equator excluded)
    zidx: np.ndarray         # (Dc, Dc, 2*Q) int32 shear map: z-index in the
                             #   box of sheet cell (i,j,[f,q]), f-major last
    qidx: np.ndarray         # (Dc, Dc, Dc) int32 unshear: shell of box cell
    unshear_valid: np.ndarray  # (Dc, Dc, Dc) bool box cell is in octahedron
    k_nonneg: np.ndarray     # (Dc, Dc, Dc) bool box cell z >= source plane
    mbits: np.ndarray        # (n_bits, Dc, Dc) bool: bits of m = |i|+|j|
                             #   (drives the binary-decomposed shear shifts)
    n_bits: int


@lru_cache(maxsize=8)
def build_sheet_geometry(N: int, max_q: int) -> SheetGeometry:
    last_r = N // 2 - 1 + (N % 2)
    last_l = -(N // 2)
    lo = max(last_l, -max_q)
    hi = min(last_r, max_q)
    c = -lo
    # pad the box side to a multiple of 8, unless that would make the wrap
    # padding exceed the mesh size: the JAX package's alignment for its
    # vector unit, kept so that the tables stay bit-equal to the JAX ones
    # (the port sweeps the extra cells as invalid; ROADMAP.md P7)
    Dc = -(-(hi - lo + 1) // 8) * 8
    if Dc - 1 - c > N:
        Dc = hi - lo + 1
    Q = max_q + 1

    ij = np.arange(Dc, dtype=np.int64) - c       # i (or j) offset per index
    in_range = (ij >= lo) & (ij <= hi)
    I = ij[:, None, None] * np.ones((1, Dc, 1), dtype=np.int64)
    J = ij[None, :, None] * np.ones((Dc, 1, 1), dtype=np.int64)
    Qs = np.arange(Q, dtype=np.int64)[None, None, :]
    M = np.abs(I) + np.abs(J)
    K = Qs - M                                   # k_abs, may be negative

    # geometry via the shared cinterp kernel on flattened (i, j, k_abs)
    flat_i = np.broadcast_to(I, (Dc, Dc, Q)).ravel()
    flat_j = np.broadcast_to(J, (Dc, Dc, Q)).ravel()
    flat_k = np.maximum(K, 0).ravel()            # clamp; invalid masked later
    # exclude the origin cell (handled specially) by faking it as (1,0,0)
    origin = (flat_i == 0) & (flat_j == 0) & (flat_k == 0)
    fi = np.where(origin, 1, flat_i)
    corners, s, path, diag = _corner_tables(fi, flat_j, flat_k)
    del corners

    def reshape(a):
        return np.transpose(a.reshape(Dc, Dc, Q), (2, 0, 1))

    sw = np.stack([reshape(s[r]) for r in range(4)])
    path = reshape(np.where(origin, 0.5, path))
    diag = reshape(np.where(origin, 1.0, diag))
    dist2 = reshape((flat_i ** 2 + flat_j ** 2 + flat_k ** 2).astype(np.float64))

    kdela = np.abs(flat_k)
    idela, jdela = np.abs(flat_i), np.abs(flat_j)
    in_z = reshape((kdela >= jdela) & (kdela >= idela) & ~origin)
    in_y = reshape(~((kdela >= jdela) & (kdela >= idela))
                   & (jdela >= idela) & (jdela >= kdela) & ~origin)

    # validity masks in (Q, Dc, Dc) layout
    Kq = np.transpose(np.broadcast_to(K, (Dc, Dc, Q)), (2, 0, 1))
    IJok = in_range[:, None] & in_range[None, :]          # (Dc, Dc)
    IJokq = np.transpose(
        np.broadcast_to(IJok[:, :, None], (Dc, Dc, Q)), (2, 0, 1))
    in_shell = (Kq >= 0) & IJokq                  # m <= q, (i,j) in clip
    clip_top = (Kq >= lo) & (Kq <= hi)            # always true for k>=0<=hi
    clip_bot = (-Kq >= lo) & (-Kq <= hi)
    valid_top = in_shell & clip_top
    valid_bot = in_shell & clip_bot
    rate_top = valid_top
    rate_bot = valid_bot & (Kq > 0)               # equator only counted in top

    # shear map: z-index (in box coords) of sheet (f, q) cell (i, j)
    z_top = np.clip(c + K, 0, Dc - 1)            # (Dc, Dc, Q)
    z_bot = np.clip(c - K, 0, Dc - 1)
    zidx = np.concatenate([z_top, z_bot], axis=2).astype(np.int32)

    # unshear: for box cell (i, j, z): shell q = m + |z - c|
    Z = np.arange(Dc, dtype=np.int64)[None, None, :] - c
    Qbox = M + np.abs(Z)
    z_ok = (Z >= lo) & (Z <= hi)
    unshear_valid = np.broadcast_to(
        (Qbox <= max_q) & IJok[:, :, None] & z_ok, (Dc, Dc, Dc)).copy()
    qidx = np.clip(Qbox, 0, Q - 1).astype(np.int32)
    k_nonneg = np.broadcast_to(Z >= 0, (Dc, Dc, Dc)).copy()

    # bits of the per-column shift m = |i| + |j| (clamped to the largest
    # meaningful shift) for the dense binary-decomposed shear
    m2d = np.minimum(np.abs(ij)[:, None] + np.abs(ij)[None, :],
                     2 * max_q).astype(np.int64)
    n_bits = max(int(np.ceil(np.log2(max(int(m2d.max()), 1) + 1))), 1)
    mbits = np.stack([(m2d >> b) & 1 for b in range(n_bits)]).astype(bool)

    return SheetGeometry(
        N=N, max_q=max_q, Dc=Dc, c=c, Q=Q, mbits=mbits, n_bits=n_bits,
        sw=sw, path=path, diag=diag, dist2=dist2,
        in_z=in_z, in_y=in_y,
        valid_top=valid_top, valid_bot=valid_bot,
        rate_top=rate_top, rate_bot=rate_bot,
        zidx=zidx, qidx=qidx, unshear_valid=unshear_valid,
        k_nonneg=k_nonneg)
