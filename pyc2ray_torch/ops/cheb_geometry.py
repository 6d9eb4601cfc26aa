"""Chebyshev-shell (cube-face) traversal geometry.

The short-characteristics dependency graph admits a traversal by
concentric CUBE shells r = max(|i|,|j|,|k|) with three sub-steps:

  1. x-faces (|i| = r, |j| < r, |k| < r): the cinterp x-branch
     (raytracing.f90:764-800) reads only corners with i' = i -+ 1 — the
     entire stencil lives in the parallel plane i' = +-(r-1), at 2D
     offsets {(jm,km), (j,km), (jm,k), (j,k)}.
  2. y-faces (|j| = r, |i| <= r, |k| < r): stencil in plane j' = +-(r-1);
     edge cells |i| = r also read x-face cells of the SAME shell —
     already written in sub-step 1.
  3. z-faces (|k| = r): stencil in plane k' = +-(r-1); edge cells read
     x/y faces of the same shell (sub-steps 1-2).

The face assignment (z if |k|=r; else y if |j|=r; else x) coincides
exactly with the reference's dominant-axis branch priority, so the values
computed are identical to the L1-shell (ASORA) and cube-sweep (Fortran)
traversals — only the evaluation order differs.

Every sub-step is two plane reads, three +-1 shifts toward the source, a
dense weight evaluation and a masked plane write-back; within a face all
cells are independent (ops/csrc/cheb_sweep.cu runs them in parallel).

In local face coordinates (a, b) = the two non-face axes in axis order,
all three faces share one stencil pattern:
  c1 = SaSb(P), c2 = Sb(P), c3 = Sa(P), c4 = P
with S = shift-toward-the-source-axis and P the previous parallel plane.
"""

from functools import lru_cache
from typing import NamedTuple

import numpy as np

from .geometry import _corner_tables

__all__ = ["ChebGeometry", "box_dims", "build_cheb_geometry",
           "pack_rates_tables"]


class ChebGeometry(NamedTuple):
    N: int
    max_q: int
    Dc: int                 # box side (multiple of 8)
    c: int                  # source index in the box
    r_max: int              # largest cube shell
    # per-face-type tables, indexed [r, a, b] (r = shell, (a,b) = plane):
    # face 0 = x (plane coords j,k), 1 = y (i,k), 2 = z (i,j)
    sw: np.ndarray          # (3, 4, r_max+1, Dc, Dc) corner weights
    path: np.ndarray        # (3, r_max+1, Dc, Dc)
    diag: np.ndarray        # (3, r_max+1, Dc, Dc)
    mask_p: np.ndarray      # (3, r_max+1, Dc, Dc) bool: +face cell valid
    mask_m: np.ndarray      # (3, r_max+1, Dc, Dc) bool: -face cell valid
    # dense per-cell tables over the whole box (for the rate pass):
    path3: np.ndarray       # (Dc, Dc, Dc) path length (cells); source 0.5
    dist2: np.ndarray       # (Dc, Dc, Dc)
    rate_valid: np.ndarray  # (Dc, Dc, Dc) bool (octahedron & clip)


def box_dims(N, max_q, r_cube=None):
    """(lo, hi, c, Dc, r_max) of the swept box of ``build_cheb_geometry``:
    the offsets of its first and last cells from the source, the source
    index, the box side and the largest cube shell."""
    last_r = N // 2 - 1 + (N % 2)
    last_l = -(N // 2)
    rc = max_q if r_cube is None else int(r_cube)
    lo = max(last_l, -rc)
    hi = min(last_r, rc)
    c = -lo
    # round the box side up to a multiple of 8 (the JAX engine's alignment,
    # kept so both engines share one geometry), unless that would make the
    # wrap padding exceed the mesh size
    Dc = -(-(hi - lo + 1) // 8) * 8
    if Dc - 1 - c > N:
        Dc = hi - lo + 1
    return lo, hi, c, Dc, min(max_q, max(c, hi))


@lru_cache(maxsize=8)
def build_cheb_geometry(N: int, max_q: int, r_cube: int = None) -> ChebGeometry:
    """Build the cube-shell traversal tables.

    ``max_q`` is the L1 octahedron bound (reference semantics,
    raytracing.cu:101: sized so the Euclidean rate sphere R fits inside).
    ``r_cube`` is the Chebyshev (L(inf)) half-extent of the swept box. In
    the cube-shell formulation every cell that can receive a rate
    (Euclidean dist <= R) has L(inf) <= R, and every stencil parent has
    strictly smaller L(inf), so r_cube = ceil(R) suffices — ~(sqrt3)^3 x
    less box volume than the octahedral bound. Defaults to max_q (the
    conservative original behavior)."""
    lo, hi, c, Dc, r_max = box_dims(N, max_q, r_cube)

    ab = np.arange(Dc, dtype=np.int64) - c
    A = np.broadcast_to(ab[:, None], (Dc, Dc)).ravel()
    B = np.broadcast_to(ab[None, :], (Dc, Dc)).ravel()
    in_rng = (ab >= lo) & (ab <= hi)
    AB_ok = (in_rng[:, None] & in_rng[None, :]).ravel()

    R1 = r_max + 1
    sw = np.zeros((3, 4, R1, Dc, Dc))
    path = np.zeros((3, R1, Dc, Dc))
    diag = np.ones((3, R1, Dc, Dc))
    mask_p = np.zeros((3, R1, Dc, Dc), dtype=bool)
    mask_m = np.zeros((3, R1, Dc, Dc), dtype=bool)

    for r in range(1, R1):
        rr = np.full(A.shape, r, dtype=np.int64)
        # face offsets: x-face cell (r, a=j, b=k); y (a=i, r, b=k); z (a,b,r)
        coords = [(rr, A, B), (A, rr, B), (A, B, rr)]
        # mirror symmetry: geometry identical for -r faces
        for f, (ii, jj, kk) in enumerate(coords):
            _, s, p, dg = _corner_tables(ii, jj, kk)
            sw[f, :, r] = s.reshape(4, Dc, Dc)
            path[f, r] = p.reshape(Dc, Dc)
            diag[f, r] = dg.reshape(Dc, Dc)
            # face membership (matches branch priority):
            #   x: |a|<r, |b|<r ; y: |a|<=r, |b|<r ; z: |a|<=r, |b|<=r
            if f == 0:
                member = (np.abs(A) < r) & (np.abs(B) < r)
            elif f == 1:
                member = (np.abs(A) <= r) & (np.abs(B) < r)
            else:
                member = (np.abs(A) <= r) & (np.abs(B) <= r)
            in_octa = (r + np.abs(A) + np.abs(B)) <= max_q
            base = member & in_octa & AB_ok
            mask_p[f, r] = (base & (r <= hi)).reshape(Dc, Dc)
            mask_m[f, r] = (base & (-r >= lo)).reshape(Dc, Dc)

    # dense 3D tables for the rate pass
    I3 = ab[:, None, None]
    J3 = ab[None, :, None]
    K3 = ab[None, None, :]
    flat_i = np.broadcast_to(I3, (Dc,) * 3).ravel()
    flat_j = np.broadcast_to(J3, (Dc,) * 3).ravel()
    flat_k = np.broadcast_to(K3, (Dc,) * 3).ravel()
    origin = (flat_i == 0) & (flat_j == 0) & (flat_k == 0)
    fi = np.where(origin, 1, flat_i)
    _, _, p3, _ = _corner_tables(fi, flat_j, flat_k)
    path3 = np.where(origin, 0.5, p3).reshape((Dc,) * 3)
    dist2 = (flat_i ** 2 + flat_j ** 2 + flat_k ** 2).astype(
        np.float64).reshape((Dc,) * 3)
    q3 = (np.abs(flat_i) + np.abs(flat_j) + np.abs(flat_k)).reshape((Dc,) * 3)
    rng_ok = ((in_rng[:, None, None]) & (in_rng[None, :, None])
              & (in_rng[None, None, :]))
    rate_valid = (q3 <= max_q) & rng_ok

    return ChebGeometry(
        N=N, max_q=max_q, Dc=Dc, c=c, r_max=r_max,
        sw=sw, path=path, diag=diag, mask_p=mask_p, mask_m=mask_m,
        path3=path3, dist2=dist2, rate_valid=rate_valid)


def pack_rates_tables(g, R2, dtype=np.float32):
    """Per-box-plane tables of the fused rate passes: (Dc, 2, Dc, Dc) with
    channels (dist2, valid). valid excludes the source cell (its rate has
    a closed form, applied by the caller) and applies the octahedron/clip
    mask and the Euclidean R_max_LLS cutoff (raytracing.f90:474), as the
    unfused rate pass masks. A copy of the JAX package's function of the
    same name."""
    Dc, c = g.Dc, g.c
    out = np.zeros((Dc, 2, Dc, Dc), dtype=dtype)
    valid = np.asarray(g.rate_valid) & (np.asarray(g.dist2) <= R2)
    valid[c, c, c] = False
    out[:, 0] = g.dist2
    out[:, 1] = valid
    return out
