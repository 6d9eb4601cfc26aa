"""Octahedral short-characteristics traversal geometry.

Numpy copy of pyc2ray_tpu/ops/geometry.py. ``_corner_tables`` is the
vectorized cinterp geometry of C2Ray (raytracing.f90:576-815): for each cell
offset from the source it gives the four interpolation corners, their
geometric weights, the path length through the cell and the diagonal
correction factor. ``max_q_for`` sizes the L1 octahedron for a raytracing
radius. ``build_geometry`` lays out the cells of that octahedron inside the
periodic clip cube, sorted by shell (constant L1 distance q from the
source), with each cell's 4 interpolation corners as indices into the same
flat layout: the tables of the flat engine (ops/raytrace.py). Host-side
numpy, built once per (N, max_q); the C++ builder of native/ is held
bit-equal to it in the tests, and never used in its place.
"""

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np

__all__ = ["OctaGeometry", "build_geometry", "max_q_for"]

SQRT2 = np.float64(1.41421356237)   # value used by raytracing.cu:439
SQRT3 = np.float64(1.73205080757)   # value used by raytracing.cu:435


def max_q_for(R: float, N: int) -> int:
    """Octahedron size for raytracing radius R on an N^3 periodic grid.

    Mirrors raytracing.cu:101: the octahedron is sized so a sphere of
    radius R fits inside it, capped at the full periodic box.
    """
    return int(np.ceil(1.73205080757 * min(float(R), 1.73205080757 * N / 2.0)))


class OctaGeometry(NamedTuple):
    """Precomputed octahedral traversal tables (numpy, host side).

    C = number of in-clip cells; Cp = padded length (C + max bucket pad).
    """
    N: int                    # mesh size
    max_q: int                # largest shell index
    num_cells: int            # C
    offsets: np.ndarray       # (3, Cp) int32 cell offsets from source
    nbr: np.ndarray           # (4, Cp) int32 flat indices of interpolation corners
    sw: np.ndarray            # (4, Cp) f64 geometric corner weights s1..s4
    path: np.ndarray          # (Cp,) f64 path length through cell, in cell units
                              #   (cell 0 stores 0.5: the source half-cell path,
                              #    raytracing.f90:434)
    diag: np.ndarray          # (Cp,) f64 diagonal correction (1, sqrt2, sqrt3)
    dist2: np.ndarray         # (Cp,) f64 squared distance to source, cell units
    shell_start: np.ndarray   # (max_q+2,) int32 flat offset of each shell
    shell_size: np.ndarray    # (max_q+1,) int32 number of cells in each shell
    buckets: Tuple[Tuple[int, int, int], ...]  # (q_lo, q_hi, S_pad) runs


def _corner_tables(di, dj, dk):
    """Vectorized cinterp geometry (raytracing.f90:576-815, source at origin).

    Given integer offset arrays (cells at shell >= 1), returns corner offsets
    (4,3,n), geometric weights s (4,n), path (n,), diag factor (n,).
    """
    idela, jdela, kdela = np.abs(di), np.abs(dj), np.abs(dk)
    # Fortran sign(1,x): +1 for x >= 0 (raytracing.f90:643-647)
    sgni = np.where(di >= 0, 1, -1).astype(np.int64)
    sgnj = np.where(dj >= 0, 1, -1).astype(np.int64)
    sgnk = np.where(dk >= 0, 1, -1).astype(np.int64)
    im, jm, km = di - sgni, dj - sgnj, dk - sgnk
    fdi, fdj, fdk = di.astype(np.float64), dj.astype(np.float64), dk.astype(np.float64)
    fim, fjm, fkm = im.astype(np.float64), jm.astype(np.float64), km.astype(np.float64)

    # branch masks, same priority as the Fortran if/elseif chain
    in_z = (kdela >= jdela) & (kdela >= idela)
    in_y = ~in_z & (jdela >= idela) & (jdela >= kdela)
    in_x = ~in_z & ~in_y

    n = di.shape[0]
    s = np.zeros((4, n), dtype=np.float64)
    path = np.zeros(n, dtype=np.float64)
    diag = np.ones(n, dtype=np.float64)
    corners = np.zeros((4, 3, n), dtype=np.int64)

    with np.errstate(divide="ignore", invalid="ignore"):
        # ---- z-plane crossing (raytracing.f90:662-710)
        alam = (fkm + sgnk * 0.5) / fdk
        xc = alam * fdi
        yc = alam * fdj
        dx = 2.0 * np.abs(xc - (fim + 0.5 * sgni))
        dy = 2.0 * np.abs(yc - (fjm + 0.5 * sgnj))
        sz = np.stack([(1. - dx) * (1. - dy), (1. - dy) * dx,
                       (1. - dx) * dy, dx * dy])
        pz = np.sqrt((fdi * fdi + fdj * fdj) / (fdk * fdk) + 1.0)
        cz = np.array([  # corner offset selectors: (use_i_plus, use_j_plus)
            (0, 0), (1, 0), (0, 1), (1, 1)])
        for c in range(4):
            ci = np.where(cz[c, 0], di, im)
            cj = np.where(cz[c, 1], dj, jm)
            corners[c, 0] = np.where(in_z, ci, corners[c, 0])
            corners[c, 1] = np.where(in_z, cj, corners[c, 1])
            corners[c, 2] = np.where(in_z, km, corners[c, 2])
        s = np.where(in_z, sz, s)
        path = np.where(in_z, pz, path)
        dgz = np.where((kdela == 1) & (idela == 1) & (jdela == 1), SQRT3,
                       np.where((kdela == 1) & ((idela == 1) | (jdela == 1)),
                                SQRT2, 1.0))
        diag = np.where(in_z, dgz, diag)

        # ---- y-plane crossing (raytracing.f90:715-758)
        alam = (fjm + sgnj * 0.5) / fdj
        zc = alam * fdk
        xc = alam * fdi
        dz = 2.0 * np.abs(zc - (fkm + 0.5 * sgnk))
        dx = 2.0 * np.abs(xc - (fim + 0.5 * sgni))
        sy = np.stack([(1. - dx) * (1. - dz), (1. - dz) * dx,
                       (1. - dx) * dz, dx * dz])
        py = np.sqrt((fdi * fdi + fdk * fdk) / (fdj * fdj) + 1.0)
        cy = np.array([(0, 0), (1, 0), (0, 1), (1, 1)])  # (use_i_plus, use_k_plus)
        for c in range(4):
            ci = np.where(cy[c, 0], di, im)
            ck = np.where(cy[c, 1], dk, km)
            corners[c, 0] = np.where(in_y, ci, corners[c, 0])
            corners[c, 1] = np.where(in_y, jm, corners[c, 1])
            corners[c, 2] = np.where(in_y, ck, corners[c, 2])
        s = np.where(in_y, sy, s)
        path = np.where(in_y, py, path)
        dgy = np.where((jdela == 1) & (idela == 1) & (kdela == 1), SQRT3,
                       np.where((jdela == 1) & ((idela == 1) | (kdela == 1)),
                                SQRT2, 1.0))
        diag = np.where(in_y, dgy, diag)

        # ---- x-plane crossing (raytracing.f90:764-800)
        alam = (fim + sgni * 0.5) / fdi
        zc = alam * fdk
        yc = alam * fdj
        dz = 2.0 * np.abs(zc - (fkm + 0.5 * sgnk))
        dy = 2.0 * np.abs(yc - (fjm + 0.5 * sgnj))
        sx = np.stack([(1. - dz) * (1. - dy), (1. - dz) * dy,
                       (1. - dy) * dz, dy * dz])
        px = np.sqrt(1.0 + (fdj * fdj + fdk * fdk) / (fdi * fdi))
        cx = np.array([(0, 0), (1, 0), (0, 1), (1, 1)])  # (use_j_plus, use_k_plus)
        for c in range(4):
            cj = np.where(cx[c, 0], dj, jm)
            ck = np.where(cx[c, 1], dk, km)
            corners[c, 0] = np.where(in_x, im, corners[c, 0])
            corners[c, 1] = np.where(in_x, cj, corners[c, 1])
            corners[c, 2] = np.where(in_x, ck, corners[c, 2])
        s = np.where(in_x, sx, s)
        path = np.where(in_x, px, path)
        dgx = np.where((idela == 1) & (jdela == 1) & (kdela == 1), SQRT3,
                       np.where((idela == 1) & ((jdela == 1) | (kdela == 1)),
                                SQRT2, 1.0))
        diag = np.where(in_x, dgx, diag)

    return corners, s, path, diag


def _bucket_plan(shell_size, lane=128):
    """Group consecutive shells into runs sharing a padded size (multiple of
    ``lane``, power-of-two scaled) so the device sweep uses a handful of
    fixed-shape loops."""
    def pad_of(n):
        p = lane
        while p < n:
            p *= 2
        return p

    buckets = []
    q = 1
    nq = len(shell_size) - 1  # shell_size[0] is the source cell
    while q <= nq:
        p = pad_of(max(int(shell_size[q]), 1))
        q_hi = q + 1
        while q_hi <= nq and pad_of(max(int(shell_size[q_hi]), 1)) == p:
            q_hi += 1
        buckets.append((q, q_hi, p))
        q = q_hi
    return tuple(buckets)


@lru_cache(maxsize=8)
def build_geometry(N: int, max_q: int) -> OctaGeometry:
    """The octahedral traversal tables for an N^3 periodic grid, cached
    per (N, max_q)."""
    return _build_geometry_numpy(N, max_q)


def _build_geometry_numpy(N: int, max_q: int) -> OctaGeometry:
    """Pure-numpy geometry builder."""
    # periodic clip cube (raytracing.cu:122-123)
    last_r = N // 2 - 1 + (N % 2)
    last_l = -(N // 2)
    lo = max(last_l, -max_q)
    hi = min(last_r, max_q)
    side = hi - lo + 1

    # enumerate candidate offsets and keep those within the octahedron
    rng = np.arange(lo, hi + 1, dtype=np.int64)
    DI, DJ, DK = np.meshgrid(rng, rng, rng, indexing="ij")
    q_all = np.abs(DI) + np.abs(DJ) + np.abs(DK)
    keep = q_all <= max_q
    di, dj, dk = DI[keep], DJ[keep], DK[keep]
    q = q_all[keep]

    order = np.argsort(q, kind="stable")
    di, dj, dk, q = di[order], dj[order], dk[order], q[order]
    C = di.shape[0]

    shell_size = np.bincount(q, minlength=max_q + 1).astype(np.int32)
    shell_start = np.zeros(max_q + 2, dtype=np.int64)
    np.cumsum(shell_size, out=shell_start[1:])
    assert shell_start[1] == 1 and shell_size[0] == 1

    # inverse map offset -> flat index
    inv = np.full((side, side, side), -1, dtype=np.int64)
    inv[di - lo, dj - lo, dk - lo] = np.arange(C, dtype=np.int64)

    # corner geometry for all cells beyond the source cell
    corners, s, path, diag = _corner_tables(di[1:], dj[1:], dk[1:])

    # resolve corner offsets to flat indices; out-of-table corners must have
    # zero geometric weight (see module docstring) and are clamped to 0.
    nbr = np.zeros((4, C), dtype=np.int64)
    for c in range(4):
        ci, cj, ck = corners[c, 0], corners[c, 1], corners[c, 2]
        inside = ((ci >= lo) & (ci <= hi) & (cj >= lo) & (cj <= hi)
                  & (ck >= lo) & (ck <= hi))
        idx = np.zeros(C - 1, dtype=np.int64)
        idx[inside] = inv[ci[inside] - lo, cj[inside] - lo, ck[inside] - lo]
        missing = ~inside | (idx < 0)
        if np.any(missing):
            assert np.all(s[c][missing] == 0.0), \
                "corner outside table carries nonzero weight"
            idx[missing] = 0
        # causality: corners must live in strictly earlier shells
        assert np.all(idx[s[c] > 0] < shell_start[q[1:]][s[c] > 0]), \
            "corner with weight in same/later shell"
        nbr[c] = np.concatenate([[0], idx])

    sw = np.concatenate([np.zeros((4, 1)), s], axis=1)
    path_full = np.concatenate([[0.5], path])       # source half-cell path
    diag_full = np.concatenate([[1.0], diag])
    dist2 = (di * di + dj * dj + dk * dk).astype(np.float64)

    buckets = _bucket_plan(shell_size)
    pad = max((b[2] for b in buckets), default=128)
    Cp = C + pad

    def padded(a, fill=0):
        out = np.full(a.shape[:-1] + (Cp,), fill, dtype=a.dtype)
        out[..., :C] = a
        return out

    return OctaGeometry(
        N=N, max_q=max_q, num_cells=C,
        offsets=padded(np.stack([di, dj, dk])).astype(np.int32),
        nbr=padded(nbr).astype(np.int32),
        sw=padded(sw),
        path=padded(path_full),
        diag=padded(diag_full, fill=1.0),
        dist2=padded(dist2),
        shell_start=shell_start.astype(np.int32),
        shell_size=shell_size,
        buckets=buckets,
    )
