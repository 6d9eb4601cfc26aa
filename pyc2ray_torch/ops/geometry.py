"""Cell geometry of the short-characteristics interpolation.

``_corner_tables`` is the vectorized cinterp geometry of C2Ray
(raytracing.f90:576-815): for each cell offset from the source it gives the
four interpolation corners, their geometric weights, the path length through
the cell and the diagonal correction factor. ``max_q_for`` sizes the L1
octahedron for a raytracing radius. Host-side numpy, built once per engine.
"""

import numpy as np

__all__ = ["max_q_for"]

SQRT2 = np.float64(1.41421356237)   # value used by raytracing.cu:439
SQRT3 = np.float64(1.73205080757)   # value used by raytracing.cu:435


def max_q_for(R: float, N: int) -> int:
    """Octahedron size for raytracing radius R on an N^3 periodic grid.

    Mirrors raytracing.cu:101: the octahedron is sized so a sphere of
    radius R fits inside it, capped at the full periodic box.
    """
    return int(np.ceil(1.73205080757 * min(float(R), 1.73205080757 * N / 2.0)))


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
