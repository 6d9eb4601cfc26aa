"""Sequential NumPy oracle: the C2Ray reference algorithm, cell by cell.

NumPy copy of pyc2ray_tpu/oracle/c2ray_ref.py on the port's own
constants (the tests hold the two bit-equal). A slow, plain-Python/NumPy
re-statement of the reference physics, used as the accuracy oracle of the
port's engines (the role the Fortran ``libc2ray`` plays for ASORA in the
reference: test/unit_tests_hackathon/1_single_black_body/run_test.py).

Algorithms implemented (with reference citations):
* cube-sweep short-characteristics raytracing for one or more sources
  (src/c2ray/raytracing.f90:52-567), full-range (no subbox early exit)
* cinterp 4-corner weighted interpolation (raytracing.f90:576-815)
* photoionization rates, tabulated thin/thick + grey analytic
  (src/c2ray/photorates.f90:13-149). Note: the oracle uses the correct
  per-source flux, i.e. it does NOT reproduce the reference's latent
  ``normflux(NumSrc)`` indexing bug (raytracing.f90:500,503), and it uses
  tau_in for the thin-table lookup as the Fortran does (photorates.f90:121).
* doric analytic chemistry update + global convergence pass
  (src/c2ray/chemistry.f90:13-316)
"""

import numpy as np

from ..constants import (S_STAR_REF, TAU_PHOTO_LIMIT, MAX_COLDENSH, EPSILON)

SQRT2 = 1.41421356237
SQRT3 = 1.73205080757
FOURPI = 12.566370614359172463991853874177

MIN_FRACTIONAL_CHANGE = 1.0e-3
MIN_FRACTION_OF_ATOMS = 1.0e-8


def _sign(x):
    return 1 if x >= 0 else -1


def _weightf(cd, sig):
    return 1.0 / max(0.6, cd * sig)


def _cinterp(i, j, k, i0, j0, k0, coldensh_out, sig, N):
    """Column density at the cell entry point (raytracing.f90:576-815).

    Coordinates are 0-indexed absolute grid positions (possibly outside
    [0,N), periodic wrap applied on lookup)."""
    idel, jdel, kdel = i - i0, j - j0, k - k0
    idela, jdela, kdela = abs(idel), abs(jdel), abs(kdel)
    sgni, sgnj, sgnk = _sign(idel), _sign(jdel), _sign(kdel)
    im, jm, km = i - sgni, j - sgnj, k - sgnk
    di, dj, dk = float(idel), float(jdel), float(kdel)

    def cd(a, b, c):
        return coldensh_out[a % N, b % N, c % N]

    if kdela >= jdela and kdela >= idela:
        alam = (float(km - k0) + sgnk * 0.5) / dk
        xc = alam * di + float(i0)
        yc = alam * dj + float(j0)
        dx = 2.0 * abs(xc - (float(im) + 0.5 * sgni))
        dy = 2.0 * abs(yc - (float(jm) + 0.5 * sgnj))
        s1 = (1. - dx) * (1. - dy)
        s2 = (1. - dy) * dx
        s3 = (1. - dx) * dy
        s4 = dx * dy
        c1, c2, c3, c4 = cd(im, jm, km), cd(i, jm, km), cd(im, j, km), cd(i, j, km)
        w1, w2, w3, w4 = (s1 * _weightf(c1, sig), s2 * _weightf(c2, sig),
                          s3 * _weightf(c3, sig), s4 * _weightf(c4, sig))
        cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3 + w4)
        if kdela == 1 and (idela == 1 or jdela == 1):
            cdensi *= SQRT3 if (idela == 1 and jdela == 1) else SQRT2
        path = np.sqrt((di * di + dj * dj) / (dk * dk) + 1.0)
    elif jdela >= idela and jdela >= kdela:
        alam = (float(jm - j0) + sgnj * 0.5) / dj
        zc = alam * dk + float(k0)
        xc = alam * di + float(i0)
        dz = 2.0 * abs(zc - (float(km) + 0.5 * sgnk))
        dx = 2.0 * abs(xc - (float(im) + 0.5 * sgni))
        s1 = (1. - dx) * (1. - dz)
        s2 = (1. - dz) * dx
        s3 = (1. - dx) * dz
        s4 = dx * dz
        c1, c2, c3, c4 = cd(im, jm, km), cd(i, jm, km), cd(im, jm, k), cd(i, jm, k)
        w1, w2, w3, w4 = (s1 * _weightf(c1, sig), s2 * _weightf(c2, sig),
                          s3 * _weightf(c3, sig), s4 * _weightf(c4, sig))
        cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3 + w4)
        if jdela == 1 and (idela == 1 or kdela == 1):
            cdensi *= SQRT3 if (idela == 1 and kdela == 1) else SQRT2
        path = np.sqrt((di * di + dk * dk) / (dj * dj) + 1.0)
    else:
        alam = (float(im - i0) + sgni * 0.5) / di
        zc = alam * dk + float(k0)
        yc = alam * dj + float(j0)
        dz = 2.0 * abs(zc - (float(km) + 0.5 * sgnk))
        dy = 2.0 * abs(yc - (float(jm) + 0.5 * sgnj))
        s1 = (1. - dz) * (1. - dy)
        s2 = (1. - dz) * dy
        s3 = (1. - dy) * dz
        s4 = dy * dz
        c1, c2, c3, c4 = cd(im, jm, km), cd(im, j, km), cd(im, jm, k), cd(im, j, k)
        w1, w2, w3, w4 = (s1 * _weightf(c1, sig), s2 * _weightf(c2, sig),
                          s3 * _weightf(c3, sig), s4 * _weightf(c4, sig))
        cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3 + w4)
        if idela == 1 and (jdela == 1 or kdela == 1):
            cdensi *= SQRT3 if (jdela == 1 and kdela == 1) else SQRT2
        path = np.sqrt(1.0 + (dj * dj + dk * dk) / (di * di))
    return cdensi, path


def oracle_photoion_rate(normflux, coldens_in, coldens_out, vol_ph, sig,
                         tables=None, grey=False):
    """Photoionization (and heating) rate of one cell.

    tables = (photo_thin, photo_thick, heat_thin, heat_thick, minlogtau,
    dlogtau) or None with grey=True (photorates.f90:13-149)."""
    tau_in = coldens_in * sig
    tau_out = coldens_out * sig
    if grey:
        prefact = normflux * S_STAR_REF / vol_ph
        if abs(tau_out - tau_in) > TAU_PHOTO_LIMIT:
            return prefact * (np.exp(-tau_in) - np.exp(-tau_out)), 0.0
        return prefact * (tau_out - tau_in) * np.exp(-tau_in), 0.0

    photo_thin, photo_thick, heat_thin, heat_thick, minlogtau, dlogtau = tables
    num_tau = photo_thin.shape[0] - 1

    def lookup(table, tau):
        logtau = np.log10(max(1.0e-20, tau))
        real_i = min(float(num_tau), max(0.0, 1.0 + (logtau - minlogtau) / dlogtau))
        i0 = int(real_i)
        i1 = min(num_tau, i0 + 1)
        resid = real_i - float(i0)
        return table[i0] + resid * (table[i1] - table[i0])

    prefact = normflux / vol_ph
    if abs(tau_out - tau_in) > TAU_PHOTO_LIMIT:
        phi = prefact * (lookup(photo_thick, tau_in) - lookup(photo_thick, tau_out))
        heat = prefact * (lookup(heat_thick, tau_in) - lookup(heat_thick, tau_out))
    else:
        phi = prefact * (tau_out - tau_in) * lookup(photo_thin, tau_in)
        heat = prefact * (tau_out - tau_in) * lookup(heat_thin, tau_in)
    return phi, heat


def oracle_raytrace(ndens, xh_av, src_pos, src_flux, dr, sig, R_max_LLS,
                    tables=None, grey=False, max_range=None):
    """Full-range cube sweep for all sources; returns (phi_ion, phi_heat,
    coldensh_out-of-last-source).

    src_pos: (NumSrc, 3) 0-indexed. Sweep order follows do_source/evolve2D
    (raytracing.f90:228-340): z planes up then down from the source, within
    each plane j up/down then i up/down.
    """
    N = ndens.shape[0]
    num_src = src_flux.shape[0]
    phi_ion = np.zeros_like(ndens)
    phi_heat = np.zeros_like(ndens)
    if max_range is None:
        max_range = N  # effectively min(.., N/2) below
    last_r = min(max_range, N // 2 - 1 + N % 2)
    last_l = -min(max_range, N // 2)
    cdh = np.zeros_like(ndens)

    for ns in range(num_src):
        i0, j0, k0 = (int(src_pos[ns][0]), int(src_pos[ns][1]),
                      int(src_pos[ns][2]))
        cdh[:, :, :] = 0.0
        ks = (list(range(k0, k0 + last_r + 1))
              + list(range(k0 - 1, k0 + last_l - 1, -1)))
        js = (list(range(j0, j0 + last_r + 1))
              + list(range(j0 - 1, j0 + last_l - 1, -1)))
        is_ = (list(range(i0, i0 + last_r + 1))
               + list(range(i0 - 1, i0 + last_l - 1, -1)))
        for k in ks:
            for j in js:
                for i in is_:
                    _evolve0D(i, j, k, i0, j0, k0, ns, src_flux, cdh,
                              ndens, xh_av, phi_ion, phi_heat, dr, sig,
                              R_max_LLS, tables, grey, N)
    return phi_ion, phi_heat, cdh


def _evolve0D(i, j, k, i0, j0, k0, ns, src_flux, cdh, ndens, xh_av,
              phi_ion, phi_heat, dr, sig, R_max_LLS, tables, grey, N):
    """Per-cell update (raytracing.f90:347-567)."""
    pi, pj, pk = i % N, j % N, k % N
    if cdh[pi, pj, pk] != 0.0:
        return
    xh_p = xh_av[pi, pj, pk]
    nHI_p = ndens[pi, pj, pk] * (1.0 - xh_p)
    stop_rt = False
    if i == i0 and j == j0 and k == k0:
        coldensh_in = 0.0
        path = 0.5 * dr
        vol_ph = dr * dr * dr
    else:
        coldensh_in, path = _cinterp(i, j, k, i0, j0, k0, cdh, sig, N)
        path *= dr
        xs, ys, zs = dr * (i - i0), dr * (j - j0), dr * (k - k0)
        dist2 = xs * xs + ys * ys + zs * zs
        vol_ph = dist2 * path * FOURPI
        if dist2 / (dr * dr) > R_max_LLS * R_max_LLS:
            stop_rt = True
        if coldensh_in > MAX_COLDENSH:
            stop_rt = True
    cdh_out = coldensh_in + nHI_p * path
    cdh[pi, pj, pk] = cdh_out
    if not stop_rt:
        phi_p, heat_p = oracle_photoion_rate(src_flux[ns], coldensh_in,
                                             cdh_out, vol_ph, sig,
                                             tables, grey)
    else:
        phi_p, heat_p = 0.0, 0.0
    phi_ion[pi, pj, pk] += phi_p / nHI_p
    phi_heat[pi, pj, pk] += heat_p / nHI_p


# ----------------------------------------------------------------------
# chemistry oracle
# ----------------------------------------------------------------------
def oracle_doric(xh_old, dt, temp, rhe, phi, bh00, albpow, colh0, temph0,
                 clumping=1.0):
    """Scalar/array doric update (chemistry.f90:221-316)."""
    brech0 = clumping * bh00 * (temp / 1e4) ** albpow
    acolh0 = colh0 * np.sqrt(temp) * np.exp(-temph0 / temp)
    aih0 = phi + rhe * acolh0
    delth = aih0 + rhe * brech0
    eqxh = aih0 / delth
    deltht = delth * dt
    ee = np.exp(-deltht)
    xh = (xh_old - eqxh) * ee + eqxh
    xh = np.maximum(xh, EPSILON)
    avg_factor = np.where(deltht < 1.0e-8, 1.0, (1.0 - ee) / deltht)
    xh_av = np.maximum(eqxh + (xh_old - eqxh) * avg_factor, EPSILON)
    return xh, xh_av


def oracle_chemistry_global(dt, ndens, temp, xh, xh_av, phi_ion,
                            bh00, albpow, colh0, temph0, abu_c,
                            max_iter=400):
    """Masked-iteration global pass (chemistry.f90:13-204).

    Returns (xh_intermed, xh_av_new, conv_flag)."""
    xh_av_entry = xh_av.copy()
    xh_av_cur = xh_av.copy()
    xh_int = xh.copy()
    active = np.ones(xh.shape, dtype=bool)
    nit = 0
    while nit < max_iter and active.any():
        nit += 1
        de = ndens * (xh_av_cur + abu_c)
        xh_new, xh_av_new = oracle_doric(xh, dt, temp, de, phi_ion,
                                         bh00, albpow, colh0, temph0)
        rel = np.abs((xh_av_new - xh_av_cur) / (1.0 - xh_av_new))
        done = (rel < MIN_FRACTIONAL_CHANGE) | \
               ((1.0 - xh_av_new) < MIN_FRACTION_OF_ATOMS)
        xh_av_cur = np.where(active, xh_av_new, xh_av_cur)
        xh_int = np.where(active, xh_new, xh_int)
        active &= ~done
    yh_entry = 1.0 - xh_av_entry
    delta = xh_av_cur - xh_av_entry
    not_conv = ((np.abs(delta) > MIN_FRACTIONAL_CHANGE)
                & (np.abs(delta / yh_entry) > MIN_FRACTIONAL_CHANGE)
                & (yh_entry > MIN_FRACTION_OF_ATOMS))
    return xh_int, xh_av_cur, int(not_conv.sum())
