"""The dense rate passes rehearsed on the host (tests/rehearsal_host.py):
rates_dense (csrc/cheb_rates.cuh) and the helium engine's rates_he
(csrc/cheb_rates_he.cuh) on an engine's list of rated cells, bit for bit
against rates_dense_ref and rates_he_ref with glibc's exp and expm1 (the
ones the host build calls) in place of torch's, and the sizes the helium
loop's host side refuses (he_loop_fits)."""

import ctypes

import pytest
import torch

from pyc2ray_torch.ops import cheb_rates, sweep
from rehearsal_host import (DR, SIG, Case, glibc_exp, he_case,  # noqa: F401
                            lib)


# (N, R, B, rb0): (16, 6) a rates subbox (Ds = 13 of Dc = 16) and (8, 6) the
# full box of a clipped one, as the engine builds them; rb0 = 2 a subbox
# away from the box's corner (the kernel's offset arithmetic)
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B,rb0", [(16, 6.0, 2, None), (8, 6.0, 2, None),
                                       (16, 6.0, 2, 2)])
@pytest.mark.parametrize("heat", [False, True])
def test_rate_pass_on_the_host_matches_plain(lib, monkeypatch, N, R, B, rb0,
                                             dt, heat):
    """rates_dense_kernel on the engine's list of rated cells
    (``rated_cells``) bit for bit against rates_dense_ref on K1's boxes with
    a zero-density cell, a cell past MAX_COLDENSH and a zero flux, Gamma and
    with ``heat`` the heating rate, its blocks in either order: the kernel
    writes the listed cells of every box and no other (the outputs start as
    NaN), where the plain pass gives 0, so its zeroed outputs equal the
    plain pass's. The plain pass takes glibc's exp and expm1 in place of
    torch's (whose vectorized forms differ from them by an ulp here and
    there)."""
    case = Case(lib, N, R, B, dt, (1, False, 5, 0, 0))
    rt, g, tb, nhi = case.rt, case.g, case.tb, case.nhi
    nhi[0, g.c + 1, g.c, g.c] = 0.0
    cd = sweep.cheb_sweep_ref(nhi, *case.geo, DR, g.c, SIG)
    cd[-1, g.c, g.c + 2, g.c] = 1e31
    Ds, rt_sub, cells = rt.Ds, tb.rt_sub, rt.rated_cells
    if rb0 is None:
        rb0 = rt._rb0
    else:
        Ds -= rb0
        rt_sub = rt_sub[:, rb0:, rb0:, rb0:].contiguous()
        cells = cheb_rates.rated_cells(rt_sub)
    listed = torch.zeros(Ds ** 3, dtype=torch.bool)
    listed[cells.long()] = True
    assert 0 < cells.numel() < Ds ** 3
    assert torch.equal(listed.view((Ds,) * 3), rt_sub[2] > 0.5)
    sdr3 = float(sweep.s_over_dr3(DR, dt))
    wh = tb.bins_wh if heat else None
    outs = {}
    for reverse in (0, 1):
        phi, heat_box = (torch.full((B,) + (Ds,) * 3, float("nan"), dtype=dt)
                         for _ in range(2))
        ptrs = [t.data_ptr() if t is not None else None for t in (
            cd, nhi, rt_sub, cells, case.flux, tb.bins_s, tb.bins_w, wh, phi,
            heat_box if heat else None)]
        fn = lib.rehearse_rates_f32 if dt == torch.float32 else \
            lib.rehearse_rates_f64
        fn((ctypes.c_void_p * 10)(*ptrs), B, tb.bins_s.shape[0], g.Dc, Ds,
           rb0, cells.numel(), DR, SIG, sdr3, 64, reverse)
        outs[reverse] = (phi, heat_box)
    exp, expm1 = glibc_exp(dt)
    monkeypatch.setattr(torch, "exp", exp)
    monkeypatch.setattr(torch, "expm1", expm1)
    want = cheb_rates.rates_dense_ref(cd, nhi, rt_sub, case.flux, tb.bins_s,
                                      tb.bins_w, DR, SIG, sdr3, rb0,
                                      bins_wh=wh)
    monkeypatch.undo()
    for reverse, got in outs.items():
        for a, w in zip(got, want):
            if w is None:
                continue
            written = ~torch.isnan(a).view(B, -1)
            assert torch.equal(written, listed.expand(B, -1)), reverse
            assert not bool(w.view(B, -1)[:, ~listed].any())
            assert float(w.max()) > 0
            assert torch.equal(torch.nan_to_num(a, nan=0.0), w), reverse
    assert float(want[0][1].abs().max()) == 0.0 or B == 1      # zero flux


# The helium engine's rate pass (csrc/cheb_rates_he.cuh) and the sizes its
# loop takes (he_trace_sweep in csrc/trace_loop.cu).
# (N, R, B, rb0): (16, 6) a rates subbox (Ds = 13 of Dc = 16) and (8, 6) the
# full box of a clipped one, as the engine builds them; rb0 = 2 a subbox
# away from the box's corner
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B,rb0", [(16, 6.0, 2, None), (8, 6.0, 2, None),
                                       (16, 6.0, 1, 2)])
@pytest.mark.parametrize("heat", [False, True])
def test_rate_pass_he_on_the_host_matches_plain(lib, monkeypatch, N, R, B,
                                                rb0, dt, heat):
    """rates_he_kernel on the host engine's list of rated cells bit for bit
    against rates_he_ref on the three species' K1 boxes, with zero-density
    cells of HeI and HeII, a cell past MAX_COLDENSH and a zero flux: the
    three rates and with ``heat`` the heat per HI atom, its blocks in either
    order, written at the listed cells of every box and no other (the
    outputs start as NaN). The plain pass takes glibc's exp and expm1 in
    place of torch's. Sizes the launch code does not take are refused."""
    rt, cds, nb, flux = he_case(N, R, B, dt, heat)
    eng, heb = rt.eng, rt.he_tables
    Ds, rt_sub, cells = eng.Ds, eng.tables.rt_sub, eng.rated_cells
    if rb0 is None:
        rb0 = eng._rb0
    else:
        Ds -= rb0
        rt_sub = rt_sub[:, rb0:, rb0:, rb0:].contiguous()
        cells = cheb_rates.rated_cells(rt_sub)
    listed = torch.zeros(Ds ** 3, dtype=torch.bool)
    listed[cells.long()] = True
    assert 0 < cells.numel() < Ds ** 3
    sdr3 = float(sweep.s_over_dr3(DR, dt))
    wh = heb.wh_se if heat else None
    fn = lib.rehearse_rates_he_f32 if dt == torch.float32 else \
        lib.rehearse_rates_he_f64
    other = cheb_rates.he_bands(heb.se, heb.w_se, None if heat else heb.se)

    def host(reverse, n_valid=cells.numel(), ds=Ds, r0=rb0,
             bands=heb.bands):
        outs = [torch.full((B,) + (Ds,) * 3, float("nan"), dtype=dt)
                for _ in range(4)]
        ptrs = [t.data_ptr() if t is not None else None for t in (
            *cds, *nb, rt_sub, cells, flux, bands.rec, bands.head,
            *outs[:3], outs[3] if heat else None)]
        rc = fn((ctypes.c_void_p * 15)(*ptrs), B, rt.geom.Dc, ds, r0,
                n_valid, DR, sdr3, 64, reverse)
        return rc, outs[:3 + heat]
    got = {reverse: host(reverse) for reverse in (0, 1)}
    exp, expm1 = glibc_exp(dt)
    monkeypatch.setattr(torch, "exp", exp)
    monkeypatch.setattr(torch, "expm1", expm1)
    want = cheb_rates.rates_he_ref(cds, nb, rt_sub, flux, heb.se, heb.w_se,
                                   DR, sdr3, rb0, wh_se=wh, cells=cells)
    monkeypatch.undo()
    assert len(want) == 3 + heat
    for reverse, (rc, outs) in got.items():
        assert rc == 0
        for a, w in zip(outs, want):
            written = ~torch.isnan(a).view(B, -1)
            assert torch.equal(written, listed.expand(B, -1)), reverse
            assert float(w.max()) > 0
            assert torch.equal(torch.nan_to_num(a, nan=0.0), w), reverse
    c = eng.geom.c - rb0
    if 0 <= c + 1 < Ds:
        assert float(want[2][0, c + 1, c, c]) == 0.0       # n_HeII = 0
    if B > 1:
        assert not any(bool(w[-1].any()) for w in want)      # zero flux
    # sizes the launch code refuses: more listed cells than the subbox
    # holds, a subbox leaving the box, records packed with the heat
    # channel's table where the pass has no heat output or the other way
    for bad in (dict(n_valid=Ds ** 3 + 1), dict(r0=eng.geom.Dc - Ds + 1),
                dict(bands=other)):
        assert host(0, **bad)[0] == 1, bad


# he_loop_fits's arguments: nb, E, rb0, Ds, n_valid, seg_S, seg_K, F0, F1, F2,
# chunk, B, Dc, c, R1 (a bench-like call), and the changes it refuses
HE_FITS = [3, 72, 0, 64, 1000, 0, 0, 320, 320, 320, 2, 8, 64, 32, 31]
HE_REFUSED = {"chunk 0": {10: 0}, "subbox beyond the box": {2: 1},
              "no listed cell": {4: 0},
              "more cells than the subbox": {4: 64 ** 3 + 1},
              "frame narrower than a box": {8: 63},
              "bands of a negative count of bins": {1: -4},
              "source outside the box": {13: 64},
              "B above 65535": {11: 65536},
              "chunk of 2^31 cells": {10: 1024},
              "bins beyond the shared memory of a block": {1: 8000}}


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_host_he_loop_refuses_other_sizes(lib, dt):
    """The host side of he_trace_sweep (he_loop_fits) takes a bench-like
    call, with and without the heat channel and segmented with its planes,
    and refuses bad sizes (the launch then never happens): a chunk of 0,
    a subbox leaving the box, no or too many rated cells, a frame narrower
    than a box, bands of a negative count of bins, a source cell outside
    the box, too many boxes or cells for a launch, bins beyond the pass's
    shared memory; the heat channel's table without its frame or the other
    way, segments without planes or of no shells, no list of rated
    cells."""
    fn = lib.rehearse_he_fits_f32 if dt == torch.float32 else \
        lib.rehearse_he_fits_f64

    def fits(v, heat_bins=0, heat_out=0, planes=0, cells=1):
        arr = (ctypes.c_int * 15)(*v)
        return fn(ctypes.cast(arr, ctypes.c_void_p), heat_bins, heat_out,
                  planes, cells)
    assert fits(HE_FITS) == 1
    assert fits(HE_FITS, heat_bins=1, heat_out=1) == 1
    seg = list(HE_FITS)
    seg[5:7] = [8, 4]
    assert fits(seg, planes=1) == 1
    for name, change in HE_REFUSED.items():
        v = list(HE_FITS)
        for i, x in change.items():
            v[i] = x
        assert fits(v) == 0, name
    assert fits(HE_FITS, heat_bins=1) == 0
    assert fits(HE_FITS, heat_out=1) == 0
    assert fits(seg) == 0
    seg[6] = 0
    assert fits(seg, planes=1) == 0
    assert fits(HE_FITS, cells=0) == 0
