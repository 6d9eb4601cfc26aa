"""The fused kernels rehearsed on the host (tests/rehearsal_host.py): K1f
(csrc/cheb_sweep_kernels.cuh) with rate threads and a ring bit for bit
against itself without them, and K3 / K3h (csrc/cheb_sweep_rates.cuh),
phase A bit for bit and the rates within libm's exp/expm1 against their
plain versions, for every launch plan of PLANS."""

import pytest
import torch

from pyc2ray_torch.ops import sweep
from rehearsal_host import (DR, K1F, K3, K3H, PLANS, SIG, SWEEP_SHAPES, Case,
                            lib)  # noqa: F401


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B", SWEEP_SHAPES)
def test_fused_kernels_on_the_host_match_plain(lib, N, R, B, dt):
    """K1f with rate threads and a ring: bit for bit against the same
    kernel without them (every cell evaluated by its chain thread inside
    the sub-step). K3's and K3h's phase A: cdin and dcol of every rated
    cell bit for bit. All three against their plain versions within libm's
    exp/expm1 against torch's, a few ulp per bin; the source cell and the
    flux (one of them 0) included."""
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    for plan in PLANS:
        case = Case(lib, N, R, B, dt, plan)
        nhi, geo, g, tb = case.nhi, case.geo, case.g, case.tb
        rates = (nhi, *geo, tb.rt_tab, case.flux, DR, g.c, SIG, tb.bins_s,
                 tb.bins_w)

        def check(got, refs):
            for a, ref in zip(got, refs):
                torch.testing.assert_close(a, ref, rtol=rtol, atol=0)
                assert float(ref[0, g.c, g.c, g.c]) > 0
                assert B == 1 or bool((a[-1] == 0).all())        # flux 0
        want = sweep.cheb_sweep_ref(
            nhi, *geo, DR, g.c, SIG, bins=(tb.bins_s, tb.bins_w),
            rt_tab=tb.rt_tab, R2=case.rt.R_max_LLS ** 2, flux=case.flux)
        got = case.run(K1F)[0]
        assert torch.equal(got, case.run(K1F, plan=plan[:3] + (0, 0))[0]), plan
        check((got,), (want,))
        check(case.run(K3)[:1], (sweep.cheb_sweep_rates_ref(*rates),))
        check(case.run(K3H)[:2],
              sweep.cheb_sweep_rates_ref(*rates, bins_wh=tb.bins_wh))
        # phase A against the plain version's emit
        ci_ref, dc_ref = torch.zeros_like(nhi), torch.zeros_like(nhi)

        def emit(f, r, mask, cdin, dcol, nhi_f, out):
            zero = torch.zeros_like(cdin)
            sweep._put(ci_ref, f, r, g.c, torch.where(mask, cdin, zero))
            sweep._put(dc_ref, f, r, g.c, torch.where(mask, dcol, zero))
        dr_t = torch.tensor(DR, dtype=dt)
        sweep._sweep_shells(nhi, *geo, dr_t, torch.tensor(SIG, dtype=dt),
                            g.c, sweep.init_planes(nhi, g.c, dr_t), 1,
                            g.r_max + 1, emit)
        valid = tb.rt_tab[:, 1] > 0.5
        assert torch.equal(case.ci[:, valid], ci_ref[:, valid]), plan
        assert torch.equal(case.dc[:, valid], dc_ref[:, valid]), plan
