"""The flat engine's plain loop (ops/raytrace.py::Raytracer.
flat_trace_sweep_ref, the CPU branch of trace_batches) against the engine's
batch body as it ran before the loop had kernels (a copy below, op for op)
and against the JAX engine's compiled trace (pyc2ray_tpu/ops/raytrace.py::
Raytracer.trace_batches), in float64 on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.raytrace import RaytraceConfig as JConfig
from pyc2ray_tpu.ops.raytrace import Raytracer as JRaytracer
from pyc2ray_tpu.radiation import BlackBodySource, make_tau_table

from pyc2ray_torch.constants import MAX_COLDENSH, S_STAR_REF, TAU_PHOTO_LIMIT
from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer

SIG = 6.30e-18
DR = 6.7e20


def _tables(numtau=200):
    tau, dlogtau = make_tau_table(-20.0, 4.0, numtau)
    bb = BlackBodySource(5e4, False, ev2fr * 13.598, 2.8)
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    thin, thick = bb.make_photo_table(tau, fmin, fmax, 1e48)
    hthin, hthick = bb.make_heat_table(tau, fmin, fmax, 1e48)
    return thin, thick, -20.0, dlogtau, hthin, hthick


TABLES = _tables()

# (N, R, sources): the octahedron clipped by the periodic box or not, an odd
# mesh, two sources at one cell
CASES = {"N12_R4.5": (12, 4.5, [[0, 0, 0], [0, 0, 0], [6, 5, 11]]),
         "N13_R30": (13, 30.0, [[0, 0, 0], [5, 7, 2], [12, 12, 12]]),
         "N16_R6": (16, 6.0, [[15, 0, 15], [8, 8, 8], [3, 12, 1],
                              [0, 5, 9], [11, 2, 14]])}


def _engines(N, R, B, mode):
    kw = dict(N=N, R_max_LLS=R, sig=SIG, batch_size=B,
              grey_analytic=mode == "grey", do_heating=mode == "heat")
    return (JRaytracer(JConfig(dtype=jnp.float64, **kw), *TABLES),
            Raytracer(RaytraceConfig(dtype=torch.float64, **kw), *TABLES,
                      device="cpu"))


def _inputs(case, seed=7, lo=-4.0):
    """The sources, densities 10^U(lo, -2), ionized fractions and fluxes of
    ``case``."""
    N, R, pos = CASES[case]
    rng = np.random.RandomState(seed + N)
    nd = 10 ** rng.uniform(lo, -2, N ** 3)
    xh = rng.uniform(0.0, 0.9, N ** 3)
    flux = rng.uniform(0.5, 2.0, len(pos))
    return N, R, np.array(pos), nd, xh, flux


def _trace_batches_before(rt, nd, xh, pos_b, flux_b, dr):
    """Raytracer.trace_batches's body before the loop had kernels, op for
    op, on the engine's tables (its _lin_idx, _sweep, _lookup and _rates
    inlined)."""
    cfg, tb = rt.config, rt.tables
    N, sig = cfg.N, cfg.sig

    def lookup(table, tau):
        logtau = torch.log10(torch.clamp(tau, min=1.0e-20))
        real_i = torch.clamp(1.0 + (logtau - rt.minlogtau) / rt.dlogtau,
                             0.0, float(rt.num_tau))
        i0 = real_i.to(torch.int64)
        resid = real_i - i0.to(real_i.dtype)
        i1 = torch.clamp(i0 + 1, max=rt.num_tau)
        t0 = table[i0]
        return t0 + resid * (table[i1] - t0)

    dr_t = torch.tensor(float(dr), dtype=cfg.dtype).to(rt.device)
    nhi_flat = nd.reshape(-1) * (1.0 - xh.reshape(-1))
    phi_grid = torch.zeros_like(nhi_flat)
    heat_grid = torch.zeros_like(nhi_flat) if cfg.do_heating else None
    for pos, flux in zip(pos_b, flux_b):
        p = torch.remainder(pos[:, :, None] + tb.offsets[None], N)
        lin = (p[:, 0] * N + p[:, 1]) * N + p[:, 2]
        nhi_octa = nhi_flat[lin]
        cdo = torch.zeros_like(nhi_octa)
        pdr = tb.path * dr_t
        cdo[:, 0] = nhi_octa[:, 0] * pdr[0]
        for lo, hi in rt.shells:
            c = cdo[:, tb.nbr[:, lo:hi]]
            w = tb.sw[:, lo:hi] / torch.clamp(c * sig, min=0.6)
            cdin = tb.diag[lo:hi] * (c * w).sum(dim=1) / w.sum(dim=1)
            cdo[:, lo:hi] = cdin + nhi_octa[:, lo:hi] * pdr[lo:hi]
        dcol = nhi_octa * (tb.path * dr_t)
        cdin = cdo - dcol
        tau_in, tau_out, dtau = cdin * sig, cdo * sig, dcol * sig
        s_over_dr3 = torch.exp(
            torch.tensor(np.log(S_STAR_REF), dtype=cfg.dtype).to(dr_t.device)
            - 3.0 * torch.log(dr_t))
        prefact = flux[:, None] * s_over_dr3 * tb.geom
        thick_cell = dtau > TAU_PHOTO_LIMIT
        heat_cell = None
        if cfg.grey_analytic:
            ein = torch.exp(-tau_in)
            phi_cell = torch.where(thick_cell,
                                   prefact * (ein - torch.exp(-tau_out)),
                                   prefact * dtau * ein)
        else:
            phi_cell = torch.where(
                thick_cell,
                prefact * (lookup(tb.photo_thick, tau_in)
                           - lookup(tb.photo_thick, tau_out)),
                prefact * dtau * lookup(tb.photo_thin, tau_in))
            if cfg.do_heating:
                heat_cell = torch.where(
                    thick_cell,
                    prefact * (lookup(tb.heat_thick, tau_in)
                               - lookup(tb.heat_thick, tau_out)),
                    prefact * dtau * lookup(tb.heat_thin, tau_in))
        mask = (cdin <= MAX_COLDENSH) & tb.rated
        nhi_safe = torch.clamp(nhi_octa, min=torch.finfo(cfg.dtype).tiny)
        zero = torch.zeros_like(phi_cell)
        phi = torch.where(mask, phi_cell / nhi_safe, zero)
        heat = (None if heat_cell is None
                else torch.where(mask, heat_cell / nhi_safe, zero))
        for b in range(lin.shape[0]):
            phi_grid.index_add_(0, lin[b], phi[b])
            if heat_grid is not None:
                heat_grid.index_add_(0, lin[b], heat[b])
    return phi_grid, heat_grid


@pytest.mark.parametrize("B", [2, 4])
@pytest.mark.parametrize("mode", ["grey", "tables", "heat"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_loop_equals_the_batch_body_before(case, mode, B):
    """flat_trace_sweep_ref, and trace_batches on CPU tensors, bit for bit
    the batch body as it ran before (Gamma and the heating rate), with
    optically thin and thick cells (densities over ten decades)."""
    N, R, pos, nd, xh, flux = _inputs(case, lo=-12.0)
    _, rt = _engines(N, R, B, mode)
    pos_b, flux_b = rt.prepare_sources(pos, flux)
    nd_t, xh_t = torch.from_numpy(nd), torch.from_numpy(xh)
    want = _trace_batches_before(rt, nd_t, xh_t, pos_b, flux_b, DR)
    assert float(want[0].max()) > 0.0
    for got in (rt.flat_trace_sweep_ref(nd_t, xh_t, pos_b, flux_b, DR),
                rt.trace_batches(nd_t, xh_t, pos_b, flux_b, DR)):
        assert torch.equal(got[0], want[0])
        if mode == "heat":
            assert torch.equal(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None


@pytest.mark.parametrize("mode", ["grey", "tables", "heat"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_loop_matches_jax_trace_batches(case, mode):
    """flat_trace_sweep_ref against the JAX engine's trace_batches on the
    same seeded inputs, test_torch_flat.py's densities (every cell thick):
    rtol 1e-12 in float64. With tables both packages interpolate
    log10(tau), and XLA's log10 differs from libm's in the last bit for
    some arguments, which the thick-cell difference L(tau_in) - L(tau_out)
    amplifies by up to 1/dtau: there an absolute floor of 1e-12 of the peak
    stands beside it (as test_torch_flat.py's). Where dtau falls toward the
    thin limit, the grey form's exp(-tau_in) - exp(-tau_out) amplifies a
    last-bit exp difference the same way (1e-10 at dtau ~ 1e-6), so the
    thin cells are held to the batch body before, bit for bit, above."""
    N, R, pos, nd, xh, flux = _inputs(case)
    jr, rt = _engines(N, R, 2, mode)
    jpos, jflux = jr.prepare_sources(pos, flux)
    want = jr.trace_batches(jnp.asarray(nd), jnp.asarray(xh), jpos, jflux,
                            DR)
    pos_b, flux_b = rt.prepare_sources(pos, flux)
    got = rt.flat_trace_sweep_ref(torch.from_numpy(nd),
                                  torch.from_numpy(xh), pos_b, flux_b, DR)
    for g, w in zip(got, want):
        if g is None:               # no heat channel
            continue
        w = np.asarray(w)
        assert w.max() > 0
        atol = 0.0 if mode == "grey" else 1e-12 * w.max()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=atol)
    assert (got[1] is None) == (mode != "heat")
