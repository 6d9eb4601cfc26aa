"""The dense rate pass of the unfused sweep modes (ops/cheb_rates.py) and
the start of a segmented sweep (sweep.init_segments).

On the CPU the wrappers run their plain versions: ``rates_dense_ref``
against the JAX engine's ``ChebRaytracer._rates`` on the same seeded
inputs, in float64 (rtol 1e-12) and in float32 (rtol 1e-5 above 1e-6 of
the peak Gamma: both rebuild cdin = cd - dcol in float32 and cancel
alike, and only their exp/expm1 differ), with and without the heat
channel, on a rates subbox and on a full box, with a zero-density cell
and a cell past MAX_COLDENSH; the dispatch of the wrappers; the engine's
list of rated cells, which the kernel evaluates (its own tables' and those
carried over from the JAX engine by ``convert.state_from_jax``). On the
card (``cuda``) the kernels against their plain versions, bit for bit, the
rate pass writing its listed cells only."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer
from pyc2ray_tpu.radiation import BlackBodySource
from pyc2ray_tpu.radiation.bins_compress import compress_bins
from pyc2ray_tpu.radiation.spectral_bins import make_spectral_bins

from pyc2ray_torch.convert import state_from_jax
from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.cheb_rates import (HE_UNROLL, he_bands,
                                          he_first_bins, rated_cells,
                                          rates_dense, rates_dense_ref)
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer

SIG = 6.30e-18
DR = 6.7e20
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
# (N, R): a rates subbox (Ds = 13 of Dc = 16), the full box of a clipped one
SHAPES = {"subbox": (16, 6.0), "full_box": (8, 6.0)}


def _bb_bins():
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    dense = make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                               fmin, fmax, panels=8, nodes=8)
    return compress_bins(dense, target_rel=1e-2, cache=False)


def _case(shape, dt, heat, device="cpu", seed=61):
    """An engine and the inputs of one batch of 3 boxes: HI densities
    1e-4..1e-2 with one zero-density cell, the plain sweep's coldensh_out
    boxes with one cell past MAX_COLDENSH, fluxes with one 0."""
    N, R = SHAPES[shape]
    tr = ChebRaytracer(N, R, SIG, _bb_bins(), batch_size=3, dtype=dt,
                       device=device, do_heating=heat)
    g, tb = tr.geom, tr.tables
    rng = np.random.RandomState(seed)
    nhi = torch.from_numpy(10 ** rng.uniform(-4, -2, (3,) + (g.Dc,) * 3)).to(
        device, dt)
    nhi[0, g.c + 1, g.c, g.c] = 0.0
    cd = sweep.cheb_sweep_ref(nhi, tb.sw, tb.path, tb.diag, tb.mask_m,
                              tb.mask_p, DR, g.c, SIG)
    cd[1, g.c, g.c + 2, g.c] = 1e31
    flux = torch.tensor([1.5, 0.7, 0.0], dtype=dt, device=device)
    return tr, cd, nhi, flux


@pytest.mark.parametrize("heat", [False, True])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rate_pass_matches_jax(shape, dt, heat):
    tr, cd, nhi, flux = _case(shape, dt, heat)
    N, R = SHAPES[shape]
    jr = JRaytracer(N, R, SIG, _bb_bins(), batch_size=3, dtype=JDT[dt],
                    use_pallas=True, accumulate="scan", do_heating=heat)
    assert (jr._rb0, jr._rb1) == (tr._rb0, tr._rb1)
    assert (tr.Ds < tr.geom.Dc) == (shape == "subbox")
    want = jr._rates(jr.tables, jnp.asarray(cd.numpy()),
                     jnp.asarray(nhi.numpy()), jnp.asarray(flux.numpy()),
                     jnp.asarray(DR, JDT[dt]))
    got = tr._rates(cd, nhi, flux, DR)
    assert (got[1] is None) == (want[1] is None) == (not heat)
    g = tr.geom
    for a, w in zip(got, want):
        if w is None:
            continue
        w = np.asarray(w)
        assert w.max() > 0 and np.all(np.isfinite(w))
        assert w[0, g.c + 1 - tr._rb0, g.c - tr._rb0, g.c - tr._rb0] == 0.0
        assert not np.any(w[2])                          # zero flux
        if dt == torch.float64:
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_engine_lists_its_rated_cells(shape, dt):
    """``ChebRaytracer.rated_cells``: int32, strictly ascending, the
    row-major indices where the table's valid channel exceeds 0.5, none
    outside the subbox; the same list for an engine given the JAX engine's
    tables through ``convert.state_from_jax``, and for ``rated_cells`` of
    the JAX engine's own rt_sub."""
    N, R = SHAPES[shape]
    tr = ChebRaytracer(N, R, SIG, _bb_bins(), batch_size=3, dtype=dt,
                       device="cpu")
    cells, rt_sub = tr.rated_cells, tr.tables.rt_sub
    Ds = tr.Ds
    assert cells.dtype == torch.int32 and cells.dim() == 1
    assert 0 < cells.numel() < Ds ** 3
    assert bool((cells[1:] > cells[:-1]).all())
    want = torch.nonzero((rt_sub[2] > 0.5).reshape(-1)).reshape(-1)
    assert torch.equal(cells.long(), want)
    jr = JRaytracer(N, R, SIG, _bb_bins(), batch_size=3, dtype=JDT[dt],
                    use_pallas=True, accumulate="scan")
    tables, bins, _ = state_from_jax(
        {k: np.asarray(v) for k, v in jr.tables._asdict().items()},
        _bb_bins()._asdict(),
        dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598 ** 2,
             temph0=13.598 / 8.617e-05, abu_c=7.1e-7))
    conv = ChebRaytracer(N, R, SIG, bins, batch_size=3, dtype=dt,
                         device="cpu")
    conv.tables = tables.to(conv.device, dt)
    assert torch.equal(conv.rated_cells, cells)
    assert torch.equal(rated_cells(torch.from_numpy(np.array(
        jr.tables.rt_sub))), cells)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors ``rates_dense``, ``ChebRaytracer._rates`` and
    ``init_segments`` are their plain versions and count no launch; a
    tensor on another device raises, and so does an engine on a card this
    machine does not have."""
    tr, cd, nhi, flux = _case("subbox", torch.float64, True)
    tb, g = tr.tables, tr.geom
    args = (tb.rt_sub, flux, tb.bins_s, tb.bins_w, DR, SIG,
            float(sweep.s_over_dr3(DR, torch.float64)), tr._rb0)
    sweep.reset_launches()
    got = rates_dense(cd, nhi, *args, bins_wh=tb.bins_wh)
    want = rates_dense_ref(cd, nhi, *args, bins_wh=tb.bins_wh)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert all(torch.equal(a, w) for a, w in
               zip(tr._rates(cd, nhi, flux, DR), want))
    box, planes = sweep.init_segments(nhi, g.c, DR)
    assert torch.equal(planes, sweep.init_planes(nhi, g.c, DR))
    centre = nhi[:, g.c, g.c, g.c] * (0.5 * torch.tensor(DR,
                                                         dtype=nhi.dtype))
    assert torch.equal(box[:, g.c, g.c, g.c], centre)
    box[:, g.c, g.c, g.c] = 0.0
    assert not bool(box.any())
    assert sum(sweep.launches.values()) == 0
    with pytest.raises(ValueError, match="unsupported device"):
        rates_dense(cd.to("meta"), nhi.to("meta"), *args)
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.init_segments(nhi.to("meta"), g.c, DR)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ChebRaytracer(8, 3.0, SIG, _bb_bins(), device="cuda")


# (3, E) = (3, 6) tables: which entries are not 0, and the first bin of
# each species' terms with and without the heat channel's table
FIRST_BINS = {
    "bands": ((["se", "w", "wh"], [(0, 0), (1, 2), (2, 4)]),
              [0, 2, 4], [0, 2, 4]),
    "heat only": ((["wh"], [(1, 3)]), [6, 6, 6], [6, 3, 6]),
    "weights only": ((["w"], [(2, 1), (0, 5)]), [5, 6, 1], [5, 6, 1]),
    "none": (([], []), [6, 6, 6], [6, 6, 6]),
}


@pytest.mark.parametrize("case", sorted(FIRST_BINS))
def test_he_first_bins(case):
    """The helium rate pass's bands: each species' terms start at the first
    bin at which any of se, w_se or (with the heat channel) wh_se is not
    0; a species with none has no term (E)."""
    (tabs, nonzero), want, want_heat = FIRST_BINS[case]
    t = {k: torch.zeros(3, 6, dtype=torch.float64) for k in ("se", "w", "wh")}
    for k in tabs:
        for s, e in nonzero:
            t[k][s, e:] = 1.0 if e < 6 else 0.0
    assert he_first_bins(t["se"], t["w"]) == want
    assert he_first_bins(t["se"], t["w"], t["wh"]) == want_heat


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(FIRST_BINS))
def test_he_bands(case, dt):
    """The helium kernel's records (he_bands), read back by their header:
    band j runs the bins from the (j + 1)-th species' first bin to the
    next's in passes of HE_UNROLL records, each record the se, w_se and
    (heat) wh_se of the band's species in ascending order, whole 16-byte
    vectors, zeros in every padding value and padding record; every bin
    with a term is in exactly one band, with every species that has a term
    there."""
    (tabs, nonzero), _, _ = FIRST_BINS[case]
    rng = np.random.RandomState(7)
    t = {k: torch.zeros(3, 6, dtype=dt) for k in ("se", "w", "wh")}
    for k in tabs:
        for s, e in nonzero:
            t[k][s, e:] = torch.from_numpy(rng.uniform(1, 2, 6 - e)).to(dt)
    vec = 16 // t["se"].element_size()
    for heat in (False, True):
        wh = t["wh"] if heat else None
        first = he_first_bins(t["se"], t["w"], wh)
        head, rec = he_bands(t["se"], t["w"], wh)
        head = head.tolist()
        assert head[:2] == [int(heat), rec.numel()]
        iters, offs, sp = head[2:5], head[5:8], head[8:]
        seen = []
        for j in range(3):
            k = j + 1
            species = sp[3 * j:3 * j + k]
            assert species == sorted(species)
            width = -(-(2 + heat) * k // vec) * vec
            recs = rec[offs[j]:offs[j] + iters[j] * HE_UNROLL * width]
            recs = recs.view(-1, width)
            assert offs[j] % vec == 0 and recs.shape[0] == iters[j] * HE_UNROLL
            bins = [e for e in range(6)
                    if sum(e >= f for f in first) == k]
            assert len(bins) <= recs.shape[0] < len(bins) + HE_UNROLL
            for r, e in enumerate(bins):
                assert species == [s for s in range(3) if e >= first[s]]
                want = torch.cat([t[n][species, e] for n in
                                  ("se", "w", "wh")[:2 + heat]])
                assert torch.equal(recs[r, :want.numel()], want)
                assert not recs[r, want.numel():].any()
            assert not recs[len(bins):].any()
            seen += bins
        assert sorted(seen) == [e for e in range(6) if e >= min(first)]
        assert sum(iters[j] * HE_UNROLL * -(-(2 + heat) * (j + 1) // vec)
                   * vec for j in range(3)) == rec.numel()


@pytest.mark.cuda
def test_rate_pass_and_init_segments_match_plain_on_cuda():
    """The kernels bit for bit against the plain versions on the card, in
    both types, with and without the heat channel, subbox and full box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for shape in sorted(SHAPES):
        for dt in (torch.float64, torch.float32):
            for heat in (False, True):
                tr, cd, nhi, flux = _case(shape, dt, heat, device="cuda")
                n0 = sweep.launches["rates_dense"]
                got = tr._rates(cd, nhi, flux, DR)
                tb = tr.tables
                want = rates_dense_ref(
                    cd, nhi, tb.rt_sub, flux, tb.bins_s, tb.bins_w, DR, SIG,
                    sweep.rate_consts(DR, dt)[1], tr._rb0,
                    bins_wh=tb.bins_wh if heat else None)
                torch.cuda.synchronize()
                assert sweep.launches["rates_dense"] == n0 + 1
                for a, w in zip(got, want):
                    if w is not None:
                        assert float(w.max()) > 0 and torch.equal(a, w)
            g = tr.geom
            got = sweep.init_segments(nhi, g.c, DR)
            want = sweep.init_segments_ref(nhi, g.c, DR)
            torch.cuda.synchronize()
            assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rate_pass_writes_its_rated_cells_on_cuda(shape):
    """The kernel on the engine's list of rated cells, at a full box and a
    subbox: bit for bit against the plain pass in both types, with and
    without heat, every cell outside the list 0; without the list it
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for dt in (torch.float64, torch.float32):
        for heat in (False, True):
            tr, cd, nhi, flux = _case(shape, dt, heat, device="cuda")
            tb, cells = tr.tables, tr.rated_cells
            args = (tb.rt_sub, flux, tb.bins_s, tb.bins_w, DR, SIG,
                    float(sweep.s_over_dr3(DR, dt)), tr._rb0)
            wh = tb.bins_wh if heat else None
            got = rates_dense(cd, nhi, *args, bins_wh=wh, cells=cells)
            want = rates_dense_ref(cd, nhi, *args, bins_wh=wh)
            torch.cuda.synchronize()
            outside = torch.ones(tr.Ds ** 3, dtype=torch.bool,
                                 device="cuda")
            outside[cells.long()] = False
            for a, w in zip(got, want):
                if w is None:
                    continue
                assert float(w.max()) > 0 and torch.equal(a, w)
                assert not bool(a.view(3, -1)[:, outside].any())
            with pytest.raises(ValueError, match="rated cells"):
                rates_dense(cd, nhi, *args, bins_wh=wh)
