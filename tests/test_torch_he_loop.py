"""The helium engine's trace as one call (trace_loop.he_trace_sweep) and its
three-species rate pass (cheb_rates.rates_he).

On the CPU the wrappers run their plain versions: ``rates_he_ref`` against
the JAX engine's ``HeRaytracer._rates_he`` on the same seeded boxes (float64
at rtol 1e-10, the tolerance of test_torch_helium.py: the JAX einsums and
the plain pass's bin loop sum in other orders; float32 at rtol 1e-4 above
1e-6 of the peak, both rebuilding cdin = cd - dcol in float32 and
cancelling alike), with and without the heat channel, on a rates subbox and
on the full box of a clipped one, with zero-density cells; the staged trace
(``he_trace_sweep``) and ``HeRaytracer.trace`` against the JAX trace, the
host engine segmented or not; ``trace_extended`` bit for bit against
``trace_extended_plain`` on a cubic and a non-cubic frame; the wrappers'
checks. The JAX HeRaytracer is built with accumulate="scan": its window
accumulate carries the stale-window fault (ROADMAP.md section 3). On the
card (``cuda``) the kernel and the loop in C against their plain versions,
bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.raytrace_he import HeRaytracer as JHeRaytracer
from pyc2ray_tpu.radiation import BlackBodySource as JBlackBody
from pyc2ray_tpu.radiation import helium as j_helium

from pyc2ray_torch.ops import sweep, trace_loop
from pyc2ray_torch.ops.cheb_rates import (he_first_bins, rated_cells,
                                          rates_he, rates_he_ref)
from pyc2ray_torch.ops.raytrace_he import HeRaytracer
from pyc2ray_torch.ops.trace_loop import (chunk_size, fold_padding,
                                          he_trace_sweep, stage_positions)
from pyc2ray_torch.radiation import BlackBodySource
from pyc2ray_torch.radiation import helium

DR = 6.7e20
ABU_HE = 0.074
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
# (N, R): a rates subbox (Ds = 13 of Dc = 16), the full box of a clipped one
SHAPES = {"subbox": (16, 6.0), "full_box": (8, 6.0)}


# bin tables: the species' terms start at bins 0 / 8 / 16 of 24
# ("default"); at 0 / 5 / 13 of 24 ("bands"); HeI with no zero column
# ("no_zeros"); at 0 / 6 / 11 of 18, bands not a multiple of the kernel's
# unroll ("e18"); at 0 / 384 / 768 of 1152, whose records in float64 with
# the heat channel (61 KB) pass the 48 KB of shared memory a block has
# without asking ("e1152")
TABLES = ("default", "bands", "no_zeros", "e18", "e1152")


def _bins(mod, bb, table="default"):
    panels, nodes = {"e18": (2, 3), "e1152": (16, 24)}.get(table, (2, 4))
    bins = mod.make_spectral_bins_he(bb(5e4, False, ev2fr * 13.598, 2.8),
                                     panels_per_band=panels, nodes=nodes)
    s = np.array(bins.s)
    if table == "bands":
        s[1, 5:8] = 0.5 * s[1, 8]
        s[2, 13:16] = 0.5 * s[2, 16]
    elif table == "no_zeros":
        s[1, :8] = 0.3 * s[1, 8]
    elif table == "e18":
        s[2, 11:12] = 0.5 * s[2, 12]
    return bins._replace(s=s)


def _boxes(rt, B, dt, device="cpu", seed=81):
    """One batch of B boxes: the three species' absorber boxes (n_HeII 0 in
    one cell, n_HeI in another, n_HI in a third), their coldensh_out boxes
    by the plain sweep at each species' sigma_th (cd_HI past MAX_COLDENSH
    in a fourth cell) and fluxes with the last one 0."""
    g, tb = rt.geom, rt.eng.tables
    rng = np.random.RandomState(seed)
    nb = [torch.from_numpy(10 ** rng.uniform(lo, lo + 2, (B,) + (g.Dc,) * 3)
                           ).to(device, dt) for lo in (-4, -5, -6)]
    c = g.c
    nb[2][0, c + 1, c, c] = 0.0
    nb[1][-1, c, c + 1, c] = 0.0
    nb[0][0, c, c, c + 1] = 0.0
    geo = (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)
    cds = [sweep.cheb_sweep_ref(n, *geo, DR, c, sig)
           for n, sig in zip(nb, rt.sigma_th)]
    cds[0][0, c, c + 2, c] = 1e31
    flux = torch.from_numpy(rng.uniform(0.5, 2.0, B)).to(device, dt)
    flux[-1] = 0.0
    return cds, nb, flux


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("heat", [False, True])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rates_he_ref_matches_jax(shape, dt, heat, table):
    """rates_he_ref (the engine's ``_rates_he`` on CPU boxes, its bins by
    band) against the JAX engine's ``_rates_he`` on the same boxes:
    Gamma_HI, Gamma_HeI, Gamma_HeII and the heat per HI atom; 0 at the
    zero-density cells (the heat where n_HI is 0) and for the zero flux;
    at bin tables whose species' terms start at other bins, with a species
    that has no zero column, with bands that are not a multiple of the
    kernel's unroll and with 1152 bins."""
    N, R = SHAPES[shape]
    B = 3
    jr = JHeRaytracer(N, R, _bins(j_helium, JBlackBody, table), ABU_HE,
                      batch_size=B, dtype=JDT[dt], accumulate="scan",
                      do_heating=heat)
    tr = HeRaytracer(N, R, _bins(helium, BlackBodySource, table), ABU_HE,
                     batch_size=B, dtype=dt, device="cpu", do_heating=heat)
    first = he_first_bins(tr.he_tables.se, tr.he_tables.w_se,
                          tr.he_tables.wh_se if heat else None)
    assert first == {"default": [0, 8, 16], "bands": [0, 5, 13],
                     "no_zeros": [0, 0, 16], "e18": [0, 6, 11],
                     "e1152": [0, 384, 768]}[table]
    eng = tr.eng
    assert (jr.eng._rb0, jr.eng._rb1) == (eng._rb0, eng._rb1)
    assert (eng.Ds < tr.geom.Dc) == (shape == "subbox")
    cds, nb, flux = _boxes(tr, B, dt)
    want = jr._rates_he(jr.eng.tables, jr.he_tables,
                        [jnp.asarray(c.numpy()) for c in cds],
                        [jnp.asarray(n.numpy()) for n in nb],
                        jnp.asarray(flux.numpy()), jnp.asarray(DR, JDT[dt]))
    got = tr._rates_he(cds, nb, flux, DR)
    assert len(got) == len(want) == 3 + heat
    c = tr.geom.c - eng._rb0
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.shape == w.shape == (B,) + (eng.Ds,) * 3
        assert w.max() > 0 and np.all(np.isfinite(w))
        assert not np.any(w[-1]) and not bool(a[-1].any())     # zero flux
        if dt == torch.float64:
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-10, atol=0)
        else:
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-4,
                                       atol=1e-6 * float(np.abs(w).max()))
    if 0 <= c + 1 < eng.Ds:
        assert float(got[2][0, c + 1, c, c]) == 0.0            # n_HeII = 0
        assert float(got[0][0, c, c, c + 1]) == 0.0            # n_HI = 0
        if heat:
            assert float(got[3][0, c, c, c + 1]) == 0.0


@pytest.mark.parametrize("heat", [False, True])
def test_rates_he_ref_writes_the_rated_cells(heat):
    """The plain pass evaluates the listed cells only: given the list of a
    part of the rated cells it is 0 at every other cell and equal to the
    whole list's result at its own."""
    tr = HeRaytracer(16, 6.0, _bins(helium, BlackBodySource), ABU_HE,
                     batch_size=2, dtype=torch.float64, device="cpu",
                     do_heating=heat)
    eng, heb = tr.eng, tr.he_tables
    cds, nb, flux = _boxes(tr, 2, torch.float64, seed=82)
    args = (eng.tables.rt_sub, flux, heb.se, heb.w_se, DR,
            sweep.rate_consts(DR, torch.float64)[1], eng._rb0)
    wh = heb.wh_se if heat else None
    full = rates_he_ref(cds, nb, *args, wh_se=wh, cells=eng.rated_cells)
    assert torch.equal(rated_cells(eng.tables.rt_sub), eng.rated_cells)
    part = eng.rated_cells[::3]
    some = rates_he_ref(cds, nb, *args, wh_se=wh, cells=part)
    listed = torch.zeros(eng.Ds ** 3, dtype=torch.bool)
    listed[part.long()] = True
    for f, p in zip(full, some):
        f, p = f.view(2, -1), p.view(2, -1)
        assert torch.equal(p[:, listed], f[:, listed])
        assert not bool(p[:, ~listed].any()) and float(f.max()) > 0


def _fields(N, seed):
    rng = np.random.RandomState(seed)
    return (10 ** rng.uniform(-4, -2, (N,) * 3),
            rng.uniform(0.0, 0.9, (N,) * 3),
            rng.uniform(0.0, 0.4, (N,) * 3),
            rng.uniform(0.0, 0.4, (N,) * 3))


# 5 sources in batches of 2 (the last batch padded with a zero-flux source
# at the origin), clustered within two cells (two at one cell): the boxes
# overlap
def _sources(N, seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, N, 3) + rng.randint(0, 3, (5, 3))
    src[1] = src[0]
    return src % N, rng.uniform(0.5, 2.0, 5)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("heat", [False, True])
def test_he_trace_sweep_matches_jax(heat, segmented):
    """The staged trace (one he_trace_sweep call; its plain version on the
    CPU), folded onto the grid, and HeRaytracer.trace against the JAX
    trace at rtol 1e-10, the host engine's sweep segmented (K2, S = 2) or
    not; its launch counts none."""
    N, R, B = 14, 5.0, 2
    fields = _fields(N, seed=83)
    src, flux = _sources(N, seed=84)
    jr = JHeRaytracer(N, R, _bins(j_helium, JBlackBody), ABU_HE,
                      batch_size=B, dtype=jnp.float64, accumulate="scan",
                      do_heating=heat)
    tr = HeRaytracer(N, R, _bins(helium, BlackBodySource), ABU_HE,
                     batch_size=B, dtype=torch.float64, device="cpu",
                     do_heating=heat)
    if segmented:
        tr.eng.seg_S, tr.eng.seg_K = 2, -(-tr.geom.r_max // 2)
    want = [np.asarray(w) for w in jr.trace(*fields, src, flux, DR)]
    sweep.reset_launches()
    got = tr.trace(*fields, src, flux, DR)
    g, eng = tr.geom, tr.eng
    pads = [eng.wrap_pad(f) for f in tr.species_fields(
        *(torch.from_numpy(a) for a in fields))]
    pos_b, flux_b = tr.prepare_sources(src, flux)
    pos = stage_positions(pos_b, pads[0].shape, g.Dc, "cpu")
    loop = he_trace_sweep(pads, pos, flux_b, eng.tables, tr.he_tables, DR,
                          g.c, tr.sigma_th, seg=(eng.seg_S, eng.seg_K),
                          rb0=eng._rb0, heat=heat, cells=eng.rated_cells)
    assert sum(sweep.launches.values()) == 0
    assert len(got) == len(want) == len(loop) == 3 + heat
    for a, f, w in zip(got, loop, want):
        assert w.max() > 0
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-10, atol=0)
        assert torch.equal(fold_padding(f, g.c, g.Dc), a)


@pytest.mark.parametrize("frame", ["cubic", "domain"])
@pytest.mark.parametrize("heat", [False, True])
def test_trace_extended_equals_plain(heat, frame):
    """trace_extended (the staged positions, one he_trace_sweep call) bit
    for bit against trace_extended_plain (he_trace_sweep_ref on the host
    positions), on the wrap-padded grid and on a halo-extended block whose
    extents differ per axis, as domain.py hands it over."""
    N, R, B = 14, 5.0, 2
    tr = HeRaytracer(N, R, _bins(helium, BlackBodySource), ABU_HE,
                     batch_size=B, dtype=torch.float64, device="cpu",
                     do_heating=heat)
    Dc = tr.geom.Dc
    src, flux = _sources(N, seed=85)
    if frame == "cubic":
        pads = [tr.eng.wrap_pad(f) for f in tr.species_fields(
            *(torch.from_numpy(a) for a in _fields(N, seed=86)))]
    else:
        rng = np.random.RandomState(87)
        shape = (Dc + 3, Dc + 9, Dc + 5)
        pads = [torch.from_numpy(10 ** rng.uniform(lo, lo + 2, shape))
                for lo in (-4, -5, -6)]
        src = src % np.array([4, 10, 6])
    pos_b, flux_b = tr.prepare_sources(src, flux)
    got = tr.trace_extended(pads, pos_b, flux_b, DR)
    want = tr.trace_extended_plain(pads, pos_b, flux_b, DR)
    assert len(got) == len(want) == 3 + heat
    for a, w in zip(got, want):
        assert a.shape == pads[0].shape
        assert float(w.max()) > 0 and torch.equal(a, w)


def test_chunk_size_counts_the_species():
    """The helium loop's chunk holds the three species' boxes within
    CHUNK_BYTES: a third of the batches of one frame's chunk."""
    per = 8 * 64 ** 3 * 4                     # a bench batch, float32
    assert chunk_size(256, 8, 64, 4, channels=3) == trace_loop.CHUNK_BYTES \
        // (3 * per)
    assert chunk_size(256, 8, 64, 4, channels=3) * 3 <= chunk_size(
        256, 8, 64, 4)
    assert chunk_size(5, 1, 8, 8, channels=3) == 5
    assert chunk_size(2, 8, 208, 4, channels=3) == 1


def test_wrappers_check_their_arguments():
    """On CPU tensors rates_he and he_trace_sweep are their plain versions
    and count no launch; they refuse other than three species, and a tensor
    on a device other than the CPU or a card raises (no silent plain
    path); an engine on a card this machine does not have raises."""
    tr = HeRaytracer(8, 6.0, _bins(helium, BlackBodySource), ABU_HE,
                     batch_size=2, dtype=torch.float64, device="cpu",
                     do_heating=True)
    eng, heb = tr.eng, tr.he_tables
    cds, nb, flux = _boxes(tr, 2, torch.float64, seed=88)
    args = (eng.tables.rt_sub, flux, heb.se, heb.w_se, DR,
            sweep.rate_consts(DR, torch.float64)[1], eng._rb0)
    sweep.reset_launches()
    got = rates_he(cds, nb, *args, wh_se=heb.wh_se, cells=eng.rated_cells)
    want = rates_he_ref(cds, nb, *args, wh_se=heb.wh_se,
                        cells=eng.rated_cells)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert all(torch.equal(a, w) for a, w in
               zip(tr._rates_he(cds, nb, flux, DR), want))
    with pytest.raises(ValueError, match="three species"):
        rates_he(cds[:2], nb[:2], *args, cells=eng.rated_cells)
    with pytest.raises(ValueError, match="unsupported device"):
        rates_he([c.to("meta") for c in cds], [n.to("meta") for n in nb],
                 *args, cells=eng.rated_cells.to("meta"))
    g = tr.geom
    pads = [eng.wrap_pad(torch.full((8,) * 3, 1e-3, dtype=torch.float64))
            for _ in range(3)]
    pos_b, flux_b = tr.prepare_sources(np.array([[1, 2, 3]]), [1.0])
    pos = stage_positions(pos_b, pads[0].shape, g.Dc, "cpu")
    loop_args = (pos, flux_b, eng.tables, heb, DR, g.c)
    out = he_trace_sweep(pads, *loop_args, tr.sigma_th, rb0=eng._rb0,
                         heat=True, cells=eng.rated_cells)
    assert len(out) == 4 and float(out[0].max()) > 0
    assert sum(sweep.launches.values()) == 0
    with pytest.raises(ValueError, match="three species"):
        he_trace_sweep(pads[:2], *loop_args, tr.sigma_th,
                       cells=eng.rated_cells)
    with pytest.raises(ValueError, match="three species"):
        he_trace_sweep(pads, *loop_args, tr.sigma_th[:2],
                       cells=eng.rated_cells)
    with pytest.raises(ValueError, match="unsupported device"):
        he_trace_sweep([p.to("meta") for p in pads], pos.to("meta"),
                       flux_b.to("meta"), eng.tables, heb, DR, g.c,
                       tr.sigma_th, rb0=eng._rb0,
                       cells=eng.rated_cells.to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HeRaytracer(8, 6.0, _bins(helium, BlackBodySource), ABU_HE)


@pytest.mark.cuda
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rates_he_matches_plain_on_cuda(shape, table):
    """The kernel at the engine's rated cells bit for bit against the plain
    pass on the card, in float32 and float64, with and without the heat
    channel, with zero-density cells, at every bin table of ``TABLES``
    (bands at other bins, a species with no zero column, bands not a
    multiple of the unroll, records beyond 48 KB of shared memory), every
    cell outside the list 0; one launch a call; with more cells listed
    than the subbox has it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    N, R = SHAPES[shape]
    for dt in (torch.float32, torch.float64):
        for heat in (False, True):
            tr = HeRaytracer(N, R, _bins(helium, BlackBodySource, table),
                             ABU_HE, batch_size=3, dtype=dt,
                             do_heating=heat)
            eng, heb = tr.eng, tr.he_tables
            cds, nb, flux = _boxes(tr, 3, dt, device="cuda")
            args = (eng.tables.rt_sub, flux, heb.se, heb.w_se, DR,
                    sweep.rate_consts(DR, dt)[1], eng._rb0)
            wh = heb.wh_se if heat else None
            n0 = sweep.launches["rates_he"]
            got = rates_he(cds, nb, *args, wh_se=wh, cells=eng.rated_cells)
            want = rates_he_ref(cds, nb, *args, wh_se=wh,
                                cells=eng.rated_cells)
            torch.cuda.synchronize()
            assert sweep.launches["rates_he"] == n0 + 1
            outside = torch.ones(eng.Ds ** 3, dtype=torch.bool,
                                 device="cuda")
            outside[eng.rated_cells.long()] = False
            assert len(got) == len(want) == 3 + heat
            for a, w in zip(got, want):
                assert float(w.max()) > 0 and torch.equal(a, w), (dt, heat)
                assert not bool(a.view(3, -1)[:, outside].any())
            with pytest.raises(ValueError, match="rated cells"):
                rates_he(cds, nb, *args, wh_se=wh, cells=torch.zeros(
                    eng.Ds ** 3 + 1, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["default", "e18"])
@pytest.mark.parametrize("frame", ["cubic", "domain"])
def test_he_trace_sweep_matches_plain_on_cuda(frame, table):
    """The helium loop in C (one he_trace_sweep call) bit for bit against
    trace_extended_plain on the card, in float32 and float64, with and
    without the heat channel, the host engine segmented or not, on the
    wrap-padded grid and a halo-extended block, at the default bins and at
    bands that are not a multiple of the rate pass's unroll, with the
    loop's launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    N, R, B = 14, 5.0, 2
    src, flux = _sources(N, seed=89)
    fields = _fields(N, seed=90)
    for dt in (torch.float32, torch.float64):
        for heat in (False, True):
            for segmented in (False, True):
                tr = HeRaytracer(N, R, _bins(helium, BlackBodySource, table),
                                 ABU_HE, batch_size=B, dtype=dt,
                                 do_heating=heat)
                eng, Dc = tr.eng, tr.geom.Dc
                if segmented:
                    eng.seg_S, eng.seg_K = 2, -(-tr.geom.r_max // 2)
                if frame == "cubic":
                    pads = [eng.wrap_pad(f) for f in tr.species_fields(
                        *(torch.from_numpy(a).to("cuda", dt)
                          for a in fields))]
                    pos_src = src
                else:
                    rng = np.random.RandomState(91)
                    shape = (Dc + 3, Dc + 9, Dc + 5)
                    pads = [torch.from_numpy(10 ** rng.uniform(
                        lo, lo + 2, shape)).to("cuda", dt)
                        for lo in (-4, -5, -6)]
                    pos_src = src % np.array([4, 10, 6])
                pos_b, flux_b = tr.prepare_sources(pos_src, flux)
                nb = pos_b.shape[0]
                sweep.reset_launches()
                got = tr.trace_extended(pads, pos_b, flux_b, DR)
                counts = dict(sweep.launches)
                want = tr.trace_extended_plain(pads, pos_b, flux_b, DR)
                torch.cuda.synchronize()
                K = eng.seg_K if segmented else 1
                expect = {k: 0 for k in counts}
                expect.update(he_trace_sweep=1, rates_he=nb,
                              accumulate_boxes=nb,
                              extract_boxes=-(-nb // chunk_size(
                                  nb, B, Dc, dt.itemsize, channels=3)))
                expect["cheb_sweep_seg" if segmented else "cheb_sweep"] = \
                    3 * nb * K
                if segmented:
                    expect["init_segments"] = 3 * nb
                assert counts == expect, (dt, heat, segmented)
                assert len(got) == len(want) == 3 + heat
                for a, w in zip(got, want):
                    assert float(w.max()) > 0 and torch.equal(a, w), (
                        dt, heat, segmented)
