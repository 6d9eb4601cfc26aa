"""The trace loop (ops/trace_loop.py): a trace with its positions staged
once, the batch loop as one call (``cheb_trace_sweep``, every sweep mode),
the box extract and the ordered accumulate.

On the CPU the wrappers run their plain versions: the staged traces
against the JAX engine's (the Pallas kernels in interpret mode, scan
accumulate) in float64 on a batch of overlapping boxes: fuse_fold with and
without the heating output, and the default mode, shell_segment, fuse_rates
and do_heating; every sweep mode's ``trace_extended`` bit for bit against
``trace_extended_plain``, the loop as it was issued before, also on a
non-cubic frame as the domain decomposition hands it. On the card
(``cuda``) the kernels and the C++ loops against their plain versions, bit
for bit: at the EoR run's shape, the accumulate on clustered batches of 16
and 40 boxes, and in every sweep mode at a small one."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer
from pyc2ray_tpu.radiation import BlackBodySource
from pyc2ray_tpu.radiation.bins_compress import compress_bins
from pyc2ray_tpu.radiation.spectral_bins import make_spectral_bins

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.ops import trace_loop
from pyc2ray_torch.ops.trace_loop import (accumulate_boxes, add_boxes,
                                          cheb_trace_sweep, chunk_size,
                                          extract_boxes, extract_boxes_ref,
                                          extract_chunk, extract_chunk_ref,
                                          stage_positions)

SIG = 6.30e-18
DR = 6.7e20


def _bb_bins():
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    dense = make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                               fmin, fmax, panels=8, nodes=8)
    return compress_bins(dense, target_rel=1e-2, cache=False)


def _clustered(N, ns, seed):
    """Fields and ``ns`` sources within two cells of one another (two at
    the same cell), as halos cluster: their boxes overlap."""
    rng = np.random.RandomState(seed)
    ndens = 10 ** rng.uniform(-4, -2, (N, N, N))
    xh = rng.uniform(0.0, 0.9, (N, N, N))
    src = rng.randint(0, N, 3) + rng.randint(0, 3, (ns, 3))
    src[1] = src[0]
    flux = rng.uniform(0.5, 2.0, ns)
    return ndens, xh, src % N, flux


# 5 sources in batches of 3: the last batch is padded with a zero-flux
# source at the origin
@pytest.mark.parametrize("heat", [False, True])
def test_staged_fuse_fold_trace_matches_jax(heat):
    N, R, B = 20, 6.0, 3
    bins = _bb_bins()
    ndens, xh, src, flux = _clustered(N, 5, seed=51)
    jr = JRaytracer(N, R, SIG, bins, batch_size=B, dtype=jnp.float64,
                    use_pallas=True, accumulate="scan", fuse_fold=True,
                    do_heating=heat)
    tr = ChebRaytracer(N, R, SIG, bins, batch_size=B, dtype=torch.float64,
                       device="cpu", fuse_fold=True, do_heating=heat)
    want = jr.trace(ndens, xh, src, flux, DR)
    got = tr.trace(ndens, xh, src, flux, DR)
    want, got = ((want, got) if heat else ((want,), (got,)))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.max() > 0 and np.all(np.isfinite(w))
        # the JAX fused kernel's Taylor substitute for expm1: rel < 2e-8
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-7, atol=0)


# the sweep modes of cheb_trace_sweep: (engine options, rtol against the
# JAX engine); the JAX K1f's rates use a Taylor substitute for expm1 (rel
# err < 2e-8)
SWEEP_MODES = {
    "default": ({}, 1e-9),
    "shell_segment": (dict(shell_segment=2), 1e-9),
    "fuse_rates": (dict(fuse_rates=True), 1e-7),
    "do_heating": (dict(do_heating=True), 1e-9),
}


# (16, 6): an unclipped box (the JAX K1f's d2 is wrong on a clipped one,
# ROADMAP §3); 7 clustered sources in batches of 3, the last batch padded
@pytest.mark.parametrize("mode", sorted(SWEEP_MODES))
def test_trace_sweep_matches_jax(mode):
    """The staged trace of a sweep mode other than fuse_fold (one
    ``cheb_trace_sweep`` call, its plain version on the CPU) against the
    JAX engine's trace and bit for bit against trace_extended_plain."""
    N, R, B = 16, 6.0, 3
    kw, rtol = SWEEP_MODES[mode]
    bins = _bb_bins()
    ndens, xh, src, flux = _clustered(N, 7, seed=56)
    jr = JRaytracer(N, R, SIG, bins, batch_size=B, dtype=jnp.float64,
                    use_pallas=True, accumulate="scan", **kw)
    tr = ChebRaytracer(N, R, SIG, bins, batch_size=B, dtype=torch.float64,
                       device="cpu", **kw)
    assert tr.seg_S == (2 if mode == "shell_segment" else 0)
    want = jr.trace(ndens, xh, src, flux, DR)
    got = tr.trace(ndens, xh, src, flux, DR)
    want, got = ((want, got) if tr.do_heating else ((want,), (got,)))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.max() > 0 and np.all(np.isfinite(w))
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=0)
    pad = tr.wrap_pad(torch.from_numpy(ndens * (1.0 - xh)))
    pos_b, flux_b = tr.prepare_sources(src, flux)
    g = tr.geom
    loop = cheb_trace_sweep(pad, stage_positions(pos_b, pad.shape, g.Dc,
                                                 "cpu"),
                            flux_b, tr.tables, DR, g.c, SIG,
                            **tr._sweep_mode())
    plain = tr.trace_extended_plain(pad, pos_b, flux_b, DR)
    for a, b in zip(loop, plain):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


MODES = {
    "default": {},
    "fuse_rates": dict(fuse_rates=True),
    "fuse_fold": dict(fuse_fold=True),
    "shell_segment": dict(shell_segment=2),
    "heat": dict(do_heating=True),
    "heat_fuse_fold": dict(do_heating=True, fuse_fold=True),
}


@pytest.mark.parametrize("frame", ["cubic", "domain"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_trace_extended_equals_plain(mode, frame):
    """The staged trace (one call of the loop, cheb_trace_sweep) bit for
    bit against the loop as it was issued before, on the wrap-padded grid
    and on a halo-extended block whose extents differ per axis."""
    N, R, B = 16, 5.0, 3
    tr = ChebRaytracer(N, R, SIG, _bb_bins(), batch_size=B,
                       dtype=torch.float64, device="cpu", **MODES[mode])
    Dc = tr.geom.Dc
    ndens, xh, src, flux = _clustered(N, 7, seed=52)
    if frame == "cubic":
        pad = tr.wrap_pad(torch.from_numpy(ndens * (1.0 - xh)))
    else:
        rng = np.random.RandomState(53)
        pad = torch.from_numpy(10 ** rng.uniform(-4, -2, (Dc + 3, Dc + 9,
                                                          Dc + 5)))
        src = src % np.array([4, 10, 6])
    pos_b, flux_b = tr.prepare_sources(src, flux)
    got = tr.trace_extended(pad, pos_b, flux_b, DR)
    want = tr.trace_extended_plain(pad, pos_b, flux_b, DR)
    assert (got[1] is None) == (want[1] is None) == (not tr.do_heating)
    for g, w in zip(got, want):
        if w is not None:
            assert float(w.max()) > 0 and torch.equal(g, w)


def test_stage_positions_checks_the_frame():
    pos = torch.tensor([[[0, 1, 2], [3, 4, 5]]])
    staged = stage_positions(pos, (9, 10, 11), 6, "cpu")
    assert staged.dtype == torch.int32 and staged.is_contiguous()
    assert torch.equal(staged, pos.to(torch.int32))
    with pytest.raises(ValueError, match="leave the frame"):
        stage_positions(pos, (9, 10, 10), 6, "cpu")
    with pytest.raises(ValueError, match="leave the frame"):
        stage_positions(-pos, (9, 10, 11), 6, "cpu")
    with pytest.raises(ValueError, match="expected"):
        stage_positions(pos[0], (9, 10, 11), 6, "cpu")


# (frame extents, padding of its rows, D, B, nb, k): a cubic frame, a
# non-cubic one (a domain's halo-extended block), both as views of a tensor
# with wider rows (a pitched frame); nb = 5 in chunks of 2 ends on a short
# chunk
CHUNKS = {"cubic": ((14, 14, 14), 0, 6, 3, 5, 2),
          "domain": ((11, 17, 13), 0, 5, 4, 4, 3),
          "pitched": ((12, 15, 13), 3, 6, 2, 5, 2),
          "pitched_domain": ((9, 16, 11), 5, 4, 5, 3, 3)}


@pytest.mark.parametrize("case", sorted(CHUNKS))
def test_extract_chunk_plain_matches_batches_and_jax(case):
    """The chunked extract's plain form: every chunk of k batches, the
    short last one too, equals the stack of extract_boxes_ref of its
    batches and the JAX engine's _extract_boxes (lax.dynamic_slice per
    box) of each batch, one channel or two, on a frame that may be a view
    with padded rows; the CPU wrapper runs it and counts no launch."""
    shape, pad, D, B, nb, k = CHUNKS[case]
    rng = np.random.RandomState(sum(shape) + pad)
    wide = rng.standard_normal(shape[:2] + (shape[2] + pad,))
    frame = torch.from_numpy(wide)[:, :, :shape[2]]
    assert pad == 0 or not frame.is_contiguous()
    other = torch.from_numpy(rng.standard_normal(shape))
    pos = stage_positions(rng.randint(0, np.array(shape) - D + 1,
                                      (nb, B, 3)), shape, D, "cpu")
    jr = JRaytracer.__new__(JRaytracer)
    jr.geom = type("G", (), {"Dc": D})()
    sweep.reset_launches()
    for k0 in range(0, nb, k):
        kk = min(k, nb - k0)
        got = extract_chunk_ref(frame, pos, k0, kk, D)
        assert got.shape == (kk, B, D, D, D)
        both = extract_chunk([frame, other], pos, k0, kk, D)
        assert torch.equal(both[0], got)
        for s_ in range(kk):
            b = k0 + s_
            assert torch.equal(got[s_], extract_boxes_ref(frame, pos[b], D))
            assert torch.equal(both[1][s_],
                               extract_boxes_ref(other, pos[b], D))
            jx = jr._extract_boxes(jnp.asarray(frame.contiguous().numpy()),
                                   jnp.asarray(pos[b].numpy()))
            np.testing.assert_array_equal(np.asarray(jx), got[s_].numpy())
    assert sum(sweep.launches.values()) == 0


def test_chunk_size_fills_its_budget():
    """chunk_size: as many batches as CHUNK_BYTES hold, at least 1, at most
    MAX_CHUNK and the trace's batches."""
    per = 16 * 24 ** 3 * 4                   # the EoR run's batch, float32
    assert chunk_size(1250, 16, 24, 4) == min(
        trace_loop.MAX_CHUNK, trace_loop.CHUNK_BYTES // per)
    assert chunk_size(1250, 8, 64, 4) == trace_loop.CHUNK_BYTES // (
        8 * 64 ** 3 * 4)                     # the bench's
    assert chunk_size(3, 16, 24, 4) == 3
    assert chunk_size(100, 8, 208, 8) == 1


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On a CPU frame extract_boxes and accumulate_boxes are the plain
    functions, one channel or several, and count no launch."""
    rng = np.random.RandomState(54)
    frames = [torch.from_numpy(rng.standard_normal((9, 11, 10)))
              for _ in range(3)]
    pos = stage_positions(rng.randint(0, 4, (2, 3, 3)), (9, 11, 10), 6,
                          "cpu")
    sweep.reset_launches()
    one = extract_boxes(frames[0], pos, 1, 6)
    assert torch.equal(one, extract_boxes_ref(frames[0], pos[1], 6))
    many = extract_boxes(frames, pos, 1, 6)
    assert all(torch.equal(m, extract_boxes_ref(f, pos[1], 6))
               for m, f in zip(many, frames))
    boxes = [torch.from_numpy(rng.standard_normal((3, 4, 4, 4)))
             for _ in range(3)]
    want = [f.clone() for f in frames]
    for w, b in zip(want, boxes):
        add_boxes(w, b, pos[0], 2)
    accumulate_boxes(frames, boxes, pos, 0, 2)
    assert all(torch.equal(f, w) for f, w in zip(frames, want))
    assert sum(sweep.launches.values()) == 0


@pytest.mark.cuda
def test_trace_loop_matches_plain_on_cuda_at_the_eor_shape():
    """At the EoR run's small bucket (N = 250, R = 7.68: Dc = 24, B = 16,
    float32): extract_boxes and accumulate_boxes bit for bit against the
    gather and the slice adds on a batch of overlapping boxes, and the C++
    loop (K3, K3h) bit for bit against trace_extended_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    N, B, dt = 250, 16, torch.float32
    R = 15.0 * N / 244.0 / 2.0
    bins = _bb_bins()
    rng = np.random.RandomState(55)
    nhi = torch.from_numpy(10 ** rng.uniform(-4, -2, (N,) * 3)).to("cuda",
                                                                    dt)
    src = rng.randint(0, N, (4 * B, 3))
    src[:B] = src[0] + rng.randint(0, 3, (B, 3))        # overlapping boxes
    src[1] = src[0]
    src %= N
    flux = rng.uniform(0.5, 2.0, 4 * B)
    for heat in (False, True):
        tr = ChebRaytracer(N, R, SIG, bins, batch_size=B, dtype=dt,
                           fuse_fold=True, do_heating=heat)
        Dc = tr.geom.Dc
        pad = tr.wrap_pad(nhi)
        pos_b, flux_b = tr.prepare_sources(src, flux)
        pos = stage_positions(pos_b, pad.shape, Dc, "cuda")
        sweep.reset_launches()
        boxes = extract_boxes(pad, pos, 0, Dc)
        assert torch.equal(boxes, extract_boxes_ref(pad, pos[0], Dc))
        frame = torch.from_numpy(rng.standard_normal(pad.shape)).to("cuda",
                                                                    dt)
        want = frame.clone()
        add_boxes(want, boxes, pos_b[0])
        accumulate_boxes(frame, boxes, pos, 0)
        torch.cuda.synchronize()
        assert torch.equal(frame, want)
        assert sweep.launches["extract_boxes"] == 1
        assert sweep.launches["accumulate_boxes"] == 1
        got = tr.trace_extended(pad, pos_b, flux_b, DR)
        ref = tr.trace_extended_plain(pad, pos_b, flux_b, DR)
        torch.cuda.synchronize()
        name = "cheb_sweep_rates_heat" if heat else "cheb_sweep_rates"
        assert sweep.launches["cheb_trace_sweep"] == 1
        assert sweep.launches[name] == 2 * pos_b.shape[0]
        for g, w in zip(got, ref):
            if w is not None:
                assert float(w.max()) > 0 and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 40])
def test_accumulate_matches_plain_on_cuda_clustered(B):
    """accumulate_boxes on a batch clustered within two cells of one
    corner (two boxes at one cell) at the EoR run's box side (D = 24), in
    both types, with one channel and two (Gamma and heat): bit for bit
    against the slice adds, one launch each. B = 16 is the EoR run's batch;
    with B = 40 a cell's coverage spans two 32-box masks and five chunks of
    loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    D, shape = 24, (40, 47, 43)
    rng = np.random.RandomState(59)
    pos = rng.randint(0, 10, 3) + rng.randint(0, 3, (1, B, 3))
    pos[0, 1] = pos[0, 0]
    pos_d = stage_positions(torch.from_numpy(pos), shape, D, "cuda")
    for dt in (torch.float32, torch.float64):
        for n in (1, 2):
            frames = [torch.from_numpy(rng.standard_normal(shape)).to(
                "cuda", dt) for _ in range(n)]
            boxes = [torch.from_numpy(rng.standard_normal(
                (B, D, D, D))).to("cuda", dt) for _ in range(n)]
            want = [f.clone() for f in frames]
            for w, b in zip(want, boxes):
                add_boxes(w, b, torch.from_numpy(pos[0]))
            sweep.reset_launches()
            accumulate_boxes(frames, boxes, pos_d, 0)
            torch.cuda.synchronize()
            assert sweep.launches["accumulate_boxes"] == 1
            for f, w in zip(frames, want):
                assert torch.equal(f, w), (dt, n)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["cubic", "domain"])
def test_trace_sweep_matches_plain_on_cuda(frame):
    """Every sweep mode through the C++ loop (one cheb_trace_sweep call)
    bit for bit against trace_extended_plain on the card, in float32 and
    float64, with the loop's launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    N, R, B = 16, 5.0, 3
    ndens, xh, src, flux = _clustered(N, 7, seed=57)
    for dt in (torch.float32, torch.float64):
        for mode in sorted(MODES):
            tr = ChebRaytracer(N, R, SIG, _bb_bins(), batch_size=B, dtype=dt,
                               **MODES[mode])
            Dc = tr.geom.Dc
            if frame == "cubic":
                pad = tr.wrap_pad(torch.from_numpy(ndens * (1.0 - xh)).to(
                    "cuda", dt))
                pos_src = src
            else:
                rng = np.random.RandomState(58)
                pad = torch.from_numpy(10 ** rng.uniform(
                    -4, -2, (Dc + 3, Dc + 9, Dc + 5))).to("cuda", dt)
                pos_src = src % np.array([4, 10, 6])
            pos_b, flux_b = tr.prepare_sources(pos_src, flux)
            nb = pos_b.shape[0]
            sweep.reset_launches()
            got = tr.trace_extended(pad, pos_b, flux_b, DR)
            counts = dict(sweep.launches)
            want = tr.trace_extended_plain(pad, pos_b, flux_b, DR)
            torch.cuda.synchronize()
            sweep_name = {"fuse_rates": "cheb_sweep_fused_rates",
                          "shell_segment": "cheb_sweep_seg",
                          "fuse_fold": "cheb_sweep_rates",
                          "heat_fuse_fold": "cheb_sweep_rates_heat"}.get(
                              mode, "cheb_sweep")
            expect = {k: 0 for k in counts}
            expect.update(cheb_trace_sweep=1, accumulate_boxes=nb,
                          extract_boxes=-(-nb // chunk_size(
                              nb, B, Dc, dt.itemsize)))
            expect[sweep_name] = nb * (tr.seg_K if tr.seg_S else 1)
            if "fuse" not in mode:
                expect["rates_dense"] = nb
            if tr.seg_S:
                expect["init_segments"] = nb
            assert counts == expect, (mode, dt)
            for a, b in zip(got, want):
                if b is not None:
                    assert float(b.max()) > 0 and torch.equal(a, b), (mode,
                                                                      dt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["bench", "eor"])
def test_extract_chunk_matches_plain_on_cuda(shape):
    """extract_chunk on the card at the bench shape (B = 8, Dc = 64) and the
    EoR run's (B = 16, Dc = 24), float32 and float64: every chunk of 5
    batches in chunks of 2 (the last one short) and one chunk of all five,
    one channel and three, bit for bit against extract_chunk_ref, one launch
    each; and on a frame that is a view with padded rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    N, B, D = {"bench": (256, 8, 64), "eor": (250, 16, 24)}[shape]
    side = N + D - 1
    rng = np.random.RandomState(60)
    pos = stage_positions(rng.randint(0, side - D + 1, (5, B, 3)),
                          (side,) * 3, D, "cuda")
    for dt in (torch.float32, torch.float64):
        frames = [torch.from_numpy(rng.standard_normal((side,) * 3)).to(
            "cuda", dt) for _ in range(3)]
        for k0, k in ((0, 2), (2, 2), (4, 1), (0, 5)):
            for n in (1, 3):
                sweep.reset_launches()
                got = extract_chunk(frames[:n], pos, k0, k, D)
                torch.cuda.synchronize()
                assert sweep.launches["extract_boxes"] == 1
                for g, f in zip(got, frames):
                    assert torch.equal(g, extract_chunk_ref(f, pos, k0, k, D))
        wide = torch.from_numpy(rng.standard_normal(
            (side, side, side + 3))).to("cuda", dt)
        view = wide[:, :, :side]
        got = extract_chunk(view, pos, 1, 3, D)
        assert torch.equal(got, extract_chunk_ref(view, pos, 1, 3, D))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_trace_loop_chunks_match_plain_on_cuda(chunk, monkeypatch):
    """The C++ loop with its extract in chunks of 1, 2 and 4 batches (7
    batches: the last chunk short where 7 is no multiple), in every sweep
    mode, bit for bit against trace_extended_plain, ceil(7 / chunk)
    extract launches a trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    N, R, B = 16, 5.0, 3
    ndens, xh, src, flux = _clustered(N, 20, seed=61)
    monkeypatch.setattr(trace_loop, "chunk_size",
                        lambda nb, *_: min(chunk, nb))
    for mode in sorted(MODES):
        tr = ChebRaytracer(N, R, SIG, _bb_bins(), batch_size=B,
                           dtype=torch.float32, **MODES[mode])
        pad = tr.wrap_pad(torch.from_numpy(ndens * (1.0 - xh)).to(
            "cuda", torch.float32))
        pos_b, flux_b = tr.prepare_sources(src, flux)
        nb = pos_b.shape[0]
        assert nb == 7
        sweep.reset_launches()
        got = tr.trace_extended(pad, pos_b, flux_b, DR)
        n_ex = sweep.launches["extract_boxes"]
        want = tr.trace_extended_plain(pad, pos_b, flux_b, DR)
        torch.cuda.synchronize()
        assert n_ex == -(-nb // chunk), mode
        for a, b in zip(got, want):
            if b is not None:
                assert torch.equal(a, b), mode
