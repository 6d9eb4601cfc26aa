"""The port's shell-segmented sweep (K2's plain version and the engine's
shell_segment mode) against its own monolithic sweep and against the JAX
engine's segmented Pallas sweep (interpret mode), in float64, and the
segmentation rule against the JAX engine's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.ops.raytrace_box import grey_bins
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer, shell_segmentation

SIG = 6.30e-18
DR = 6.7e20


def _engine(N, R, B=2, dtype=torch.float64, device="cpu", **kw):
    return ChebRaytracer(N, R, SIG, grey_bins(), batch_size=B, dtype=dtype,
                         device=device, **kw)


def _geo(tr):
    tb = tr.tables
    return tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p


def _box(tr, seed, B=2):
    Dc = tr.geom.Dc
    rng = np.random.RandomState(seed)
    return torch.from_numpy(10 ** rng.uniform(-4, -2, (B, Dc, Dc, Dc)))


def _chain(tr, box, S):
    """K segments of S shells through cheb_sweep_seg, source cell last."""
    g = tr.geom
    planes = sweep.init_planes(box, g.c, DR)
    src_cd = planes[:, 0, 0, g.c, g.c].clone()
    out = torch.zeros_like(box)
    for r0 in range(1, g.r_max + 1, S):
        out, planes = sweep.cheb_sweep_seg(box, *_geo(tr), DR, g.c, SIG,
                                           planes, r0, S, out)
    out[:, g.c, g.c, g.c] = src_cd
    return out


# N=16, R=8 clips the box (c + r_max leaves it); r_max = 8, so S = 3 is a
# ragged last segment, 4 divides it and 9 = r_max + 1 is one segment
@pytest.mark.parametrize("S", [3, 4, 9])
def test_seg_ref_chained_equals_sweep_ref(S):
    tr = _engine(16, 8.0)
    assert tr.geom.r_max == 8
    box = _box(tr, 11)
    want = sweep.cheb_sweep_ref(box, *_geo(tr), DR, tr.geom.c, SIG)
    assert torch.equal(_chain(tr, box, S), want)


def test_seg_ref_returns_last_planes():
    """A segment's returned planes are the carry: two segments from them
    equal one segment over both ranges, box and planes."""
    tr = _engine(12, 5.0)
    g, box = tr.geom, _box(tr, 12)
    p0 = sweep.init_planes(box, g.c, DR)
    b1, p1 = sweep.cheb_sweep_seg_ref(box, *_geo(tr), DR, g.c, SIG, p0, 1, 2)
    b2, p2 = sweep.cheb_sweep_seg_ref(box, *_geo(tr), DR, g.c, SIG, p1, 3, 2,
                                      b1.clone())
    b12, p12 = sweep.cheb_sweep_seg_ref(box, *_geo(tr), DR, g.c, SIG, p0, 1,
                                        4)
    assert torch.equal(b2, b12) and torch.equal(p2, p12)
    assert not torch.equal(p1, p12)


# N=24, R=10: r_max = 10, so S = 4 leaves a ragged last segment and S = 5
# divides it
@pytest.mark.parametrize("S", [4, 5])
def test_segmented_trace_matches_jax(S):
    N, R = 24, 10.0
    rng = np.random.RandomState(32)
    ndens = 10 ** rng.uniform(-4, -2, (N,) * 3)
    xh = rng.uniform(0.0, 0.5, (N,) * 3)
    src = rng.randint(0, N, size=(3, 3))
    flux = rng.uniform(0.5, 3.0, 3)
    jr = JRaytracer(N, R, SIG, grey_bins(), batch_size=2, dtype=jnp.float64,
                    use_pallas=True, accumulate="scan", shell_segment=S)
    tr = _engine(N, R, shell_segment=S)
    assert (tr.seg_S, tr.seg_K) == (jr.seg_S, jr.seg_K) == (S, -(-10 // S))
    want = np.asarray(jr.trace(ndens, xh, src, flux, DR))
    got = tr.trace(ndens, xh, src, flux, DR)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    mono = _engine(N, R, shell_segment=0)
    assert mono.seg_S == 0
    assert torch.equal(got, mono.trace(ndens, xh, src, flux, DR))


# the configurations of the JAX package's test_segmentation_auto_thresholds
# plus the R = 100 row of the raytracing benchmark harness (B = 8)
@pytest.mark.parametrize("N,R,B", [(64, 30.0, 8), (250, 100.0, 4),
                                   (250, 100.0, 8), (250, 100.0, 16)])
def test_segmentation_matches_jax(N, R, B):
    jr = JRaytracer(N, R, SIG, grey_bins(), batch_size=B, dtype=jnp.float32,
                    use_pallas=True)
    got = shell_segmentation(N, R, B, torch.float32)
    assert got == (jr.seg_S, jr.seg_K)
    if (N, B) == (250, 8):
        assert got == (24, 5)
    if N == 64:
        assert (_engine(N, R, B, torch.float32).seg_S,) == (jr.seg_S,) == (0,)


def test_segmentation_with_fused_modes():
    """auto resolves to 0 with a fused mode where the JAX engine raises;
    an explicit S with a fused mode raises in both."""
    for fuse in ("fuse_rates", "fuse_fold"):
        assert shell_segmentation(250, 100.0, 8, torch.float32,
                                  fused=True) == (0, 0)
        with pytest.raises(ValueError, match="does not compose"):
            JRaytracer(250, 100.0, SIG, grey_bins(), batch_size=8,
                       dtype=jnp.float32, use_pallas=True, **{fuse: True})
        tr = _engine(16, 8.0, **{fuse: True})
        assert (tr.seg_S, tr.seg_K) == (0, 0)
        with pytest.raises(ValueError, match="does not compose"):
            _engine(16, 8.0, shell_segment=3, **{fuse: True})
    # an explicit S past r_max turns segmentation off, fused or not
    assert _engine(16, 8.0, shell_segment=9, fuse_fold=True).seg_S == 0


def test_seg_wrapper_dispatch_on_device():
    tr = _engine(8, 6.0)
    box = _box(tr, 3)
    planes = sweep.init_planes(box, tr.geom.c, DR)
    sweep.reset_launches()
    got = sweep.cheb_sweep_seg(box, *_geo(tr), DR, tr.geom.c, SIG, planes,
                               1, 2)
    want = sweep.cheb_sweep_seg_ref(box, *_geo(tr), DR, tr.geom.c, SIG,
                                    planes, 1, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(sweep.launches.values()) == 0
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.cheb_sweep_seg(box.to("meta"), *_geo(tr), DR, tr.geom.c, SIG,
                             planes, 1, 2)


@pytest.mark.cuda
def test_seg_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        tr = _engine(16, 8.0, dtype=dt, device="cuda")
        box = _box(tr, 4).to("cuda", dt)
        k1 = sweep.cheb_sweep(box, *_geo(tr), DR, tr.geom.c, SIG)
        want = sweep.cheb_sweep_ref(box, *_geo(tr), DR, tr.geom.c, SIG)
        for S in (3, 4):
            n0 = sweep.launches["cheb_sweep_seg"]
            got = _chain(tr, box, S)
            assert sweep.launches["cheb_sweep_seg"] == n0 + -(-8 // S)
            assert torch.equal(got, k1)       # the same rounded arithmetic
            torch.testing.assert_close(got, want, rtol=rtol, atol=0)
