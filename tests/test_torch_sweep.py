"""The port's plain sweep (the CPU path of the CUDA kernel) against the
JAX engine's kernel K1 (cheb_sweep_pallas in interpret mode, folded by
_fold_stacks_packed) and its XLA sweep, in float64."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.ops.raytrace_box import grey_bins
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer

SIG = 6.30e-18
DR = 6.7e20


def _pair(N, R, B=2):
    jr = JRaytracer(N, R, SIG, grey_bins(), batch_size=B, dtype=jnp.float64,
                    use_pallas=True, accumulate="scan")
    tr = ChebRaytracer(N, R, SIG, grey_bins(), batch_size=B,
                       dtype=torch.float64, device="cpu")
    return jr, tr


def _box(tr, seed, B=2):
    Dc = tr.geom.Dc
    rng = np.random.RandomState(seed)
    return 10 ** rng.uniform(-4, -2, (B, Dc, Dc, Dc))


def _sweep_args(tr, box):
    tb = tr.tables
    return (torch.from_numpy(box), tb.sw, tb.path, tb.diag, tb.mask_m,
            tb.mask_p, DR, tr.geom.c, SIG)


# (16, 3): the small-radius box of test_cheb_small_radius_lls (the box
# side rounds past the radius); (8, 6): the mesh clips the box (c + r
# leaves it on the last shell); (16, 6): a full unclipped box
@pytest.mark.parametrize("N,R,seed", [(16, 3.0, 0), (8, 6.0, 1),
                                      (16, 6.0, 2)])
def test_sweep_ref_matches_jax(N, R, seed):
    jr, tr = _pair(N, R)
    box = _box(tr, seed)
    got = sweep.cheb_sweep_ref(*_sweep_args(tr, box)).numpy()
    k1 = np.asarray(jr._sweep_pallas(jr.tables, jnp.asarray(box),
                                     jnp.asarray(DR)))
    xla = np.asarray(jr._sweep(jr.tables, jnp.asarray(box),
                               jnp.asarray(DR)))
    assert got.shape == k1.shape == (2,) + (tr.geom.Dc,) * 3
    np.testing.assert_allclose(got, k1, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, xla, rtol=1e-12, atol=0)
    c = tr.geom.c
    np.testing.assert_array_equal(got[:, c, c, c], box[:, c, c, c] * 0.5 * DR)


def test_sweep_wrapper_dispatch_on_device():
    """A CPU tensor takes the plain version (and is not counted as a
    launch); a device that is neither CPU nor CUDA raises."""
    _, tr = _pair(8, 6.0)
    args = _sweep_args(tr, _box(tr, 3))
    sweep.reset_launches()
    out = sweep.cheb_sweep(*args)
    assert torch.equal(out, sweep.cheb_sweep_ref(*args))
    assert sum(sweep.launches.values()) == 0
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.cheb_sweep(args[0].to("meta"), *args[1:])


@pytest.mark.cuda
def test_sweep_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        tr = ChebRaytracer(16, 6.0, SIG, grey_bins(), batch_size=2,
                           dtype=dt, device="cuda")
        tb = tr.tables
        box = torch.from_numpy(_box(tr, 4)).to("cuda", dt)
        args = (box, tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p, DR,
                tr.geom.c, SIG)
        n0 = sweep.launches["cheb_sweep"]
        got = sweep.cheb_sweep(*args)
        assert sweep.launches["cheb_sweep"] == n0 + 1
        torch.testing.assert_close(got, sweep.cheb_sweep_ref(*args),
                                   rtol=rtol, atol=0)
