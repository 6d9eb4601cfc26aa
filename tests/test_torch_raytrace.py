"""The port's ChebRaytracer.trace against the JAX engine's (Pallas sweep
in interpret mode, per-source scan accumulate), in float64. The port
accumulates with slice adds and the JAX engine with dynamic updates, so
the match is to rounding, not bitwise."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.raytrace_box import grey_bins
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer
from pyc2ray_tpu.radiation import BlackBodySource
from pyc2ray_tpu.radiation.bins_compress import compress_bins
from pyc2ray_tpu.radiation.spectral_bins import make_spectral_bins

from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer

SIG = 6.30e-18
DR = 6.7e20


def _bb_bins():
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    dense = make_spectral_bins(BlackBodySource(5e4, False, fmin, 2.8),
                               fmin, fmax, panels=8, nodes=8)
    return compress_bins(dense, target_rel=1e-2, cache=False)


def _inputs(N, seed, ns=3):
    rng = np.random.RandomState(seed)
    ndens = 10 ** rng.uniform(-4, -2, (N, N, N))
    xh = rng.uniform(0.0, 0.9, (N, N, N))
    src = rng.randint(0, N, (ns, 3))
    flux = rng.uniform(0.5, 2.0, ns)
    return ndens, xh, src, flux


@pytest.mark.parametrize("spectrum,N,R", [("grey", 16, 6.0),
                                          ("blackbody", 12, 4.0)])
def test_trace_matches_jax(spectrum, N, R):
    bins = grey_bins() if spectrum == "grey" else _bb_bins()
    ndens, xh, src, flux = _inputs(N, seed=5)
    jr = JRaytracer(N, R, SIG, bins, batch_size=2, dtype=jnp.float64,
                    use_pallas=True, accumulate="scan")
    tr = ChebRaytracer(N, R, SIG, bins, batch_size=2, dtype=torch.float64,
                       device="cpu")
    want = np.asarray(jr.trace(ndens, xh, src, flux, DR))
    got = tr.trace(ndens, xh, src, flux, DR)
    assert got.shape == (N, N, N) and got.dtype == torch.float64
    assert np.all(want >= 0) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=0)


def test_trace_batches_flat_io_and_padding_sources():
    """trace_batches on prepared batches (the last one padded with
    zero-flux sources) equals trace; the heating slot is None."""
    N = 12
    ndens, xh, src, flux = _inputs(N, seed=6, ns=3)
    tr = ChebRaytracer(N, 4.0, SIG, grey_bins(), batch_size=2,
                       dtype=torch.float64, device="cpu")
    pos_b, flux_b = tr.prepare_sources(src, flux)
    assert tuple(pos_b.shape) == (2, 2, 3) and float(flux_b[1, 1]) == 0.0
    phi, heat = tr.trace_batches(torch.from_numpy(ndens).reshape(-1),
                                 torch.from_numpy(xh).reshape(-1),
                                 pos_b, flux_b, DR)
    assert heat is None and phi.shape == (N ** 3,)
    torch.testing.assert_close(phi.reshape(N, N, N),
                               tr.trace(ndens, xh, src, flux, DR),
                               rtol=0, atol=0)
