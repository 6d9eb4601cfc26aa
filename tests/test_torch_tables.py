"""Host-side inputs of the PyTorch port: spectral bins, compressed bins,
the cube-shell geometry, the rates-subbox tables and the fused modes'
rates tables are bit-equal to the JAX package's; state_from_jax carries
the JAX engine's state over."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyc2ray_tpu.constants import ev2fr
from pyc2ray_tpu.ops.cheb_geometry import build_cheb_geometry as j_geometry
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.geometry import max_q_for as j_max_q
from pyc2ray_tpu.ops.pallas_sweep import pack_rates_tables as j_rates_tables
from pyc2ray_tpu.ops.raytrace_box import grey_bins
from pyc2ray_tpu.ops.raytrace_cheb import ChebRaytracer as JRaytracer
from pyc2ray_tpu.radiation import BlackBodySource as JBlackBody
from pyc2ray_tpu.radiation import make_tau_table as j_tau
from pyc2ray_tpu.radiation.bins_compress import compress_bins as j_compress
from pyc2ray_tpu.radiation.spectral_bins import make_spectral_bins as j_bins

from pyc2ray_torch.convert import state_from_jax
from pyc2ray_torch.ops.cheb_geometry import (box_dims, build_cheb_geometry,
                                             pack_rates_tables)
from pyc2ray_torch.ops.geometry import max_q_for
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.radiation import BlackBodySource, make_tau_table
from pyc2ray_torch.radiation.bins_compress import compress_bins
from pyc2ray_torch.radiation.spectral_bins import make_spectral_bins

SIG = 6.30e-18
FMIN, FMAX = ev2fr * 13.598, 10 * ev2fr * 54.416


def _bins_pair():
    jb = j_bins(JBlackBody(5e4, False, FMIN, 2.8), FMIN, FMAX,
                panels=8, nodes=8)
    tb = make_spectral_bins(BlackBodySource(5e4, False, FMIN, 2.8), FMIN,
                            FMAX, panels=8, nodes=8)
    return jb, tb


def _assert_bins_equal(a, b):
    assert a.num_bins == b.num_bins
    for f in ("s", "w_photo", "w_heat"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_spectral_bins_bit_equal():
    jb, tb = _bins_pair()
    _assert_bins_equal(jb, tb)
    np.testing.assert_array_equal(j_tau(-20.0, 4.0, 200)[0],
                                  make_tau_table(-20.0, 4.0, 200)[0])


def test_compressed_bins_bit_equal():
    jb, tb = _bins_pair()
    _assert_bins_equal(j_compress(jb, target_rel=1e-2, cache=False),
                       compress_bins(tb, target_rel=1e-2, cache=False))


@pytest.mark.parametrize("N,R", [(16, 3.0), (8, 6.0), (12, 1e9), (7, 2.5)])
def test_cheb_geometry_bit_equal(N, R):
    assert max_q_for(R, N) == j_max_q(R, N)
    r_cube = int(np.ceil(min(R, N)))
    jg = j_geometry(N, j_max_q(R, N), r_cube=r_cube)
    tg = build_cheb_geometry(N, max_q_for(R, N), r_cube=r_cube)
    assert tg._fields == jg._fields
    for f in tg._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)


# (16, 8.0): the mesh clips the box; (12, 1e9): the whole mesh
@pytest.mark.parametrize("N,R", [(16, 3.0), (16, 8.0), (12, 1e9)])
def test_rates_tables_bit_equal(N, R):
    r_cube = int(np.ceil(min(R, N)))
    jg = j_geometry(N, j_max_q(R, N), r_cube=r_cube)
    tg = build_cheb_geometry(N, max_q_for(R, N), r_cube=r_cube)
    assert box_dims(N, max_q_for(R, N), r_cube)[2:] == (jg.c, jg.Dc,
                                                       jg.r_max)
    for dt in (np.float64, np.float32):
        want = j_rates_tables(jg, R * R, dt)
        got = pack_rates_tables(tg, R * R, dt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,R", [(16, 3.0), (64, 8.0)])
def test_engine_tables_bit_equal(N, R):
    """The port's device tables (incl. the rates subbox rt_sub and the
    fused modes' rt_tab) equal the JAX engine's, in float64 and in
    float32."""
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        jr = JRaytracer(N, R, SIG, grey_bins(), batch_size=2, dtype=jdt)
        tr = ChebRaytracer(N, R, SIG, grey_bins(), batch_size=2, dtype=tdt,
                           device="cpu")
        assert (tr._rb0, tr._rb1, tr.Ds) == (jr._rb0, jr._rb1, jr.Ds)
        for f in tr.tables._fields:
            np.testing.assert_array_equal(
                getattr(tr.tables, f).numpy(),
                np.asarray(getattr(jr.tables, f)), err_msg=f)


def test_state_from_jax_round_trip():
    jb, _ = _bins_pair()
    jr = JRaytracer(16, 3.0, SIG, jb, batch_size=2, dtype=jnp.float64)
    chem = JChem(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598**2,
                 temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
    tables, bins, tchem = state_from_jax(
        {k: np.asarray(v) for k, v in jr.tables._asdict().items()},
        {"s": jb.s, "w_photo": jb.w_photo, "w_heat": jb.w_heat},
        chem._asdict())
    _assert_bins_equal(bins, jb)
    assert tuple(tchem) == tuple(chem)
    native = ChebRaytracer(16, 3.0, SIG, bins, batch_size=2,
                           dtype=torch.float64, device="cpu").tables
    for f in native._fields:
        got = getattr(tables, f)
        assert got.dtype == getattr(native, f).dtype, f
        assert torch.equal(got, getattr(native, f)), f
    moved = tables.to("cpu", torch.float32)
    assert moved.sw.dtype == torch.float32 and moved.mask_p.dtype == torch.bool
