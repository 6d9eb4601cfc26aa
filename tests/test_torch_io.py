"""The port's C2Ray binary and checkpoint IO (pyc2ray_torch/io) against
the JAX package's readers and writers: files written by one read back bit
for bit by the other."""

import os

import numpy as np
import pytest

from pyc2ray_tpu import io as jio
from pyc2ray_torch import io as tio


@pytest.mark.parametrize("bits,order", [(64, "F"), (32, "F"), (64, "C"),
                                        (32, "C")])
def test_cbin_roundtrip_equals_jax(tmp_path, bits, order):
    data = np.random.RandomState(0).rand(8, 6, 5)
    ft, fj = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
    tio.save_cbin(ft, data, bits=bits, order=order)
    jio.save_cbin(fj, data, bits=bits, order=order)
    assert open(ft, "rb").read() == open(fj, "rb").read()
    got = tio.read_cbin(ft, bits=bits, order=order)
    want = jio.read_cbin(ft, bits=bits, order=order)
    assert got.dtype == want.dtype and got.shape == (8, 6, 5)
    np.testing.assert_array_equal(got, want)
    if bits == 64:
        np.testing.assert_array_equal(got, data)


def test_density_file_equals_jax(tmp_path):
    rho = np.random.RandomState(1).rand(6, 7, 5).astype(np.float32)
    fn = str(tmp_path / "8.000n_all.dat")
    with open(fn, "wb") as f:
        np.asarray(rho.shape, dtype=np.int32).tofile(f)
        rho.flatten(order="F").tofile(f)
    got, want = tio.DensityFile(fn), jio.DensityFile(fn)
    assert got.mesh == want.mesh == (6, 7, 5)
    assert got.cgs_density.dtype == np.float64
    np.testing.assert_array_equal(got.cgs_density, want.cgs_density)
    np.testing.assert_array_equal(got.cgs_density, rho)


@pytest.mark.parametrize("records", [True, False])
def test_xfrac_file_equals_jax(tmp_path, records):
    """Fortran unformatted records, and the headerless cbin layout."""
    x = np.random.RandomState(2).rand(4, 3, 5)
    fn = str(tmp_path / "xfrac.bin")
    with open(fn, "wb") as f:
        if records:
            np.asarray([12], dtype=np.int32).tofile(f)
        np.asarray(x.shape, dtype=np.int32).tofile(f)
        if records:
            np.asarray([12, x.size * 8], dtype=np.int32).tofile(f)
        x.flatten(order="F").tofile(f)
        if records:
            np.asarray([x.size * 8], dtype=np.int32).tofile(f)
    got, want = tio.XfracFile(fn), jio.XfracFile(fn)
    assert got.mesh == want.mesh == (4, 3, 5)
    np.testing.assert_array_equal(got.xi, want.xi)
    np.testing.assert_array_equal(got.xi, x)


def test_checkpoints_equal_jax(tmp_path):
    """Each package loads the other's checkpoints, the optional channels
    included, and finds the same latest one."""
    xh = np.random.RandomState(3).rand(4, 4, 4)
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    for save, d in ((tio.save_checkpoint, dt), (jio.save_checkpoint, dj)):
        save(d, 9.0, xh, xh * 2, xh * 3, 1e15, 9.0)
        save(d, 8.5, xh, xh * 2, xh * 3, 2e15, 8.5, temp=xh * 1e4,
             xhe1=xh * 0.1, xhe2=xh * 0.01)
    assert os.path.basename(tio.latest_checkpoint(dt)) \
        == os.path.basename(jio.latest_checkpoint(dj)) \
        == "checkpoint_8.500000.npz"
    assert tio.latest_checkpoint(str(tmp_path / "none")) is None
    for d in (dt, dj):
        for name in ("checkpoint_9.000000.npz", "checkpoint_8.500000.npz"):
            got = tio.load_checkpoint(os.path.join(d, name))
            want = jio.load_checkpoint(os.path.join(d, name))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    state = tio.load_checkpoint(os.path.join(dj, "checkpoint_8.500000.npz"))
    np.testing.assert_array_equal(state["temp"], xh * 1e4)
    assert float(state["time"]) == 2e15 and float(state["zred"]) == 8.5
