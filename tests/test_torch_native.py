"""The port's loader of the sequential C++ oracle (pyc2ray_torch.native_ext)
against the numpy builder, the Python oracle and the JAX package's loader of
the same C++ file."""

import os
import re
import shlex
import subprocess

import numpy as np
import pytest

from pyc2ray_tpu import native_ext as j_native
from pyc2ray_tpu.oracle import oracle_chemistry_global, oracle_raytrace

from pyc2ray_torch import native_ext
from pyc2ray_torch.ops import _build
from pyc2ray_torch.ops.geometry import _build_geometry_numpy, max_q_for

SIG, DR = 6.3e-18, 6.7e20
CHEM = (2.59e-13, -0.7, 1.3e-8 * 0.83 / 13.598 ** 2, 13.598 / 8.617e-05,
        7.1e-7)


def test_library_is_built_into_the_port_build_dir():
    """The library is compiled from native/c2ray_native.cpp into the port's
    build directory, named by a hash of the source and the flags, and never
    into native/."""
    lib = native_ext.load_native()
    assert lib is native_ext.load_native()
    so = native_ext._so_path()
    assert so.exists() and so.parent == _build._build_dir()
    assert native_ext.SOURCE.parent.name == "native"
    assert so.parent != native_ext.SOURCE.parent
    assert "-ffp-contract=off" in native_ext.CXX_FLAGS


def test_missing_source_raises(monkeypatch, tmp_path):
    """Without its source the loader raises; nothing falls back."""
    monkeypatch.setattr(native_ext, "_lib", None)
    monkeypatch.setattr(native_ext, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="missing"):
        native_ext.oracle_sweep_native(np.ones((4, 4, 4)),
                                       np.zeros((4, 4, 4)),
                                       np.zeros((1, 3)), np.ones(1), DR,
                                       SIG, 1e9, grey=True)


@pytest.mark.parametrize("N,R", [(8, 1e9), (12, 4.0), (13, 1e9), (16, 6.5)])
def test_native_geometry_equals_numpy_builder(N, R):
    """The C++ tables, unpadded, bit for bit against ops/geometry.py's
    numpy builder."""
    mq = max_q_for(R, N)
    g = _build_geometry_numpy(N, mq)
    C = g.num_cells
    offsets, nbr, sw, path, diag, dist2, shell_start, shell_size = \
        native_ext.build_geometry_tables_native(N, mq)
    assert offsets.shape == (3, C)
    for got, want in ((offsets, g.offsets[:, :C]), (nbr, g.nbr[:, :C]),
                      (sw, g.sw[:, :C]), (path, g.path[:C]),
                      (diag, g.diag[:C]), (dist2, g.dist2[:C]),
                      (shell_start, g.shell_start),
                      (shell_size, g.shell_size)):
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's loader pointed at a private build of
    native/c2ray_native.cpp.

    That loader runs ``make -C native`` when native/libc2ray_native.so is
    missing, and the Makefile links straight into that path: with several
    test processes, one may dlopen the file while another's linker is
    still writing it ("file too short"), and the loader then gives up for
    the life of the process. Here the library is compiled with the
    Makefile's own flags into a directory of this module's, under a
    temporary name and then renamed, and the loader's path and state are
    restored afterwards."""
    native_dir = native_ext.SOURCE.parent
    makefile = (native_dir / "Makefile").read_text()
    cxx = re.search(r"^CXX \?= (.+)$", makefile, re.M).group(1).strip()
    flags = re.search(r"^CXXFLAGS \?= (.+)$", makefile, re.M).group(1)
    out = tmp_path_factory.mktemp("native") / "libc2ray_native.so"
    tmp = out.with_suffix(".so.tmp")
    subprocess.run([cxx, *shlex.split(flags), "-shared", "-o", str(tmp),
                    str(native_ext.SOURCE)], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_SO_PATH", str(out))
        mp.setattr(j_native, "_LIB", None)
        mp.setattr(j_native, "_TRIED", False)
        yield j_native.load_native()


@pytest.mark.parametrize("grey", [True, False], ids=["grey", "tables"])
def test_native_sweep_equals_jax_loader_and_python_oracle(grey,
                                                          jax_native_lib):
    """oracle_sweep_native: bit for bit the JAX package's loader of the
    same C++ code, and the Python oracle at 1e-13 (grey) / 1e-11."""
    from test_torch_flat import TABLES
    N = 9
    rng = np.random.RandomState(3)
    nd = 10 ** rng.uniform(-4, -2, (N,) * 3)
    xh = rng.uniform(0.0, 0.9, (N,) * 3)
    src = np.array([[0, 8, 5], [3, 3, 3]])
    flux = np.array([1.0, 2.5])
    kw = dict(grey=True) if grey else dict(tables=TABLES)
    got = native_ext.oracle_sweep_native(nd, xh, src, flux, DR, SIG, 1e9,
                                         **kw)
    want = j_native.oracle_sweep_native(nd, xh, src, flux, DR, SIG, 1e9,
                                        **kw)
    assert jax_native_lib is not None and want is not None, \
        f"the JAX loader did not load {j_native._SO_PATH}"
    ref = oracle_raytrace(nd, xh, src, flux, DR, SIG, 1e9, **kw)
    for g, w, r in zip(got, want, ref):
        assert np.array_equal(g, w)
        np.testing.assert_allclose(g, r, rtol=1e-13 if grey else 1e-11)


def test_native_chemistry_equals_python_oracle():
    rng = np.random.RandomState(4)
    shape = (6, 6, 6)
    nd = 10 ** rng.uniform(-4, -2, shape)
    temp = 1e4 * np.ones(shape)
    xh = 1.2e-3 * np.ones(shape)
    phi = 10 ** rng.uniform(-16, -8, shape)
    dt = 3.15e13
    xi, xav, cf = native_ext.chemistry_global_native(
        dt, nd, temp, xh, xh.copy(), phi, *CHEM)
    xi_p, xav_p, cf_p = oracle_chemistry_global(
        dt, nd, temp, xh, xh.copy(), phi, *CHEM)
    np.testing.assert_allclose(xi, xi_p, rtol=1e-10)
    np.testing.assert_allclose(xav, xav_p, rtol=1e-10)
    assert cf == cf_p and xi.shape == shape


def test_mismatched_shapes_raise():
    """Sizes are checked before any pointer reaches the C code."""
    nd = np.ones((4, 4, 4))
    with pytest.raises(ValueError, match="oracle_sweep_native"):
        native_ext.oracle_sweep_native(nd, np.zeros((4, 4, 5)),
                                       np.zeros((1, 3)), np.ones(1), DR,
                                       SIG, 1e9, grey=True)
    with pytest.raises(ValueError, match="oracle_sweep_native"):
        native_ext.oracle_sweep_native(nd, np.zeros((4, 4, 4)),
                                       np.array([[0, 0, 4]]), np.ones(1), DR,
                                       SIG, 1e9, grey=True)
    with pytest.raises(ValueError, match="unequal"):
        native_ext.chemistry_global_native(3e13, nd, nd, nd, nd,
                                           np.ones(5), *CHEM)
