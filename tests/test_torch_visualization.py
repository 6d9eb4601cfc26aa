"""The port's plot helpers (pyc2ray_torch/visualization) against the JAX
package's with matplotlib's Agg backend: the image arrays of xfrac_plot,
resid_plot and the z-slice browsers after key presses are equal; and
importing the package leaves matplotlib out."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyc2ray_tpu import visualization as j_vis

from pyc2ray_torch import visualization as t_vis

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("up", "right", "right", "down", "left", "x", "up", "up", "up")


@pytest.fixture
def plt():
    """pyplot on the Agg backend (imported here: the card's machine, which
    collects this file for its cuda-marked tests, has no matplotlib)."""
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as pyplot
    yield pyplot
    pyplot.close("all")


def _press(fig, key):
    """A key press through the figure's canvas callbacks."""
    from matplotlib.backend_bases import KeyEvent
    event = KeyEvent("key_press_event", fig.canvas, key)
    fig.canvas.callbacks.process(event.name, event)


def _fields():
    rng = np.random.RandomState(4)
    a = 10 ** rng.uniform(-6, 0, (12, 12, 12))
    return a, a * (1 + 1e-3 * rng.standard_normal(a.shape))


def test_plot_helpers_equal_jax(plt):
    a, b = _fields()
    for fn, args in ((t_vis.xfrac_plot, (a[:, :, 3],)),
                     (t_vis.resid_plot, (a[:, :, 3], b[:, :, 3]))):
        jfn = getattr(j_vis, fn.__name__)
        (_, ax), (_, jax_) = plt.subplots(), plt.subplots()
        got = fn(*(torch.from_numpy(x) for x in args), ax)
        want = jfn(*args, jax_)
        np.testing.assert_array_equal(got.get_array(), want.get_array())
        assert got.get_clim() == want.get_clim()
        assert ax.get_title() == jax_.get_title()


@pytest.mark.parametrize("name", ["zTomography", "zTomography_xfrac",
                                  "zTomography_rates", "zTomography_3panels"])
def test_tomography_browsers_equal_jax(plt, name):
    """The same slices after every key press of a sequence that walks up,
    down and past both ends (and an unbound key)."""
    a, b = _fields()
    args = (a, b) if name == "zTomography_3panels" else (a,)
    got = getattr(t_vis, name)(*(torch.from_numpy(x) for x in args), incr=4)
    want = getattr(j_vis, name)(*args, incr=4)
    for key in KEYS:
        _press(got.fig, key)
        _press(want.fig, key)
        assert got.zi == want.zi
        images = (zip(got.ims, want.ims) if hasattr(want, "ims")
                  else [(got.im, want.im)])
        for g, w in images:
            np.testing.assert_array_equal(g.get_array(), w.get_array())
        if hasattr(want, "ax"):
            assert got.ax.get_title() == want.ax.get_title()
    assert got.zi == 11


def test_import_leaves_matplotlib_out():
    """Importing the package, its plot helpers and its oracle loads no
    matplotlib (the card's machine has none)."""
    code = ("import sys\n"
            "import pyc2ray_torch, pyc2ray_torch.visualization\n"
            "import pyc2ray_torch.oracle\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('matplotlib', 'jax',\n"
            "                                    'pyc2ray_tpu')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
