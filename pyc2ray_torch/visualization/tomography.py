"""Interactive z-slice browsers (equivalent of reference
visualization/tomography.py:14-175): matplotlib figures with arrow-key
navigation through the z planes of 3D grids.

Twin of pyc2ray_tpu/visualization/tomography.py. matplotlib is imported
when a browser is made, never with the package (the card's machine has
none); a tensor argument is moved to the host as a NumPy array."""

import numpy as np

from .common import to_host

__all__ = ["zTomography", "zTomography_rates", "zTomography_xfrac",
           "zTomography_3panels"]


class _TomographyBase:
    """Arrow-key navigable slice viewer."""

    def __init__(self, data, zi=None, incr=10, log=False, cmap="jet"):
        import matplotlib.pyplot as plt
        self.data = to_host(data)
        self.N = self.data.shape[2]
        self.zi = self.N // 2 if zi is None else zi
        self.incr = incr
        self.log = log
        self.fig, self.ax = plt.subplots()
        self.im = self.ax.imshow(self._slice(), origin="lower", cmap=cmap)
        self.fig.colorbar(self.im, ax=self.ax)
        self._update_title()
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)

    def _slice(self):
        s = self.data[:, :, self.zi]
        return np.log10(np.maximum(s, 1e-30)) if self.log else s

    def _update_title(self):
        self.ax.set_title(f"z-slice {self.zi}/{self.N - 1}")

    def _on_key(self, event):
        if event.key == "up":
            self.zi = min(self.zi + self.incr, self.N - 1)
        elif event.key == "down":
            self.zi = max(self.zi - self.incr, 0)
        elif event.key == "right":
            self.zi = min(self.zi + 1, self.N - 1)
        elif event.key == "left":
            self.zi = max(self.zi - 1, 0)
        else:
            return
        self.im.set_data(self._slice())
        self._update_title()
        self.fig.canvas.draw_idle()


class zTomography(_TomographyBase):
    """Generic slice browser."""


class zTomography_xfrac(_TomographyBase):
    def __init__(self, xfrac, zi=None, incr=10, cmap="jet"):
        super().__init__(xfrac, zi, incr, log=True, cmap=cmap)


class zTomography_rates(_TomographyBase):
    def __init__(self, rates, zi=None, incr=10, cmap="inferno"):
        super().__init__(rates, zi, incr, log=True, cmap=cmap)


class zTomography_3panels:
    """Three-panel comparison browser (a, b, relative residual)."""

    def __init__(self, data_a, data_b, zi=None, incr=10, log=True):
        import matplotlib.pyplot as plt
        self.a = to_host(data_a)
        self.b = to_host(data_b)
        self.N = self.a.shape[2]
        self.zi = self.N // 2 if zi is None else zi
        self.incr = incr
        self.log = log
        self.fig, self.axes = plt.subplots(1, 3, figsize=(14, 4))
        self.ims = [
            self.axes[0].imshow(self._sl(self.a), origin="lower"),
            self.axes[1].imshow(self._sl(self.b), origin="lower"),
            self.axes[2].imshow(self._resid(), origin="lower", cmap="bwr"),
        ]
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)

    def _sl(self, d):
        s = d[:, :, self.zi]
        return np.log10(np.maximum(s, 1e-30)) if self.log else s

    def _resid(self):
        a, b = self.a[:, :, self.zi], self.b[:, :, self.zi]
        return (a - b) / np.maximum(np.abs(b), 1e-30)

    def _on_key(self, event):
        if event.key in ("up", "right"):
            self.zi = min(self.zi + (self.incr if event.key == "up" else 1),
                          self.N - 1)
        elif event.key in ("down", "left"):
            self.zi = max(self.zi - (self.incr if event.key == "down" else 1),
                          0)
        else:
            return
        self.ims[0].set_data(self._sl(self.a))
        self.ims[1].set_data(self._sl(self.b))
        self.ims[2].set_data(self._resid())
        self.fig.canvas.draw_idle()
