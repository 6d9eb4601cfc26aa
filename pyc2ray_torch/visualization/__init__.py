"""Plot helpers and z-slice browsers (matplotlib, imported only when
they draw)."""

from .common import xfrac_plot, resid_plot
from .tomography import (zTomography, zTomography_rates, zTomography_xfrac,
                         zTomography_3panels)

__all__ = ["xfrac_plot", "resid_plot", "zTomography", "zTomography_rates",
           "zTomography_xfrac", "zTomography_3panels"]
