"""The port's sequential NumPy oracle (pyc2ray_torch/oracle) bit-equal to
the JAX package's on the same inputs: the raytrace with the grey analytic
rates and with the reference's tables, one cell's rate, doric and the
global chemistry pass."""

import numpy as np
import pytest

from pyc2ray_tpu import oracle as j_oracle

from pyc2ray_torch import oracle
from pyc2ray_torch.constants import ev2fr
from pyc2ray_torch.radiation import BlackBodySource, make_tau_table

SIG = 6.30e-18
DR = 6.7e20
CHEM = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598**2,
            temph0=13.598 / 8.617e-05)


def _tables():
    tau, dlogtau = make_tau_table(-20.0, 4.0, 200)
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    bb = BlackBodySource(5e4, False, fmin, 2.8)
    thin, thick = bb.make_photo_table(tau, fmin, fmax, 1e48)
    h_thin, h_thick = bb.make_heat_table(tau, fmin, fmax, 1e48)
    return thin, thick, h_thin, h_thick, -20.0, dlogtau


def _equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spectrum,N,R", [("grey", 6, 1e9), ("grey", 7, 2.5),
                                          ("tables", 6, 1e9)])
def test_oracle_raytrace_equals_jax(spectrum, N, R):
    rng = np.random.RandomState(5)
    nd = 10 ** rng.uniform(-4, -2, (N,) * 3)
    xh = rng.uniform(0.0, 0.9, (N,) * 3)
    src = np.array([[0, N - 1, 2], [N // 2, 1, N // 2]])
    flux = np.array([2.0, 0.5])
    kw = (dict(grey=True) if spectrum == "grey"
          else dict(tables=_tables()))
    got = oracle.oracle_raytrace(nd, xh, src, flux, DR, SIG, R, **kw)
    want = j_oracle.oracle_raytrace(nd, xh, src, flux, DR, SIG, R, **kw)
    assert float(np.max(got[0])) > 0.0
    _equal(got, want)


def test_oracle_rates_and_chemistry_equal_jax():
    """oracle_photoion_rate (grey, thin and thick), oracle_doric and
    oracle_chemistry_global on a random field."""
    tables = _tables()
    for cin, cout in ((1e17, 1e17 + 1e15), (1e17, 5e18), (3e18, 9e19)):
        for kw in (dict(grey=True), dict(tables=tables)):
            _equal(oracle.oracle_photoion_rate(2.0, cin, cout, 1e62, SIG,
                                               **kw),
                   j_oracle.oracle_photoion_rate(2.0, cin, cout, 1e62, SIG,
                                                 **kw))
    rng = np.random.RandomState(9)
    shape = (6, 6, 6)
    nd = 10 ** rng.uniform(-4, -2, shape)
    temp = rng.uniform(1e3, 3e4, shape)
    xh = rng.uniform(1e-4, 0.5, shape)
    phi = 10 ** rng.uniform(-16, -11, shape)
    _equal(oracle.oracle_doric(xh, 1e13, temp, nd, phi, **CHEM),
           j_oracle.oracle_doric(xh, 1e13, temp, nd, phi, **CHEM))
    got = oracle.oracle_chemistry_global(1e13, nd, temp, xh, xh, phi,
                                         abu_c=7.1e-7, **CHEM)
    want = j_oracle.oracle_chemistry_global(1e13, nd, temp, xh, xh, phi,
                                            abu_c=7.1e-7, **CHEM)
    _equal(got[:2], want[:2])
    assert got[2] == want[2]
