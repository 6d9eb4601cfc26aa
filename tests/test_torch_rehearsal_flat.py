"""The flat engine's kernels of csrc/flat_sweep.cu rehearsed on the host
(tests/rehearsal_host.py): the sweep, the rate pass, the ordered
accumulate and the trace loop, bit for bit (torch.equal) against the
engine's plain functions (ops/raytrace.py's Raytracer: _gather, _sweep,
_rates, _accumulate and the plain loop flat_trace_sweep_ref).

The sweep and the accumulate are held to the plain functions as they run.
The rate pass and the loop are held to them with the card's arithmetic
where the CPU's differs from it: glibc's log10 and exp (the functions the
host build of the kernels calls) in place of torch's vectorized ones, and a
division by a Python number as ATen's CUDA kernels compute it (a multiply
by the reciprocal, formed in double and rounded to the type; on the CPU
ATen divides)."""

import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from pyc2ray_torch.constants import ev2fr
from pyc2ray_torch.ops import flat_sweep as fs
from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.geometry import _corner_tables
from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
from pyc2ray_torch.radiation import BlackBodySource, make_tau_table
from rehearsal_host import DR, SIG, lib  # noqa: F401

DTYPES = [torch.float64, torch.float32]


def _rate_tables(numtau=200):
    tau, dlogtau = make_tau_table(-20.0, 4.0, numtau)
    bb = BlackBodySource(5e4, False, ev2fr * 13.598, 2.8)
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    thin, thick = bb.make_photo_table(tau, fmin, fmax, 1e48)
    hthin, hthick = bb.make_heat_table(tau, fmin, fmax, 1e48)
    return thin, thick, -20.0, dlogtau, hthin, hthick


TABLES = _rate_tables()

# (N, R, the positions of the B sources of each of two batches): R inside
# the mesh (a clipped octahedron) and beyond it (the whole box, as the
# golden's); every batch has two sources at one cell and octahedra that
# overlap
CASES = {
    "N16_R4": (16, 4.0, [[[3, 3, 3], [3, 3, 3], [5, 2, 4], [15, 0, 15]],
                         [[8, 8, 8], [9, 8, 6], [0, 0, 0], [8, 8, 8]]]),
    "N16_box": (16, 1e9, [[[1, 2, 3], [1, 2, 3], [9, 12, 0]],
                          [[4, 4, 4], [12, 1, 7], [4, 4, 4]]]),
    "N24_R7": (24, 7.0, [[[0, 0, 0], [23, 23, 23], [2, 1, 22]],
                         [[12, 12, 12], [12, 12, 12], [15, 10, 11]]]),
    "N24_box": (24, 1e9, [[[5, 6, 7], [5, 6, 7], [17, 3, 20]],
                          [[23, 0, 11], [0, 23, 11], [11, 11, 11]]]),
}

# (cluster, threads a block) of the sweep: every cluster size flat_plan
# may choose
PLANS = [(1, 37), (2, 16), (4, 9), (8, 5), (16, 3)]


def _engine(N, R, B, dt, mode):
    cfg = RaytraceConfig(N=N, R_max_LLS=R, sig=SIG, batch_size=B, dtype=dt,
                         grey_analytic=mode == "grey",
                         do_heating=mode == "heat")
    return Raytracer(cfg, *TABLES, device="cpu")


def _case(case, dt, mode, seed=3):
    """The engine, the density and ionized fraction grids (N^3,), the
    positions (nb, B, 3) and the fluxes (nb, B): densities over ten decades
    (optically thin and thick cells), a zero-density cell beside the first
    source, the first batch's last flux 0."""
    N, R, pos = CASES[case]
    pos = torch.tensor(pos, dtype=torch.int64)
    nb, B = pos.shape[:2]
    rt = _engine(N, R, B, dt, mode)
    rng = np.random.RandomState(seed + N)
    nd = 10 ** rng.uniform(-12, -2, N ** 3)
    xh = rng.uniform(0.0, 0.9, N ** 3)
    x, y, z = pos[0, 0].tolist()
    nd[(((x + 1) % N) * N + y) * N + z] = 0.0
    flux = rng.uniform(0.5, 2.0, (nb, B))
    flux[0, -1] = 0.0
    return (rt, torch.from_numpy(nd).to(dt), torch.from_numpy(xh).to(dt),
            pos, torch.from_numpy(flux).to(dt))


def _libm(name, dt):
    """glibc's ``name`` (float64) or ``name``f (float32), elementwise."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    if dt == torch.float32:
        f = getattr(libm, name + "f")
        f.argtypes, f.restype = [ctypes.c_float], ctypes.c_float
    else:
        f = getattr(libm, name)
        f.argtypes, f.restype = [ctypes.c_double], ctypes.c_double
    return lambda x: torch.tensor([f(v) for v in x.reshape(-1).tolist()],
                                  dtype=x.dtype).reshape(x.shape)


def _card_arithmetic(monkeypatch, dt):
    """torch.log10 and torch.exp as glibc's, and tensor / Python number as
    ATen's CUDA kernels divide by a CPU scalar: times its reciprocal, formed
    in double and rounded to the tensor's type."""
    monkeypatch.setattr(torch, "log10", _libm("log10", dt))
    monkeypatch.setattr(torch, "exp", _libm("exp", dt))
    real_div = torch.Tensor.__truediv__

    def card_div(a, b):
        if isinstance(b, (int, float)) and not isinstance(b, bool):
            return a * (1.0 / float(b))
        return real_div(a, b)
    monkeypatch.setattr(torch.Tensor, "__truediv__", card_div)


def _host(lib, rt, kind, io, pos, cluster=4, threads=9, reverse=0):
    """Kernel ``kind`` of run_flat (0 sweep, 1 rates, 2 accumulate, 3 the
    loop) on the host: ``io`` the dict of its tensors (rehearsal.cpp's
    order; absent ones null), ``pos`` (B, 3) or, for the loop, (nb, B, 3),
    staged as the wrappers stage them."""
    kt = rt.kernel_tables()
    order = ("nhi", "pos", "flux", "sdr3", "cd", "phi", "heat", "phi_grid",
             "heat_grid")
    io = dict(io, pos=fs.stage_positions(pos, rt.config.N, "cpu"))
    ptrs = (ctypes.c_void_p * len(order))(
        *[None if io.get(k) is None else io[k].data_ptr() for k in order])
    nb = pos.shape[0] if kind == 3 else 1
    B = pos.shape[-2]
    fn = lib.rehearse_flat_f32 if rt.config.dtype == torch.float32 else \
        lib.rehearse_flat_f64
    fn(kind, kt.tabs, kt.dims, fs._vals(kt, DR), ptrs, nb, B, cluster,
       threads, reverse)


def _nan(rt, B):
    return torch.full((B, rt.geom_np.num_cells), float("nan"),
                      dtype=rt.config.dtype)


def _dr(rt):
    return torch.tensor(DR, dtype=rt.config.dtype)


def test_plans_cover_every_cluster_size():
    assert sorted(c for c, _ in PLANS) == sorted(sweep.CLUSTERS)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_flat_sweep_on_the_host_matches_plain(lib, case, dt):
    """flat_sweep_kernel at every cluster size (its clusters in either
    order) bit for bit against the plain gather and sweep: every cell of
    every source's octahedron written (the outputs start as NaN)."""
    rt, nd, xh, pos, _ = _case(case, dt, "tables")
    nhi = nd * (1.0 - xh)
    want = rt._sweep(rt._gather(nhi, pos[0])[1], _dr(rt))
    assert bool(torch.isfinite(want).all())
    for k, (cluster, threads) in enumerate(PLANS):
        cd = _nan(rt, pos.shape[1])
        _host(lib, rt, 0, dict(nhi=nhi, cd=cd), pos[0], cluster, threads,
              reverse=k % 2)
        assert torch.equal(cd, want), (cluster, threads)


@pytest.mark.parametrize("mode", ["grey", "tables", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["N16_R4", "N24_box"])
def test_flat_rates_on_the_host_matches_plain(lib, monkeypatch, case, dt,
                                              mode):
    """flat_rates_kernel (its rows and blocks in either order) bit for bit
    against the plain rate pass on the plain sweep's column densities, with
    a cell past MAX_COLDENSH, the zero-density cell and a zero flux: Gamma
    and with ``heat`` the heating rate per HI atom; thin and thick cells,
    rated and (R inside the mesh) unrated ones."""
    rt, nd, xh, pos, flux = _case(case, dt, mode)
    nhi = nd * (1.0 - xh)
    lin, nhi_octa = rt._gather(nhi, pos[0])
    cd = rt._sweep(nhi_octa, _dr(rt))
    cd[1, 5] = 1e31
    _card_arithmetic(monkeypatch, dt)
    sdr3 = rt._s_over_dr3(_dr(rt))
    want = rt._rates(cd, nhi_octa, flux[0], _dr(rt))
    monkeypatch.undo()
    dtau = nhi_octa * rt.tables.path * _dr(rt) * SIG
    assert bool((dtau > 1e-7).any()) and bool((dtau < 1e-7).any())
    assert (want[1] is not None) == (mode == "heat")
    for reverse in (0, 1):
        phi, heat = _nan(rt, pos.shape[1]), _nan(rt, pos.shape[1])
        _host(lib, rt, 1, dict(nhi=nhi, flux=flux[0], sdr3=sdr3, cd=cd,
                               phi=phi, heat=heat if mode == "heat" else None),
              pos[0], threads=64, reverse=reverse)
        assert torch.equal(phi, want[0]), reverse
        if mode == "heat":
            assert torch.equal(heat, want[1]), reverse
    assert float(want[0][1, 5]) == 0.0 and float(want[0].max()) > 0.0
    assert not bool(want[0][-1].any())                  # zero flux
    zero = nhi_octa == 0.0
    assert bool(zero.any()) and not bool(want[0][zero].any())


@pytest.mark.parametrize("heat", [False, True])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_flat_accumulate_on_the_host_matches_plain(lib, case, dt, heat):
    """flat_accumulate_kernel (its rows and blocks in either order) bit for
    bit against the plain ordered accumulate (index_add_ source after
    source) of rates over twelve decades into grids that already hold
    values, where a grid cell takes the rates of several sources (two of
    them at one cell)."""
    rt, _, _, pos, _ = _case(case, dt, "heat" if heat else "tables")
    N, B = rt.config.N, pos.shape[1]
    rng = np.random.RandomState(N + B)
    C = rt.geom_np.num_cells

    def rand(*shape, lo=-22.0, hi=-10.0):
        return torch.from_numpy(10 ** rng.uniform(lo, hi, shape)).to(dt)
    vals = [rand(B, C) for _ in range(2)]
    start = [rand(N ** 3, lo=-14.0, hi=-11.0) for _ in range(2)]
    lin = rt._lin_idx(pos[0])
    want = [s.clone() for s in start]
    for g, v in zip(want[:1 + heat], vals):
        rt._accumulate(g, lin, v)
    cover = torch.zeros(N ** 3, dtype=torch.int64)
    for b in range(B):
        cover[lin[b]] += 1
    assert int(cover.max()) >= 2
    for reverse in (0, 1):
        got = [s.clone() for s in start]
        _host(lib, rt, 2, dict(phi=vals[0], heat=vals[1] if heat else None,
                               phi_grid=got[0],
                               heat_grid=got[1] if heat else None),
              pos[0], threads=64, reverse=reverse)
        assert torch.equal(got[0], want[0]), reverse
        assert torch.equal(got[1], want[1]), reverse


@pytest.mark.parametrize("mode", ["grey", "tables", "heat"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_flat_loop_on_the_host_matches_plain(lib, monkeypatch, case, dt,
                                             mode):
    """The loop's two batches (sweep, rates, accumulate each, on the
    scratch of one batch) bit for bit against flat_trace_sweep_ref: Gamma
    and with ``heat`` the heating rate, under a cluster size per case."""
    rt, nd, xh, pos, flux = _case(case, dt, mode)
    _card_arithmetic(monkeypatch, dt)
    want = rt.flat_trace_sweep_ref(nd, xh, pos, flux, DR)
    sdr3 = rt._s_over_dr3(_dr(rt))
    monkeypatch.undo()
    nhi = nd * (1.0 - xh)
    B = pos.shape[1]
    grids = [torch.zeros_like(nhi) for _ in range(2)]
    io = dict(nhi=nhi, flux=flux, sdr3=sdr3, cd=_nan(rt, B),
              phi=_nan(rt, B), phi_grid=grids[0])
    if mode == "heat":
        io.update(heat=_nan(rt, B), heat_grid=grids[1])
    cluster, threads = PLANS[list(CASES).index(case) + 1]
    _host(lib, rt, 3, io, pos, cluster, threads)
    assert float(want[0].max()) > 0.0
    assert torch.equal(grids[0], want[0])
    if mode == "heat":
        assert torch.equal(grids[1], want[1])
    else:
        assert want[1] is None and not bool(grids[1].any())


def test_single_cell_shells_have_one_corner_weight():
    """The premise of the sweep's corner order (csrc/flat_sweep.cu): the
    only shell of one cell, the far corner (-n, -n, -n) of an even mesh's
    whole box, has a single corner of nonzero weight, for every even mesh
    up to 4096, so its sums have the same bits in any order."""
    n = np.arange(1, 2049, dtype=np.int64)
    _, s, _, _ = _corner_tables(-n, -n, -n)
    assert np.all((s != 0.0).sum(axis=0) == 1)
