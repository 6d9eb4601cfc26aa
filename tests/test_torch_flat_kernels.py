"""The flat engine's steps and their kernels: Raytracer's sweep_batch,
rates_batch, accumulate_batch and trace_batches on the CPU (the plain
functions; a device other than the CPU or the card raises, nothing falls
back), the bindings of ops/flat_sweep.py (they refuse CPU tensors), the
kernels' tables, and, ``cuda``, every kernel and the loop on the card bit
for bit against their plain versions. Imports nothing of JAX."""

import numpy as np
import pytest
import torch

from pyc2ray_torch.constants import ev2fr
from pyc2ray_torch.ops import flat_sweep as fs
from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
from pyc2ray_torch.radiation import BlackBodySource, make_tau_table

SIG = 6.30e-18
DR = 6.7e20
MODES = ["grey", "tables", "heat"]


def _rate_tables(numtau=200):
    tau, dlogtau = make_tau_table(-20.0, 4.0, numtau)
    bb = BlackBodySource(5e4, False, ev2fr * 13.598, 2.8)
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    thin, thick = bb.make_photo_table(tau, fmin, fmax, 1e48)
    hthin, hthick = bb.make_heat_table(tau, fmin, fmax, 1e48)
    return thin, thick, -20.0, dlogtau, hthin, hthick


TABLES = _rate_tables()


def _setup(N, R, B, dt, mode, device, ns=None, seed=5):
    """An engine on ``device``, densities over ten decades with a zero
    cell, the batches of ``ns`` sources (two at one cell; the last flux 0)
    and their grids."""
    cfg = RaytraceConfig(N=N, R_max_LLS=R, sig=SIG, batch_size=B, dtype=dt,
                         grey_analytic=mode == "grey",
                         do_heating=mode == "heat")
    rt = Raytracer(cfg, *TABLES, device=device)
    rng = np.random.RandomState(seed + N)
    ns = ns or 2 * B
    pos = rng.randint(0, N, size=(ns, 3))
    pos[1] = pos[0]
    flux = rng.uniform(0.5, 2.0, ns)
    flux[-1] = 0.0
    nd = 10 ** rng.uniform(-12, -2, N ** 3)
    nd[0] = 0.0
    xh = rng.uniform(0.0, 0.9, N ** 3)
    pos_b, flux_b = rt.prepare_sources(pos, flux)
    return (rt, torch.from_numpy(nd).to(device, dt),
            torch.from_numpy(xh).to(device, dt), pos_b, flux_b)


@pytest.mark.parametrize("mode", MODES)
def test_wrappers_on_cpu_are_the_plain_functions(mode):
    """On CPU tensors each step is its plain function and the trace is
    flat_trace_sweep_ref, bit for bit; nothing is counted as a launch."""
    rt, nd, xh, pos_b, flux_b = _setup(12, 5.0, 3, torch.float64, mode,
                                       "cpu")
    sweep.reset_launches()
    nhi = nd * (1.0 - xh)
    dr_t = torch.tensor(DR, dtype=torch.float64)
    lin, nhi_octa = rt._gather(nhi, pos_b[0])
    cd = rt._sweep(nhi_octa, dr_t)
    assert torch.equal(rt.sweep_batch(nhi, pos_b[0], DR), cd)
    want = rt._rates(cd, nhi_octa, flux_b[0], dr_t)
    got = rt.rates_batch(cd, nhi, pos_b[0], flux_b[0], DR)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (mode != "heat")
    if got[1] is not None:
        assert torch.equal(got[1], want[1])
    grids = [torch.rand(12 ** 3, dtype=torch.float64) for _ in range(2)]
    ref = [g.clone() for g in grids]
    heat = want[1]
    rt.accumulate_batch(grids[0], grids[1] if heat is not None else None,
                        pos_b[0], want[0], heat)
    rt._accumulate(ref[0], lin, want[0])
    if heat is not None:
        rt._accumulate(ref[1], lin, heat)
    assert all(torch.equal(g, r) for g, r in zip(grids, ref))
    loop = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    plain = rt.flat_trace_sweep_ref(nd, xh, pos_b, flux_b, DR)
    assert torch.equal(loop[0], plain[0])
    assert not any(v for k, v in sweep.launches.items() if "flat" in k)


def test_other_devices_raise():
    """A tensor neither on the CPU nor on the card reaches the kernel path,
    which refuses it: no fallback to the plain loop. The bindings refuse
    CPU tensors too."""
    rt, nd, xh, pos_b, flux_b = _setup(8, 3.0, 2, torch.float64, "tables",
                                       "cpu")
    meta = [t.to("meta") for t in (nd, xh, pos_b, flux_b)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        rt.trace_batches(*meta, DR)
    with pytest.raises(ValueError, match="unsupported device meta"):
        rt.sweep_batch(meta[0], meta[2][0], DR)
    kt = rt.kernel_tables()
    with pytest.raises(ValueError, match="unsupported device cpu"):
        fs.flat_sweep(kt, nd, pos_b[0], DR)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        fs.flat_trace_sweep(kt, nd, pos_b, flux_b, nd[:1].reshape(()), DR)


@pytest.mark.parametrize("N,R", [(12, 4.0), (13, 1e9), (16, 1e9)])
def test_kernel_tables(N, R):
    """The inverse table of the clip cube maps every cell's offset back to
    the cell and nothing else to a cell; the shells are the engine's; the
    positions are wrapped as torch.remainder wraps them."""
    rt, _, _, _, _ = _setup(N, R, 2, torch.float64, "tables", "cpu")
    kt = rt.kernel_tables()
    assert rt.kernel_tables() is kt
    sz = kt.sizes
    off, inv, shell = (kt.tensors[0].long(), kt.tensors[8].long(),
                       kt.tensors[7].long())
    C, lo, side = sz["C"], sz["lo"], sz["side"]
    idx = ((off[0] - lo) * side + off[1] - lo) * side + off[2] - lo
    assert torch.equal(inv[idx], torch.arange(C))
    assert int((inv >= 0).sum()) == C and C == rt.geom_np.num_cells
    assert [(int(shell[q]), int(shell[q + 1]))
            for q in range(1, sz["n_shells"] + 1)] == rt.shells
    pos = torch.tensor([[-1, N, 2 * N + 3], [5, -N - 2, 0]])
    assert torch.equal(fs.stage_positions(pos, N, "cpu").long(),
                       torch.remainder(pos, N))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("N,R", [(16, 4.0), (24, 1e9)])
def test_flat_kernels_equal_plain_on_cuda(N, R, mode, dt):
    """Each kernel (one launch, counted) and the loop (one call, three
    launches a batch) bit for bit against its plain version on the card,
    at every cluster size of the sweep."""
    _cuda()
    rt, nd, xh, pos_b, flux_b = _setup(N, R, 4, dt, mode, "cuda")
    nhi = nd * (1.0 - xh)
    dr_t = torch.tensor(DR, dtype=dt).to("cuda")
    lin, nhi_octa = rt._gather(nhi, pos_b[0])
    cd = rt._sweep(nhi_octa, dr_t)
    sweep.reset_launches()
    for C in sweep.CLUSTERS:
        assert torch.equal(rt.sweep_batch(nhi, pos_b[0], DR, C), cd), C
    assert torch.equal(rt.sweep_batch(nhi, pos_b[0], DR), cd)
    want = rt._rates(cd, nhi_octa, flux_b[0], dr_t)
    got = rt.rates_batch(cd, nhi, pos_b[0], flux_b[0], DR)
    assert torch.equal(got[0], want[0])
    if mode == "heat":
        assert torch.equal(got[1], want[1])
    grids = [torch.rand(N ** 3, dtype=dt, device="cuda") for _ in range(2)]
    ref = [g.clone() for g in grids]
    heat = want[1]
    rt.accumulate_batch(grids[0], grids[1] if heat is not None else None,
                        pos_b[0], want[0], heat)
    rt._accumulate(ref[0], lin, want[0])
    if heat is not None:
        rt._accumulate(ref[1], lin, heat)
    assert all(torch.equal(g, r) for g, r in zip(grids, ref))
    loop = rt.trace_batches(nd, xh, pos_b, flux_b, DR)
    plain = rt.flat_trace_sweep_ref(nd, xh, pos_b, flux_b, DR)
    assert float(plain[0].max()) > 0.0
    assert torch.equal(loop[0], plain[0])
    if mode == "heat":
        assert torch.equal(loop[1], plain[1])
    nb = pos_b.shape[0]
    assert sweep.launches["flat_trace_sweep"] == 1
    assert sweep.launches["flat_sweep"] == len(sweep.CLUSTERS) + 1 + nb
    assert sweep.launches["flat_rates"] == 1 + nb
    assert sweep.launches["flat_accumulate"] == 1 + nb


@pytest.mark.cuda
def test_sweep_coldens_on_cuda_equals_cpu():
    """Raytracer.sweep_coldens through the sweep kernel on the card, bit for
    bit the plain sweep on the CPU (the sweep has no log10 or exp)."""
    _cuda()
    rt_g, nd, xh, _, _ = _setup(12, 1e9, 1, torch.float64, "grey", "cuda")
    rt_c = Raytracer(rt_g.config, device="cpu")
    src = np.array([3, 11, 6])
    got = rt_g.sweep_coldens(nd, xh, src, DR)
    want = rt_c.sweep_coldens(nd.cpu(), xh.cpu(), src, DR)
    assert np.array_equal(got, want)
