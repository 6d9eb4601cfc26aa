"""The flat engine's steps and their kernels: Raytracer's gather_batch,
sweep_batch, rates_batch, accumulate_batch and trace_batches on the CPU
(the plain functions; a device other than the CPU or the card raises,
nothing falls back), the bindings of ops/flat_sweep.py (they refuse CPU
tensors), the kernels' tables (the gather's runs and the rated cells with
numpy emulations of the gather and the rate pass over them), and,
``cuda``, every kernel and the loop on the card bit for bit against their
plain versions. Only the emulated gather's one case against the JAX
engine's nhi_flat[lin] imports JAX."""

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
    assert torch.equal(rt.gather_batch(nhi, pos_b[0]), nhi_octa)
    cd = rt._sweep(nhi_octa, dr_t)
    assert torch.equal(rt.sweep_batch(nhi, pos_b[0], DR), cd)
    want = rt._rates(cd, nhi_octa, flux_b[0], dr_t)
    got = rt.rates_batch(cd, nhi_octa, flux_b[0], DR)
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
    with pytest.raises(ValueError, match="unsupported device meta"):
        rt.gather_batch(meta[0], meta[2][0])
    C = rt.geom_np.num_cells
    cd = torch.zeros((2, C), dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported device meta"):
        rt.rates_batch(cd.to("meta"), cd.to("meta"), meta[3][0], DR)
    kt = rt.kernel_tables()
    sdr3 = nd[:1].reshape(())
    with pytest.raises(ValueError, match="unsupported device cpu"):
        fs.flat_gather(kt, nd, pos_b[0])
    with pytest.raises(ValueError, match="unsupported device cpu"):
        fs.flat_sweep(kt, nd, pos_b[0], DR)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        fs.flat_rates(kt, cd, cd, flux_b[0], sdr3, DR)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        fs.flat_trace_sweep(kt, nd, pos_b, flux_b, sdr3, DR)


@pytest.mark.parametrize("N,R", [(12, 4.0), (13, 1e9), (16, 1e9),
                                 (16, 4.0), (24, 1e9), (256, 30.0),
                                 (128, 1e9)])
def test_kernel_tables(N, R):
    """The inverse table of the clip cube maps every cell's offset back to
    the cell and nothing else to a cell; the shells are the engine's; the
    positions are wrapped as torch.remainder wraps them. The grid order is
    a permutation of the cells that lists their offsets in lexicographic
    order. The corners' codes name each weighted corner's cell (its shell
    lag shells back, its chunk and its place there), the ring's depth is
    the largest lag of a weighted corner plus one (4 at these meshes, the
    bench's N = 256, R = 30 and the golden's whole box at N = 128 among
    them) and a corner of zero weight has the code -1."""
    cfg = RaytraceConfig(N=N, R_max_LLS=R, sig=SIG, batch_size=2,
                         dtype=torch.float64, grey_analytic=True)
    rt = Raytracer(cfg, device="cpu")
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
    # the grid order
    order = kt.tensors[14].long()
    assert torch.equal(torch.sort(order).values, torch.arange(C))
    key = idx[order]
    assert bool((key[1:] > key[:-1]).all())
    packed = kt.tensors[15].long()
    assert torch.equal(torch.stack([(packed >> (10 * a)) & 1023
                                    for a in range(3)]) + lo, off[:, order])
    # the corners' codes and the ring's depth
    g = rt.geom_np
    size = torch.from_numpy(g.shell_size.astype(np.int64))
    start = torch.from_numpy(g.shell_start.astype(np.int64))
    q = torch.repeat_interleave(torch.arange(size.shape[0]), size)
    nbr = torch.from_numpy(g.nbr[:, :C].astype(np.int64))
    weighted = torch.from_numpy(g.sw[:, :C] != 0.0)
    lag = (q[None, :] - q[nbr])[weighted]
    assert int(lag.min()) >= 1
    assert sz["depth"] == int(lag.max()) + 1 == 4
    u = (size + fs.CHUNKS - 1) // fs.CHUNKS
    assert sz["max_u"] == int(u.max())
    code = kt.tensors[13].long()
    assert bool((code[~weighted] == -1).all())
    c = code[weighted]
    q2 = q[None, :].expand_as(nbr)[weighted] - (c >> 20)
    cell = start[q2] + ((c >> 16) & 15) * u[q2] + (c & 0xffff)
    assert torch.equal(cell, nbr[weighted])
    assert torch.equal(c >> 20, lag)
    # the gather's runs cover every cell once, each run one shell of its
    # block's slab and band; the rated cells ascending
    blocks, runs = kt.tensors[16].long(), kt.tensors[17].long()
    assert sz["n_blk"] == blocks.shape[0] and runs.shape[1] == 3
    assert torch.equal(runs[:, 2], torch.cumsum(runs[:, 1], 0) - runs[:, 1])
    run_of = torch.repeat_interleave(torch.arange(runs.shape[0]), runs[:, 1])
    cells = runs[run_of, 0] + torch.arange(C) - runs[run_of, 2]
    assert torch.equal(torch.sort(cells).values, torch.arange(C))
    assert torch.equal(blocks[:, 5], torch.cumsum(blocks[:, 6], 0)
                       - blocks[:, 6])
    assert torch.equal(blocks[:, 7], torch.cumsum(blocks[:, 8], 0)
                       - blocks[:, 8])
    assert torch.equal(blocks[:, 7], runs[blocks[:, 5], 2])
    blk = torch.repeat_interleave(torch.arange(blocks.shape[0]),
                                  blocks[:, 6])[run_of]
    d0, d1a, nd1, d2lo, pitch = blocks[blk, :5].T
    d = off[:, cells]
    assert int((blocks[:, 2] * blocks[:, 4]).max()) == sz["g_cells"] < 1 << 16
    assert torch.equal(d[0], d0)
    assert bool(((d[1] >= d1a) & (d[1] < d1a + nd1)).all())
    assert bool(((d[2] >= d2lo) & (d[2] < d2lo + pitch)).all())
    shell_of = d.abs().sum(0)
    assert torch.equal(shell_of, shell_of[runs[run_of, 2]])   # one shell
    place = kt.tensors[18].numpy().view(np.uint16).astype(np.int64)
    assert np.array_equal(place, ((d[1] - d1a) * pitch + d[2] - d2lo).numpy())
    rated = kt.tensors[19].long()
    assert sz["n_rated"] == rated.shape[0]
    assert torch.equal(rated, torch.nonzero(rt.tables.rated)[:, 0])


def _emulated_gather(rt, nhi, pos):
    """The gather kernel emulated in numpy over the engine's tables: per
    source and gather block the band's rows of the grid (the octahedron's
    cells, at their periodic images) into a block of staged values that
    starts as NaN, then each run's cells from their places there; the
    output starts as NaN. Returns (B, C) float64."""
    kt = rt.kernel_tables()
    N, max_q, C = rt.config.N, kt.sizes["max_q"], kt.sizes["C"]
    blocks, runs = kt.tensors[16].numpy(), kt.tensors[17].numpy()
    places = kt.tensors[18].numpy().view(np.uint16)
    nhi, pos = nhi.numpy(), np.asarray(pos)
    out = np.full((pos.shape[0], C), np.nan)
    for b, p in enumerate(pos):
        for d0, d1a, nd1, d2lo, pitch, run0, nrun, _, _, _ in blocks:
            e = np.arange(nd1 * pitch)
            d1, d2 = d1a + e // pitch, d2lo + e % pitch
            inside = np.abs(d1) + np.abs(d2) <= max_q - abs(d0)
            staged = np.full(nd1 * pitch, np.nan)
            staged[inside] = nhi[(((p[0] + d0) % N * N + (p[1] + d1[inside])
                                   % N) * N + (p[2] + d2[inside]) % N)]
            for first, n, at in runs[run0:run0 + nrun]:
                out[b, first:first + n] = staged[places[at:at + n]]
    return out


# (N, R, sources): an octahedron inside the mesh, one clipped by it (side <
# 2 max_q + 1, the golden's case), and an odd mesh's whole box; sources at
# the corners and edges of the box, so their octahedra wrap on every axis
GATHER_CASES = {
    "N24_R4": (24, 4.0, [[0, 0, 0], [23, 23, 23], [1, 22, 12]]),
    "N16_box": (16, 1e9, [[0, 15, 0], [15, 0, 15], [8, 8, 8]]),
    "N13_box": (13, 1e9, [[12, 0, 6], [0, 12, 12], [6, 6, 0]]),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_emulated_gather_equals_plain(case):
    """The staged gather emulated over the tables (``_emulated_gather``)
    equals the plain gather bit for bit: every cell written, from the cell
    of the grid the plain gather reads."""
    N, R, pos = GATHER_CASES[case]
    rt, _, _, _, _ = _setup(N, R, 3, torch.float64, "grey", "cpu")
    nhi = torch.from_numpy(np.random.RandomState(N).uniform(0, 1, N ** 3))
    got = _emulated_gather(rt, nhi, pos)
    want = rt._gather(nhi, torch.tensor(pos))[1].numpy()
    assert np.array_equal(got, want)
    if case == "N16_box":
        assert rt.kernel_tables().sizes["side"] < 2 * rt.geom_np.max_q + 1


def test_emulated_gather_equals_jax():
    """The emulated gather against the JAX engine's nhi_flat[lin]
    (pyc2ray_tpu/ops/raytrace.py::Raytracer._trace_impl), on its C cells,
    at a clipped octahedron with sources that wrap on every axis."""
    import jax.numpy as jnp
    from pyc2ray_tpu.ops import raytrace as j_raytrace
    N, R, pos = GATHER_CASES["N16_box"]
    rt, _, _, _, _ = _setup(N, R, 3, torch.float64, "grey", "cpu")
    jr = j_raytrace.Raytracer(j_raytrace.RaytraceConfig(
        N=N, R_max_LLS=R, sig=SIG, batch_size=3, dtype=jnp.float64,
        grey_analytic=True))
    nhi = np.random.RandomState(3).uniform(0, 1, N ** 3)
    lin = jr._lin_idx(jr.tables, jnp.asarray(pos, dtype=jnp.int32))
    want = np.asarray(jnp.asarray(nhi)[lin])[:, :rt.geom_np.num_cells]
    assert np.array_equal(_emulated_gather(rt, torch.from_numpy(nhi), pos),
                          want)


def _emulated_rates(rt, cdo, nhi_octa, flux, dr_t):
    """The rate kernel emulated over the engine's list of rated cells: the
    outputs zeros, then at each rated cell (for every source) the rates from
    its gathered nHI and column density, each tau's place in the tables
    (log10, index, residual) formed once and read by every table that needs
    it, the thick cells' out place only for them."""
    cfg, tb = rt.config, rt.tables
    cells = rt.kernel_tables().tensors[19].long()
    heat = cfg.do_heating
    phi_o = torch.zeros_like(cdo)
    heat_o = torch.zeros_like(cdo) if heat else None
    nhi, cd = nhi_octa[:, cells], cdo[:, cells]
    dcol = nhi * (tb.path[cells] * dr_t)
    cdin = cd - dcol
    tau_in, tau_out, dtau = cdin * cfg.sig, cd * cfg.sig, dcol * cfg.sig
    prefact = flux[:, None] * rt._s_over_dr3(dr_t) * tb.geom[cells]
    thick = dtau > 1e-7

    def place(tau):
        logtau = torch.log10(torch.clamp(tau, min=1.0e-20))
        real_i = torch.clamp(1.0 + (logtau - rt.minlogtau) / rt.dlogtau,
                             0.0, float(rt.num_tau))
        i0 = real_i.to(torch.int64)
        return i0, torch.clamp(i0 + 1, max=rt.num_tau), \
            real_i - i0.to(real_i.dtype)

    def interp(table, at):
        i0, i1, resid = at
        return table[i0] + resid * (table[i1] - table[i0])
    out = [torch.zeros_like(cd), torch.zeros_like(cd)]
    if cfg.grey_analytic:
        ein = torch.exp(-tau_in)
        out[0] = torch.where(thick, prefact * (ein - torch.exp(-tau_out)),
                             prefact * dtau * ein)
    else:
        at_in = place(tau_in)
        at_out = tuple(x[thick] for x in place(tau_out))
        at_in_k = tuple(x[thick] for x in at_in)
        at_in_n = tuple(x[~thick] for x in at_in)
        tabs = [(tb.photo_thin, tb.photo_thick)]
        if heat:
            tabs.append((tb.heat_thin, tb.heat_thick))
        for k, (thin, thk) in enumerate(tabs):
            out[k][thick] = prefact[thick] * (interp(thk, at_in_k)
                                              - interp(thk, at_out))
            out[k][~thick] = prefact[~thick] * dtau[~thick] * \
                interp(thin, at_in_n)
    mask = cdin <= 2.0e30
    nhi_safe = torch.clamp(nhi, min=torch.finfo(cfg.dtype).tiny)
    for k, o in enumerate((phi_o, heat_o)):
        if o is not None:
            o[:, cells] = torch.where(mask, out[k] / nhi_safe,
                                      torch.zeros_like(cd))
    return phi_o, heat_o


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("N,R", [(16, 4.0), (13, 1e9)])
def test_emulated_rates_over_rated_cells_equal_plain(monkeypatch, N, R,
                                                     mode):
    """The rate pass emulated over the rated cells (``_emulated_rates``)
    equals the plain rate pass bit for bit, with and without heat and grey:
    the unrated cells' +0 (R inside the mesh), a cell past MAX_COLDENSH,
    the zero-density cell and a zero flux, thin and thick cells; log10 and
    exp elementwise (glibc's) in both, so the CPU's vector paths do not
    decide a bit."""
    from rehearsal_flat import _card_arithmetic
    dt = torch.float64
    rt, nd, xh, pos_b, flux_b = _setup(N, R, 3, dt, mode, "cpu")
    nhi_octa = rt._gather(nd * (1.0 - xh), pos_b[0])[1]
    dr_t = torch.tensor(DR, dtype=dt)
    cd = rt._sweep(nhi_octa, dr_t)
    cd[1, 5] = 1e31
    _card_arithmetic(monkeypatch, dt)
    want = rt._rates(cd, nhi_octa, flux_b[0], dr_t)
    got = _emulated_rates(rt, cd, nhi_octa, flux_b[0], dr_t)
    monkeypatch.undo()
    rated = rt.tables.rated
    assert bool(rated.all()) == (R > N)
    assert float(want[0].max()) > 0.0 and float(want[0][1, 5]) == 0.0
    dtau = nhi_octa * rt.tables.path * dr_t * SIG
    assert bool((dtau > 1e-7).any()) and bool((dtau < 1e-7).any())
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
            assert bool((torch.signbit(w[:, ~rated]) == 0).all())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("N,R", [(16, 4.0), (24, 1e9)])
def test_flat_kernels_equal_plain_on_cuda(N, R, mode, dt):
    """Each kernel (one launch, counted; the sweep's binding launches the
    gather and the sweep) and the loop (one call: per device batch of as
    many sources as the card holds the gather, the sweep and the rates, the
    accumulate a batch at a time) bit for bit against its plain version on
    the card, at every cluster size of the sweep and both placements of its
    column densities (the ring in distributed shared memory, global
    memory)."""
    _cuda()
    rt, nd, xh, pos_b, flux_b = _setup(N, R, 4, dt, mode, "cuda")
    nhi = nd * (1.0 - xh)
    dr_t = torch.tensor(DR, dtype=dt).to("cuda")
    lin, nhi_octa = rt._gather(nhi, pos_b[0])
    cd = rt._sweep(nhi_octa, dr_t)
    sweep.reset_launches()
    for C in sweep.CLUSTERS:
        for shared in (True, False):
            assert torch.equal(rt.sweep_batch(nhi, pos_b[0], DR, C, shared),
                               cd), (C, shared)
    assert torch.equal(rt.sweep_batch(nhi, pos_b[0], DR), cd)
    assert torch.equal(rt.gather_batch(nhi, pos_b[0]), nhi_octa)
    want = rt._rates(cd, nhi_octa, flux_b[0], dr_t)
    got = rt.rates_batch(cd, nhi_octa, flux_b[0], DR)
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
    loop = fs.loop_plan(rt.kernel_tables(), nb, 4, nd.device)[3]
    assert sweep.launches["flat_trace_sweep"] == 1
    for k in ("flat_gather", "flat_sweep"):
        assert sweep.launches[k] == 2 * len(sweep.CLUSTERS) + 1 + loop[k] \
            + (k == "flat_gather")
    assert sweep.launches["flat_rates"] == 1 + loop["flat_rates"]
    assert sweep.launches["flat_accumulate"] == 1 + loop["flat_accumulate"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("N,R", [(24, 7.0), (16, 1e9)])
def test_flat_gather_and_rates_write_their_cells_on_cuda(N, R, mode, dt):
    """The gather kernel and the rate kernel on outputs made NaN first, bit
    for bit against the plain gather and rate pass: the gather writes every
    cell of every octahedron (R inside the mesh and the whole box; sources
    at the box's corners, so the octahedra wrap on every axis), the rate
    kernel every rated cell and no other (those stay NaN; the binding's
    outputs start as zeros, the plain pass's +0)."""
    _cuda()
    rt, nd, xh, _, flux_b = _setup(N, R, 4, dt, mode, "cuda")
    kt = rt.kernel_tables()
    pos = torch.tensor([[0, 0, 0], [N - 1, N - 1, N - 1], [0, N - 1, 3],
                        [N // 2, 1, N - 2]], device="cuda")
    nhi = nd * (1.0 - xh)
    want_g = rt._gather(nhi, pos)[1]
    out = torch.full_like(want_g, float("nan"))
    lib = fs._lib()
    sfx = "f32" if dt == torch.float32 else "f64"
    ps = fs.stage_positions(pos, N, nhi.device)
    assert getattr(lib, f"flat_gather_{sfx}")(
        kt.tabs, kt.dims, fs._vals(kt, 1.0), fs._ptr(nhi), fs._ptr(ps),
        fs._ptr(out), 4, fs._stream(nhi.device)) == 0
    assert torch.equal(out, want_g)
    cd = rt.sweep_batch(nhi, pos, DR)
    flux = flux_b[0]
    want = rt._rates(cd, want_g, flux, rt._dr(DR, "cuda"))
    outs = [torch.full_like(cd, float("nan")) for _ in range(2)]
    sdr3 = rt._s_over_dr3(rt._dr(DR, "cuda"))
    assert getattr(lib, f"flat_rates_{sfx}")(
        kt.tabs, kt.dims, fs._vals(kt, DR), fs._ptr(want_g), fs._ptr(flux),
        fs._ptr(sdr3), fs._ptr(cd), fs._ptr(outs[0]),
        fs._ptr(outs[1] if mode == "heat" else None), 4,
        fs._stream(nhi.device)) == 0
    rated = rt.tables.rated
    assert bool(rated.all()) == (R > N)
    for got, ref in zip(outs, want):
        if ref is None:
            continue
        assert torch.equal(got[:, rated], ref[:, rated])
        assert bool(got[:, ~rated].isnan().all())
    got = rt.rates_batch(cd, want_g, flux, DR)
    assert all(g is None if w is None else torch.equal(g, w)
               for g, w in zip(got, want))


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


@pytest.mark.cuda
@pytest.mark.parametrize("heat", [False, True])
def test_flat_accumulate_flushes_subnormals_as_index_add_on_cuda(heat):
    """The float32 accumulate on the card against the plain ordered
    index_add_ on the card, bit for bit, with subnormal rates planted among
    normal ones and grid cells that start subnormal: the kernel's register
    adds flush as index_add_'s atomicAdd does."""
    _cuda()
    dt = torch.float32
    rt, _, _, pos_b, _ = _setup(16, 1e9, 4, dt, "heat" if heat else "tables",
                                "cuda")
    C, N = rt.geom_np.num_cells, 16
    rng = np.random.RandomState(11)
    tiny = torch.finfo(dt).tiny

    def rand(*shape, lo, hi, sub=0.0):
        v = 10 ** rng.uniform(lo, hi, shape)
        v[rng.uniform(size=shape) < sub] *= 1e-3
        return torch.from_numpy(v).to("cuda", dt)
    vals = [rand(4, C, lo=-38.5, hi=-36.0, sub=0.5) for _ in range(2)]
    start = [rand(N ** 3, lo=-39.5, hi=-37.5) for _ in range(2)]
    assert bool((vals[0] < tiny).any()) and bool((start[0] < tiny).any())
    lin = rt._lin_idx(pos_b[0])
    want = [g.clone() for g in start]
    for g, v in zip(want[:1 + heat], vals):
        rt._accumulate(g, lin, v)
    got = [g.clone() for g in start]
    sweep.reset_launches()
    rt.accumulate_batch(got[0], got[1] if heat else None, pos_b[0], vals[0],
                        vals[1] if heat else None)
    assert sweep.launches["flat_accumulate"] == 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    # the flush shows: some cell's sum is 0 on the card but not on the CPU
    cpu = [g.cpu() for g in start]
    rt_c = Raytracer(rt.config, *TABLES, device="cpu")
    rt_c._accumulate(cpu[0], lin.cpu(), vals[0].cpu())
    assert not torch.equal(cpu[0], want[0].cpu())


@pytest.mark.cuda
def test_flat_sweep_at_the_golden_shape_on_cuda():
    """The sweep at the golden's shape (N = 128, the whole box, one source,
    float64): the plan is clusters of 16 with the ring in distributed
    shared memory, and the kernel in both placements, its output first
    filled with NaN, equals the plain gather and sweep bit for bit; so do
    the gather and the rate pass (over the rated cells, their outputs on
    blocks of NaN)."""
    _cuda()
    dt = torch.float64
    cfg = RaytraceConfig(N=128, R_max_LLS=1e9, sig=SIG, batch_size=1,
                         dtype=dt, grey_analytic=True)
    rt = Raytracer(cfg, device="cuda")
    rng = np.random.RandomState(13)
    nhi = torch.from_numpy(10 ** rng.uniform(-4, -2, 128 ** 3)).to("cuda",
                                                                    dt)
    pos = torch.tensor([[96, 96, 64]], device="cuda")
    want = rt._sweep(rt._gather(nhi, pos)[1], rt._dr(DR, "cuda"))
    assert fs.flat_plan(rt.kernel_tables(), 1, nhi.device)[:2] == (16, True)
    assert torch.equal(fs.flat_gather(rt.kernel_tables(), nhi, pos),
                       rt._gather(nhi, pos)[1])
    for shared in (True, False):
        torch.cuda.empty_cache()
        torch.full((2 * want.numel(),), float("nan"), dtype=dt,
                   device="cuda")
        got = rt.sweep_batch(nhi, pos, DR, 16, shared)
        assert torch.equal(got, want), shared
    rt_t = Raytracer(cfg._replace(grey_analytic=False, do_heating=True),
                     *TABLES, device="cuda")
    nhi_octa = rt._gather(nhi, pos)[1]
    flux = torch.tensor([10.0], dtype=dt, device="cuda")
    ref = rt_t._rates(want, nhi_octa, flux, rt._dr(DR, "cuda"))
    torch.cuda.empty_cache()
    torch.full((4 * want.numel(),), float("nan"), dtype=dt, device="cuda")
    assert torch.equal(rt_t.gather_batch(nhi, pos), nhi_octa)
    got = rt_t.rates_batch(want, nhi_octa, flux, DR)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
