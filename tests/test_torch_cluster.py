"""What the cluster sweep of the port's CUDA kernels rests on, checked on
the CPU: every mask plane of shell r is false outside the shell window the
kernel visits, and the host rule that picks the cluster size and the plane
placement gives launchable sizes that cover every plane row once. The
``cuda`` tests hold K1 and K2 against their plain versions bit for bit in
every cluster size and placement."""

import numpy as np
import pytest
import torch

from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.cheb_geometry import build_cheb_geometry
from pyc2ray_torch.ops.geometry import max_q_for
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.radiation.spectral_bins import SpectralBins

SIG = 6.30e-18
DR = 6.7e20


def _grey():
    return SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                        w_heat=np.array([0.0]), num_bins=1)


# (N, R, r_cube): the engine's geometries of the sweep, segmented, fused and
# model tests (r_cube = ceil(R) < max_q); (8, 6) and (16, 8) are clipped by
# the mesh, (9, 8) is clipped with a box side that is no multiple of 8;
# r_cube None sweeps the whole octahedron (r_cube = max_q); (32, 4.0, 3) has
# a box smaller than the rate sphere
@pytest.mark.parametrize("N,R,r_cube", [
    (16, 3.0, 3), (8, 6.0, 6), (16, 6.0, 6), (16, 8.0, 8), (12, 5.0, 5),
    (24, 10.0, 10), (48, 48.0, 48), (9, 8.0, 8), (16, 4.0, None),
    (32, 4.0, 3)])
def test_masks_are_false_outside_the_shell_window(N, R, r_cube):
    g = build_cheb_geometry(N, max_q_for(R, N), r_cube)
    if r_cube is not None:
        assert r_cube < g.max_q
    assert g.r_max >= 1
    ab = np.arange(g.Dc)
    for r in range(g.r_max + 1):
        lo, hi = max(g.c - r, 0), min(g.c + r, g.Dc - 1)
        inside = (ab >= lo) & (ab <= hi)
        window = inside[:, None] & inside[None, :]
        for mask in (g.mask_m, g.mask_p):
            assert not mask[:, r][:, ~window].any(), (r, lo, hi)
    assert not g.mask_m[:, 0].any() and not g.mask_p[:, 0].any()
    # the windows grow with r, so a cell outside shell r's window was
    # outside every earlier one and its plane value is the initial zero
    assert g.mask_m[:, 1:].any() or g.mask_p[:, 1:].any()


def _max_active(sms=132, gpc=16):
    """A card of ``sms`` SMs in groups of ``gpc``: a cluster fits inside
    one group, a block with more than half the shared memory alone on its
    SM."""
    def ask(plan):
        per_sm = 1 if plan.smem > sweep.SMEM_MAX // 2 else 2
        per_group = gpc * per_sm // plan.cluster
        return (sms // gpc) * per_group
    return ask


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("Dc,R1", [(48, 25), (61, 31), (64, 31), (208, 101),
                                   (9, 5)])
@pytest.mark.parametrize("B", [1, 8, 32, 128])
def test_sweep_plan_is_launchable_and_covers_every_row(B, Dc, R1, itemsize):
    ask = _max_active()
    plan = sweep.sweep_plan(B, Dc, itemsize, ask)
    C = plan.cluster
    assert C in sweep.CLUSTERS and 0 <= plan.smem <= sweep.SMEM_MAX
    assert plan.threads == sweep.THREADS
    assert (plan.smem, plan.rows) == sweep.plan_sizes(
        Dc, itemsize, C, plan.shared_planes)
    # the largest cluster size of which the card holds B at once
    assert ask(plan) >= B or C == 1
    for bigger in (k for k in sweep.CLUSTERS if k > C):
        assert ask(sweep.sweep_plan(B, Dc, itemsize, ask,
                                    cluster=bigger)) < B
    if plan.shared_planes:
        # row a of a plane lives in block a % C at local row a // C
        homes = {(a % C, a // C) for a in range(Dc)}
        assert len(homes) == Dc and max(h[1] for h in homes) < plan.rows
        assert plan.rows == -(-Dc // C)
    else:
        assert plan.rows == 0
        assert sweep.plan_sizes(Dc, itemsize, C, True)[0] > sweep.SMEM_MAX
    # the shares of a sub-step, as the kernel deals them out, cover the
    # window once
    for r in (1, R1 // 2, R1 - 1):
        n = 2 * min(Dc, 2 * r + 1) ** 2
        per = -(-n // C)
        cells = [i for k in range(C)
                 for i in range(min(k * per, n), min(k * per + per, n))]
        assert cells == list(range(n))


def test_sweep_plan_sizes_at_the_documented_shapes():
    ask = _max_active()
    # bench shape, float32: eight clusters of 16 fit, planes shared
    p = sweep.sweep_plan(8, 64, 4, ask)
    assert p == sweep.SweepPlan(16, True, sweep.THREADS, 12288, 4)
    assert sweep.plan_sizes(64, 4, 8, True) == (24576, 8)
    # R = 100 shape: float32 planes fit at 16 blocks, not at 8, and not in
    # float64
    p = sweep.sweep_plan(8, 208, 4, ask)
    assert (p.cluster, p.shared_planes, p.smem) == (16, True, 129792)
    assert not sweep.sweep_plan(8, 208, 4, ask, cluster=8).shared_planes
    assert not sweep.sweep_plan(8, 208, 8, ask).shared_planes
    # a card that holds only six clusters of 16 at once: eight sources get 8
    six = lambda plan: 6 if plan.cluster == 16 else 132 // plan.cluster
    assert sweep.sweep_plan(8, 64, 4, six).cluster == 8
    assert sweep.sweep_plan(1, 48, 8, six).cluster == 16
    # more sources than blocks fit: one block per source
    assert sweep.sweep_plan(4096, 64, 4, ask).cluster == 1
    # the kernel's own values at the start of shared memory count
    assert sweep.plan_sizes(64, 4, 8, True, head=28)[0] == 24576 + 28 * 4


def test_sweep_plan_forced_parts():
    ask = _max_active()
    p = sweep.sweep_plan(8, 64, 4, ask, cluster=4, shared_planes=False,
                         threads=128)
    assert p == sweep.SweepPlan(4, False, 128, 0, 0)
    with pytest.raises(ValueError, match="fits"):
        sweep.sweep_plan(8, 208, 8, ask, cluster=8, shared_planes=True)
    with pytest.raises(ValueError, match="fits"):
        sweep.sweep_plan(8, 208, 4, ask, cluster=4, shared_planes=True)
    with pytest.raises(ValueError, match="cluster size"):
        sweep.sweep_plan(8, 64, 4, ask, cluster=3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _engine(N, R, B, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tr = ChebRaytracer(N, R, SIG, _grey(), batch_size=B, dtype=dt,
                       device="cuda")
    rng = np.random.RandomState(N + B)
    Dc = tr.geom.Dc
    box = torch.from_numpy(
        10 ** rng.uniform(-4, -2, (B, Dc, Dc, Dc))).to("cuda", dt)
    tb = tr.tables
    return tr, box, (tb.sw, tb.path, tb.diag, tb.mask_m, tb.mask_p)


def _chain(tr, box, geo, S, seg, **kw):
    g = tr.geom
    planes = sweep.init_planes(box, g.c, DR)
    src_cd = planes[:, 0, 0, g.c, g.c].clone()
    out = torch.zeros_like(box)
    for r0 in range(1, g.r_max + 1, S):
        out, planes = seg(box, *geo, DR, g.c, SIG, planes, r0, S, out, **kw)
    out[:, g.c, g.c, g.c] = src_cd
    return out, planes


# (16, 8, B=8): a clipped box, Dc = 16; (9, 8, B=1): clipped with Dc = 9,
# which no cluster size above 1 divides; (24, 10, B=1): unclipped
@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,R,B", [(16, 8.0, 8), (9, 8.0, 1), (24, 10.0, 1)])
@pytest.mark.parametrize("shared_planes", [False, True])
@pytest.mark.parametrize("cluster", [1, 4, 8, 16])
def test_cluster_sweep_matches_plain_on_cuda(cluster, shared_planes, N, R, B,
                                             dt):
    tr, box, geo = _engine(N, R, B, dt)
    plan = dict(cluster=cluster, shared_planes=shared_planes)
    c = tr.geom.c
    n0 = dict(sweep.launches)
    k1 = sweep.cheb_sweep(box, *geo, DR, c, SIG, plan=plan)
    torch.cuda.synchronize()
    assert sweep.launches["cheb_sweep"] == n0["cheb_sweep"] + 1
    assert sweep.last_plan["cheb_sweep"][:2] == (cluster, shared_planes)
    assert torch.equal(k1, sweep.cheb_sweep_ref(box, *geo, DR, c, SIG))
    # K2 chained over ragged segments: the box equals K1's, and box and
    # carried planes equal the plain version's
    S = 3
    got, planes = _chain(tr, box, geo, S, sweep.cheb_sweep_seg, plan=plan)
    torch.cuda.synchronize()
    assert sweep.launches["cheb_sweep_seg"] == (
        n0["cheb_sweep_seg"] + -(-tr.geom.r_max // S))
    want, planes_ref = _chain(tr, box, geo, S, sweep.cheb_sweep_seg_ref)
    assert torch.equal(got, k1) and torch.equal(got, want)
    assert torch.equal(planes, planes_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,R,B", [(16, 8.0, 8), (9, 8.0, 1), (64, 30.0, 2)])
def test_planned_sweep_matches_plain_on_cuda(N, R, B, dt):
    """The plan the host rule picks for the card (no part forced)."""
    tr, box, geo = _engine(N, R, B, dt)
    c = tr.geom.c
    k1 = sweep.cheb_sweep(box, *geo, DR, c, SIG)
    torch.cuda.synchronize()
    plan = sweep.last_plan["cheb_sweep"]
    assert sweep.occupancy[f"cheb_sweep_{'f32' if dt == torch.float32 else 'f64'}",
                           plan] >= B or plan.cluster == 1
    assert torch.equal(k1, sweep.cheb_sweep_ref(box, *geo, DR, c, SIG))
    got, _ = _chain(tr, box, geo, 4, sweep.cheb_sweep_seg)
    assert torch.equal(got, k1)


@pytest.mark.cuda
def test_refused_cluster_launch_raises_on_cuda():
    """A plan with more shared memory than a block may have (and not the
    size the launch code computes): the launch is refused and the wrapper
    raises with CUDA's error string; nothing runs in its place."""
    tr, box, geo = _engine(16, 8.0, 2, torch.float32)
    lib_plan = sweep.SweepPlan(8, True, sweep.THREADS, sweep.SMEM_MAX + 1024,
                               2)
    real = sweep.sweep_plan
    sweep.sweep_plan = lambda *a, **k: lib_plan
    sweep._plans.clear()
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            sweep.cheb_sweep(box, *geo, DR, tr.geom.c, SIG)
    finally:
        sweep.sweep_plan = real
        sweep._plans.clear()
