"""K1 and K2 (csrc/cheb_sweep_kernels.cuh), the start of a segmented sweep
(init_segments) and the launch code's refusals, rehearsed on the host
(tests/rehearsal_host.py): K1, K2 (box and carried planes) and
init_segments bit for bit against their plain versions for every cluster
size, placement and block size of PLANS. A cluster runs as C x T
std::threads (the cluster barrier a split std::barrier, map_shared_rank an
offset into another block's buffer), so this checks the shell windows, the
dealing of cells to blocks, plane ownership and stitches."""

import pytest
import torch

from pyc2ray_torch.ops import sweep
from rehearsal_host import (DR, K1, K1F, K2, K3, PLANS, SIG, SWEEP_SHAPES,
                            Case, lib)  # noqa: F401


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B", SWEEP_SHAPES)
def test_kernels_on_the_host_match_plain(lib, N, R, B, dt):
    for plan in PLANS:
        case = Case(lib, N, R, B, dt, plan)
        nhi, geo, g, tb = case.nhi, case.geo, case.g, case.tb
        # K1
        k1, _, _ = case.run(K1)
        want = sweep.cheb_sweep_ref(nhi, *geo, DR, g.c, SIG)
        assert torch.equal(k1, want), plan
        # K2 chained over ragged segments: box and carried planes
        planes = sweep.init_planes(nhi, g.c, DR)
        planes_ref = planes.clone()
        box, box_ref = torch.zeros_like(nhi), torch.zeros_like(nhi)
        for r0 in range(1, g.r_max + 1, 3):
            box, _, planes = case.run(K2, planes=planes, r0=r0,
                                      r1=min(r0 + 3, g.r_max + 1), box=box)
            box_ref, planes_ref = sweep.cheb_sweep_seg_ref(
                nhi, *geo, DR, g.c, SIG, planes_ref, r0, 3, box_ref)
            assert torch.equal(planes, planes_ref), (plan, r0)
            assert torch.equal(box, box_ref), (plan, r0)



def test_host_launch_code_refuses_other_sizes(lib):
    """make_plan computes the shared-memory size itself and refuses a
    caller whose size differs (the launch then never happens), a cluster
    size that is no power of two, rate threads or a ring for a kernel
    that defers nothing, and a ring that no thread drains."""
    case = Case(lib, 8, 6.0, 1, torch.float64, (4, True, 1, 0, 0))
    smem = sweep.plan_sizes(case.g.Dc, 8, 4, True)[0]
    assert case.run(K1, smem=smem + 8) == 1
    assert case.run(K1, plan=(3, True, 1, 0, 0), smem=smem) == 1
    assert isinstance(case.run(K1), tuple)
    smem = sweep.plan_sizes(case.g.Dc, 8, 4, True, 6, 5)[0]
    assert case.run(K1F, plan=(4, True, 1, 2, 5), smem=smem + 4) == 1
    assert case.run(K1F, plan=(4, True, 1, 0, 5)) == 1
    assert case.run(K3, plan=(4, True, 1, 2, 5)) == 1
    assert isinstance(case.run(K1F, plan=(4, True, 1, 2, 5)), tuple)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B", [(16, 6.0, 2), (8, 6.0, 2), (16, 8.0, 1)])
@pytest.mark.parametrize("reverse", [0, 1])
def test_init_segments_on_the_host_matches_plain(lib, N, R, B, dt, reverse):
    """init_segments_kernel bit for bit against init_segments_ref (the box
    and shell 0's planes), with its blocks in either order; chained with K2
    it gives K1's box."""
    case = Case(lib, N, R, B, dt, (1, False, 5, 0, 0))
    nhi, g = case.nhi, case.g
    box = torch.full_like(nhi, float("nan"))
    planes = torch.full((B, 3, 2, g.Dc, g.Dc), float("nan"), dtype=dt)
    fn = lib.rehearse_init_f32 if dt == torch.float32 else \
        lib.rehearse_init_f64
    fn(nhi.data_ptr(), box.data_ptr(), planes.data_ptr(), B, g.Dc, g.c, DR,
       7, reverse)
    want_box, want_planes = sweep.init_segments_ref(nhi, g.c, DR)
    assert torch.equal(box, want_box) and torch.equal(planes, want_planes)
    assert torch.equal(want_planes, sweep.init_planes(nhi, g.c, DR))
    S = 3
    for r0 in range(1, g.r_max + 1, S):
        box, _, planes = case.run(K2, planes=planes, r0=r0,
                                  r1=min(r0 + S, g.r_max + 1), box=box)
    assert torch.equal(box, sweep.cheb_sweep_ref(nhi, *case.geo, DR, g.c,
                                                 SIG))
