"""The trace loop's accumulate over an engine's rated cells
(csrc/trace_loop.cu), rehearsed on the host (tests/rehearsal_host.py), bit
for bit against the plain slice adds with its blocks in either order."""

import ctypes

import numpy as np
import pytest
import torch

from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.ops.trace_loop import add_boxes
from rehearsal_host import SIG, lib, three_bins  # noqa: F401


# (N, R, B, clustered): the engine's rates subbox (Ds = 13 of Dc = 16 at
# rb0 = 1) and the full box of a clipped one (Dc = 8); 3 batches of B
# sources, clustered as halos are or spread, and 40 clustered sources in the
# clipped box (two 32-box masks)
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,R,B,clustered", [(16, 6.0, 6, True),
                                             (16, 6.0, 5, False),
                                             (8, 6.0, 4, True),
                                             (8, 6.0, 40, True)])
def test_rated_accumulate_on_the_host_matches_plain(lib, N, R, B, clustered,
                                                    dt):
    """accumulate_boxes over the engine's rated cells (the unfused modes'
    rate boxes, 0 at every other cell) bit for bit against the slice adds
    of the whole boxes at shift rb0, one channel and two (Gamma and heat),
    its blocks in either order: where boxes overlap, the owner of a frame
    cell is the lowest box that rates it."""
    rt = ChebRaytracer(N, R, SIG, three_bins(), batch_size=B, dtype=dt,
                       device="cpu")
    g, tb, Ds, rb0 = rt.geom, rt.tables, rt.Ds, rt._rb0
    cells, valid = rt.rated_cells, tb.rt_sub[2].contiguous()
    shape = (N + g.Dc - 1,) * 3
    rng = np.random.RandomState(N + B)
    if clustered:
        pos = rng.randint(0, N - 2, 3) + rng.randint(0, 3, (3, B, 3))
        pos[:, 1] = pos[:, 0]
    else:
        pos = rng.randint(0, N, (3, B, 3))
    pos = torch.from_numpy(pos.astype(np.int32))
    fn = lib.rehearse_boxes_f32 if dt == torch.float32 else \
        lib.rehearse_boxes_f64
    ptrs = ctypes.c_void_p * 4
    for n in ((1, 2) if B <= 32 else (2,)):
        frames = [torch.from_numpy(np.abs(rng.standard_normal(shape))).to(dt)
                  for _ in range(n)]
        want = [f.clone() for f in frames]
        got = {r: [f.clone() for f in frames] for r in (0, 1)}
        for k in range(3):
            boxes = [torch.from_numpy(np.abs(rng.standard_normal(
                (B, Ds, Ds, Ds)))).to(dt) * (valid > 0.5) for _ in range(n)]
            for f, bx in zip(want, boxes):
                add_boxes(f, bx, pos[k], rb0)
            for r in (0, 1):
                fn(ptrs(*[f.data_ptr() for f in got[r]]),
                   ptrs(*[bx.data_ptr() for bx in boxes]), n,
                   pos.data_ptr(), k, B, Ds, rb0, *shape, cells.data_ptr(),
                   valid.data_ptr(), cells.numel(), 16, r)
        for r in (0, 1):
            for a, w in zip(got[r], want):
                assert torch.equal(a, w), (n, r)
    if clustered:
        # some frame cell takes the rates of several boxes
        cover = torch.zeros(shape, dtype=torch.int32)
        for p in pos[0].tolist():
            cover[tuple(slice(c + rb0, c + rb0 + Ds) for c in p)] += (
                valid > 0.5).to(torch.int32)
        assert int(cover.max()) >= 3
