"""The trace loop's accumulate (csrc/trace_loop.cu) rehearsed on the host
(tests/rehearsal_host.py) with more boxes in a batch than it stages in
shared memory."""

import ctypes

import numpy as np
import pytest
import torch

from pyc2ray_torch.ops.trace_loop import add_boxes
from rehearsal_host import corners, lib  # noqa: F401


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_accumulate_on_the_host_with_more_boxes_than_staged(lib, dt):
    """accumulate_boxes with 1100 clustered boxes in a batch, more than the
    kernel stages in shared memory (1024: their corners are read from
    device memory), whose near-box mask spans 35 words: an owner's adds run
    on across the 32-box words in ascending box order, bit for bit against
    add_boxes, with its blocks in either order; some cell takes all 1100
    adds."""
    shape, D, B = (6, 6, 7), 3, 1100
    rng = np.random.RandomState(71)
    pos = corners(rng, 1, B, shape, D, True)
    box = torch.from_numpy(rng.standard_normal((B, D, D, D))).to(dt)
    frame = torch.from_numpy(rng.standard_normal(shape)).to(dt)
    want = frame.clone()
    add_boxes(want, box, pos[0])
    fn = lib.rehearse_boxes_f32 if dt == torch.float32 else \
        lib.rehearse_boxes_f64
    for reverse in (0, 1):
        got = frame.clone()
        fn((ctypes.c_void_p * 4)(got.data_ptr()),
           (ctypes.c_void_p * 4)(box.data_ptr()), 1, pos.data_ptr(), 0, B, D,
           0, *shape, None, None, 0, 32, reverse)
        assert torch.equal(got, want), reverse
    p = pos[0].long()
    assert bool((p.amax(0) - p.amin(0) < D).all())      # a cell in all boxes
