"""The trace loop's box kernels (csrc/trace_loop.cu) rehearsed on the host
(tests/rehearsal_host.py) on the 40 clustered boxes of "masks",
more than one 32-box coverage mask. The cases of
rehearsal_host.BOX_CASES are dealt over test_torch_rehearsal_boxes_a/b/c.py
so that the xdist workers share them."""

import pytest
import torch

from rehearsal_host import check_box_kernels, lib  # noqa: F401


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["masks"])
@pytest.mark.parametrize("threads", [7, 64])
def test_box_kernels_on_the_host_match_plain(lib, case, dt, threads):
    """extract_boxes and accumulate_boxes bit for bit against their plain
    versions, for one channel and for several at once (the helium engine's
    three species; Gamma and heat; its four rate channels), on frames that
    do not start at zero; the accumulate also with its blocks in reverse
    order, which a design where two threads write one cell would not
    survive."""
    check_box_kernels(lib, case, dt, threads)
