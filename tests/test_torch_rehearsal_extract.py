"""The trace loop's chunked extract (csrc/trace_loop.cu), rehearsed on the
host (tests/rehearsal_host.py), bit for bit against its plain version with
its blocks in either order."""

import ctypes

import numpy as np
import pytest
import torch

from rehearsal_host import lib  # noqa: F401


# The chunked extract (csrc/trace_loop.cu): a case is the frame's extents,
# the padding of its rows (a pitched view: the frame a slice of a wider
# tensor), the box side D, B, the batches nb and the chunk k. D = 8: rows of
# 16 bytes in both types (vectors of 16 bytes); D = 7 and 5: neither (a
# vector of one cell); nb = 5, k = 2 ends on a short chunk.
CHUNK_CASES = {
    "wide": ((20, 21, 22), 0, 8, 3, 5, 2),
    "pitched": ((13, 30, 22), 5, 7, 4, 3, 3),
    "narrow": ((11, 12, 13), 0, 5, 6, 4, 4),
    "planes": ((17, 16, 15), 3, 12, 2, 5, 2),
}


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_extract_chunk_on_the_host_matches_plain(lib, case, dt):
    """The extract, a chunk of k batches a launch, bit for bit against
    extract_chunk_ref (each batch's extract_boxes_ref) with one channel and
    with three: every chunk of the trace, the short last one too, with the
    blocks in either order, on a frame that is a view with padded rows."""
    from pyc2ray_torch.ops.trace_loop import extract_chunk_ref
    shape, pad, D, B, nb, k = CHUNK_CASES[case]
    rng = np.random.RandomState(sum(shape) + D)
    pos = torch.from_numpy(rng.randint(0, np.array(shape) - D + 1,
                                       size=(nb, B, 3)).astype(np.int32))
    fn = lib.rehearse_extract_f32 if dt == torch.float32 else \
        lib.rehearse_extract_f64
    ptrs = ctypes.c_void_p * 4
    wide = [torch.from_numpy(rng.standard_normal(
        shape[:2] + (shape[2] + pad,))).to(dt) for _ in range(3)]
    frames = [w[:, :, :shape[2]] for w in wide]
    S0, S1 = frames[0].stride(0), frames[0].stride(1)
    for n in (1, 3):
        for reverse in (0, 1):
            for k0 in range(0, nb, k):
                kk = min(k, nb - k0)
                got = [torch.full((kk, B, D, D, D), float("nan"), dtype=dt)
                       for _ in range(n)]
                fn(ptrs(*[f.data_ptr() for f in frames[:n]]),
                   ptrs(*[g.data_ptr() for g in got]), n, pos.data_ptr(),
                   k0, kk, B, D, S0, S1, reverse)
                for f, g in zip(frames, got):
                    want = extract_chunk_ref(f, pos, k0, kk, D)
                    assert torch.equal(g, want), (n, reverse, k0)
