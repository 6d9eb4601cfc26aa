"""The Chebyshev-face column-density sweep: CUDA kernel and plain version.

Counterpart of pyc2ray_tpu/ops/pallas_sweep.py::cheb_sweep_pallas (K1).
For a batch of B sources, each with its (Dc, Dc, Dc) box of HI density
centred at box index c, the sweep runs sequentially over the cube shells
r = 1..R1-1. Each shell updates its x faces, then its y faces, then its z
faces; a face cell interpolates the incoming column density from four
cells of the parallel plane at distance r-1 (with line stitches from the
other faces, see ``cheb_sweep_ref``) and adds its own nHI * path * dr.

The result is the cartesian box of outgoing column densities
(coldensh_out) with the source cell set to nHI_c * dr / 2 — the box the JAX
engine assembles from the kernel's face stacks in _fold_stacks_packed.

``cheb_sweep`` dispatches on the device of its input: a CPU tensor runs
``cheb_sweep_ref``; a CUDA tensor launches the kernel of
csrc/cheb_sweep.cu or raises. ``launches`` counts the kernel launches.
"""

import ctypes

import torch

__all__ = ["cheb_sweep", "cheb_sweep_ref", "launches", "reset_launches"]

LIM = 0.6          # floor of the tau weighting (raytracing.f90 cinterp)
THREADS = 512      # threads per block of the CUDA kernel

launches = 0


def reset_launches():
    global launches
    launches = 0


def _shift(P, dim, c):
    """One-cell shift toward the source along ``dim``: index a >= c reads
    a-1, a < c reads a+1, with the edge rows replicated."""
    n = P.shape[dim]
    up = torch.cat([P.narrow(dim, 0, 1), P.narrow(dim, 0, n - 1)], dim)
    dn = torch.cat([P.narrow(dim, 1, n - 1), P.narrow(dim, n - 1, 1)], dim)
    shape = [1] * P.dim()
    shape[dim] = n
    a_up = (torch.arange(n, device=P.device) >= c).reshape(shape)
    return torch.where(a_up, up, dn)


def _face_update(P, nhi, sw, path, diag, mask, dr, sig, c):
    """Interpolate the stencil planes P (B, 2, Dc, Dc) and advance one
    face pair; sw is (4, Dc, Dc), path/diag (Dc, Dc), mask (2, Dc, Dc)."""
    Pa = _shift(P, 2, c)
    Pb = _shift(P, 3, c)
    Pab = _shift(Pa, 3, c)
    lim = torch.tensor(LIM, dtype=P.dtype, device=P.device)
    w1 = sw[0] / torch.maximum(lim, Pab * sig)
    w2 = sw[1] / torch.maximum(lim, Pb * sig)
    w3 = sw[2] / torch.maximum(lim, Pa * sig)
    w4 = sw[3] / torch.maximum(lim, P * sig)
    cdin = diag * (Pab * w1 + Pb * w2 + Pa * w3 + P * w4) \
        / (w1 + w2 + w3 + w4)
    cdout = cdin + nhi * (path * dr)
    return torch.where(mask, cdout, torch.zeros_like(cdout))


def cheb_sweep_ref(nhi_box, sw, path, diag, mask_m, mask_p, dr, c, sig):
    """Plain PyTorch sweep, twin of raytrace_cheb._sweep.

    nhi_box: (B, Dc, Dc, Dc); sw: (3, 4, R1, Dc, Dc); path, diag: (3, R1,
    Dc, Dc); mask_m, mask_p: (3, R1, Dc, Dc) bool (face cell valid on the
    minus / plus face). Face planes are (B, 2, Dc, Dc) with the sign
    (minus, plus) second and the two non-face axes in axis order: x faces
    (j, k), y faces (i, k), z faces (i, j).

    Stencil-plane composition (plane at distance r-1 from the source,
    read by face cells of shell r; alo/ahi = c -+ (r-1); later writes win):
      x: X[r-1]; rows j = alo/ahi from Y[r-1]; cols k = alo/ahi from Z[r-1].
      y: Y[r-1]; cols k = alo/ahi from Z[r-1]; rows i = c-+r from X[r].
      z: Z[r-1]; rows i = c-+r from X[r]; cols j = c-+r from Y[r].
    The rows/cols at c-+r are written only where they lie inside the box
    (a mesh smaller than the box clips it).

    Returns the (B, Dc, Dc, Dc) coldensh_out box: each face plane is added
    at its box position (face memberships are disjoint, so this is the
    fold of the face stacks) and the source cell holds nhi_c * dr / 2.
    """
    dt, dev = nhi_box.dtype, nhi_box.device
    B, Dc = nhi_box.shape[0], nhi_box.shape[-1]
    R1 = sw.shape[2]
    dr = torch.as_tensor(dr, dtype=dt, device=dev)
    sig = torch.as_tensor(sig, dtype=dt, device=dev)
    src_cd = nhi_box[:, c, c, c] * (0.5 * dr)
    init = torch.zeros((B, 2, Dc, Dc), dtype=dt, device=dev)
    init[:, :, c, c] = src_cd[:, None]
    Xp, Yp, Zp = init, init, init
    box = torch.zeros_like(nhi_box)
    for r in range(1, R1):
        alo, ahi = c - r + 1, c + r - 1
        ok_lo, ok_hi = c - r >= 0, c + r <= Dc - 1
        pos = [alo, ahi]                    # stencil-plane index per sign
        lo, hi = max(c - r, 0), min(c + r, Dc - 1)

        def geom(f):
            mask = torch.stack([mask_m[f, r], mask_p[f, r]])
            return sw[f, :, r], path[f, r], diag[f, r], mask

        # ---- x faces (plane (j, k)); stencil from X/Y/Z[r-1]
        P = Xp.clone()
        P[:, :, alo, :] = Yp[:, 0, pos, :]
        P[:, :, ahi, :] = Yp[:, 1, pos, :]
        P[:, :, :, alo] = Zp[:, 0, pos, :]
        P[:, :, :, ahi] = Zp[:, 1, pos, :]
        nhi = nhi_box[:, [lo, hi], :, :]
        Xn = _face_update(P, nhi, *geom(0), dr, sig, c)

        # ---- y faces (plane (i, k)); stencil Y[r-1] + Z[r-1] + X[r]
        P = Yp.clone()
        P[:, :, :, alo] = Zp[:, 0][:, :, pos].transpose(1, 2)
        P[:, :, :, ahi] = Zp[:, 1][:, :, pos].transpose(1, 2)
        if ok_lo:
            P[:, :, c - r, :] = Xn[:, 0, pos, :]
        if ok_hi:
            P[:, :, c + r, :] = Xn[:, 1, pos, :]
        nhi = nhi_box[:, :, [lo, hi], :].transpose(1, 2)
        Yn = _face_update(P, nhi, *geom(1), dr, sig, c)

        # ---- z faces (plane (i, j)); stencil Z[r-1] + X[r] + Y[r]
        P = Zp.clone()
        if ok_lo:
            P[:, :, c - r, :] = Xn[:, 0][:, :, pos].transpose(1, 2)
        if ok_hi:
            P[:, :, c + r, :] = Xn[:, 1][:, :, pos].transpose(1, 2)
        if ok_lo:
            P[:, :, :, c - r] = Yn[:, 0][:, :, pos].transpose(1, 2)
        if ok_hi:
            P[:, :, :, c + r] = Yn[:, 1][:, :, pos].transpose(1, 2)
        nhi = nhi_box[:, :, :, [lo, hi]].permute(0, 3, 1, 2)
        Zn = _face_update(P, nhi, *geom(2), dr, sig, c)

        if ok_lo:
            box[:, c - r, :, :] += Xn[:, 0]
            box[:, :, c - r, :] += Yn[:, 0]
            box[:, :, :, c - r] += Zn[:, 0]
        if ok_hi:
            box[:, c + r, :, :] += Xn[:, 1]
            box[:, :, c + r, :] += Yn[:, 1]
            box[:, :, :, c + r] += Zn[:, 1]
        Xp, Yp, Zp = Xn, Yn, Zn
    box[:, c, c, c] = src_cd
    return box


_FN = {torch.float32: "cheb_sweep_f32", torch.float64: "cheb_sweep_f64"}


def cheb_sweep(nhi_box, sw, path, diag, mask_m, mask_p, dr, c, sig):
    """The sweep on the device of ``nhi_box`` (see ``cheb_sweep_ref`` for
    the arguments): the plain version for a CPU tensor, the CUDA kernel for
    a CUDA tensor. ``dr`` and ``sig`` are floats."""
    if nhi_box.device.type == "cpu":
        return cheb_sweep_ref(nhi_box, sw, path, diag, mask_m, mask_p, dr,
                              c, sig)
    if nhi_box.device.type != "cuda":
        raise ValueError(f"cheb_sweep: unsupported device {nhi_box.device}")
    dt = nhi_box.dtype
    if dt not in _FN:
        raise TypeError(f"cheb_sweep: dtype {dt} (float32 or float64)")
    B, Dc = nhi_box.shape[0], nhi_box.shape[-1]
    R1 = sw.shape[2]
    if nhi_box.shape != (B, Dc, Dc, Dc) or not 0 <= c < Dc:
        raise ValueError(f"cheb_sweep: nhi_box {tuple(nhi_box.shape)}, c={c}")
    expect = {"sw": (sw, (3, 4, R1, Dc, Dc), dt),
              "path": (path, (3, R1, Dc, Dc), dt),
              "diag": (diag, (3, R1, Dc, Dc), dt),
              "mask_m": (mask_m, (3, R1, Dc, Dc), torch.bool),
              "mask_p": (mask_p, (3, R1, Dc, Dc), torch.bool)}
    for name, (t, shape, tdt) in expect.items():
        if (tuple(t.shape) != shape or t.dtype != tdt
                or t.device != nhi_box.device):
            raise ValueError(
                f"cheb_sweep: {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, expected {shape} {tdt} on {nhi_box.device}")
    tensors = [nhi_box, sw, path, diag, mask_m, mask_p]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cheb_sweep: inputs must be contiguous")
    from ._build import load
    lib = load()
    box = torch.empty_like(nhi_box)
    # per block: two parities x three faces x two signs of (Dc, Dc) planes
    scratch = torch.empty((B, 12, Dc, Dc), dtype=dt, device=nhi_box.device)
    stream = torch.cuda.current_stream(nhi_box.device).cuda_stream
    fn = getattr(lib, _FN[dt])
    err = fn(*[ctypes.c_void_p(t.data_ptr()) for t in tensors],
             ctypes.c_void_p(box.data_ptr()),
             ctypes.c_void_p(scratch.data_ptr()),
             B, Dc, c, R1, float(dr), float(sig), THREADS,
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cheb_sweep kernel launch failed: CUDA error "
                           f"{err} ({lib.cheb_sweep_error_string(err)!r})")
    global launches
    launches += 1
    return box
