"""The Chebyshev-face sweep kernels and their plain versions.

Counterparts of the TPU kernels of pyc2ray_tpu/ops/pallas_sweep.py. For a
batch of B sources, each with its (Dc, Dc, Dc) box of HI density centred
at box index c, the sweep runs sequentially over the cube shells
r = 1..R1-1. Each shell updates its x faces, then its y faces, then its z
faces; a face cell interpolates the incoming column density cdin from four
cells of the parallel plane at distance r-1 (with line stitches from the
other faces, see ``_sweep_shells``) and adds its own dcol = nHI * path * dr.

  ``cheb_sweep``        K1: the cartesian box of outgoing column densities
                        (coldensh_out), source cell nHI_c * dr / 2 — the box
                        the JAX engine assembles from the kernel's face
                        stacks in _fold_stacks_packed. With ``bins`` (K1f,
                        fuse_rates) the box holds the flux-less Gamma of
                        every face cell instead, source cell 0.
  ``cheb_sweep_seg``    K2: shells r0 .. r0+S-1 from carried planes
                        (shell_segment).
  ``cheb_sweep_rates``  K3: sweep, box assembly and the spectral-bin rate
                        pass with the flux, source cell 0 (fuse_fold). With
                        ``bins_wh`` (K3h) also the photoheating box, from
                        the same per-bin attenuation factors.

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain PyTorch version (``*_ref``); a CUDA tensor launches the kernel of
csrc/ or raises. ``launches`` counts the kernel launches per kernel.

On the card every sweep is launched as thread-block clusters, one cluster
of C blocks per source. ``sweep_plan`` is the host rule that picks C and
where the shell planes live (the cluster's distributed shared memory, or a
global scratch); ``last_plan`` keeps the plan of each kernel's last launch and ``occupancy``
what cudaOccupancyMaxActiveClusters answered for every plan it was asked.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..constants import MAX_COLDENSH, S_STAR_REF

__all__ = ["cheb_sweep", "cheb_sweep_ref", "cheb_sweep_seg",
           "cheb_sweep_seg_ref", "cheb_sweep_rates", "cheb_sweep_rates_ref",
           "init_planes", "s_over_dr3", "launches", "reset_launches",
           "SweepPlan", "sweep_plan", "plan_sizes", "last_plan", "occupancy",
           "cluster_barriers"]

LIM = 0.6          # floor of the tau weighting (raytracing.f90 cinterp)
FOURPI = 12.566370614359172463991853874177
THREADS = 512      # threads per block of the sweep kernels, unless forced
SMEM_MAX = 232448  # dynamic shared memory one block may have on sm_90, bytes
CLUSTERS = (16, 8, 4, 2, 1)   # cluster sizes, in the order they are tried
THREADS_RATES = 256   # threads per block of K3's rate phase

# kernel name -> launches since the last reset_launches()
launches = {"cheb_sweep": 0, "cheb_sweep_fused_rates": 0,
            "cheb_sweep_seg": 0, "cheb_sweep_rates": 0,
            "cheb_sweep_rates_heat": 0}


# kernel name -> SweepPlan of its last launch
last_plan = {}
# (entry point, SweepPlan) -> cudaOccupancyMaxActiveClusters for that launch
occupancy = {}
_plans = {}        # the plan chosen per (entry point, shapes, forced parts)


def reset_launches():
    for k in launches:
        launches[k] = 0


class SweepPlan(NamedTuple):
    """How one launch lays the sweep onto the card."""
    cluster: int          # blocks per source (the cluster's size)
    shared_planes: bool   # planes in distributed shared memory, else scratch
    threads: int          # threads per block
    smem: int             # dynamic shared memory per block, bytes
    rows: int             # plane rows per block (0 with the scratch)


def plan_sizes(Dc, itemsize, cluster, shared_planes, head=0):
    """(smem bytes, rows) of a placement; the launch code of
    csrc/cheb_sweep.cuh (make_plan) computes the same and refuses a launch
    that disagrees. Row a of each of the 12 planes lives in block
    a mod cluster, so a block holds ceil(Dc / cluster) rows. ``head``:
    values of the kernel's own at the start of shared memory."""
    rows = -(-Dc // cluster) if shared_planes else 0
    return itemsize * (head + 12 * rows * Dc), rows


def sweep_plan(B, Dc, itemsize, max_active, head=0, cluster=None,
               shared_planes=None, threads=THREADS):
    """The plan of a sweep of B sources with (Dc, Dc, Dc) boxes in a type
    of ``itemsize`` bytes.

    For a cluster size the planes go into the cluster's shared memory
    where they fit SMEM_MAX, else into the global scratch. The cluster size
    is the largest of CLUSTERS of which the card holds B at once, so that
    every source's chain runs from the start, ``max_active(plan)`` being
    cudaOccupancyMaxActiveClusters for that launch; one block per source
    when no size does. ``cluster``, ``shared_planes`` and ``threads`` force
    a part of the plan (a forced placement that does not fit raises)."""
    def place(C):
        for sh in (True, False):
            if shared_planes is not None and sh != bool(shared_planes):
                continue
            smem, rows = plan_sizes(Dc, itemsize, C, sh, head)
            if smem <= SMEM_MAX:
                return SweepPlan(C, sh, int(threads), smem, rows)
        return None

    sizes = CLUSTERS if cluster is None else (int(cluster),)
    if any(C not in CLUSTERS for C in sizes):
        raise ValueError(f"sweep_plan: cluster size {cluster} not in "
                         f"{CLUSTERS}")
    plans = [p for p in map(place, sizes) if p is not None]
    if not plans:
        raise ValueError(
            f"sweep_plan: no placement with cluster={cluster}, "
            f"shared_planes={shared_planes} fits {SMEM_MAX} bytes at "
            f"Dc={Dc}, itemsize={itemsize}")
    for plan in plans:
        if max_active(plan) >= B:
            return plan
    return plans[-1]


def s_over_dr3(dr, dtype):
    """S* / dr^3 as a 0-dim CPU tensor of ``dtype``, computed as the rate
    passes do (exp(log S* - 3 log dr))."""
    dr = torch.as_tensor(dr, dtype=dtype)
    return torch.exp(torch.tensor(np.log(S_STAR_REF), dtype=dtype)
                     - 3.0 * torch.log(dr))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

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
    face pair; sw is (4, Dc, Dc), path/diag (Dc, Dc), mask (2, Dc, Dc).
    Returns (cdin, dcol, out) with out = mask ? cdin + dcol : 0."""
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
    dcol = nhi * (path * dr)
    return cdin, dcol, torch.where(mask, cdin + dcol, torch.zeros_like(cdin))


def init_planes(nhi_box, c, dr):
    """The planes of shell 0, (B, 3, 2, Dc, Dc) as (face, sign): zero, with
    the source cell of every face and sign at nHI_c * dr / 2."""
    B, Dc = nhi_box.shape[0], nhi_box.shape[-1]
    dr = torch.as_tensor(dr, dtype=nhi_box.dtype, device=nhi_box.device)
    planes = torch.zeros((B, 3, 2, Dc, Dc), dtype=nhi_box.dtype,
                         device=nhi_box.device)
    planes[:, :, :, c, c] = (nhi_box[:, c, c, c] * (0.5 * dr))[:, None, None]
    return planes


def _put(box, f, r, c, plane):
    """Add the face-pair plane (B, 2, Dc, Dc) of face f (0 = x, 1 = y,
    2 = z), shell r, at its box planes c -+ r that lie inside the box. The
    planes are masked and face memberships disjoint, so this is a store."""
    Dc = box.shape[-1]
    for s, q in ((0, c - r), (1, c + r)):
        if 0 <= q < Dc:
            box.select(f + 1, q).add_(plane[:, s])


def _sweep_shells(nhi_box, sw, path, diag, mask_m, mask_p, dr, sig, c,
                  planes, r0, r1, emit):
    """Shells r0 .. r1-1 of the sweep from ``planes``, the (B, 3, 2, Dc, Dc)
    planes of shell r0-1. For each face pair calls
    ``emit(f, r, mask, cdin, dcol, nhi, out)`` (planes (B, 2, Dc, Dc), the
    mask (2, Dc, Dc)) and returns the planes of shell r1-1.

    Face planes have the sign (minus, plus) second and the two non-face
    axes in axis order: x faces (j, k), y faces (i, k), z faces (i, j).
    Stencil-plane composition (plane at distance r-1 from the source,
    read by face cells of shell r; alo/ahi = c -+ (r-1); later writes win):
      x: X[r-1]; rows j = alo/ahi from Y[r-1]; cols k = alo/ahi from Z[r-1].
      y: Y[r-1]; cols k = alo/ahi from Z[r-1]; rows i = c-+r from X[r].
      z: Z[r-1]; rows i = c-+r from X[r]; cols j = c-+r from Y[r].
    The rows/cols at c-+r are written only where they lie inside the box
    (a mesh smaller than the box clips it)."""
    Dc = nhi_box.shape[-1]
    Xp, Yp, Zp = planes.unbind(1)
    for r in range(r0, r1):
        alo, ahi = c - r + 1, c + r - 1
        ok_lo, ok_hi = c - r >= 0, c + r <= Dc - 1
        pos = [alo, ahi]                    # stencil-plane index per sign
        lo, hi = max(c - r, 0), min(c + r, Dc - 1)

        def face(f, P, nhi):
            mask = torch.stack([mask_m[f, r], mask_p[f, r]])
            cdin, dcol, out = _face_update(P, nhi, sw[f, :, r], path[f, r],
                                           diag[f, r], mask, dr, sig, c)
            emit(f, r, mask, cdin, dcol, nhi, out)
            return out

        # ---- x faces (plane (j, k)); stencil from X/Y/Z[r-1]
        P = Xp.clone()
        P[:, :, alo, :] = Yp[:, 0, pos, :]
        P[:, :, ahi, :] = Yp[:, 1, pos, :]
        P[:, :, :, alo] = Zp[:, 0, pos, :]
        P[:, :, :, ahi] = Zp[:, 1, pos, :]
        Xn = face(0, P, nhi_box[:, [lo, hi], :, :])

        # ---- y faces (plane (i, k)); stencil Y[r-1] + Z[r-1] + X[r]
        P = Yp.clone()
        P[:, :, :, alo] = Zp[:, 0][:, :, pos].transpose(1, 2)
        P[:, :, :, ahi] = Zp[:, 1][:, :, pos].transpose(1, 2)
        if ok_lo:
            P[:, :, c - r, :] = Xn[:, 0, pos, :]
        if ok_hi:
            P[:, :, c + r, :] = Xn[:, 1, pos, :]
        Yn = face(1, P, nhi_box[:, :, [lo, hi], :].transpose(1, 2))

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
        Zn = face(2, P, nhi_box[:, :, :, [lo, hi]].permute(0, 3, 1, 2))
        Xp, Yp, Zp = Xn, Yn, Zn
    return torch.stack([Xp, Yp, Zp], 1)


def _bin_sum(tau_in, dtau, bins_s, bins_w, bins_wh=None):
    """(acc, acc_h): sum_e w_e core_e and, with ``bins_wh``, sum_e
    w_heat_e core_e (else None) over the same core_e = exp(-tau_in s_e)
    (-expm1(-dtau s_e)), evaluated once per bin."""
    acc = torch.zeros_like(tau_in)
    acc_h = None if bins_wh is None else torch.zeros_like(tau_in)
    for e, (se, we) in enumerate(zip(bins_s, bins_w)):
        core = torch.exp(-tau_in * se) * (-torch.expm1(-dtau * se))
        acc = acc + we * core
        if bins_wh is not None:
            acc_h = acc_h + bins_wh[e] * core
    return acc, acc_h


def _face_d2(d2box, f, r, c):
    """(2, Dc, Dc) squared distances of face f's cells at box planes c -+ r
    (clamped into the box: a plane outside it has no valid cell)."""
    Dc = d2box.shape[-1]
    qs = [min(max(q, 0), Dc - 1) for q in (c - r, c + r)]
    return torch.stack([d2box.select(f, q) for q in qs])


def cheb_sweep_ref(nhi_box, sw, path, diag, mask_m, mask_p, dr, c, sig,
                   bins=None, rt_tab=None, R2=0.0):
    """Plain PyTorch sweep, twin of raytrace_cheb._sweep (K1).

    nhi_box: (B, Dc, Dc, Dc); sw: (3, 4, R1, Dc, Dc); path, diag: (3, R1,
    Dc, Dc); mask_m, mask_p: (3, R1, Dc, Dc) bool (face cell valid on the
    minus / plus face).

    Returns the (B, Dc, Dc, Dc) coldensh_out box: each face plane is stored
    at its box position and the source cell holds nhi_c * dr / 2.

    With ``bins`` = (bins_s, bins_w), the fused-rates mode of the TPU
    kernel (K1f): the box holds the flux-less Gamma of every valid face
    cell, S*/(dr^3 4 pi d2 path max(nHI, tiny)) * sum_e w_e
    exp(-tau_in s_e) (-expm1(-dtau s_e)), masked by d2 <= R2 and
    cdin <= MAX_COLDENSH, and the source cell is 0. d2 is the cell's
    squared distance, channel 0 of ``rt_tab`` ((Dc, 2, Dc, Dc), see
    cheb_geometry.pack_rates_tables) at the cell's cartesian position.
    """
    dt = nhi_box.dtype
    R1 = sw.shape[2]
    dr = torch.as_tensor(dr, dtype=dt, device=nhi_box.device)
    sig = torch.as_tensor(sig, dtype=dt, device=nhi_box.device)
    planes = init_planes(nhi_box, c, dr)
    box = torch.zeros_like(nhi_box)
    if bins is None:
        def emit(f, r, mask, cdin, dcol, nhi, out):
            _put(box, f, r, c, out)
    else:
        bins_s, bins_w = bins
        d2box = rt_tab[:, 0]
        sdr3 = s_over_dr3(dr.cpu(), dt).to(nhi_box.device)
        max_cd = torch.tensor(MAX_COLDENSH, dtype=dt, device=nhi_box.device)
        tiny = torch.finfo(dt).tiny

        def emit(f, r, mask, cdin, dcol, nhi, out):
            d2 = _face_d2(d2box, f, r, c)
            acc, _ = _bin_sum(cdin * sig, dcol * sig, bins_s, bins_w)
            pref = sdr3 / (d2 * path[f, r] * FOURPI)
            ok = mask & (d2 <= R2) & (cdin <= max_cd)
            gam = pref * acc / torch.clamp(nhi, min=tiny)
            _put(box, f, r, c, torch.where(ok, gam, torch.zeros_like(gam)))
    _sweep_shells(nhi_box, sw, path, diag, mask_m, mask_p, dr, sig, c,
                  planes, 1, R1, emit)
    box[:, c, c, c] = planes[:, 0, 0, c, c] if bins is None else 0.0
    return box


def cheb_sweep_seg_ref(nhi_box, sw, path, diag, mask_m, mask_p, dr, c, sig,
                       planes, r0, S, box=None):
    """Plain version of one segment of the shell-segmented sweep (K2).

    Shells r0 .. r0+S-1 (those past r_max = R1-1 are overrun and write
    nothing) from ``planes``, the (B, 3, 2, Dc, Dc) planes of shell r0-1
    (``init_planes`` for r0 = 1). Stores the segment's valid face cells
    into ``box`` (zeros of nhi_box's shape when None; the caller zeroes it
    once and hands it to every segment) and returns (box, the planes of
    the segment's last shell). Chained over r0 = 1, 1+S, ... with the
    source cell set afterwards, it gives ``cheb_sweep_ref``'s box."""
    dt = nhi_box.dtype
    r1 = min(r0 + S, sw.shape[2])
    dr = torch.as_tensor(dr, dtype=dt, device=nhi_box.device)
    sig = torch.as_tensor(sig, dtype=dt, device=nhi_box.device)
    if box is None:
        box = torch.zeros_like(nhi_box)

    def emit(f, r, mask, cdin, dcol, nhi, out):
        _put(box, f, r, c, out)
    planes = _sweep_shells(nhi_box, sw, path, diag, mask_m, mask_p, dr, sig,
                           c, planes, r0, r1, emit)
    return box, planes


def _box_rates(ci, dc, rt_tab, flux, dr, sig, bins_s, bins_w, bins_wh=None):
    """K3's rate phase over whole boxes: phi = flux S* dr / (dr^3 4 pi d2)
    * sum_e w_e exp(-tau_in s_e) (-expm1(-dtau s_e)) / max(dcol, tiny),
    masked by the valid channel of rt_tab and cdin <= MAX_COLDENSH. ``dr``
    is a 0-dim CPU tensor of the boxes' dtype. With ``bins_wh`` returns
    (phi, heat), heat being the same expression with the heating weights
    (K3h)."""
    dt = ci.dtype
    d2, valid = rt_tab[:, 0], rt_tab[:, 1] > 0.5
    s_fac = (s_over_dr3(dr, dt) * dr).to(ci.device)
    acc, acc_h = _bin_sum(ci * sig, dc * sig, bins_s, bins_w, bins_wh)
    pref = (flux[:, None, None, None] * s_fac) / (d2 * FOURPI)
    ok = valid[None] & (ci <= torch.tensor(MAX_COLDENSH, dtype=dt,
                                           device=ci.device))
    dsafe = torch.clamp(dc, min=torch.finfo(dt).tiny)
    zero = torch.zeros_like(acc)
    phi = torch.where(ok, pref * acc / dsafe, zero)
    if bins_wh is None:
        return phi
    return phi, torch.where(ok, pref * acc_h / dsafe, zero)


def cheb_sweep_rates_ref(nhi_box, sw, path, diag, mask_m, mask_p, rt_tab,
                         flux, dr, c, sig, bins_s, bins_w, bins_wh=None):
    """Plain version of the fused sweep + box + rates kernel (K3, and K3h
    with ``bins_wh``).

    Phase A is the sweep, storing the masked cdin and dcol of every face
    cell at its cartesian position; phase B evaluates the spectral-bin
    rates per box cell with the per-source ``flux`` (B,) (``_box_rates``).
    Returns the (B, Dc, Dc, Dc) phi box with the source cell 0, or with
    ``bins_wh`` the pair (phi, heat) of such boxes."""
    dt, dev = nhi_box.dtype, nhi_box.device
    R1 = sw.shape[2]
    dr = torch.as_tensor(dr, dtype=dt)              # on the CPU
    sig = torch.as_tensor(sig, dtype=dt, device=dev)
    ci = torch.zeros_like(nhi_box)
    dc = torch.zeros_like(nhi_box)

    def emit(f, r, mask, cdin, dcol, nhi, out):
        zero = torch.zeros_like(cdin)
        _put(ci, f, r, c, torch.where(mask, cdin, zero))
        _put(dc, f, r, c, torch.where(mask, dcol, zero))
    _sweep_shells(nhi_box, sw, path, diag, mask_m, mask_p, dr.to(dev), sig,
                  c, init_planes(nhi_box, c, dr), 1, R1, emit)
    return _box_rates(ci, dc, rt_tab, flux, dr, sig, bins_s, bins_w, bins_wh)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, nhi_box, tensors):
    """Validate the inputs of a kernel: nhi_box (B, Dc, Dc, Dc) on CUDA in
    float32/float64, and ``tensors`` {name: (tensor, shape, dtype)} on the
    same device, contiguous. Returns the function suffix."""
    if nhi_box.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {nhi_box.device}")
    dt = nhi_box.dtype
    if dt not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dt} (float32 or float64)")
    B, Dc = nhi_box.shape[0], nhi_box.shape[-1]
    if tuple(nhi_box.shape) != (B, Dc, Dc, Dc):
        raise ValueError(f"{name}: nhi_box {tuple(nhi_box.shape)}")
    for tname, (t, shape, tdt) in tensors.items():
        if (tuple(t.shape) != tuple(shape) or t.dtype != tdt
                or t.device != nhi_box.device):
            raise ValueError(
                f"{name}: {tname} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, expected {tuple(shape)} {tdt} on "
                f"{nhi_box.device}")
    if not all(t.is_contiguous() for t in [nhi_box] + [
            v[0] for v in tensors.values()]):
        raise ValueError(f"{name}: inputs must be contiguous")
    return _SUFFIX[dt]


def _geom(nhi_box, sw, path, diag, mask_m, mask_p, c):
    """The shape checks of the sweep tables; returns (B, Dc, R1)."""
    B, Dc = nhi_box.shape[0], nhi_box.shape[-1]
    R1 = sw.shape[2]
    if not 0 <= c < Dc:
        raise ValueError(f"sweep: source index c={c} outside the box {Dc}")
    dt = nhi_box.dtype
    return (B, Dc, R1), {
        "sw": (sw, (3, 4, R1, Dc, Dc), dt),
        "path": (path, (3, R1, Dc, Dc), dt),
        "diag": (diag, (3, R1, Dc, Dc), dt),
        "mask_m": (mask_m, (3, R1, Dc, Dc), torch.bool),
        "mask_p": (mask_p, (3, R1, Dc, Dc), torch.bool)}


def _bins_spec(Dc, bins_s, bins_w, rt_tab, dt):
    """The number of bins E (kept in the kernel's shared memory, 2 E
    values, 3 E with the heating weights) and the shape checks of the rate
    inputs."""
    E = bins_s.shape[0]
    return E, {"rt_tab": (rt_tab, (Dc, 2, Dc, Dc), dt),
               "bins_s": (bins_s, (E,), dt), "bins_w": (bins_w, (E,), dt)}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _launch(lib, fn, name, nhi_box, R1, c, dr, sig, tensors, scalars=(),
            head=0, plan=None):
    """Plan and launch entry point ``fn`` of ``lib`` for the sweep of
    ``nhi_box``: ``tensors`` are its pointer arguments up to the scratch
    (None for a null pointer), ``scalars`` those between the scratch and
    the launch arguments, ``head`` the kernel's own values at the start of
    shared memory, ``plan`` a dict of forced parts of the plan (see
    ``sweep_plan``). The plan is made once per shape. Raises when the card
    refuses the launch; counts it otherwise."""
    B, Dc = nhi_box.shape[0], nhi_box.shape[-1]
    dt, dev = nhi_box.dtype, nhi_box.device
    call = getattr(lib, fn)
    ptrs = [ctypes.c_void_p(None) if t is None else _ptr(t) for t in tensors]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def invoke(p, scratch, query):
        err = call(*ptrs, scratch, *scalars, B, Dc, c, R1, float(dr),
                   float(sig), p.threads, p.cluster, int(p.shared_planes),
                   p.smem, query, stream)
        if err != 0:
            raise RuntimeError(
                f"{name} kernel launch failed: CUDA error {err} "
                f"({lib.error_string(err)!r}) with {p}")

    def max_active(p):
        n = ctypes.c_int(0)
        invoke(p, ctypes.c_void_p(None), ctypes.byref(n))
        occupancy[fn, p] = n.value
        return n.value

    forced = tuple(sorted((plan or {}).items()))
    key = (fn, B, Dc, head, dev, forced)
    if key not in _plans:
        _plans[key] = sweep_plan(B, Dc, dt.itemsize, max_active, head,
                                 **dict(forced))
    p = _plans[key]
    # without shared planes: two parities x three faces x two signs of
    # (Dc, Dc) planes per source, zeroed by the kernel
    scratch = None if p.shared_planes else torch.empty(
        (B, 12, Dc, Dc), dtype=dt, device=dev)
    invoke(p, ctypes.c_void_p(None) if scratch is None else _ptr(scratch),
           None)
    launches[name] += 1
    last_plan[name] = p


def cluster_barriers(B, cluster, n, device="cuda"):
    """Launch B clusters of ``cluster`` blocks that do nothing but ``n``
    cluster barriers: timed, the least cost of one sub-step of the sweep's
    chain. Not counted in ``launches``."""
    from ._build import load
    lib = load("cheb_sweep")
    stream = torch.cuda.current_stream(torch.device(device)).cuda_stream
    err = lib.cheb_cluster_barriers(B, THREADS, cluster, n,
                                    ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cluster_barriers launch failed: CUDA error "
                           f"{err} ({lib.error_string(err)!r})")


def cheb_sweep(nhi_box, sw, path, diag, mask_m, mask_p, dr, c, sig,
               bins=None, rt_tab=None, R2=0.0, plan=None):
    """The sweep on the device of ``nhi_box`` (see ``cheb_sweep_ref`` for
    the arguments): the plain version for a CPU tensor, the CUDA kernel
    (K1, or K1f with ``bins``) for a CUDA tensor. ``dr``, ``sig`` and
    ``R2`` are floats. ``plan`` forces parts of the kernel's launch plan
    (a dict of ``sweep_plan``'s cluster, shared_planes, threads)."""
    if nhi_box.device.type == "cpu":
        return cheb_sweep_ref(nhi_box, sw, path, diag, mask_m, mask_p, dr,
                              c, sig, bins=bins, rt_tab=rt_tab, R2=R2)
    (B, Dc, R1), spec = _geom(nhi_box, sw, path, diag, mask_m, mask_p, c)
    dt = nhi_box.dtype
    if bins is not None:
        E, more = _bins_spec(Dc, bins[0], bins[1], rt_tab, dt)
        spec.update(more)
    sfx = _check("cheb_sweep", nhi_box, spec)
    from ._build import load
    lib = load("cheb_sweep")
    box = torch.empty_like(nhi_box)
    geo = (nhi_box, sw, path, diag, mask_m, mask_p)
    if bins is None:
        _launch(lib, f"cheb_sweep_{sfx}", "cheb_sweep", nhi_box, R1, c, dr,
                sig, (*geo, box), plan=plan)
    else:
        sdr3 = float(s_over_dr3(float(dr), dt))
        _launch(lib, f"cheb_sweep_gamma_{sfx}", "cheb_sweep_fused_rates",
                nhi_box, R1, c, dr, sig, (*geo, rt_tab, bins[0], bins[1], box),
                (E, float(R2), sdr3), head=2 * E, plan=plan)
    return box


def cheb_sweep_seg(nhi_box, sw, path, diag, mask_m, mask_p, dr, c, sig,
                   planes, r0, S, box=None, plan=None):
    """One segment of the shell-segmented sweep on the device of
    ``nhi_box`` (see ``cheb_sweep_seg_ref``): the plain version for a CPU
    tensor, the CUDA kernel (K2) for a CUDA tensor. Returns (box, planes);
    ``box`` is updated in place when given. ``plan`` as in ``cheb_sweep``."""
    if nhi_box.device.type == "cpu":
        return cheb_sweep_seg_ref(nhi_box, sw, path, diag, mask_m, mask_p,
                                  dr, c, sig, planes, r0, S, box)
    (B, Dc, R1), spec = _geom(nhi_box, sw, path, diag, mask_m, mask_p, c)
    dt = nhi_box.dtype
    if box is None:
        box = torch.zeros_like(nhi_box)
    if not 1 <= r0 < R1 or S < 1:
        raise ValueError(f"cheb_sweep_seg: r0={r0}, S={S} (1 <= r0 < {R1})")
    spec["planes"] = (planes, (B, 3, 2, Dc, Dc), dt)
    spec["box"] = (box, (B, Dc, Dc, Dc), dt)
    sfx = _check("cheb_sweep_seg", nhi_box, spec)
    from ._build import load
    lib = load("cheb_sweep")
    out = torch.empty_like(planes)
    _launch(lib, f"cheb_sweep_seg_{sfx}", "cheb_sweep_seg", nhi_box, R1, c,
            dr, sig, (nhi_box, sw, path, diag, mask_m, mask_p, planes, out,
                      box), (r0, min(r0 + S, R1)), plan=plan)
    return box, out


def cheb_sweep_rates(nhi_box, sw, path, diag, mask_m, mask_p, rt_tab, flux,
                     dr, c, sig, bins_s, bins_w, bins_wh=None):
    """The fused sweep + box + rates on the device of ``nhi_box`` (see
    ``cheb_sweep_rates_ref``): the plain version for a CPU tensor, the CUDA
    kernel (two __global__ launches on the stream, the first as clusters
    like K1, counted as one) for a CUDA tensor: K3, counted as
    "cheb_sweep_rates", or with ``bins_wh`` K3h, counted as
    "cheb_sweep_rates_heat", which returns (phi, heat). ``dr`` and ``sig``
    are floats."""
    if nhi_box.device.type == "cpu":
        return cheb_sweep_rates_ref(nhi_box, sw, path, diag, mask_m, mask_p,
                                    rt_tab, flux, dr, c, sig, bins_s, bins_w,
                                    bins_wh)
    (B, Dc, R1), spec = _geom(nhi_box, sw, path, diag, mask_m, mask_p, c)
    dt = nhi_box.dtype
    E, more = _bins_spec(Dc, bins_s, bins_w, rt_tab, dt)
    spec.update(more)
    spec["flux"] = (flux, (B,), dt)
    heat = None
    if bins_wh is not None:
        spec["bins_wh"] = (bins_wh, (E,), dt)
        heat = torch.empty_like(nhi_box)
    name = "cheb_sweep_rates" if heat is None else "cheb_sweep_rates_heat"
    sfx = _check(name, nhi_box, spec)
    from ._build import load
    lib = load("cheb_sweep_rates")
    phi = torch.empty_like(nhi_box)
    ci = torch.empty_like(nhi_box)        # phase A's cdin and dcol boxes
    dc = torch.empty_like(nhi_box)
    dr_t = torch.tensor(float(dr), dtype=dt)
    s_fac = float(s_over_dr3(dr_t, dt) * dr_t)     # as in _box_rates
    _launch(lib, f"cheb_sweep_rates_{sfx}", name, nhi_box, R1, c, dr, sig,
            (nhi_box, sw, path, diag, mask_m, mask_p, rt_tab, bins_s, bins_w,
             bins_wh, flux, phi, heat, ci, dc), (E, s_fac, THREADS_RATES))
    return phi if heat is None else (phi, heat)
