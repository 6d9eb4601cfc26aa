"""The dense spectral-bin rate pass of the unfused sweep modes.

``rates_dense`` evaluates, per cell of the central (Ds)^3 rates subbox of B
(Dc)^3 boxes (at offset rb0 on every axis), the photoionization rate Gamma
and, with the heating weights, the photoheating rate, from the coldensh_out
boxes of the sweep (K1 or K2) and the HI density boxes:

    dcol = nHI (path3 dr),  cdin = cd - dcol
    phi  = (flux S*/dr^3) geominv sum_e w_e core_e / max(nHI, tiny)
    core_e = exp(-cdin sig s_e) (-expm1(-dcol sig s_e)),

0 where the cell is not valid (the rates table's third channel) or cdin
exceeds MAX_COLDENSH. It is the counterpart of the JAX engine's
ChebRaytracer._rates (pyc2ray_tpu/ops/raytrace_cheb.py), which XLA fuses;
``rates_dense_ref`` is that function in PyTorch, op by op, and it rebuilds
cdin = cd - dcol as the JAX engine does (with its float32 cancellation at
thick cells, ROADMAP §3).

``rates_dense`` runs the plain version for a CPU tensor and the kernel of
csrc/cheb_rates.cu for a CUDA tensor (one launch, counted in
``sweep.launches["rates_dense"]``), or raises. The kernel evaluates only
the rated cells of the subbox, the list ``rated_cells`` makes of the
table's valid channel once per engine (``ChebRaytracer.rated_cells``), and
leaves every other cell at the 0 its zeroed output starts from. It is
bit-equal to the plain version on the card: every operation in its type
and order, the scalars ``dr``, ``sig`` and ``sdr3`` = S*/dr^3 handed to
both as the same floats (``sweep.s_over_dr3``), each rounded to the type
once.
"""

import ctypes

import torch

from ..constants import MAX_COLDENSH
from . import sweep

__all__ = ["rated_cells", "rates_dense", "rates_dense_ref"]


def rated_cells(rt_sub):
    """The cells of the (Ds)^3 rates subbox that the table ``rt_sub`` (3,
    Ds, Ds, Ds) rates (its valid channel > 0.5), as int32 row-major indices
    in ascending order on ``rt_sub``'s device: what ``rates_dense``'s kernel
    evaluates. On the card this waits for the device once (the list's
    length): make it once, outside any loop, as the engine does."""
    valid = rt_sub[2].reshape(-1) > 0.5
    return torch.nonzero(valid).reshape(-1).to(torch.int32)


def rates_dense_ref(cd, nhi_box, rt_sub, flux, bins_s, bins_w, dr, sig, sdr3,
                    rb0, bins_wh=None):
    """Plain version of ``rates_dense``: ``cd`` and ``nhi_box`` (B, Dc, Dc,
    Dc), ``rt_sub`` (3, Ds, Ds, Ds) with channels (path3, geominv, valid),
    ``flux`` (B,), the bins (E,); ``dr``, ``sig`` and ``sdr3`` floats.
    Returns (phi, heat) of shape (B, Ds, Ds, Ds), heat None without
    ``bins_wh``. The scalars enter as 0-dim CPU tensors of the type, which
    ATen hands to a CUDA kernel as arguments: the pass copies nothing to the
    device."""
    dt = cd.dtype
    dr, sig, sdr3, max_cd = (torch.tensor(float(v), dtype=dt)
                             for v in (dr, sig, sdr3, MAX_COLDENSH))
    Ds = rt_sub.shape[-1]
    sub = (slice(None),) + (slice(rb0, rb0 + Ds),) * 3
    cd = cd[sub]
    nhi_box = nhi_box[sub]
    path3, geominv = rt_sub[0], rt_sub[1]
    dcol = nhi_box * (path3[None] * dr)
    cdin = cd - dcol
    tau_in = cdin * sig
    dtau = dcol * sig
    prefact = flux[:, None, None, None] * sdr3 * geominv[None]

    acc = torch.zeros_like(cd)
    acc_h = None if bins_wh is None else torch.zeros_like(cd)
    for e in range(bins_s.shape[0]):
        se = bins_s[e]
        core = torch.exp(-tau_in * se) * (-torch.expm1(-dtau * se))
        acc = acc + bins_w[e] * core
        if bins_wh is not None:
            acc_h = acc_h + bins_wh[e] * core

    mask = (rt_sub[2] > 0.5)[None] & (cdin <= max_cd)
    # Guard the photon-conserving division: a zero-density cell absorbs
    # nothing (acc = 0), so Gamma-per-atom is 0, not 0/0. The floor is the
    # smallest normal float, a no-op for any physical density.
    nhi_safe = torch.clamp(nhi_box, min=torch.finfo(dt).tiny)
    zero = torch.zeros_like(acc)
    phi = torch.where(mask, prefact * acc / nhi_safe, zero)
    heat = (None if bins_wh is None
            else torch.where(mask, prefact * acc_h / nhi_safe, zero))
    return phi, heat


def rates_dense(cd, nhi_box, rt_sub, flux, bins_s, bins_w, dr, sig, sdr3,
                rb0, bins_wh=None, cells=None):
    """The rate pass on the device of ``cd`` (arguments as
    ``rates_dense_ref``): the plain version for a CPU tensor, one launch of
    the kernel for a CUDA tensor, which returns the same bits. The kernel
    needs ``cells``, the rated cells of ``rt_sub`` (``rated_cells``; an
    engine's ``rated_cells``), int32 on the card; the plain version takes
    no list."""
    if cd.device.type == "cpu":
        return rates_dense_ref(cd, nhi_box, rt_sub, flux, bins_s, bins_w, dr,
                               sig, sdr3, rb0, bins_wh)
    dt = cd.dtype
    B, Dc, Ds, E = cd.shape[0], cd.shape[-1], rt_sub.shape[-1], bins_s.shape[0]
    if not 0 <= rb0 <= Dc - Ds:
        raise ValueError(f"rates_dense: a rates subbox of {Ds} at {rb0} "
                         f"leaves the box {Dc}")
    spec = {"nhi_box": (nhi_box, (B, Dc, Dc, Dc), dt),
            "rt_sub": (rt_sub, (3, Ds, Ds, Ds), dt),
            "flux": (flux, (B,), dt),
            "bins_s": (bins_s, (E,), dt), "bins_w": (bins_w, (E,), dt)}
    if bins_wh is not None:
        spec["bins_wh"] = (bins_wh, (E,), dt)
    if cells is not None:
        spec["cells"] = (cells, (cells.numel(),), torch.int32)
    sfx = sweep._check("rates_dense", cd, spec)
    if cells is None or cells.numel() > Ds ** 3:
        raise ValueError("rates_dense: the kernel needs the rated cells of "
                         "rt_sub (rated_cells), a list of at most Ds^3")
    n_valid = cells.numel()
    from ._build import load
    lib = load("cheb_rates")
    phi = torch.zeros((B, Ds, Ds, Ds), dtype=dt, device=cd.device)
    heat = None if bins_wh is None else torch.zeros_like(phi)
    ptr = sweep._ptr
    stream = torch.cuda.current_stream(cd.device).cuda_stream
    err = getattr(lib, f"rates_dense_{sfx}")(
        ptr(cd), ptr(nhi_box), ptr(rt_sub), ptr(cells), ptr(flux),
        ptr(bins_s), ptr(bins_w),
        ctypes.c_void_p(None if heat is None else bins_wh.data_ptr()),
        ptr(phi), ctypes.c_void_p(None if heat is None else heat.data_ptr()),
        B, E, Dc, Ds, rb0, n_valid, float(dr), float(sig), float(sdr3),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"rates_dense kernel launch failed: CUDA error "
                           f"{err} ({lib.error_string(err)!r})")
    sweep.launches["rates_dense"] += 1
    return phi, heat
