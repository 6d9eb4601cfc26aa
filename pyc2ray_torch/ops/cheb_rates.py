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

``rates_he`` is the helium engine's three-species pass (HI, HeI, HeII),
the counterpart of the JAX engine's HeRaytracer._rates_he
(pyc2ray_tpu/ops/raytrace_he.py), which XLA runs as einsums around an
exp/expm1 block. Per rated cell of the subbox and bin e, with se, w_se and
wh_se the engine's (3, E) bin tables (``raytrace_he.HeBinTables``):

    dcol_s = n_s (path3 dr),  cdin_s = cd_s - dcol_s
    inv_e  = exp(-sum_s cdin_s se[s, e]) (-expm1(-dtau_e)) / max(dtau_e, tiny),
             dtau_e = sum_s dcol_s se[s, e]
    G_s    = (flux S*/dr^3) geominv dcol_s sum_e inv_e w_se[s, e]
             / max(n_s, tiny)
    heat   = (flux S*/dr^3) geominv sum_s dcol_s sum_e inv_e wh_se[s, e]
             / max(n_HI, tiny)

0 where the cell is not valid, cdin_HI exceeds MAX_COLDENSH or n_s <= 0
(the heat where G_HI is), tiny the JAX engine's (``HE_TINY``).
``rates_he_ref`` evaluates that op by op at the rated cells in the
kernel's order: the bins one after the other, each with the terms of the
species that have one there (``he_first_bins``: a species has a term from
the first bin at which its se, w_se or wh_se is not 0; a term left out is
c 0 with c finite, which leaves every sum's bits as they are), each
species sum in the order HI, HeI, HeII. ``rates_he`` runs it for a CPU
tensor and the kernel of csrc/cheb_rates_he.cuh for a CUDA tensor (one
launch, counted in ``sweep.launches["rates_he"]``), bit-equal to it on the
card. The kernel takes the bins by band as ``he_bands`` packs them, once
per engine (``raytrace_he.HeBinTables.bands``).
"""

import ctypes
from typing import NamedTuple

import torch

from ..constants import MAX_COLDENSH
from . import sweep

__all__ = ["HeBands", "he_bands", "he_first_bins", "rated_cells",
           "rates_dense", "rates_dense_ref", "rates_he", "rates_he_ref"]

# the floor of the helium pass's dtau and densities, the JAX engine's
HE_TINY = {torch.float32: 1e-30, torch.float64: 1e-280}


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


def _listed(cells, rt_sub, rb0, Dc):
    """The listed cells ``cells`` of the (Ds)^3 subbox as int64 subbox
    indices and their flat offsets in a (Dc)^3 box with the subbox at
    ``rb0``."""
    Ds = rt_sub.shape[-1]
    idx = cells.to(rt_sub.device, torch.long)
    i = idx // (Ds * Ds)
    jk = idx - i * (Ds * Ds)
    j = jk // Ds
    return idx, ((i + rb0) * Dc + j + rb0) * Dc + (jk - j * Ds) + rb0


def he_first_bins(se, w_se, wh_se=None):
    """The first bin at which each species (HI, HeI, HeII) of the (3, E)
    tables has a non-zero se, w_se or (given) wh_se, E where it has none:
    from there on the helium rate pass gives the species a term in every
    bin, in the plain version and in the kernel (``he_bands``) alike."""
    tabs = [se, w_se] + ([] if wh_se is None else [wh_se])
    nz = torch.stack([t != 0 for t in tabs]).any(0).cpu()
    E = nz.shape[1]
    return [int(torch.nonzero(r)[0]) if bool(r.any()) else E for r in nz]


# bins a thread of the helium kernel has in flight (kHeUnroll of
# csrc/cheb_rates_he.cuh): a band's records are padded to a multiple
HE_UNROLL = 2


class HeBands(NamedTuple):
    """The helium rate kernel's bins by band (``he_bands``)."""
    head: torch.Tensor      # (17,) int32 on the host, kHeHead of the kernel
    rec: torch.Tensor       # the records, on the tables' device


def he_bands(se, w_se, wh_se=None):
    """The (3, E) tables ``se``, ``w_se`` and (given) ``wh_se`` by band, as
    the helium rate kernel takes them: band j (0, 1, 2) holds the bins
    from the (j + 1)-th species' first bin (``he_first_bins``, the species
    in that order) to the next species', with the terms of the j + 1 first
    species. Each bin is one record: the se, then the w_se and wh_se of the
    band's species in ascending order, padded with zeros to whole 16-byte
    vectors; each band is padded with records of zeros to a multiple of
    HE_UNROLL. ``head``: whether the records hold wh_se, their values in
    all, then per band its passes of HE_UNROLL records, the offset of its
    first record and its species (three slots)."""
    first = he_first_bins(se, w_se, wh_se)
    tabs = [t.cpu() for t in (se, w_se, wh_se) if t is not None]
    E, vec = se.shape[1], 16 // se.element_size()
    order = sorted(range(3), key=lambda s: (first[s], s))
    iters, offs, species, recs = [], [], [], []
    n_rec = 0
    for j in range(3):
        lo = min(first[order[j]], E)
        hi = min(first[order[j + 1]], E) if j < 2 else E
        sp = sorted(order[:j + 1])
        n = -(-(hi - lo) // HE_UNROLL) * HE_UNROLL
        rec = torch.zeros((n, -(-len(tabs) * (j + 1) // vec) * vec),
                          dtype=se.dtype)
        rec[:hi - lo, :len(tabs) * (j + 1)] = torch.cat(
            [t[sp, lo:hi].T for t in tabs], 1)
        iters.append(n // HE_UNROLL)
        offs.append(n_rec)
        species += sp + [0] * (2 - j)
        recs.append(rec.reshape(-1))
        n_rec += rec.numel()
    head = [int(wh_se is not None), n_rec] + iters + offs + species
    return HeBands(torch.tensor(head, dtype=torch.int32),
                   torch.cat(recs).to(se.device))


def rates_he_ref(cds, nboxes, rt_sub, flux, se, w_se, dr, sdr3, rb0,
                 wh_se=None, *, cells):
    """Plain version of ``rates_he``: ``cds`` and ``nboxes`` the three
    species' (B, Dc, Dc, Dc) coldensh_out and absorber boxes (HI, HeI,
    HeII), ``rt_sub`` (3, Ds, Ds, Ds) with channels (path3, geominv, valid)
    at box offset ``rb0``, ``flux`` (B,), ``se``, ``w_se`` and ``wh_se``
    the (3, E) bin tables; ``dr`` and ``sdr3`` (S*/dr^3) floats. Evaluated
    at the listed cells ``cells`` (the rated cells of ``rt_sub``,
    ``rated_cells``: the host engine's ``rated_cells``) in the kernel's
    order of operations. Returns [G_HI, G_HeI, G_HeII] (with
    ``wh_se`` and the heat per HI atom) of shape (B, Ds, Ds, Ds), 0 at every
    cell not listed."""
    dt, dev = cds[0].dtype, cds[0].device
    dr, sdr3, max_cd = (torch.tensor(float(v), dtype=dt)
                        for v in (dr, sdr3, MAX_COLDENSH))
    tiny = HE_TINY[dt]
    B, Dc, Ds = cds[0].shape[0], cds[0].shape[-1], rt_sub.shape[-1]
    idx, o = _listed(cells, rt_sub, rb0, Dc)
    path = rt_sub[0].reshape(-1)[idx] * dr
    geominv = rt_sub[1].reshape(-1)[idx]
    n = [b.reshape(B, -1)[:, o] for b in nboxes]
    dcol = [x * path for x in n]
    cdin = [c.reshape(B, -1)[:, o] - d for c, d in zip(cds, dcol)]
    zero = torch.zeros_like(dcol[0])
    acc = [zero] * 3
    acc_h = [zero] * 3
    first = he_first_bins(se, w_se, wh_se)
    for e in range(se.shape[1]):
        terms = [s for s in range(3) if e >= first[s]]
        if not terms:
            continue
        s0 = terms[0]
        tau = cdin[s0] * se[s0, e]
        dtau = dcol[s0] * se[s0, e]
        for s in terms[1:]:
            tau = tau + cdin[s] * se[s, e]
            dtau = dtau + dcol[s] * se[s, e]
        core = torch.exp(-tau) * (-torch.expm1(-dtau))
        inv = core / torch.clamp(dtau, min=tiny)
        for s in terms:
            acc[s] = acc[s] + inv * w_se[s, e]
            if wh_se is not None:
                acc_h[s] = acc_h[s] + inv * wh_se[s, e]
    pref = flux[:, None] * sdr3 * geominv[None]
    ok = cdin[0] <= max_cd
    outs = [torch.where(ok & (n[s] > 0),
                        pref * (dcol[s] * acc[s])
                        / torch.clamp(n[s], min=tiny), zero)
            for s in range(3)]
    if wh_se is not None:
        # the heat channel is per HI atom: the thermal update multiplies it
        # by n_HI and recovers sum_s Gamma_heat_s n_s
        h = dcol[0] * acc_h[0]
        for s in (1, 2):
            h = h + dcol[s] * acc_h[s]
        outs.append(torch.where(ok & (n[0] > 0),
                                pref * h / torch.clamp(n[0], min=tiny),
                                zero))
    boxes = []
    for x in outs:
        box = torch.zeros((B, Ds ** 3), dtype=dt, device=dev)
        box[:, idx] = x
        boxes.append(box.view(B, Ds, Ds, Ds))
    return boxes


def rates_he(cds, nboxes, rt_sub, flux, se, w_se, dr, sdr3, rb0,
             wh_se=None, *, cells, bands=None):
    """The helium rate pass on the device of the boxes (arguments as
    ``rates_he_ref``, ``cells`` int32, 1 to Ds^3 of them): the plain version
    for CPU tensors, one launch of the kernel for CUDA ones, which returns
    the same bits. ``bands``: the tables by band (``he_bands``), which an
    engine packs once; packed here where not given."""
    if len(cds) != 3 or len(nboxes) != 3:
        raise ValueError(f"rates_he: {len(cds)} and {len(nboxes)} boxes, "
                         f"three species each")
    if cds[0].device.type == "cpu":
        return rates_he_ref(cds, nboxes, rt_sub, flux, se, w_se, dr, sdr3,
                            rb0, wh_se, cells=cells)
    dt = cds[0].dtype
    B, Dc, Ds = cds[0].shape[0], cds[0].shape[-1], rt_sub.shape[-1]
    if not 0 <= rb0 <= Dc - Ds:
        raise ValueError(f"rates_he: a rates subbox of {Ds} at {rb0} "
                         f"leaves the box {Dc}")
    if bands is None:
        bands = he_bands(se, w_se, wh_se)
    heat = wh_se is not None
    box = (B, Dc, Dc, Dc)
    spec = {f"{k}{s}": (t, box, dt) for k, ts in (("cd", cds), ("n", nboxes))
            for s, t in enumerate(ts)}
    spec.update(rt_sub=(rt_sub, (3, Ds, Ds, Ds), dt), flux=(flux, (B,), dt),
                rec=(bands.rec, (bands.rec.numel(),), dt),
                cells=(cells, (cells.numel(),), torch.int32))
    sfx = sweep._check("rates_he", cds[0], spec)
    _check_bands("rates_he", bands, heat)
    if not 1 <= cells.numel() <= Ds ** 3:
        raise ValueError(f"rates_he: {cells.numel()} rated cells, the kernel "
                         f"takes 1 to Ds^3")
    from ._build import load
    lib = load("cheb_rates")
    outs = [torch.zeros((B, Ds, Ds, Ds), dtype=dt, device=cds[0].device)
            for _ in range(3 + heat)]
    ptr = sweep._ptr

    def opt(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(cds[0].device).cuda_stream
    err = getattr(lib, f"rates_he_{sfx}")(
        *map(ptr, cds), *map(ptr, nboxes), ptr(rt_sub), ptr(cells),
        ptr(flux), ptr(bands.rec), ptr(bands.head), *map(ptr, outs[:3]),
        opt(outs[3] if heat else None), B, Dc, Ds, rb0,
        cells.numel(), float(dr), float(sdr3), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"rates_he kernel launch failed: CUDA error {err} "
                           f"({lib.error_string(err)!r})")
    sweep.launches["rates_he"] += 1
    return outs


def _check_bands(name, bands, heat):
    """Raise unless ``bands`` (``he_bands``) were packed with the heat
    channel's table exactly where ``heat``, their header on the host."""
    head = bands.head
    if (head.device.type != "cpu" or head.dtype != torch.int32
            or head.shape != (17,) or bool(head[0]) != heat
            or int(head[1]) != bands.rec.numel()):
        raise ValueError(f"{name}: bands of header {head.tolist()} on "
                         f"{head.device} and {bands.rec.numel()} values are "
                         f"not he_bands' {'with' if heat else 'without'} "
                         f"the heat channel's table")
