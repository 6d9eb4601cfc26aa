"""The chemistry passes as the port dispatches them (ops/chemistry.py,
ops/chemistry_he.py): on CPU fields ``global_pass`` and ``global_pass_he``
run their plain versions, held here against the JAX package's passes on
the same seeded numpy inputs; on CUDA fields they launch the kernels of
csrc/chemistry.cu once, held (``cuda``) bit for bit against the plain
versions on the card. The kernels' logic is rehearsed on the host in
test_torch_rehearsal.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyc2ray_tpu.ops import chemistry_he as jhe
from pyc2ray_tpu.ops.chemistry import ChemistryParams as JChem
from pyc2ray_tpu.ops.chemistry import global_pass as j_global_pass

from pyc2ray_torch.ops import chemistry as ch
from pyc2ray_torch.ops import chemistry_he as che
from pyc2ray_torch.ops import sweep
from pyc2ray_torch.ops.chemistry import ChemistryParams

PARAMS = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598 ** 2,
              temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
SIGS = dict(sig_h_he1=1.18e-18, sig_he1_he1=7.42e-18, sig_h_lya2=3.4e-19,
            sig_he1_lya2=3.0e-18)
H_ORDER = ("ndens", "temp", "xh", "xh_av", "phi_h")
HE_ORDER = ("ndens", "temp", "xh", "xh_av", "y1", "y1_av", "y2", "y2_av",
            "phi_h", "phi_he1", "phi_he2")
DT = 1e13


def _fields(seed, n=16 ** 3, log_phi=(-18, -10), log_ndens=(-4, -1)):
    """Hydrogen and helium fields, from neutral to nearly ionized."""
    rng = np.random.RandomState(seed)
    xh = rng.uniform(1e-4, 0.99, n)
    y1, y2 = rng.uniform(1e-4, 0.6, n), rng.uniform(0.0, 0.35, n)
    return dict(ndens=10 ** rng.uniform(*log_ndens, n),
                temp=rng.uniform(5e3, 3e4, n), xh=xh,
                xh_av=np.clip(xh * rng.uniform(0.8, 1.2, n), 0, 0.999),
                y1=y1, y1_av=y1 * rng.uniform(0.8, 1.2, n), y2=y2,
                y2_av=y2 * rng.uniform(0.8, 1.2, n),
                phi_h=10 ** rng.uniform(*log_phi, n),
                phi_he1=10 ** rng.uniform(*log_phi, n),
                phi_he2=10 ** rng.uniform(log_phi[0] - 1, log_phi[1] - 1, n),
                heat=10 ** rng.uniform(-30, -20, n),
                mask=rng.uniform(size=n) > 0.4)


def _jax_pass(f, dtype, mask=False):
    return j_global_pass(jnp.asarray(DT, dtype),
                         *(jnp.asarray(f[k], dtype) for k in H_ORDER),
                         JChem(**PARAMS),
                         mask=jnp.asarray(f["mask"]) if mask else None)


def _torch(f, dtype, device="cpu"):
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=torch.bool if k == "mask"
                                      else dtype)
            for k, v in f.items()}


@pytest.mark.parametrize("mask", [False, True])
def test_global_pass_float64_on_cpu_matches_jax(mask):
    """float64 near sources, with and without the mask: the tolerance of
    test_torch_chemistry.py's near-source case (rtol 1e-12), counts equal;
    the dispatching pass returns the plain version's tensors bit for bit
    and launches nothing."""
    f = _fields(1, log_phi=(-14, -10), log_ndens=(-3, -1))
    want = _jax_pass(f, np.float64, mask)
    t = _torch(f, torch.float64)
    args = (torch.tensor(DT, dtype=torch.float64), *(t[k] for k in H_ORDER),
            ChemistryParams(**PARAMS))
    sweep.reset_launches()
    got = ch.global_pass(*args, mask=t["mask"] if mask else None)
    assert sum(sweep.launches.values()) == 0
    ref = ch.global_pass_ref(*args, mask=t["mask"] if mask else None)
    for g, r, w in zip(got[:2], ref[:2], want[:2]):
        assert torch.equal(g, r)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    assert int(got[2]) == int(ref[2]) == int(want[2]) > 0


def test_global_pass_float32_with_mask_on_cpu_matches_jax():
    """float32 with the mask near sources against the JAX pass in float64:
    doric's float32 tolerance of test_torch_chemistry.py (rtol 2e-6, atol
    1.2e-7: a few float32 ulps), counts equal."""
    f = _fields(3, log_phi=(-14, -10), log_ndens=(-3, -1))
    want = _jax_pass(f, np.float64, mask=True)
    t = _torch(f, torch.float32)
    got = ch.global_pass(torch.tensor(DT, dtype=torch.float32),
                         *(t[k] for k in H_ORDER), ChemistryParams(**PARAMS),
                         mask=t["mask"])
    assert got[0].dtype == torch.float32
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.double().numpy(), np.asarray(w),
                                   rtol=2e-6, atol=1.2e-7)
    assert int(got[2]) == int(want[2]) > 0


def _he_params(abu_he=0.074):
    kw = dict(abu_he=abu_he, sec_ramp_hi=0.62, sec_ramp_hei=0.31, **SIGS)
    return (jhe.HeChemistryParams(chem=JChem(**PARAMS), **kw),
            che.HeChemistryParams(chem=ChemistryParams(**PARAMS), **kw))


@pytest.mark.parametrize("heat", [False, True])
@pytest.mark.parametrize("rec", [False, True])
def test_global_pass_he_on_cpu_matches_jax(heat, rec):
    """The four combinations of the helium pass's options (secondary
    ionisations, recombination photons), with the mask, in float64 against
    the JAX pass: rtol 1e-9, the tolerance of test_torch_chemistry_he.py
    (the 2x2 solve's one-ulp sensitivity); counts equal; bit for bit the
    plain version."""
    f = _fields(1, n=12 ** 3)
    jp, tp = _he_params()
    kw = {"mask": f["mask"]}
    if heat:
        kw["heat"] = f["heat"]
    want = jhe.global_pass_he(DT, *(jnp.asarray(f[k]) for k in HE_ORDER), jp,
                              **{k: jnp.asarray(v) for k, v in kw.items()},
                              recombination_photons=rec)
    t = _torch(f, torch.float64)
    args = (DT, *(t[k] for k in HE_ORDER), tp)
    tkw = dict(mask=t["mask"], heat=t["heat"] if heat else None,
               recombination_photons=rec)
    got = che.global_pass_he(*args, **tkw)
    ref = che.global_pass_he_ref(*args, **tkw)
    for g, r, w in zip(got[:6], ref[:6], want[:6]):
        assert torch.equal(g, r)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9)
    assert int(got[6]) == int(ref[6]) == int(want[6]) > 0


def test_passes_raise_on_other_devices():
    """No silent fallback: fields on neither the CPU nor a CUDA card (the
    meta device) make both passes raise."""
    t = _torch(_fields(0, n=64), torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ch.global_pass(DT, *(t[k] for k in H_ORDER), ChemistryParams(**PARAMS))
    with pytest.raises(ValueError, match="unsupported device"):
        che.global_pass_he(DT, *(t[k] for k in HE_ORDER), _he_params()[1])


# ---- on the card: each kernel against its plain version, bit for bit -----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the chemistry kernels have no CPU "
                    "mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_global_pass_kernel_equals_plain_on_cuda(dtype):
    """One launch, no host transfer: xh, <x> and the count equal to
    global_pass_ref's on the card, with and without the mask, with the
    cap at 400 and at 8, dt a device tensor and a Python number, and on a
    Fortran-ordered grid; the kernel's per-cell iterations lie within the
    cap."""
    _card()
    f = _fields(5)
    t = _torch(f, dtype, "cuda")
    p = ChemistryParams(**PARAMS)
    cap = ch.MAX_INNER_ITER
    try:
        for ch.MAX_INNER_ITER in (400, 8):
            for dt in (torch.tensor(DT, dtype=dtype, device="cuda"), DT):
                for mask in (None, t["mask"]):
                    args = (dt, *(t[k] for k in H_ORDER), p)
                    sweep.reset_launches()
                    got = ch.global_pass(*args, mask=mask)
                    assert sweep.launches["chemistry_pass"] == 1
                    ref = ch.global_pass_ref(*args, mask=mask)
                    for g, r in zip(got, ref):
                        assert torch.equal(g, r), (ch.MAX_INNER_ITER, mask)
                    assert int(got[2]) > 0
            its = torch.empty(t["xh"].shape, dtype=torch.int32,
                              device="cuda")
            ch._pass_cuda(DT, *(t[k] for k in H_ORDER), p, iterations=its)
            assert 1 <= int(its.min()) and int(its.max()) <= ch.MAX_INNER_ITER
    finally:
        ch.MAX_INNER_ITER = cap
    # a grid in Fortran order, as the reference's files hold it
    f3 = [t[k].reshape(16, 16, 16).permute(2, 1, 0) for k in H_ORDER]
    assert not f3[0].is_contiguous()
    got = ch.global_pass(DT, *f3, p)
    ref = ch.global_pass_ref(DT, *f3, p)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_global_pass_kernel_takes_several_cells_a_thread_on_cuda(dtype):
    """The hydrogen kernel's threads take two cells a field at a time: over
    1001 cells (no multiple of a thread's cells), on one temperature (the
    isothermal case) and on a different one in every cell, with the fields
    aligned to the two cells' vector and one element off it (the one-cell
    path), bit for bit
    against global_pass_ref with the mask, and each cell's iterations
    equal on both paths."""
    _card()
    p = ChemistryParams(**PARAMS)
    f = _fields(9, n=1001)
    for temp in (None, 1.0e4):
        if temp is not None:
            f["temp"] = np.full(1001, temp)
        t = _torch(f, dtype, "cuda")
        bufs = {k: torch.zeros(1002, dtype=v.dtype, device="cuda")
                for k, v in t.items()}
        off = {}
        for k, v in t.items():
            bufs[k][1:] = v
            off[k] = bufs[k][1:]
        assert off["xh"].data_ptr() % (2 * t["xh"].element_size()) != 0
        its = []
        for fields in (t, off):
            args = (DT, *(fields[k] for k in H_ORDER), p)
            got = ch.global_pass(*args, mask=fields["mask"])
            ref = ch.global_pass_ref(*args, mask=fields["mask"])
            assert all(torch.equal(g, r) for g, r in zip(got, ref))
            its.append(torch.empty(1001, dtype=torch.int32, device="cuda"))
            ch._pass_cuda(*args, iterations=its[-1])
        assert torch.equal(its[0], its[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("heat", [False, True])
@pytest.mark.parametrize("rec", [False, True])
def test_global_pass_he_kernel_equals_plain_on_cuda(dtype, heat, rec):
    """The helium kernel in each option combination, with the mask: the six
    fractions and the count equal to global_pass_he_ref's on the card, with
    the cap at 400 and at 8; one launch per pass."""
    _card()
    f = _fields(6, n=24 ** 3)
    t = _torch(f, dtype, "cuda")
    tp = _he_params()[1]
    args = (torch.tensor(DT, dtype=dtype, device="cuda"),
            *(t[k] for k in HE_ORDER), tp)
    kw = dict(mask=t["mask"], heat=t["heat"] if heat else None,
              recombination_photons=rec)
    cap = che.MAX_INNER_ITER
    try:
        for che.MAX_INNER_ITER in (400, 8):
            sweep.reset_launches()
            got = che.global_pass_he(*args, **kw)
            assert sweep.launches["chemistry_pass_he"] == 1
            ref = che.global_pass_he_ref(*args, **kw)
            for g, r in zip(got, ref):
                assert torch.equal(g, r), che.MAX_INNER_ITER
    finally:
        che.MAX_INNER_ITER = cap


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_global_pass_he_kernel_without_helium_is_hydrogen_on_cuda(dtype):
    """With abu_he = 0 the helium kernel's xh, <x> and count are the
    hydrogen kernel's bit for bit."""
    _card()
    t = _torch(_fields(7), dtype, "cuda")
    tp = _he_params(abu_he=0.0)[1]
    he = che.global_pass_he(DT, *(t[k] for k in HE_ORDER), tp, mask=t["mask"])
    h = ch.global_pass(DT, *(t[k] for k in H_ORDER), tp.chem, mask=t["mask"])
    assert torch.equal(he[0], h[0]) and torch.equal(he[1], h[1])
    assert int(he[6]) == int(h[2])
