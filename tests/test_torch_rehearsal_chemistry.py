"""The chemistry passes of csrc/chemistry.cu and the thermal update of
csrc/thermal.cu, rehearsed on the host (tests/rehearsal_host.py) against
global_pass_ref, global_pass_he_ref and update_temperature_ref."""

import ctypes

import numpy as np
import pytest
import torch

from rehearsal_host import lib  # noqa: F401


# The chemistry passes of csrc/chemistry.cu. On the host the kernels call
# glibc's exp, expm1 and pow and divide by a scalar as the card does (a
# multiply by its reciprocal), where torch's CPU path calls its vectorized
# exp, expm1 and pow and divides; the few-ulp differences that leaves are
# carried on by the iteration, most where <x> cancels (the reason for the
# 1e-8 of test_torch_chemistry.py's far-from-source case). So the results
# are held to the plain versions within those tolerances, with equal
# counts; the kernels' own logic (per-cell freezing, the cap, the mask, the
# block-reduced count in any block order and grid) is held exactly.
CHEM = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598 ** 2,
            temph0=13.598 / 8.617e-05, abu_c=7.1e-7)
HE_SIGS = dict(sig_h_he1=1.18e-18, sig_he1_he1=7.42e-18, sig_h_lya2=3.4e-19,
               sig_he1_lya2=3.0e-18)
HE_ORDER = ("ndens", "temp", "xh", "xh_av", "y1", "y1_av", "y2", "y2_av",
            "phi_h", "phi_he1", "phi_he2")
CHEM_RTOL = {torch.float64: 1e-8, torch.float32: 1e-6}
CHEM_DT = 1e13


def _chem_fields(seed, dt, n=16 ** 3):
    """Hydrogen and helium fields from neutral to nearly ionized, Gamma
    over eight decades (the cells far from sources included)."""
    rng = np.random.RandomState(seed)
    xh = rng.uniform(1e-4, 0.99, n)
    y1, y2 = rng.uniform(1e-4, 0.6, n), rng.uniform(0.0, 0.35, n)
    f = dict(ndens=10 ** rng.uniform(-4, -1, n), temp=rng.uniform(5e3, 3e4, n),
             xh=xh, xh_av=np.clip(xh * rng.uniform(0.8, 1.2, n), 0, 0.999),
             y1=y1, y1_av=y1 * rng.uniform(0.8, 1.2, n), y2=y2,
             y2_av=y2 * rng.uniform(0.8, 1.2, n),
             phi_h=10 ** rng.uniform(-18, -10, n),
             phi_he1=10 ** rng.uniform(-18, -10, n),
             phi_he2=10 ** rng.uniform(-19, -11, n),
             heat=10 ** rng.uniform(-30, -20, n))
    t = {k: torch.from_numpy(v).to(dt) for k, v in f.items()}
    t["mask"] = torch.from_numpy(rng.uniform(size=n) > 0.3)
    return t


def _host_pass(lib, t, p, helium=0, mask=False, cap=400, blocks=5, threads=64,
               reverse=0):
    """A chemistry kernel on the host: the hydrogen pass (``helium`` 0) or
    the helium pass (1 + 2 heat + 4 recombination photons) over the fields
    ``t`` with the parameters ``p``. Returns (outputs, count, iterations)."""
    from pyc2ray_torch.ops import chemistry as ch, chemistry_he as che
    dt = t["xh"].dtype
    outs = [torch.full_like(t["xh"], float("nan"))
            for _ in range(6 if helium else 2)]
    count = torch.zeros((), dtype=torch.int64)
    its = torch.full(t["xh"].shape, -1, dtype=torch.int32)
    m = t["mask"].data_ptr() if mask else None
    if helium:
        ptrs = ([t[k].data_ptr() for k in HE_ORDER]
                + [t["heat"].data_ptr() if helium & 2 else None, m])
        params = che._kernel_params_he(p, dt)
    else:
        ptrs = [t[k].data_ptr() for k in ("ndens", "temp", "xh", "xh_av",
                                          "phi_h")] + [m]
        params = ch._kernel_params(p)
    ptrs += [o.data_ptr() for o in outs] + [count.data_ptr(), its.data_ptr()]
    fn = lib.rehearse_chem_f32 if dt == torch.float32 else \
        lib.rehearse_chem_f64
    fn(helium, (ctypes.c_void_p * len(ptrs))(*ptrs), t["xh"].numel(), cap,
       (ctypes.c_double * len(params))(*params), 0, None, CHEM_DT, blocks,
       threads, reverse)
    return outs, int(count), its


def _plain_iterations(t, p, cap=400):
    """The doric iterations each cell takes in global_pass_ref's loop."""
    from pyc2ray_torch.ops.chemistry import (MIN_FRACTIONAL_CHANGE,
                                             MIN_FRACTION_OF_ATOMS, doric)
    xav = t["xh_av"]
    active = torch.ones(xav.shape, dtype=torch.bool)
    its = torch.zeros(xav.shape, dtype=torch.int32)
    for _ in range(cap):
        if not bool(active.any()):
            break
        rhe = t["ndens"] * (xav + p.abu_c)
        _, av = doric(t["xh"], CHEM_DT, t["temp"], rhe, t["phi_h"], p)
        done = (torch.abs((av - xav) / (1.0 - av)) < MIN_FRACTIONAL_CHANGE) \
            | ((1.0 - av) < MIN_FRACTION_OF_ATOMS)
        xav = torch.where(active, av, xav)
        its += active.int()
        active = active & ~done
    return its


def _votes(xav, xav_entry, mask=None):
    """global_pass_ref's not-converged test per cell."""
    yh = 1.0 - xav_entry
    delta = xav - xav_entry
    v = (delta.abs() > 1e-3) & ((delta / yh).abs() > 1e-3) & (yh > 1e-8)
    return v if mask is None else v & mask


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_chemistry_pass_on_the_host_matches_plain(lib, dt):
    """The hydrogen kernel against global_pass_ref, with and without the
    mask: xh and <x> within CHEM_RTOL, the count equal, each cell's
    iterations those of the plain loop, the count the masked sum of the
    per-cell votes of the kernel's own outputs."""
    from pyc2ray_torch.ops.chemistry import ChemistryParams, global_pass_ref
    p = ChemistryParams(**CHEM)
    for seed in (0, 1):
        t = _chem_fields(seed, dt)
        for mask in (False, True):
            (xi, xa), count, its = _host_pass(lib, t, p, mask=mask)
            ref = global_pass_ref(CHEM_DT, t["ndens"], t["temp"], t["xh"],
                                  t["xh_av"], t["phi_h"], p,
                                  mask=t["mask"] if mask else None)
            for a, b in zip((xi, xa), ref[:2]):
                torch.testing.assert_close(a, b, rtol=CHEM_RTOL[dt], atol=0)
            assert count == int(ref[2]) > 0
            assert count == int(_votes(
                xa, t["xh_av"], t["mask"] if mask else None).sum())
        assert torch.equal(its, _plain_iterations(t, p))
        assert int(its.max()) > 8


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_chemistry_pass_on_the_host_is_per_cell(lib, dt):
    """Any grid and block order gives the same bits and count. With a cap
    of 8 a cell that converged within 8 iterations holds the bits of the
    uncapped pass, the rest stop at the cap; the capped pass matches
    global_pass_ref with MAX_INNER_ITER = 8 within CHEM_RTOL."""
    from pyc2ray_torch.ops import chemistry as ch
    p = ch.ChemistryParams(**CHEM)
    t = _chem_fields(2, dt)
    out, count, its = _host_pass(lib, t, p, mask=True)
    for blocks, threads, reverse in ((1, 32, 0), (7, 64, 1), (64, 64, 1)):
        o, c, i = _host_pass(lib, t, p, mask=True, blocks=blocks,
                             threads=threads, reverse=reverse)
        assert all(torch.equal(a, b) for a, b in zip(o, out)) and c == count
        assert torch.equal(i, its)
    o8, c8, i8 = _host_pass(lib, t, p, cap=8, mask=True)
    assert torch.equal(i8, its.clamp(max=8))
    early = its < 8
    assert 0 < int(early.sum()) < its.numel()
    for a, b in zip(o8, out):
        assert torch.equal(a[early], b[early])
        assert not torch.equal(a[~early], b[~early])
    cap, ch.MAX_INNER_ITER = ch.MAX_INNER_ITER, 8
    try:
        ref = ch.global_pass_ref(CHEM_DT, t["ndens"], t["temp"], t["xh"],
                                 t["xh_av"], t["phi_h"], p, mask=t["mask"])
    finally:
        ch.MAX_INNER_ITER = cap
    for a, b in zip(o8, ref[:2]):
        torch.testing.assert_close(a, b, rtol=CHEM_RTOL[dt], atol=0)
    assert c8 == int(ref[2])


# option -> (helium flags: 1 + 2 heat + 4 recombination photons, abu_he);
# float32 without the heat channel (see below)
HE_OPTIONS = {"plain": (1, 0.074), "secondary": (3, 0.074),
              "recombination": (5, 0.074), "all": (7, 0.074),
              "no_helium": (1, 0.0)}
HE_CASES = ([(o, torch.float64) for o in sorted(HE_OPTIONS)]
            + [(o, torch.float32) for o in ("plain", "recombination",
                                            "no_helium")])


@pytest.mark.parametrize("option,dt", HE_CASES)
def test_chemistry_pass_he_on_the_host_matches_plain(lib, option, dt):
    """The helium kernel against global_pass_he_ref in each option (the
    mask with "all" and "recombination"): the six fractions within
    CHEM_RTOL, the count equal; any block order the same bits. With abu_he
    = 0 its xh and <x> are the hydrogen kernel's bit for bit. In float32
    with the heat channel the plain pass's own 400-iteration cells (a tenth
    of these) and its one-ulp sensitivity put the two up to 2e-4 apart:
    those options are held in float64 here and bit for bit on the card."""
    from pyc2ray_torch.ops.chemistry import ChemistryParams
    from pyc2ray_torch.ops.chemistry_he import (HeChemistryParams,
                                                global_pass_he_ref)
    flags, abu_he = HE_OPTIONS[option]
    p = HeChemistryParams(chem=ChemistryParams(**CHEM), abu_he=abu_he,
                          sec_ramp_hi=0.62, sec_ramp_hei=0.31, **HE_SIGS)
    t = _chem_fields(3, dt, n=12 ** 3)
    mask = option in ("all", "recombination")
    out, count, its = _host_pass(lib, t, p, helium=flags, mask=mask)
    ref = global_pass_he_ref(
        CHEM_DT, *(t[k] for k in HE_ORDER), p,
        mask=t["mask"] if mask else None,
        heat=t["heat"] if flags & 2 else None,
        recombination_photons=bool(flags & 4))
    for a, b in zip(out, ref[:6]):
        torch.testing.assert_close(a, b, rtol=CHEM_RTOL[dt], atol=0)
    assert count == int(ref[6]) > 0
    o, c, i = _host_pass(lib, t, p, helium=flags, mask=mask, blocks=3,
                         reverse=1)
    assert all(torch.equal(a, b) for a, b in zip(o, out)) and c == count
    assert torch.equal(i, its)
    if abu_he == 0.0:
        h, hc, hi = _host_pass(lib, t, p.chem)
        assert torch.equal(h[0], out[0]) and torch.equal(h[1], out[1])
        assert hc == count and torch.equal(hi, its)


def _runs(rng, n, values, run):
    """n cells holding ``values`` in runs of ``run`` equal cells."""
    return np.repeat(values, run)[:n] if len(values) * run >= n else \
        np.resize(np.repeat(values, run), n)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("temps", ["uniform", "runs", "mixed"])
def test_chemistry_pass_on_the_host_takes_several_cells_a_thread(lib, dt,
                                                                 temps):
    """The hydrogen kernel's threads take two cells a field at a time
    (one vector load) over a length that no thread's cells divide (1001
    cells), with one temperature (the isothermal case: a thread's
    temperature rates computed once), runs of three equal temperatures and
    a different one in every cell. The vector path (aligned fields) and
    the one-cell path (fields one element off the vector's alignment) give
    the same bits, as do other grids and block orders; the results hold to
    global_pass_ref within CHEM_RTOL, with each cell's iterations and the
    count of the plain loop."""
    from pyc2ray_torch.ops.chemistry import ChemistryParams, global_pass_ref
    p = ChemistryParams(**CHEM)
    n = 1001
    t = _chem_fields(4, dt, n=n)
    rng = np.random.RandomState(5)
    if temps == "uniform":
        t["temp"] = torch.full((n,), 1.0e4, dtype=dt)
    elif temps == "runs":
        t["temp"] = torch.from_numpy(
            _runs(rng, n, rng.uniform(5e3, 3e4, n // 3 + 1), 3)).to(dt)
    out, count, its = _host_pass(lib, t, p, mask=True)
    # every field one element into a larger buffer: off the vector's
    # alignment
    off = {}
    for k, v in t.items():
        buf = torch.zeros(n + 1, dtype=v.dtype)
        buf[1:] = v
        off[k] = buf[1:]
    assert off["xh"].data_ptr() % (2 * t["xh"].element_size()) != 0
    o, c, i = _host_pass(lib, off, p, mask=True)
    assert all(torch.equal(a, b) for a, b in zip(o, out)) and c == count
    assert torch.equal(i, its)
    for blocks, threads, reverse in ((1, 32, 0), (3, 64, 1), (40, 32, 1)):
        o, c, i = _host_pass(lib, t, p, mask=True, blocks=blocks,
                             threads=threads, reverse=reverse)
        assert all(torch.equal(a, b) for a, b in zip(o, out)) and c == count
        assert torch.equal(i, its)
    ref = global_pass_ref(CHEM_DT, t["ndens"], t["temp"], t["xh"],
                          t["xh_av"], t["phi_h"], p, mask=t["mask"])
    for a, b in zip(out, ref[:2]):
        torch.testing.assert_close(a, b, rtol=CHEM_RTOL[dt], atol=0)
    assert count == int(ref[2]) > 0
    assert torch.equal(its, _plain_iterations(t, p))


# The thermal update of csrc/thermal.cu. The host build calls glibc's pow,
# exp, expm1 and sqrt where torch's CPU path calls its vectorized ones,
# which differ by an ulp here and there; over the substeps those ulps stay
# within THERMAL_RTOL of update_temperature_ref (at most 4.6e-7 in float32
# and 9.4e-15 in float64 on these fields, in 1-4 % of the cells; the card
# holds the kernel bit for bit, chip_smoke 3c and the cuda tests). The
# kernel's own logic (the substeps, the clamps, phi1's branch, Compton, dt
# read as the plain version reads it) is held here.
THERMAL_RTOL = {torch.float64: 1e-13, torch.float32: 2e-6}
THERMAL = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598 ** 2,
               temph0=13.598 / 8.617e-05, abu_c=7.1e-7)


def _thermal_fields(seed, dt, n=3000):
    """Temperatures from 10 K to 1e6 K over densities, fractions and
    heating rates of several decades, with: a cell below t_floor (200 K,
    no heating: it clamps up), cells heated past t_cap (1e5 K), cells so
    thin that b h stays below 1e-8 (phi1's series branch), a neutral and a
    fully ionized cell."""
    rng = np.random.RandomState(seed)
    f = dict(temp=10 ** rng.uniform(1, 6, n), ndens=10 ** rng.uniform(-4, 0, n),
             xh=rng.uniform(1e-4, 0.999, n),
             heat=10 ** rng.uniform(-30, -18, n))
    f["heat"][rng.uniform(size=n) < 0.1] = 0.0
    f["temp"][0], f["heat"][0] = 50.0, 0.0          # below t_floor
    f["heat"][1:4] = 1e-9                            # past t_cap
    f["ndens"][4:8], f["xh"][4:8] = 1e-22, 1e-6      # phi1(-x) = 1
    f["xh"][8], f["xh"][9] = 0.0, 1.0
    return {k: torch.from_numpy(v).to(dt) for k, v in f.items()}


def _host_thermal(lib, t, p, z, dt_arg, nsub=16, blocks=5, threads=64,
                  reverse=0, form=-1):
    """The thermal kernel on the host over the fields ``t``: the engine's
    for these arguments (``form`` -1) or a design step of
    thermal.cuh::run_form; ``dt_arg`` a Python number or a 0-dim tensor
    (read through its pointer)."""
    from pyc2ray_torch.ops import thermal
    dtype = t["temp"].dtype
    out = torch.full_like(t["temp"], float("nan"))
    ptrs = [t[k].data_ptr() for k in ("temp", "ndens", "xh", "heat")]
    ptrs.append(out.data_ptr())
    params = thermal._kernel_params(p, z)
    if isinstance(dt_arg, torch.Tensor):
        kind = 1 if dt_arg.dtype == torch.float32 else 2
        dtp, val = dt_arg.data_ptr(), 0.0
    else:
        kind, dtp, val = 0, None, float(dt_arg)
    fn = lib.rehearse_thermal_f32 if dtype == torch.float32 else \
        lib.rehearse_thermal_f64
    rc = fn((ctypes.c_void_p * 5)(*ptrs), out.numel(), nsub,
            (ctypes.c_double * len(params))(*params), kind, dtp, val, blocks,
            threads, reverse, form)
    assert rc == 0, (form, rc)
    return out


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("compton,z", [(False, 0.0), (True, 0.0),
                                       (True, 9.0)])
def test_thermal_update_on_the_host_matches_plain(lib, dt, compton, z):
    """The thermal kernel against update_temperature_ref within
    THERMAL_RTOL, Compton off and on at z = 0 and 9, dt a Python number
    and a 0-dim tensor of either type, 16 substeps and 5 (a reciprocal of
    nsub that is not a power of two); every cell within [t_floor, t_cap],
    the clamps reached, phi1's branch taken; any grid and block order the
    same bits."""
    from pyc2ray_torch.ops.thermal import (ThermalParams,
                                           update_temperature_ref)
    p = ThermalParams(**THERMAL, compton=compton, t_floor=200.0, t_cap=1e5)
    t = _thermal_fields(11, dt)
    args = (t["temp"], t["ndens"], t["xh"], t["heat"], p)
    for dt_arg, nsub in ((3e13, 16), (torch.tensor(3e13, dtype=dt), 5),
                         (torch.tensor(1e13, dtype=torch.float64), 16)):
        got = _host_thermal(lib, t, p, z, dt_arg, nsub=nsub)
        want = update_temperature_ref(dt_arg, *args, z=z, nsub=nsub)
        torch.testing.assert_close(got, want, rtol=THERMAL_RTOL[dt], atol=0)
        assert float(got.min()) == p.t_floor and float(got.max()) == p.t_cap
        for blocks, threads, reverse in ((1, 32, 0), (7, 64, 1)):
            other = _host_thermal(lib, t, p, z, dt_arg, nsub=nsub,
                                  blocks=blocks, threads=threads,
                                  reverse=reverse)
            assert torch.equal(other, got)
    # the thin cells take phi1's branch: their x = b h is below 1e-8
    from pyc2ray_torch.ops.thermal import KB, cooling_rate
    T = t["temp"][4:8]
    _, dlam = torch.func.jvp(
        lambda x: cooling_rate(x, t["ndens"][4:8], t["xh"][4:8], p, z),
        (T,), (torch.ones_like(T),))
    ntot = t["ndens"][4:8] * (1.0 + t["xh"][4:8] + p.abu_c)
    assert float((dlam / (1.5 * KB * ntot) * 3e13 / 16).abs().max()) < 1e-8


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("compton", [False, True])
@pytest.mark.parametrize("nsub", [1, 5, 16])
def test_thermal_kept_form_on_the_host(lib, dt, compton, nsub):
    """The engine's kernel (thermal.cuh::dispatch: the fixed kernel for
    nsub 16, the general one else) within THERMAL_RTOL of
    update_temperature_ref on an odd count of cells, and on the same fields
    from their element 1 (an unaligned start) the same bits cell for cell:
    the fields of
    test_thermal_update_on_the_host_matches_plain, on which THERMAL_RTOL
    was set, their first 2999 cells. In float32 with one substep of 3e13 s
    the host's ulps (glibc's exp, expm1 and pow against torch's) grow past
    THERMAL_RTOL in the first port's body as well (1.9e-5 here; the card
    holds both bit-equal to the plain version), so there the reference is
    that body (run_form's step 0) on the host."""
    from pyc2ray_torch.ops.thermal import (ThermalParams,
                                           update_temperature_ref)
    p = ThermalParams(**THERMAL, compton=compton, t_floor=200.0, t_cap=1e5)
    t = {k: v[:2999] for k, v in _thermal_fields(11, dt).items()}
    got = _host_thermal(lib, t, p, 9.0, 3e13, nsub=nsub)
    if dt == torch.float32 and nsub == 1:
        want = _host_thermal(lib, t, p, 9.0, 3e13, nsub=nsub, form=0)
    else:
        want = update_temperature_ref(3e13, t["temp"], t["ndens"], t["xh"],
                                      t["heat"], p, z=9.0, nsub=nsub)
    torch.testing.assert_close(got, want, rtol=THERMAL_RTOL[dt], atol=0)
    tail = {k: v[1:] for k, v in t.items()}
    assert tail["temp"].data_ptr() % 16 != 0
    assert torch.equal(_host_thermal(lib, tail, p, 9.0, 3e13, nsub=nsub),
                       got[1:])


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_thermal_design_steps_on_the_host(lib, dt):
    """Every design step of thermal.cuh::run_form (chip_smoke's
    THERMAL_FORMS, six forms) within THERMAL_RTOL of
    update_temperature_ref. On the host the steps with libdevice's pow (0,
    a, b) call glibc's and give one set of bits, the steps with the pow
    pair (c, d and e, the engine's kernel) another (the pair's rcp.approx
    is an exact reciprocal here); a fixed step refuses 5 substeps."""
    from pyc2ray_torch.ops.thermal import (ThermalParams,
                                           update_temperature_ref)
    p = ThermalParams(**THERMAL, compton=True, t_floor=200.0, t_cap=1e5)
    t = _thermal_fields(11, dt)
    want = update_temperature_ref(3e13, t["temp"], t["ndens"], t["xh"],
                                  t["heat"], p, z=9.0)
    steps = [_host_thermal(lib, t, p, 9.0, 3e13, form=f) for f in range(6)]
    for got in steps:
        torch.testing.assert_close(got, want, rtol=THERMAL_RTOL[dt], atol=0)
    assert all(torch.equal(s, steps[0]) for s in steps[1:3])
    engine = _host_thermal(lib, t, p, 9.0, 3e13)
    assert all(torch.equal(s, engine) for s in steps[3:])
    with pytest.raises(AssertionError, match="1"):
        _host_thermal(lib, t, p, 9.0, 3e13, nsub=5, form=1)
