"""What the host rehearsals of the flat engine's kernels share
(tests/test_torch_rehearsal_flat.py, test_torch_rehearsal_flat_loop.py):
the cases, the engines and fields, the card's arithmetic for the plain
functions, and the call of csrc/flat_sweep.cuh's kernels on the host
(tests/rehearsal_host.py's library)."""

import ctypes
import ctypes.util

import numpy as np
import torch

from pyc2ray_torch.constants import ev2fr
from pyc2ray_torch.ops import flat_sweep as fs
from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
from pyc2ray_torch.radiation import BlackBodySource, make_tau_table
from rehearsal_host import DR, SIG

DTYPES = [torch.float64, torch.float32]


def _rate_tables(numtau=200):
    tau, dlogtau = make_tau_table(-20.0, 4.0, numtau)
    bb = BlackBodySource(5e4, False, ev2fr * 13.598, 2.8)
    fmin, fmax = ev2fr * 13.598, 10 * ev2fr * 54.416
    thin, thick = bb.make_photo_table(tau, fmin, fmax, 1e48)
    hthin, hthick = bb.make_heat_table(tau, fmin, fmax, 1e48)
    return thin, thick, -20.0, dlogtau, hthin, hthick


TABLES = _rate_tables()

# (N, R, the positions of the B sources of each of two batches): R inside
# the mesh (a clipped octahedron) and beyond it (the whole box, as the
# golden's); every batch has two sources at one cell and octahedra that
# overlap
CASES = {
    "N16_R4": (16, 4.0, [[[3, 3, 3], [3, 3, 3], [5, 2, 4], [15, 0, 15]],
                         [[8, 8, 8], [9, 8, 6], [0, 0, 0], [8, 8, 8]]]),
    "N16_box": (16, 1e9, [[[1, 2, 3], [1, 2, 3], [9, 12, 0]],
                          [[4, 4, 4], [12, 1, 7], [4, 4, 4]]]),
    "N24_R7": (24, 7.0, [[[0, 0, 0], [23, 23, 23], [2, 1, 22]],
                         [[12, 12, 12], [12, 12, 12], [15, 10, 11]]]),
    "N24_box": (24, 1e9, [[[5, 6, 7], [5, 6, 7], [17, 3, 20]],
                          [[23, 0, 11], [0, 23, 11], [11, 11, 11]]]),
}

# (cluster, threads a block) of the sweep: every cluster size flat_plan
# may choose
PLANS = [(1, 37), (2, 16), (4, 9), (8, 5), (16, 3)]


def _engine(N, R, B, dt, mode):
    cfg = RaytraceConfig(N=N, R_max_LLS=R, sig=SIG, batch_size=B, dtype=dt,
                         grey_analytic=mode == "grey",
                         do_heating=mode == "heat")
    return Raytracer(cfg, *TABLES, device="cpu")


def _case(case, dt, mode, seed=3):
    """The engine, the density and ionized fraction grids (N^3,), the
    positions (nb, B, 3) and the fluxes (nb, B): densities over ten decades
    (optically thin and thick cells), a zero-density cell beside the first
    source, the first batch's last flux 0."""
    N, R, pos = CASES[case]
    pos = torch.tensor(pos, dtype=torch.int64)
    nb, B = pos.shape[:2]
    rt = _engine(N, R, B, dt, mode)
    rng = np.random.RandomState(seed + N)
    nd = 10 ** rng.uniform(-12, -2, N ** 3)
    xh = rng.uniform(0.0, 0.9, N ** 3)
    x, y, z = pos[0, 0].tolist()
    nd[(((x + 1) % N) * N + y) * N + z] = 0.0
    flux = rng.uniform(0.5, 2.0, (nb, B))
    flux[0, -1] = 0.0
    return (rt, torch.from_numpy(nd).to(dt), torch.from_numpy(xh).to(dt),
            pos, torch.from_numpy(flux).to(dt))


def _libm(name, dt):
    """glibc's ``name`` (float64) or ``name``f (float32), elementwise."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    if dt == torch.float32:
        f = getattr(libm, name + "f")
        f.argtypes, f.restype = [ctypes.c_float], ctypes.c_float
    else:
        f = getattr(libm, name)
        f.argtypes, f.restype = [ctypes.c_double], ctypes.c_double
    return lambda x: torch.tensor([f(v) for v in x.reshape(-1).tolist()],
                                  dtype=x.dtype).reshape(x.shape)


def _card_arithmetic(monkeypatch, dt):
    """torch.log10 and torch.exp as glibc's, and tensor / Python number as
    ATen's CUDA kernels divide by a CPU scalar: times its reciprocal, formed
    in double and rounded to the tensor's type."""
    monkeypatch.setattr(torch, "log10", _libm("log10", dt))
    monkeypatch.setattr(torch, "exp", _libm("exp", dt))
    real_div = torch.Tensor.__truediv__

    def card_div(a, b):
        if isinstance(b, (int, float)) and not isinstance(b, bool):
            return a * (1.0 / float(b))
        return real_div(a, b)
    monkeypatch.setattr(torch.Tensor, "__truediv__", card_div)


def _forms(lib):
    """The engine's forms of the sweep, {"ring": ..., "global_": ...}, the
    probe's (csrc/flat_probe.cu's FLAT_PROBE_FORMS) under "probe" and its
    rate pass's (FLAT_RATE_FORMS, F | K << 4) under "rates"."""
    out, rates = (ctypes.c_int * 64)(), (ctypes.c_int * 64)()
    lib.rehearse_flat_forms(out, rates)
    forms, rates = list(out), list(rates)
    return dict(ring=out[0], global_=out[1],
                probe=forms[2:forms.index(-100)],
                rates=rates[:rates.index(-100)])


# the probe's forms that compute the sweep (FLAT_PROBE_FORMS' first twelve
# but the bare barriers and the engine's two): the first port's chain, nHI
# gathered by the gather kernel or by the sweep's prologue, the ring, the
# ring with the prologue, and the shared form with each step that was
# measured and left out
PROBE_ROWS = [0, 2, 3, 4, 5, 8, 9, 10, 11]


def _host(lib, rt, kind, io, pos, cluster=4, threads=9, reverse=0,
          form=None):
    """Kernel ``kind`` of run_flat (0 gather and sweep, 1 rates, 2
    accumulate, 3 the loop, 4 gather, 5 the probe's rates) on the host:
    ``io`` the dict of its tensors (rehearsal.cpp's order; absent ones
    null; the gathered nHI's scratch made here as NaN where ``io`` has
    none), ``pos`` (B, 3) or, for the loop, (nb, B, 3), staged as the
    wrappers stage them; the sweep in the form ``form`` (the engine's
    shared one where None), the gather in its form (the engine's, 2, where
    None)."""
    kt = rt.kernel_tables()
    order = ("nhi", "pos", "flux", "sdr3", "cd", "phi", "heat", "phi_grid",
             "heat_grid", "nhi_octa")
    io = dict(dict(nhi_octa=_nan(rt, pos.shape[-2])), **io,
              pos=fs.stage_positions(pos, rt.config.N, "cpu"))
    if form is None:
        form = 2 if kind == 4 else _forms(lib)["ring"]
    ptrs = (ctypes.c_void_p * len(order))(
        *[None if io.get(k) is None else io[k].data_ptr() for k in order])
    nb = pos.shape[0] if kind == 3 else 1
    B = pos.shape[-2]
    fn = lib.rehearse_flat_f32 if rt.config.dtype == torch.float32 else \
        lib.rehearse_flat_f64
    fn(kind, kt.tabs, kt.dims, fs._vals(kt, DR), ptrs, nb, B, cluster,
       threads, reverse, form)


def _nan(rt, B):
    return torch.full((B, rt.geom_np.num_cells), float("nan"),
                      dtype=rt.config.dtype)


def _dr(rt):
    return torch.tensor(DR, dtype=rt.config.dtype)


def _ftz(x):
    """float32 ``x`` with its subnormals flushed to zeros of their sign."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(x.abs() < tiny, torch.zeros_like(x).copysign(x), x)
