"""The rank programs of the port's multi-process tests.

tests/test_torch_parallel.py (source-parallel) and tests/test_torch_domain.py
(domain decomposition) each spawn one world of ranks for the module
(``spawn_world``): torch.multiprocessing with the spawn start method (the
parent process holds JAX's threads: never fork), gloo on the CPU, a
file:// rendezvous in the module's temporary directory (several test
processes run at once: no fixed TCP port). Every rank reads the inputs the
parent wrote (``inputs.npz``), runs the cases of its suite in order and
saves what the parent compares as ``<case>.r<rank>.npz``; a case on a mesh
smaller than the world runs on the mesh's ranks only.

This module imports numpy, torch and pyc2ray_torch only; each rank records
whether jax or pyc2ray_tpu was imported in it (``modules.r<rank>.npz``).
"""

import os
import sys
import time

import numpy as np
import torch

SIG = 6.30e-18
DR = 6.7e20
DR_THERMAL = 2.0e21
DR_HE = 2.0e21
ABU_HE = 0.074
CHEM = dict(bh00=2.59e-13, albpow=-0.7, colh0=1.3e-8 * 0.83 / 13.598 ** 2,
            temph0=13.598 / 8.617e-05, abu_c=7.1e-7)

SOURCE_WORLD = 4
DOMAIN_WORLD = 8

# per case: the configuration both the ranks and the parent's references
# build from (inputs are in inputs.npz under "<case>/<name>")
SOURCE = {
    "trace_flat": dict(N=8, batch=2, mesh=(4, 1)),
    "trace_cheb": dict(N=8, R=3.0, batch=2, mesh=(2, 2)),
    "evolve_flat": dict(N=8, batch=1, mesh=(2, 2), dt=1e13),
    "thermal": dict(N=8, R=1e9, batch=2, mesh=(4, 1), dt=3.0e13, zred=9.0),
    "helium": dict(N=8, R=3.0, batch=1, mesh=(4, 1), dt=1.0e13),
    "helium_thermal": dict(N=8, R=3.0, batch=1, mesh=(4, 1), dt=1.0e13,
                           zred=9.0),
    "adaptive_trace": dict(N=12, R=6.0, radii=(3.0, 6.0), batch=2,
                           R_min=3.0, mesh=(2, 2)),
    "adaptive_evolve": dict(N=8, R=4.0, radii=(2.0, 4.0), batch=1,
                            R_min=2.0, mesh=(2, 2), dt=1e13),
    "adaptive_empty": dict(N=8, R=4.0, radii=(2.0, 4.0), batch=2,
                           R_min=2.0, mesh=(4, 1)),
    "loss_warning": dict(N=8, R=4.0, radii=(2.0, 4.0), batch=1, R_min=2.0,
                         mesh=(4, 1), dt=1e13),
    "global_pass": dict(N=8, mesh=(4, 1), dt=3.15e13),
    "uneven": dict(N=5, mesh=(4, 1), dt=1e13),
    "model_test": dict(N=8, mesh=(4, 1), steps=2),
    "model_he": dict(N=8, mesh=(4, 1), steps=1),
    "model_cubep3m": dict(N=12, mesh=(4, 1)),
}
DOMAIN = {
    "halo_2x2": dict(N=16, R=3.0, mesh=(2, 2, 1)),
    "halo_4x2": dict(N=16, R=6.0, mesh=(4, 2, 1)),
    "trace_2x4": dict(N=16, R=3.0, batch=2, mesh=(2, 4, 1)),
    "trace_multihop": dict(N=16, R=5.0, batch=2, mesh=(8, 1, 1)),
    "trace_fullbox": dict(N=8, R=1e9, batch=2, mesh=(4, 2, 1)),
    "trace_2x2x2": dict(N=32, R=3.0, batch=2, mesh=(2, 2, 2)),
    "trace_nondiv_i": dict(N=10, R=3.0, batch=2, mesh=(3, 2, 1)),
    "trace_nondiv_k": dict(N=10, R=2.0, batch=2, mesh=(2, 1, 3)),
    "evolve_2x4": dict(N=8, R=1e9, batch=2, mesh=(2, 4, 1), dt=3.0e13),
    "evolve_nondiv": dict(N=10, R=1e9, batch=2, mesh=(3, 1, 2), dt=3.0e13),
    "thermal": dict(N=8, R=1e9, batch=2, mesh=(2, 4, 1), dt=3.0e13,
                    zred=9.0),
    "helium": dict(N=8, R=3.0, batch=1, mesh=(2, 2, 2), dt=1.0e13),
    "helium_thermal": dict(N=8, R=3.0, batch=1, mesh=(2, 2, 2), dt=1.0e13,
                           zred=9.0),
    "adaptive_evolve": dict(N=16, R=5.0, radii=(3.0, 5.0), batch=2,
                            R_min=1.0, mesh=(2, 2, 1), dt=3.0e13),
    "adaptive_trace": dict(N=16, R=6.0, radii=(3.0, 6.0), batch=4,
                           R_min=1.0, mesh=(2, 2, 2)),
    "adaptive_empty": dict(N=16, R=6.0, radii=(3.0, 6.0), batch=4,
                           R_min=1.0, mesh=(2, 2, 1)),
    "traffic": dict(N=16, R=3.0, batch=2, mesh=(2, 2, 2), dt=1e13),
    "model_test": dict(N=8, mesh=(2, 2, 2), steps=2),
    "model_he": dict(N=8, mesh=(2, 2, 2), steps=1),
    "model_cubep3m": dict(N=12, mesh=(2, 2, 2)),
}


# -- engines and parameters shared with the parent (port side) ------------

def chem():
    from pyc2ray_torch.ops.chemistry import ChemistryParams
    return ChemistryParams(**CHEM)


def thermal():
    from pyc2ray_torch.ops.thermal import ThermalParams
    return ThermalParams(**CHEM, compton=False)


def grey():
    from pyc2ray_torch.radiation.spectral_bins import SpectralBins
    return SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                        w_heat=np.array([0.0]), num_bins=1)


def grey_heat():
    """One bin with a heating weight, so the heat channel is not zero."""
    from pyc2ray_torch.radiation.spectral_bins import SpectralBins
    return SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                        w_heat=np.array([3.0e-12]), num_bins=1)


def he_bins():
    from pyc2ray_torch.constants import ev2fr
    from pyc2ray_torch.radiation import BlackBodySource
    from pyc2ray_torch.radiation.helium import (HE_EDGES_EV,
                                                make_spectral_bins_he)
    bb = BlackBodySource(1e5, False, ev2fr * HE_EDGES_EV[0], 2.8)
    return make_spectral_bins_he(bb, panels_per_band=2, nodes=2)


def he_params():
    from pyc2ray_torch.ops.chemistry_he import HeChemistryParams
    return HeChemistryParams(chem=chem(), abu_he=ABU_HE)


TABLE_KEYS = ("photo_thin", "photo_thick", "heat_thin", "heat_thick",
              "minlogtau", "dlogtau")


def flat_engine(c, I, device="cpu"):
    """The flat engine on the tables of ``I`` (TABLE_KEYS: the layout of
    tests/test_raytrace.py's TABLES)."""
    from pyc2ray_torch.ops.raytrace import RaytraceConfig, Raytracer
    cfg = RaytraceConfig(N=c["N"], R_max_LLS=1e9, sig=SIG,
                         batch_size=c["batch"], dtype=torch.float64)
    return Raytracer(cfg, I["photo_thin"], I["photo_thick"],
                     float(I["minlogtau"]), float(I["dlogtau"]),
                     device=device)


def cheb_engine(c, heating=False, device="cpu"):
    from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
    return ChebRaytracer(c["N"], c["R"], SIG,
                         grey_heat() if heating else grey(),
                         batch_size=c["batch"], dtype=torch.float64,
                         device=device, do_heating=heating)


def adaptive_engine(c, device="cpu"):
    from pyc2ray_torch.ops.adaptive import AdaptiveRaytracer
    return AdaptiveRaytracer(c["N"], c["R"], SIG, grey(),
                             radii=list(c["radii"]), batch_size=c["batch"],
                             dtype=torch.float64, device=device,
                             R_min=c["R_min"])


def he_engine(c, heating=False, device="cpu"):
    from pyc2ray_torch.ops.raytrace_he import HeRaytracer
    return HeRaytracer(c["N"], c["R"], he_bins(), ABU_HE,
                       batch_size=c["batch"], dtype=torch.float64,
                       device=device, do_heating=heating)


def count_iterations(text):
    """Raytrace iterations in an evolve log (one "Iteration n took" line
    each, in both packages' sharded loops)."""
    return sum(1 for line in text.splitlines()
               if line.startswith("Iteration ") and " took " in line)


# -- the world --------------------------------------------------------------

class World:
    """``suite`` ("source" or "domain") running on ``n_ranks`` spawned gloo
    ranks in the background, so that the parent computes its references
    meanwhile. ``wait`` returns the work directory once every rank has
    finished; it raises with a failing rank's traceback, or kills the ranks
    after ``timeout_s``."""

    def __init__(self, n_ranks, suite, workdir, timeout_s=600):
        import torch.multiprocessing as mp
        self.workdir = workdir
        self._deadline = time.monotonic() + timeout_s
        self._ctx = mp.start_processes(
            _rank_main, args=(n_ranks, os.path.join(workdir, "rendezvous"),
                              suite, workdir, timeout_s // 2),
            nprocs=n_ranks, join=False, start_method="spawn")
        self._done = False

    def wait(self):
        while not self._done:
            left = self._deadline - time.monotonic()
            if left <= 0:
                for p in self._ctx.processes:
                    p.kill()
                raise TimeoutError("the world of ranks did not finish")
            self._done = self._ctx.join(timeout=min(left, 5.0))
        return self.workdir

    def out(self, case, rank=0):
        """The arrays rank ``rank`` saved for ``case``."""
        path = os.path.join(self.wait(), f"{case}.r{rank}.npz")
        with np.load(path) as f:
            return {k: f[k] for k in f.files}


def _rank_main(rank, n_ranks, init, suite, workdir, timeout_s):
    import torch.distributed as dist
    from pyc2ray_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(init_method="file://" + init, world_size=n_ranks,
                         rank=rank, backend="gloo", timeout_s=timeout_s)
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    cases = SOURCE_CASES if suite == "source" else DOMAIN_CASES
    for name, fn in cases.items():
        I = {k.split("/", 1)[1]: v for k, v in inputs.items()
             if k.startswith(name + "/")}
        out = fn(rank, I, os.path.join(workdir, name))
        if out is not None:
            np.savez(os.path.join(workdir, f"{name}.r{rank}.npz"), **out)
    dist.barrier()
    np.savez(os.path.join(workdir, f"modules.r{rank}.npz"),
             jax=any(m == "jax" or m.startswith(("jax.", "pyc2ray_tpu"))
                     for m in sys.modules))
    dist.destroy_process_group()


_MESHES = {}


def _mesh(shape):
    """The mesh of ``shape`` (2 axes: source, 3: domain), made once per
    world (every rank makes the same meshes in the same order)."""
    from pyc2ray_torch.parallel import make_domain_mesh, make_mesh
    if shape not in _MESHES:
        _MESHES[shape] = (make_mesh(*shape, device="cpu") if len(shape) == 2
                          else make_domain_mesh(*shape, device="cpu"))
    return _MESHES[shape]


def _log(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def _read(path):
    with open(path) as f:
        return f.read()


# -- source-parallel cases ---------------------------------------------------

def _src_trace_flat(rank, I, wd):
    from pyc2ray_torch.parallel import (prepare_sources_sharded,
                                        trace_sharded)
    c = SOURCE["trace_flat"]
    mesh = _mesh(c["mesh"])
    rt = flat_engine(c, I)
    phi = trace_sharded(rt, mesh, I["nd"], I["xh"], I["src"], I["flux"], DR)
    pos, flux = prepare_sources_sharded(rt, mesh, I["src"], I["flux"])
    return dict(phi=phi.numpy(), pos=pos.numpy(), flux=flux.numpy())


def _src_trace_cheb(rank, I, wd):
    from pyc2ray_torch.parallel import trace_sharded
    c = SOURCE["trace_cheb"]
    phi = trace_sharded(cheb_engine(c), _mesh(c["mesh"]), I["nd"], I["xh"],
                        I["src"], I["flux"], DR)
    return dict(phi=phi.numpy())


def _evolve_out(out, log, names=("xh", "phi")):
    res = dict(zip(names, out))
    res["iterations"] = count_iterations(_read(log)) if log else -1
    return res


def _src_evolve_flat(rank, I, wd):
    from pyc2ray_torch.parallel import evolve3D_sharded
    c = SOURCE["evolve_flat"]
    log = _log(os.path.join(wd, "evolve.log"))
    out = evolve3D_sharded(c["dt"], DR, I["flux"], I["src"],
                           flat_engine(c, I), _mesh(c["mesh"]),
                           chem(), I["temp"], I["nd"], I["xh"],
                           logfile=log, quiet=True)
    return _evolve_out(out, log if rank == 0 else None)


def _src_thermal(rank, I, wd):
    from pyc2ray_torch.parallel import evolve3D_sharded
    c = SOURCE["thermal"]
    log = _log(os.path.join(wd, "evolve.log"))
    out = evolve3D_sharded(c["dt"], DR_THERMAL, I["flux"], I["src"],
                           cheb_engine(c, heating=True), _mesh(c["mesh"]),
                           chem(), I["temp"], I["nd"], I["xh"],
                           logfile=log, quiet=True, thermal=thermal(),
                           zred=c["zred"])
    return _evolve_out(out, log if rank == 0 else None,
                       ("xh", "phi", "temp"))


HE_NAMES = ("xh", "phi_HI", "y1", "y2", "phi_HeI", "phi_HeII")


def _src_helium(rank, I, wd, case="helium"):
    from pyc2ray_torch.parallel import evolve3D_he_sharded
    c = SOURCE[case]
    heat = case == "helium_thermal"
    log = _log(os.path.join(wd, "evolve.log"))
    kw = dict(thermal=thermal(), zred=c["zred"]) if heat else {}
    out = evolve3D_he_sharded(c["dt"], DR_HE, I["flux"], I["src"],
                              he_engine(c, heating=heat), _mesh(c["mesh"]),
                              he_params(), I["temp"], I["nd"], I["xh"],
                              I["y1"], I["y2"], logfile=log, quiet=True, **kw)
    return _evolve_out(out, log if rank == 0 else None,
                       HE_NAMES + (("temp",) if heat else ()))


def _src_helium_thermal(rank, I, wd):
    return _src_helium(rank, I, wd, "helium_thermal")


def _src_adaptive_trace(rank, I, wd):
    from pyc2ray_torch.parallel import (prepare_sources_sharded,
                                        trace_sharded)
    c = SOURCE["adaptive_trace"]
    mesh = _mesh(c["mesh"])
    rt = adaptive_engine(c)
    phi = trace_sharded(rt, mesh, I["nd"], I["xh"], I["src"], I["flux"], DR)
    pos, flux = prepare_sources_sharded(rt, mesh, I["src"], I["flux"],
                                        dr=DR, avg_dens=float(I["nd"].mean()))
    out = dict(phi=phi.numpy())
    for k, (p, f) in enumerate(zip(pos, flux)):
        out[f"pos{k}"] = p.numpy()
        out[f"flux{k}"] = f.numpy()
    return out


def _src_adaptive_evolve(rank, I, wd):
    from pyc2ray_torch.parallel import evolve3D_sharded
    c = SOURCE["adaptive_evolve"]
    log = _log(os.path.join(wd, "evolve.log"))
    out = evolve3D_sharded(c["dt"], DR, I["flux"], I["src"],
                           adaptive_engine(c), _mesh(c["mesh"]), chem(),
                           I["temp"], I["nd"], I["xh"], logfile=log,
                           quiet=True)
    return _evolve_out(out, log if rank == 0 else None)


def _src_adaptive_empty(rank, I, wd):
    from pyc2ray_torch.parallel import (prepare_sources_sharded,
                                        trace_sharded)
    c = SOURCE["adaptive_empty"]
    mesh = _mesh(c["mesh"])
    rt = adaptive_engine(c)
    phi = trace_sharded(rt, mesh, I["nd"], I["xh"], I["src"], I["flux"], DR)
    pos, flux = prepare_sources_sharded(rt, mesh, I["src"], I["flux"],
                                        dr=DR, avg_dens=float(I["nd"].mean()))
    return dict(phi=phi.numpy(),
                shapes=np.array([p.shape[0] for p in pos]),
                flux_max=np.array([float(f.max()) for f in flux]))


def _src_loss_warning(rank, I, wd):
    from pyc2ray_torch.parallel import evolve3D_sharded
    c = SOURCE["loss_warning"]
    log = _log(os.path.join(wd, f"warn.r{rank}.log"))
    evolve3D_sharded(c["dt"], DR, I["flux"], I["src"], adaptive_engine(c),
                     _mesh(c["mesh"]), chem(), I["temp"], I["nd"], I["xh"],
                     logfile=log, quiet=True, loss_fraction=1e-30)
    text = _read(log) if os.path.exists(log) else ""
    return dict(warned="exceeds" in text and "loss_fraction" in text,
                logged=bool(text))


def _src_global_pass(rank, I, wd):
    from pyc2ray_torch.parallel import global_pass_sharded
    c = SOURCE["global_pass"]
    t = {k: torch.from_numpy(I[k]) for k in ("nd", "temp", "xh", "phi")}
    xi, xa, cf = global_pass_sharded(_mesh(c["mesh"]), c["dt"], t["nd"],
                                     t["temp"], t["xh"], t["xh"], t["phi"],
                                     chem())
    return dict(xi=xi.numpy(), xav=xa.numpy(), cf=cf)


def _src_uneven(rank, I, wd):
    """N^3 = 125 cells over 4 ranks: refused before any collective."""
    from pyc2ray_torch.parallel import evolve3D_sharded
    c = SOURCE["uneven"]
    N = c["N"]
    g = np.full((N,) * 3, 1e-3)
    try:
        evolve3D_sharded(c["dt"], DR, np.ones(1), np.array([[2, 2, 2]]),
                         cheb_engine(dict(N=N, R=2.0, batch=1)),
                         _mesh(c["mesh"]), chem(), g * 1e7, g, g,
                         quiet=True)
    except ValueError as e:
        return dict(error=str(e))
    return dict(error="")


def _model_params(I, results, engine="cheb"):
    from pyc2ray_torch.utils.paramutils import read_paramfile
    text = str(I["yml"]).replace("@RESULTS@", results)
    path = results + "parameters.yml"
    os.makedirs(results, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return read_paramfile(path)


def run_model_test(params, N, steps, mesh=None):
    """C2Ray_Test with one source at the centre for ``steps`` timesteps,
    the outputs written after each (the loop of tests/test_torch_models)."""
    from pyc2ray_torch import C2Ray_Test
    sim = C2Ray_Test(params, N, mesh=mesh, device="cpu")
    sim.ndens = 1e-3 * np.ones((N,) * 3)
    zreds = sim.generate_redshift_array(2, 2e6)
    dt = sim.set_timestep(zreds[0], zreds[1], steps)
    pos = np.array([[N // 2], [N // 2], [N // 2]], dtype=float)
    for n in range(steps):
        sim.evolve3D(dt, np.array([10.0]), pos)
        sim.write_output_numbered(n)
    return sim


def run_model_cubep3m(params, N, zlist, mesh=None):
    """C2Ray_CubeP3M on the synthetic inputs: one slice of
    tests/test_torch_cubep3m.py (four sources, one timestep)."""
    from pyc2ray_torch import C2Ray_CubeP3M
    sim = C2Ray_CubeP3M(params, N, mesh=mesh, device="cpu")
    sim.read_density(zlist[0])
    srcpos, flux = sim.read_sources(os.path.join(
        params["Output"]["inputs_basename"], "sources",
        f"{zlist[0]:.3f}-sources.hdf5"))
    dt = sim.set_timestep(zlist[0], zlist[1], 1)
    sim.cosmo_evolve(dt)
    sim.evolve3D(dt, flux[:4], srcpos[:, :4])
    sim.write_output(zlist[1])
    return sim


def _model_case(rank, I, wd, table, case):
    c = table[case]
    results = os.path.join(wd, f"r{rank}") + "/"
    mesh = _mesh(c["mesh"])
    params = _model_params(I, results)
    if case == "model_cubep3m":
        sim = run_model_cubep3m(params, c["N"], tuple(I["zlist"]), mesh)
    else:
        sim = run_model_test(params, c["N"], c["steps"], mesh)
    files = sorted(f for f in os.listdir(results)
                   if not f.endswith(".yml"))
    out = dict(xh=sim.xh, phi=sim.phi_ion, temp=sim.temp,
               files=np.array(files, dtype=str))
    if sim.multi_species:
        out.update(xhe1=sim.xhe1, xhe2=sim.xhe2)
    return out


def _src_model_test(rank, I, wd):
    return _model_case(rank, I, wd, SOURCE, "model_test")


def _src_model_he(rank, I, wd):
    return _model_case(rank, I, wd, SOURCE, "model_he")


def _src_model_cubep3m(rank, I, wd):
    return _model_case(rank, I, wd, SOURCE, "model_cubep3m")


SOURCE_CASES = {
    "trace_flat": _src_trace_flat, "trace_cheb": _src_trace_cheb,
    "evolve_flat": _src_evolve_flat, "thermal": _src_thermal,
    "helium": _src_helium, "helium_thermal": _src_helium_thermal,
    "adaptive_trace": _src_adaptive_trace,
    "adaptive_evolve": _src_adaptive_evolve,
    "adaptive_empty": _src_adaptive_empty,
    "loss_warning": _src_loss_warning, "global_pass": _src_global_pass,
    "uneven": _src_uneven, "model_test": _src_model_test,
    "model_he": _src_model_he, "model_cubep3m": _src_model_cubep3m,
}


# -- domain cases -----------------------------------------------------------

def _domain(c, engine):
    """(decomposition, mesh) of case ``c`` on this rank, or None off the
    mesh."""
    from pyc2ray_torch.parallel import DomainDecomposition
    mesh = _mesh(c["mesh"])
    if not mesh.member:
        return None
    return DomainDecomposition(engine, mesh)


def _dom_halo(rank, I, wd, case):
    c = DOMAIN[case]
    dd = _domain(c, cheb_engine(dict(c, batch=2)))
    if dd is None:
        return None
    f = torch.from_numpy(I["f"])
    ext = dd.halo_gather(dd.local_block(f))
    red = dd.halo_reduce(ext)
    return dict(ext=ext.numpy(), red=red.numpy(), coords=np.array(dd.coords),
                hlo=dd.hlo, hhi=dd.hhi, L=np.array([dd.Li, dd.Lj, dd.Lk]))


def _dom_trace(rank, I, wd, case):
    c = DOMAIN[case]
    dd = _domain(c, cheb_engine(c))
    if dd is None:
        return None
    phi = dd.trace(I["nd"], I["xh"], I["src"], I["flux"], DR)
    srcs = dd.prepare_sources(I["src"], I["flux"])
    out = dict(phi=phi.numpy(), n_interior=dd.n_interior,
               padded=dd.padded)
    for k, s in zip(("pos_i", "flux_i", "pos_b", "flux_b"), srcs):
        if s is not None:
            out[k] = s.numpy()
    return out


def _dom_evolve(rank, I, wd, case):
    from pyc2ray_torch.parallel import evolve3D_domain
    c = DOMAIN[case]
    heat = case == "thermal"
    adaptive = "radii" in c
    eng = adaptive_engine(c) if adaptive else cheb_engine(c, heating=heat)
    dd = _domain(c, eng)
    if dd is None:
        return None
    log = _log(os.path.join(wd, "evolve.log"))
    kw = dict(thermal=thermal(), zred=c["zred"]) if heat else {}
    dr = DR_THERMAL if heat else DR
    out = evolve3D_domain(c["dt"], dr, I["flux"], I["src"], dd, chem(),
                          I["temp"], I["nd"], I["xh"], logfile=log,
                          quiet=True, **kw)
    return _evolve_out(out, log if rank == 0 else None,
                       ("xh", "phi", "temp") if heat else ("xh", "phi"))


def _dom_helium(rank, I, wd, case):
    from pyc2ray_torch.parallel import evolve3D_he_domain
    c = DOMAIN[case]
    heat = case == "helium_thermal"
    dd = _domain(c, he_engine(c, heating=heat))
    if dd is None:
        return None
    log = _log(os.path.join(wd, "evolve.log"))
    kw = dict(thermal=thermal(), zred=c["zred"]) if heat else {}
    out = evolve3D_he_domain(c["dt"], DR_HE, I["flux"], I["src"], dd,
                             he_params(), I["temp"], I["nd"], I["xh"],
                             I["y1"], I["y2"], logfile=log, quiet=True, **kw)
    return _evolve_out(out, log if rank == 0 else None,
                       HE_NAMES + (("temp",) if heat else ()))


def _dom_adaptive_trace(rank, I, wd, case):
    c = DOMAIN[case]
    dd = _domain(c, adaptive_engine(c))
    if dd is None:
        return None
    phi = dd.trace(I["nd"], I["xh"], I["src"], I["flux"], DR)
    srcs = dd.prepare_sources(I["src"], I["flux"], dr=DR,
                              avg_dens=float(I["nd"].mean()))
    out = dict(phi=phi.numpy(), hlo=dd.hlo,
               slots=np.array([s is not None for s in srcs]))
    for k, s in enumerate(srcs):
        if s is None:
            continue
        for b, t in enumerate(s):
            if t is not None:
                out[f"s{k}_b{b}"] = t.numpy()
    return out


def _dom_traffic(rank, I, wd, case):
    """One domain step with boundary sources: the bytes this rank's halo
    exchange sends."""
    c = DOMAIN[case]
    dd = _domain(c, cheb_engine(c))
    if dd is None:
        return None
    srcs = dd.prepare_sources(I["src"], I["flux"])
    step = dd.make_step(chem(), srcs)
    f = torch.ones((dd.Li, dd.Lj, dd.Lk), dtype=torch.float64)
    dd.mesh.reset_traffic()
    step(f * 1e-3, f * 1e4, f * 1e-3, f * 1e-3,
         torch.tensor(c["dt"], dtype=torch.float64), DR)
    t = dd.mesh.traffic
    return dict(halo=t["halo"]["bytes"], boundary=srcs[2] is not None,
                kinds=np.array(sorted(t), dtype=str),
                other=sum(v["bytes"] for k, v in t.items() if k != "halo"),
                hlo=dd.hlo, hhi=dd.hhi, L=np.array([dd.Li, dd.Lj, dd.Lk]))


def _dom_model(rank, I, wd, case):
    return _model_case(rank, I, wd, DOMAIN, case)


def _bind(fn, case):
    return lambda rank, I, wd: fn(rank, I, wd, case)


DOMAIN_CASES = {
    "halo_2x2": _bind(_dom_halo, "halo_2x2"),
    "halo_4x2": _bind(_dom_halo, "halo_4x2"),
    **{k: _bind(_dom_trace, k) for k in
       ("trace_2x4", "trace_multihop", "trace_fullbox", "trace_2x2x2",
        "trace_nondiv_i", "trace_nondiv_k")},
    **{k: _bind(_dom_evolve, k) for k in
       ("evolve_2x4", "evolve_nondiv", "thermal", "adaptive_evolve")},
    "helium": _bind(_dom_helium, "helium"),
    "helium_thermal": _bind(_dom_helium, "helium_thermal"),
    "adaptive_trace": _bind(_dom_adaptive_trace, "adaptive_trace"),
    "adaptive_empty": _bind(_dom_adaptive_trace, "adaptive_empty"),
    "traffic": _bind(_dom_traffic, "traffic"),
    "model_test": _bind(_dom_model, "model_test"),
    "model_he": _bind(_dom_model, "model_he"),
    "model_cubep3m": _bind(_dom_model, "model_cubep3m"),
}
