"""Abstract simulation base class.

PyTorch twin of pyc2ray_tpu/models/base.py, itself the equivalent of the
reference's ``C2Ray`` base class (pyc2ray/c2ray_base.py:83-512): owns
parameters, grid, cosmology, radiation tables, the raytracer and the
time-evolution methods. Concrete simulations subclass it and override the
``_*_init`` hooks, like the reference's template pattern
(c2ray_base.py:466-484).

Differences from the JAX package:
* ``device`` selects where the raytracer and the evolve loop run ("cuda"
  by default; "cpu" runs the plain PyTorch versions of the kernels).
* ``paramfile`` may be an already-parsed mapping instead of the path of a
  YAML file (PyYAML is imported only to read a file).
* ``Raytracing.engine``: ``cheb`` and ``pallas`` both build the port's
  ``ChebRaytracer`` (on the GPU there is one implementation of the
  Chebyshev-face engine: the sweep is a CUDA kernel on a CUDA device and
  its plain version on the CPU); ``adaptive`` builds ``AdaptiveRaytracer``,
  one such engine per flux bucket. Every Chebyshev engine the model layer
  builds runs the fused mode ``fuse_fold`` (sweep, box and rates in one
  kernel per batch, K3, or K3h with the heating rates) on both devices:
  it computes the same Gamma as the default mode, several times faster on
  the card. ``flat`` (the YAML default) builds the table-exact octahedral
  ``Raytracer`` (ops/raytrace.py), the engine of the 2e-5 golden
  (examples/single_source_test); ``he`` builds the three-species
  ``HeRaytracer`` (ops/raytrace_he.py) and evolves hydrogen and helium
  together (``evolve3D_he``); ``box`` builds the octahedral sheet engine
  ``BoxRaytracer`` (ops/raytrace_box.py) on the spectral bins of ``cheb``.
  The window accumulate, a layout device of the TPU, is not ported and
  raises ``NotImplementedError`` naming the ROADMAP.md item; no engine is
  mapped onto another.
* ``mesh`` is a mesh of ranks of ``pyc2ray_torch.parallel`` (one process
  per rank on torch.distributed, every rank building the same simulation):
  a ("src", "space") mesh runs the source-parallel path, a ("di", "dj",
  "dk") mesh the domain-decomposed one, as the JAX model layer switches on
  its device mesh. Only the primary rank writes the log and the output
  files.
"""

import numpy as np
import torch

from ..constants import Mpc, YEAR, ev2fr, ev2k
from ..cosmology import FlatLambdaCDM
from ..device import resolve_device
from ..evolve import evolve3D, evolve3D_he
from ..ops.chemistry import ChemistryParams
from ..radiation import BlackBodySource, make_tau_table
from ..utils.logutils import printlog
from ..utils.paramutils import read_paramfile
from ..utils.sourceutils import format_sources

__all__ = ["C2RaySimulation"]

# Defaults for optional YAML keys (reference requires every key; missing ->
# KeyError, TODO noted at c2ray_base.py:64-67)
_DEFAULTS = {
    "Grid": {"resume": 0},
    "Photo": {"compute_heating_rates": 0, "grey": 0,
              "SourceType": "blackbody", "secondary_ionization": 0,
              "secondary_ramp": 0, "recombination_photons": 0},
    "Raytracing": {"source_batch_size": 8, "convergence_fraction": 1e-4,
                   "loss_fraction": 1e-2, "subboxsize": 150,
                   "max_subbox": 1000, "dtype": "float64",
                   "engine": "flat"},
    "Output": {"logfile": "pyC2Ray.log"},
}

class C2RaySimulation:
    """Base class for a C2Ray-style reionization simulation in PyTorch."""

    def __init__(self, paramfile, Nmesh, use_gpu=True, use_mpi=None,
                 mesh=None, device=None):
        """
        Parameters
        ----------
        paramfile : str or mapping
            YAML parameter file (same schema as the reference pyc2ray), or
            the parsed parameters as a nested dict.
        Nmesh : int
            Mesh size.
        use_gpu, use_mpi :
            Accepted for API compatibility with the reference constructor
            signature (c2ray_base.py:84); ignored (see ``device``).
        mesh : pyc2ray_torch.parallel mesh, optional
            A mesh of ranks for multi-GPU execution: ``make_mesh`` (source
            parallel) or ``make_domain_mesh`` (domain decomposition).
        device : str or torch.device, optional
            Where the raytracer and the evolve loop run: "cuda" (the
            default; under a mesh the rank's card, ``mesh.device``) or
            "cpu".
        """
        del use_gpu, use_mpi
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.primary = self.rank == 0
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        self.device = resolve_device(device)

        self._read_paramfile(paramfile)
        self.N = Nmesh
        self.shape = (Nmesh, Nmesh, Nmesh)

        self._param_init()
        self._output_init()
        self._grid_init()
        self._cosmology_init()
        self._redshift_init()
        self._material_init()
        self._sources_init()
        self._radiation_init()
        self._raytracer_init()
        self.printlog("Starting simulation... \n\n")

    # ==================================================================
    # TIME-EVOLUTION METHODS (c2ray_base.py:147-257)
    # ==================================================================
    def set_timestep(self, z1, z2, num_timesteps):
        """Timestep between two redshift slices, in seconds
        (c2ray_base.py:147-168)."""
        t1 = self.cosmology.lookback_time(z1)
        t2 = self.cosmology.lookback_time(z2)
        return (t1 - t2) / num_timesteps

    def evolve3D(self, dt, src_flux, src_pos):
        """Evolve the grid over one timestep (c2ray_base.py:170-226).

        src_pos is (3, NumSrc) 1-indexed (reference convention). Updates
        ``xh`` and ``phi_ion``, and ``temp`` in the non-isothermal mode."""
        pos, flux = format_sources(src_pos, src_flux)
        common = dict(convergence_fraction=self.convergence_fraction,
                      logfile=self.logfile, quiet=not self.primary,
                      thermal=self.thermal, zred=self.zred,
                      loss_fraction=self.loss_fraction)
        # the JAX model layer's switch (its models/base.py:113-175): a
        # ("di", ...) mesh decomposes the grid, any other mesh splits the
        # sources
        domain = self.mesh is not None and "di" in self.mesh.axis_names
        if self.multi_species:
            args = (self.chem_he, self.temp, self.ndens, self.xh, self.xhe1,
                    self.xhe2)
            if domain:
                from ..parallel.domain import evolve3D_he_domain
                out = evolve3D_he_domain(dt, self.dr, flux, pos,
                                         self._decomposition(), *args,
                                         **common)
            elif self.mesh is not None:
                from ..parallel.source_parallel import evolve3D_he_sharded
                out = evolve3D_he_sharded(dt, self.dr, flux, pos,
                                          self.raytracer, self.mesh, *args,
                                          **common)
            else:
                out = evolve3D_he(dt, self.dr, flux, pos, self.raytracer,
                                  *args, **common)
            (self.xh, self.phi_ion, self.xhe1, self.xhe2,
             self.phi_he1, self.phi_he2) = out[:6]
            if self.thermal is not None:
                self.temp = out[6]
            return
        if self.mesh is not None and not domain \
                and not hasattr(self.raytracer, "shard_trace"):
            raise NotImplementedError(
                f"engine {type(self.raytracer).__name__} does not support "
                "the source-parallel mesh (no shard_trace); use engine: "
                "cheb, pallas or flat under a mesh")
        args = (self.chem, self.temp, self.ndens, self.xh)
        if domain:
            from ..parallel.domain import evolve3D_domain
            out = evolve3D_domain(dt, self.dr, flux, pos,
                                  self._decomposition(), *args, **common)
        elif self.mesh is not None:
            from ..parallel.source_parallel import evolve3D_sharded
            out = evolve3D_sharded(dt, self.dr, flux, pos, self.raytracer,
                                   self.mesh, *args, **common)
        else:
            out = evolve3D(dt, self.dr, flux, pos, self.raytracer, *args,
                           **common)
        if self.thermal is not None:
            self.xh, self.phi_ion, self.temp = out
        else:
            self.xh, self.phi_ion = out

    def _decomposition(self):
        """The domain decomposition of the raytracer over the mesh, made
        once."""
        if getattr(self, "_decomp", None) is None:
            from ..parallel.domain import DomainDecomposition
            self._decomp = DomainDecomposition(self.raytracer, self.mesh)
        return self._decomp

    def cosmo_evolve(self, dt):
        """Dilute density / contract cell size over a timestep using the
        half-step redshift convention (c2ray_base.py:229-257)."""
        t_now = self.time
        t_half = t_now + 0.5 * dt
        t_after = t_now + dt
        z_half = self.time2zred(t_half)
        if self.cosmological:
            dilution = ((1 + z_half) / (1 + self.zred)) ** 3
            self.ndens = self.ndens * dilution
            self.dr = self.dr_c * self.cosmology.scale_factor(z_half)
            if not getattr(self, "isothermal", True):
                # adiabatic cooling of the expanding gas: T ~ rho^(2/3)
                self.temp = self.temp * dilution ** (2.0 / 3.0)
        self.zred = z_half
        self.time = t_after

    def do_raytracing(self, src_flux, src_pos, stats=False):
        """Standalone Gamma computation (c2ray_base.py:300-323).

        With ``stats=True`` also returns a diagnostics dict with the
        photon-loss fraction and, for the adaptive engine, the bucket
        assignment (the analog of the reference's
        ``do_raytracing(..., stats=True) -> (phi, nsubbox, photonloss)``,
        reference raytracing.py:105-108; bucket counts play nsubbox's
        role)."""
        pos, flux = format_sources(src_pos, src_flux)
        if self.multi_species:
            g = self.raytracer.trace(self.ndens, self.xh, self.xhe1,
                                     self.xhe2, pos, flux, self.dr)
            self.phi_ion, self.phi_he1, self.phi_he2 = (
                t.cpu().numpy() for t in g[:3])
            if stats:
                from ..diagnostics import photon_budget
                return self.phi_ion, photon_budget(
                    self.phi_ion, self.ndens, self.xh, flux, self.dr)
            return self.phi_ion
        bucket_stats = None
        if getattr(self.raytracer, "needs_flux_bucketing", False):
            out, bucket_stats = self.raytracer.trace(
                self.ndens, self.xh, pos, flux, self.dr, stats=True)
        else:
            out = self.raytracer.trace(self.ndens, self.xh, pos, flux,
                                       self.dr)
        if self.raytracer.config.do_heating and bucket_stats is None:
            self.phi_ion = out[0].cpu().numpy()
            self.phi_heat = out[1].cpu().numpy()
        else:
            self.phi_ion = out.cpu().numpy()
        if stats:
            from ..diagnostics import photon_budget
            st = photon_budget(self.phi_ion, self.ndens, self.xh,
                               flux, self.dr)
            if bucket_stats is not None:
                st.update(bucket_stats)
            return self.phi_ion, st
        return self.phi_ion

    # ==================================================================
    # UTILITY METHODS
    # ==================================================================
    def time2zred(self, t):
        return self.cosmology.z_at_age(t)

    def zred2time(self, z, unit="s"):
        t = self.cosmology.age(z)
        return t / YEAR if unit in ("yr", "yrs") else t

    def printlog(self, s, quiet=False):
        """Log ``s``: on the primary rank only."""
        if self.logfile is None:
            raise RuntimeError("Please set the log file in _output_init")
        if self.primary:
            printlog(s, self.logfile, quiet)

    def write_output(self, z):
        pass

    # ==================================================================
    # INITIALIZATION (private; template hooks as in c2ray_base.py:466-484)
    # ==================================================================
    def _param_init(self):
        """CGS constants & misc parameters -> attributes
        (c2ray_base.py:329-352)."""
        ld = self._ld
        self.eth0 = ld["CGS"]["eth0"]
        self.ethe0 = ld["CGS"]["ethe0"]
        self.ethe1 = ld["CGS"]["ethe1"]
        self.bh00 = ld["CGS"]["bh00"]
        self.fh0 = ld["CGS"]["fh0"]
        self.xih0 = ld["CGS"]["xih0"]
        self.albpow = ld["CGS"]["albpow"]
        self.abu_h = ld["Abundances"]["abu_h"]
        self.abu_he = ld["Abundances"]["abu_he"]
        self.mean_molecular = self.abu_h + 4.0 * self.abu_he
        self.abu_c = ld["Abundances"]["abu_c"]
        self.colh0 = ld["CGS"]["colh0_fact"] * self.fh0 * self.xih0 / self.eth0 ** 2
        self.temph0 = self.eth0 * ev2k
        self.sig = ld["Photo"]["sigma_HI_at_ion_freq"]
        self.loss_fraction = ld["Raytracing"]["loss_fraction"]
        self.convergence_fraction = ld["Raytracing"]["convergence_fraction"]
        self.max_subbox = ld["Raytracing"]["max_subbox"]
        self.subboxsize = ld["Raytracing"]["subboxsize"]
        self.chem = ChemistryParams(
            bh00=self.bh00, albpow=self.albpow, colh0=self.colh0,
            temph0=self.temph0, abu_c=self.abu_c)
        # Non-isothermal mode (beyond reference; the reference declares
        # the thermal chemistry TODO, README.md:81-87): Material.isothermal
        # defaults to true = reference behavior. When false, evolve3D
        # advances the temperature with the photoheating rates.
        self.isothermal = bool(ld["Material"].get("isothermal", True))
        if not self.isothermal:
            from ..ops.thermal import ThermalParams
            self.thermal = ThermalParams(
                bh00=self.bh00, albpow=self.albpow, colh0=self.colh0,
                temph0=self.temph0, abu_c=self.abu_c)
        else:
            self.thermal = None

    def _cosmology_init(self):
        """(c2ray_base.py:354-373)"""
        ld = self._ld
        h = ld["Cosmology"]["h"]
        self.cosmology = FlatLambdaCDM(
            100 * h, ld["Cosmology"]["Omega0"],
            Tcmb0=ld["Cosmology"]["cmbtemp"], Ob0=ld["Cosmology"]["Omega_B"])
        self.cosmological = bool(ld["Cosmology"]["cosmological"])
        self.zred_0 = ld["Cosmology"]["zred_0"]
        self.age_0 = self.zred2time(self.zred_0)
        if self.cosmological:
            self.printlog(
                f"Cosmology is on, scaling comoving quantities to the "
                f"initial redshift, which is z0 = {self.zred_0:.3f}...")
            self.dr = self.cosmology.scale_factor(self.zred_0) * self.dr_c
        else:
            self.printlog("Cosmology is off.")

    def _radiation_init(self):
        """Radiation tables (c2ray_base.py:375-443)."""
        ld = self._ld
        self.minlogtau = ld["Photo"]["minlogtau"]
        self.maxlogtau = ld["Photo"]["maxlogtau"]
        self.NumTau = ld["Photo"]["NumTau"]
        self.SourceType = ld["Photo"]["SourceType"]
        self.grey = bool(ld["Photo"]["grey"])
        self.compute_heating_rates = bool(ld["Photo"]["compute_heating_rates"])
        self.secondary_ionization = bool(
            ld["Photo"]["secondary_ionization"])
        self.secondary_ramp = bool(ld["Photo"]["secondary_ramp"])
        self.recombination_photons = bool(
            ld["Photo"]["recombination_photons"])

        self.tau, self.dlogtau = make_tau_table(
            self.minlogtau, self.maxlogtau, self.NumTau)

        ion_freq_HI = ev2fr * self.eth0
        ion_freq_HeII = ev2fr * self.ethe1

        if self.SourceType == "blackbody":
            freq_min = ion_freq_HI
            freq_max = 10 * ion_freq_HeII
            self.bb_Teff = ld["BlackBodySource"]["Teff"]
            self.cs_pl_idx_h = ld["BlackBodySource"]["cross_section_pl_index"]
            radsource = BlackBodySource(self.bb_Teff, self.grey,
                                        ion_freq_HI, self.cs_pl_idx_h)
            self.printlog(
                f"Using Black-Body sources with effective temperature "
                f"T = {radsource.temp:.1e} K")
            self.printlog("Integrating photoionization rates tables...")
            self.photo_thin_table, self.photo_thick_table = \
                radsource.make_photo_table(self.tau, freq_min, freq_max, 1e48)
            if self.compute_heating_rates:
                self.printlog("Integrating photoheating rates tables...")
                self.heat_thin_table, self.heat_thick_table = \
                    radsource.make_heat_table(self.tau, freq_min, freq_max, 1e48)
            else:
                self.heat_thin_table = np.zeros(self.NumTau + 1)
                self.heat_thick_table = np.zeros(self.NumTau + 1)
        else:
            raise NameError("Unknown source type: " + str(self.SourceType))

    def _raytracer_init(self):
        """Build the raytracer (replaces device_init + table upload,
        asora_core.py:20-58)."""
        ld = self._ld
        batch = int(ld["Raytracing"]["source_batch_size"])
        dtype_name = str(ld["Raytracing"].get("dtype", "float64"))
        dtype = {"float64": torch.float64, "f64": torch.float64,
                 "float32": torch.float32, "f32": torch.float32}[dtype_name]
        engine = str(ld["Raytracing"].get("engine", "flat"))
        valid_engines = ("flat", "cheb", "pallas", "adaptive", "he", "box")
        if engine not in valid_engines:
            raise ValueError(
                f"Unknown Raytracing.engine: {engine!r}. Valid engines: "
                f"{', '.join(valid_engines)} (flat = reference-exact "
                f"octahedral f64 tables; cheb = Chebyshev-face sweep; "
                f"pallas = the same engine, the name of its TPU-kernel "
                f"variant in the JAX package; adaptive = flux-bucketed "
                f"per-source radii; he = three-species H+He; box = "
                f"octahedral sheet-batched formulation)")
        # The reference's CPU subbox knobs (parameters.yml Raytracing:
        # subboxsize/max_subbox; raytracing.f90:183-226) only act on the
        # adaptive engine, and only when the USER sets them; on any other
        # engine a user-set value is announced as unused, not silent.
        user_subbox = ({"subboxsize", "max_subbox"}
                       & set(self._user_keys.get("Raytracing", ())))
        if user_subbox and engine != "adaptive":
            self.printlog(
                f"NOTE: Raytracing.{'/'.join(sorted(user_subbox))} "
                f"configure the reference's CPU subbox machinery; here "
                f"only Raytracing.engine: adaptive consumes them "
                f"(subboxsize -> minimum bucket radius, max_subbox -> "
                f"radius cap). engine: {engine} traces every source at "
                f"R_max_LLS and ignores them, matching the reference's "
                f"own GPU path.")
        self.multi_species = (engine == "he")
        if self.secondary_ionization and engine != "he":
            raise ValueError(
                "Photo.secondary_ionization: 1 requires Raytracing."
                "engine: he (the Shull & van Steenberg redistribution "
                "needs the three-species photoelectron energy channel)")
        if self.recombination_photons and engine != "he":
            raise ValueError(
                "Photo.recombination_photons: 1 requires Raytracing."
                "engine: he (recycling redistributes HELIUM "
                "recombination radiation; the hydrogen-only engines "
                "already assume case-B on-the-spot for H)")
        # The JAX engine's window accumulate is a placement by one-hot
        # matmuls; the port adds each source's box with a slice add, which
        # is what "scan" names and what "auto" may resolve to there.
        accumulate = str(ld["Raytracing"].get("accumulate", "auto"))
        window_size = ld["Raytracing"].get("window_size", None)
        if accumulate not in ("auto", "scan") or window_size is not None:
            raise NotImplementedError(
                f"Raytracing.accumulate: {accumulate} / window_size: "
                f"{window_size} select the JAX engine's window accumulate, "
                f"which the port does not have (ROADMAP.md section 1 item "
                f"3: a layout device of the TPU; the port accumulates per "
                f"source). Leave both at their defaults.")
        if engine == "flat":
            self._flat_init(batch, dtype, dtype_name)
            return
        if engine == "he":
            self._he_init(batch, dtype)
            return

        # the spectral-bin engines: Chebyshev-face (cheb, pallas, adaptive)
        # and octahedral sheet (box)
        from ..ops.raytrace_cheb import ChebRaytracer
        from ..radiation.spectral_bins import make_spectral_bins
        ion_freq_HI = ev2fr * self.eth0
        # quadrature resolution knobs (4 x 8 = 32 Gauss-Legendre bins when
        # the compression is off)
        panels = int(ld["Raytracing"].get("bins_panels", 4))
        nodes = int(ld["Raytracing"].get("bins_nodes", 8))
        # Raytracing.bins_compress: sum-of-exponentials compression
        # (radiation/bins_compress.py). "auto"/true (default) compresses
        # a dense 768-bin quadrature to a ~14-node sum at 1e-3 uniform
        # relative error; a float sets the target; 0/false keeps the
        # Gauss-Legendre bins.
        comp = ld["Raytracing"].get("bins_compress", "auto")
        if comp in ("auto", True):
            comp = 1e-3
        comp = 0.0 if comp in (False, None) else float(comp)
        source = BlackBodySource(self.bb_Teff, self.grey, ion_freq_HI,
                                 self.cs_pl_idx_h)
        if comp > 0:
            from ..radiation.bins_compress import compress_bins
            dense = make_spectral_bins(source, ion_freq_HI,
                                       10 * ev2fr * self.ethe1,
                                       panels=48, nodes=16)
            bins = compress_bins(dense, target_rel=comp)
            self.printlog(
                f"Spectral bins: compressed {dense.num_bins} dense "
                f"-> {bins.num_bins} nodes (target {comp:g})")
        else:
            bins = make_spectral_bins(source, ion_freq_HI,
                                      10 * ev2fr * self.ethe1,
                                      panels=panels, nodes=nodes)
        if engine == "box":
            # the octahedral sheet formulation: one box_trace_sweep call of
            # hand-written kernels a trace on the card, the plain loop on
            # the CPU (no shard_trace: refused under a mesh, as in JAX)
            from ..ops.raytrace_box import BoxRaytracer
            self.raytracer = BoxRaytracer(
                self.N, float(self.R_max_LLS), float(self.sig), bins,
                batch_size=batch, dtype=dtype,
                do_heating=self.compute_heating_rates, device=self.device)
            how = ("CUDA kernels" if self.device.type == "cuda"
                   else "plain PyTorch")
            self.printlog(
                f"Using octahedral sheet raytracing ({how}) on {self.device} "
                f"({bins.num_bins} spectral bins, batch = {batch:n}, dtype "
                f"= {dtype_name})")
            return
        if engine == "adaptive":
            # flux-bucketed per-source radii, the production answer to the
            # reference's subbox machinery (Raytracing.loss_fraction bounds
            # the truncation through the evolve loop's photon-loss log).
            # User-set subbox keys steer the bucket policy (cells):
            # subboxsize = smallest per-source radius, max_subbox = radius
            # cap; both clamp to R_max_LLS as the reference clamps its
            # subbox to the grid.
            from ..ops.adaptive import AdaptiveRaytracer
            safety = float(ld["Raytracing"].get("adaptive_safety", 2.0))
            radii = ld["Raytracing"].get("adaptive_radii", None)
            r_cap = float(self.R_max_LLS)
            if "max_subbox" in user_subbox:
                r_cap = min(r_cap, float(self.max_subbox))
            r_min = (min(float(self.subboxsize), r_cap)
                     if "subboxsize" in user_subbox else 4.0)
            self.raytracer = AdaptiveRaytracer(
                self.N, r_cap, float(self.sig), bins, radii=radii,
                batch_size=batch, dtype=dtype, device=self.device,
                safety=safety, R_min=r_min,
                do_heating=self.compute_heating_rates, fuse_fold=True)
            self.printlog(
                f"Using PyTorch adaptive-radius raytracing on {self.device} "
                f"(buckets R = {self.raytracer.radii}, safety = "
                f"{safety:g}, fuse_fold, {bins.num_bins} spectral bins, "
                f"batch = {batch:n}, dtype = {dtype_name})")
            return
        self.raytracer = ChebRaytracer(
            self.N, float(self.R_max_LLS), float(self.sig), bins,
            batch_size=batch, dtype=dtype, device=self.device,
            do_heating=self.compute_heating_rates, fuse_fold=True)
        self.printlog(
            f"Using PyTorch Chebyshev-face raytracing on {self.device} "
            f"(engine: {engine}; cheb and pallas are one implementation "
            f"here: the sweep is a CUDA kernel on a GPU and plain PyTorch "
            f"on the CPU; fuse_fold, r_max = "
            f"{self.raytracer.geom.r_max:n}, {bins.num_bins} spectral "
            f"bins, batch = {batch:n}, dtype = {dtype_name})")

    def _flat_init(self, batch, dtype, dtype_name):
        """The table-exact octahedral engine on the reference's tables
        (the schema's default engine)."""
        from ..ops.raytrace import RaytraceConfig, Raytracer
        cfg = RaytraceConfig(
            N=self.N, R_max_LLS=float(self.R_max_LLS), sig=float(self.sig),
            batch_size=batch, dtype=dtype,
            do_heating=self.compute_heating_rates)
        self.raytracer = Raytracer(
            cfg, self.photo_thin_table, self.photo_thick_table,
            self.minlogtau, self.dlogtau, self.heat_thin_table,
            self.heat_thick_table, device=self.device)
        self.printlog(
            f"Using PyTorch octahedral raytracing on {self.device} (q_max = "
            f"{self.raytracer.geom_np.max_q:n}, batch = {batch:n}, dtype = "
            f"{dtype_name})")

    def _he_init(self, batch, dtype):
        """The three-species engine and the coupled H+He chemistry (beyond
        the reference; see ops/raytrace_he.py)."""
        from ..ops.chemistry_he import HeChemistryParams
        from ..ops.raytrace_he import HeRaytracer
        from ..radiation.helium import (DEFAULT_PL, HE_EDGES_EV,
                                        cross_section, make_spectral_bins_he,
                                        secondary_ramps,
                                        verner_cross_section)
        ld = self._ld
        # 3 x 8 = 72 bins over 3 bands; the He rate pass scales linearly
        # with the bin count
        panels = int(ld["Raytracing"].get("bins_panels", 3))
        nodes = int(ld["Raytracing"].get("bins_nodes", 8))
        # the configured HI cross-section slope; HeI/HeII keep the defaults
        pl = (float(self.cs_pl_idx_h), DEFAULT_PL[1], DEFAULT_PL[2])
        # Raytracing.cross_sections: powerlaw (the reference's family,
        # default) or verner (Verner et al. 1996 fits)
        cs_model = str(ld["Raytracing"].get("cross_sections", "powerlaw"))
        if cs_model == "verner" and float(self.cs_pl_idx_h) != 2.8:
            raise ValueError(
                "BlackBodySource.cross_section_pl_index = "
                f"{self.cs_pl_idx_h!r} conflicts with Raytracing."
                "cross_sections: verner — the Verner fits fix the "
                "frequency dependence and would silently ignore the "
                "configured slope; drop one of the two settings")
        bins = make_spectral_bins_he(
            BlackBodySource(self.bb_Teff, self.grey, ev2fr * self.eth0,
                            self.cs_pl_idx_h),
            panels_per_band=panels, nodes=nodes, pl=pl,
            cross_section_model=cs_model)
        self.raytracer = HeRaytracer(
            self.N, float(self.R_max_LLS), bins, self.abu_he,
            batch_size=batch, dtype=dtype, device=self.device,
            do_heating=self.compute_heating_rates)
        if self.thermal is not None and not self.compute_heating_rates:
            raise ValueError(
                "Material.isothermal: false with engine: he requires "
                "Photo.compute_heating_rates: 1 (the He engine "
                "accumulates heating only when asked)")
        if self.secondary_ionization and not self.compute_heating_rates:
            raise ValueError(
                "Photo.secondary_ionization: 1 requires "
                "Photo.compute_heating_rates: 1 (the heat channel "
                "carries the photoelectron energy being "
                "redistributed into HI/HeI collisional ionizations)")
        # the recycling's cross sections from the model the bins use
        if cs_model == "verner":
            cs = verner_cross_section
        else:
            def cs(nu, s):
                return cross_section(nu, s, pl=pl[s])
        nu_he1 = ev2fr * HE_EDGES_EV[1]
        nu_lya2 = ev2fr * 40.8
        # opt-in energy ramps on the SvS secondary fractions
        ramps = (1.0, 1.0)
        if self.secondary_ramp:
            if not self.secondary_ionization:
                raise ValueError(
                    "Photo.secondary_ramp: 1 modifies the secondary-"
                    "ionization channel; set Photo."
                    "secondary_ionization: 1 too (or drop the ramp)")
            ramps = secondary_ramps(bins, self.abu_he)
            self.printlog(
                f"Secondary-ionization energy ramps (SED-averaged "
                f"threshold interpolation): f_ion,HI x {ramps[0]:.3f}, "
                f"f_ion,HeI x {ramps[1]:.3f}")
        self.chem_he = HeChemistryParams(
            chem=self.chem, abu_he=self.abu_he,
            secondary=self.secondary_ionization,
            recombination_photons=self.recombination_photons,
            sig_h_he1=float(cs(nu_he1, 0)),
            sig_he1_he1=float(cs(nu_he1, 1)),
            sig_h_lya2=float(cs(nu_lya2, 0)),
            sig_he1_lya2=float(cs(nu_lya2, 1)),
            sec_ramp_hi=float(ramps[0]),
            sec_ramp_hei=float(ramps[1]))
        # He ionization state (xHeII, xHeIII fractions), unless a resume
        # loaded it
        if not hasattr(self, "xhe1"):
            self.xhe1 = np.full(self.shape, 1e-3)
            self.xhe2 = np.zeros(self.shape)
        self.printlog(
            f"Using three-species (H+He) raytracing on {self.device} "
            f"({bins.num_bins} bins over 3 bands, abu_he = "
            f"{self.abu_he:.3g}, batch = {batch:n})")

    def _grid_init(self):
        """(c2ray_base.py:445-462)"""
        ld = self._ld
        self.boxsize_c = ld["Grid"]["boxsize"] * Mpc
        self.dr_c = self.boxsize_c / self.N
        self.printlog(f"Welcome! Mesh size is N = {self.N:n}.")
        self.printlog(f"Simulation box size (comoving Mpc): "
                      f"{self.boxsize_c/Mpc:.3e}")
        self.dr = self.dr_c
        self.R_max_LLS = (ld["Photo"]["R_max_cMpc"] * self.N
                          / ld["Grid"]["boxsize"])
        self.printlog(f"Maximum comoving distance for photons from source "
                      f"(type 3 LLS): {ld['Photo']['R_max_cMpc']:.3e} cMpc "
                      f"= {self.R_max_LLS:.3f} grid cells.")

    # -- subclass hooks -------------------------------------------------
    def _output_init(self):
        pass

    def _redshift_init(self):
        pass

    def _material_init(self):
        pass

    def _sources_init(self):
        pass

    # ==================================================================
    # PRIVATE
    # ==================================================================
    def _read_paramfile(self, paramfile):
        """The parameters (a YAML file with the scientific-notation float
        resolver of c2ray_base.py:490-507, or a parsed mapping) + the
        defaults layer."""
        self._ld = read_paramfile(paramfile)
        # remember which keys the USER set before the defaults layer fills
        # the rest: some reference keys (subboxsize/max_subbox) are only
        # meaningful when explicitly configured and must not act, or
        # warn, at their defaulted values
        self._user_keys = {sec: frozenset(self._ld.get(sec) or ())
                           for sec in _DEFAULTS}
        for section, defaults in _DEFAULTS.items():
            sec = self._ld.setdefault(section, {})
            for key, val in defaults.items():
                sec.setdefault(key, val)
