"""The port's domain decomposition (pyc2ray_torch/parallel/domain.py) on a
world of 8 gloo ranks spawned on the CPU (tests/torch_ranks.py; meshes of 4
and 6 ranks run on the first ranks of it), in float64, against the JAX
package's domain functions on tests/conftest.py's 8 virtual CPU devices and
against the port's single-rank path, with the tolerances of
tests/test_torch_parallel.py: the halo round trip (2x2, and 4x2 where the
halo is wider than a block), the trace on 2x4, 8x1, 4x2 (the whole box), 2x2x2
and the non-divisible 3x2x1 and 2x1x3 meshes, the evolve on 2x4 and 3x1x2,
thermal, helium, helium + thermal and the adaptive engine, each rank's
staging against the JAX device's, the bytes of the halo exchange against
the analytic halo model, and the model layer under a domain mesh.

The window-accumulate cases of tests/test_domain.py have no counterpart
(the port has no window accumulate), and the HLO traffic checks
(test_domain_step_collective_traffic_matches_model and the 512^3 rows) are
replaced by test_halo_bytes_match_the_halo_model, which counts the bytes the
port's exchange sends."""

import numpy as np
import pytest

from pyc2ray_tpu.parallel import (DomainDecomposition as JDomain,
                                  evolve3D_domain as j_evolve,
                                  evolve3D_he_domain as j_evolve_he,
                                  make_domain_mesh as j_mesh)

from pyc2ray_torch.evolve import evolve3D
from pyc2ray_torch.parallel import DomainDecomposition, make_domain_mesh
from pyc2ray_torch.parallel.domain import _halo_pieces

import torch_ranks as R
from test_torch_parallel import (GAMMA, FIELD_RTOL, HE_RTOL, _evolve_fields,
                                 _fields, _he_fields, _iterations, _jadaptive,
                                 _jcheb, _jchem, _jhe, _jhe_params, _jlog,
                                 _jthermal, check_model,
                                 check_ranks_import_no_jax, close,
                                 make_inputs, start_world)

C = R.DOMAIN


def _domain_inputs(workdir):
    out, _ = make_inputs(workdir, C)
    rng = np.random.RandomState(0)
    for case in ("halo_2x2", "halo_4x2"):
        out[case] = dict(f=rng.rand(16, 16, 16))
    for case, seed, ns in (("trace_2x4", 3, 9), ("trace_multihop", 4, 5),
                           ("trace_fullbox", 5, 2), ("trace_2x2x2", 7, 20),
                           ("trace_nondiv_i", 8, 11),
                           ("trace_nondiv_k", 9, 7)):
        out[case] = _fields(seed, C[case]["N"], ns)
    out["trace_fullbox"]["src"] = np.array([[0, 7, 3], [4, 4, 4]])
    src3 = [[4, 4, 4], [1, 6, 2], [7, 0, 5]]
    out["evolve_2x4"] = _evolve_fields(8, src3, [1.0, 0.5, 2.0], nd=1e-3)
    out["evolve_nondiv"] = _evolve_fields(10, [[4, 4, 4], [1, 6, 2],
                                               [9, 0, 5]], [1.0, 0.5, 2.0],
                                          nd=1e-3)
    out["thermal"] = _evolve_fields(8, [[4, 4, 4], [1, 6, 2]], [1.0, 0.5],
                                    nd=1e-3, temp=1e2)
    rng = np.random.RandomState(23)
    a = _evolve_fields(16, rng.randint(0, 16, (12, 3)),
                       10 ** rng.uniform(-1, 1, 12))
    a["nd"] = 1e-3 * (1.0 + rng.rand(16, 16, 16))
    out["adaptive_evolve"] = a
    a = _fields(21, 16, 40)
    a["flux"] = 10 ** np.random.RandomState(21).uniform(-3, 1, 40)
    out["adaptive_trace"] = a
    rng = np.random.RandomState(24)
    out["adaptive_empty"] = dict(nd=np.full((16,) * 3, 1e-3),
                                 xh=np.full((16,) * 3, 1.2e-3),
                                 src=rng.randint(4, 12, (6, 3)),
                                 flux=np.full(6, 1e-3))
    rng = np.random.RandomState(11)
    out["traffic"] = dict(src=rng.randint(0, 16, (6, 3)), flux=np.ones(6))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's suite on a world of 8 ranks: (World, inputs by case)."""
    inputs = _domain_inputs(str(tmp_path_factory.mktemp("domain_inputs")))
    w = start_world(tmp_path_factory, "domain_world", inputs,
                    R.DOMAIN_WORLD, "domain")
    yield w, inputs
    w.wait()


def _ranks(case):
    return int(np.prod(C[case]["mesh"]))


def _jdomain(engine, case):
    return JDomain(engine, j_mesh(*C[case]["mesh"]))


@pytest.mark.parametrize("case", ["helium", "helium_thermal"])
def test_helium_domain_matches_jax(world, tmp_path, case):
    """Capability cells "helium" and "helium + thermal", domain (2x2x2):
    the three absorber fields in one stacked exchange."""
    w, inputs = world
    c, I = C[case], inputs[case]
    heat = case == "helium_thermal"
    log = _jlog(tmp_path, "j")
    kw = dict(thermal=_jthermal(), zred=c["zred"]) if heat else {}
    want = j_evolve_he(c["dt"], R.DR_HE, I["flux"], I["src"],
                       _jdomain(_jhe(c, heating=heat), case), _jhe_params(),
                       I["temp"], I["nd"], I["xh"], I["y1"], I["y2"],
                       logfile=log, quiet=True, **kw)
    got = w.out(case)
    assert int(got["iterations"]) == _iterations(log) > 0
    names = R.HE_NAMES + (("temp",) if heat else ())
    assert len(want) == len(names)
    for name, ref in zip(names, want):
        if name.startswith("phi"):
            close(got[name], ref, **GAMMA, name=name)
        else:
            close(got[name], ref, HE_RTOL if name in ("y1", "y2")
                  else FIELD_RTOL, name=name)
    assert got["y1"].max() > 1e-3


def test_adaptive_evolve_domain_matches_jax(world, tmp_path):
    """Capability cell "adaptive per-source radii", domain (2x2x1):
    owner-local buckets on one halo sized for the largest."""
    w, inputs = world
    c, I = C["adaptive_evolve"], inputs["adaptive_evolve"]
    log = _jlog(tmp_path, "j")
    jxh, jphi = j_evolve(c["dt"], R.DR, I["flux"], I["src"],
                         _jdomain(_jadaptive(c), "adaptive_evolve"),
                         _jchem(), I["temp"], I["nd"], I["xh"], logfile=log,
                         quiet=True)
    got = w.out("adaptive_evolve")
    assert int(got["iterations"]) == _iterations(log) > 0
    close(got["xh"], jxh, FIELD_RTOL)
    close(got["phi"], jphi, **GAMMA)


def test_domain_trace_matches_jax_and_single_2x4(world):
    """Capability cell "standalone raytrace", domain: 2x4 against the JAX
    domain trace and the port's single-rank trace."""
    w, inputs = world
    c, I = C["trace_2x4"], inputs["trace_2x4"]
    want = np.asarray(_jdomain(_jcheb(c), "trace_2x4").trace(
        I["nd"], I["xh"], I["src"], I["flux"], R.DR))
    single = R.cheb_engine(c).trace(I["nd"], I["xh"], I["src"], I["flux"],
                                    R.DR).numpy()
    got = w.out("trace_2x4")["phi"]
    close(got, want, **GAMMA)
    close(got, single, **GAMMA)
    for r in range(1, _ranks("trace_2x4")):
        np.testing.assert_array_equal(w.out("trace_2x4", r)["phi"], got)


def test_thermal_domain_matches_jax(world, tmp_path):
    """Capability cell "thermal", domain: the heat of the blocks feeds the
    update on the blocks."""
    w, inputs = world
    c, I = C["thermal"], inputs["thermal"]
    log = _jlog(tmp_path, "j")
    jxh, jphi, jt = j_evolve(c["dt"], R.DR_THERMAL, I["flux"], I["src"],
                             _jdomain(_jcheb(c, heating=True), "thermal"),
                             _jchem(), I["temp"], I["nd"], I["xh"],
                             logfile=log, quiet=True, thermal=_jthermal(),
                             zred=c["zred"])
    got = w.out("thermal")
    assert int(got["iterations"]) == _iterations(log) > 0
    close(got["xh"], jxh, FIELD_RTOL)
    close(got["phi"], jphi, **GAMMA)
    close(got["temp"], jt, FIELD_RTOL)
    assert got["temp"].std() > 0 and got["temp"].max() > 1e2


@pytest.mark.parametrize("case", ["evolve_2x4", "evolve_nondiv"])
def test_evolve3D_domain_matches_jax_and_single(world, tmp_path, case):
    """Capability cell "H ionization", domain: 2x4 against the JAX domain
    evolve (and the port's single rank); 3x1x2 (non-divisible, the dead
    rows masked out of the convergence sums) against the port's single
    rank."""
    w, inputs = world
    c, I = C[case], inputs[case]
    args = (R.chem(), I["temp"], I["nd"], I["xh"])
    sxh, sphi = evolve3D(c["dt"], R.DR, I["flux"], I["src"], R.cheb_engine(c),
                         *args, quiet=True)
    if case == "evolve_2x4":
        log = _jlog(tmp_path, "j")
        jxh, jphi = j_evolve(c["dt"], R.DR, I["flux"], I["src"],
                             _jdomain(_jcheb(c), case), _jchem(), I["temp"],
                             I["nd"], I["xh"], logfile=log, quiet=True)
    got = w.out(case)
    close(got["xh"], sxh, FIELD_RTOL)
    close(got["phi"], sphi, **GAMMA)
    if case == "evolve_2x4":
        assert int(got["iterations"]) == _iterations(log) > 0
        close(got["xh"], jxh, FIELD_RTOL)
        close(got["phi"], jphi, **GAMMA)


@pytest.mark.parametrize("case", ["halo_2x2", "halo_4x2"])
def test_halo_roundtrip(world, case):
    """Each rank's gathered frame is the window of the periodic field, and
    halo_reduce is its exact adjoint: reduce(gather(f)) = f x the number
    of frames holding each cell (4x2 at N = 16, R = 6: the halo is wider
    than a block of 4, multi-hop)."""
    w, inputs = world
    f = inputs[case]["f"]
    N = f.shape[0]
    padg = np.pad(f, ((N, N),) * 3, mode="wrap")
    got = np.zeros_like(f)
    for r in range(_ranks(case)):
        o = w.out(case, r)
        hlo, hhi = int(o["hlo"]), int(o["hhi"])
        Li, Lj, Lk = o["L"]
        oi, oj, ok = o["coords"]
        want = padg[N + oi * Li - hlo:N + (oi + 1) * Li + hhi,
                    N + oj * Lj - hlo:N + (oj + 1) * Lj + hhi,
                    N + ok * Lk - hlo:N + (ok + 1) * Lk + hhi]
        np.testing.assert_array_equal(o["ext"], want)
        got[oi * Li:(oi + 1) * Li, oj * Lj:(oj + 1) * Lj,
            ok * Lk:(ok + 1) * Lk] = o["red"]
    if case == "halo_4x2":
        assert hlo > Li                     # multi-hop

    def cov(L, p):
        c = np.ones(L)
        if p == 1:
            c[L - hlo:] += 1
            c[:hhi] += 1
            return c
        for s, w in _halo_pieces(hlo, L):
            c[L - w:] += 1
        for s, w in _halo_pieces(hhi, L):
            c[:w] += 1
        return np.tile(c, p)
    pi, pj, pk = C[case]["mesh"]
    exp = (f * cov(Li, pi)[:, None, None] * cov(Lj, pj)[None, :, None]
           * cov(Lk, pk)[None, None, :])
    np.testing.assert_allclose(got, exp, rtol=1e-14)


@pytest.mark.parametrize("case", ["trace_multihop", "trace_fullbox",
                                  "trace_2x2x2", "trace_nondiv_i",
                                  "trace_nondiv_k"])
def test_domain_trace_matches_single(world, case):
    """8x1 (halo wider than a block), 4x2 with R beyond the box, 2x2x2 with
    interior and boundary sources, non-divisible i (3x2x1) and k (2x1x3)
    axes: Gamma against the port's single-rank trace."""
    w, inputs = world
    c, I = C[case], inputs[case]
    o = w.out(case)
    single = R.cheb_engine(c).trace(I["nd"], I["xh"], I["src"], I["flux"],
                                    R.DR).numpy()
    close(o["phi"], single, **GAMMA)
    assert bool(o["padded"]) == (case.startswith("trace_nondiv"))
    if case == "trace_2x2x2":
        assert 0 < int(o["n_interior"]) < len(I["flux"])


def test_domain_staging_matches_jax_2x2x2(world):
    """Owner buckets and the interior/boundary split: every rank's batches
    are the JAX device's of its index."""
    w, inputs = world
    c, I = C["trace_2x2x2"], inputs["trace_2x2x2"]
    jsrcs = _jdomain(_jcheb(c), "trace_2x2x2").prepare_sources(I["src"],
                                                               I["flux"])
    assert jsrcs[0] is not None and jsrcs[2] is not None
    n = _ranks("trace_2x2x2")
    for key, js in zip(("pos_i", "flux_i", "pos_b", "flux_b"), jsrcs):
        js = np.asarray(js)
        k = js.shape[0] // n
        for r in range(n):
            np.testing.assert_array_equal(w.out("trace_2x2x2", r)[key],
                                          js[r * k:(r + 1) * k])


def test_adaptive_trace_domain_matches_single(world):
    """The adaptive trace on 2x2x2 with every bucket occupied: the halo of
    the largest bucket, Gamma against the port's single-rank trace."""
    w, inputs = world
    c, I = C["adaptive_trace"], inputs["adaptive_trace"]
    o = w.out("adaptive_trace")
    phi, st = R.adaptive_engine(c).trace(I["nd"], I["xh"], I["src"],
                                         I["flux"], R.DR, stats=True)
    assert all(n > 0 for n in st["bucket_counts"])
    close(o["phi"], phi.numpy(), **GAMMA)
    assert int(o["hlo"]) == R.adaptive_engine(c).engines[-1].geom.c


def test_adaptive_empty_bucket_static_structure(world):
    """A bucket without sources stages one zero-flux interior batch per
    rank (the JAX structure) and adds nothing."""
    w, inputs = world
    c, I = C["adaptive_empty"], inputs["adaptive_empty"]
    phi, st = R.adaptive_engine(c).trace(I["nd"], I["xh"], I["src"],
                                         I["flux"], R.DR, stats=True)
    assert st["bucket_counts"][-1] == 0
    jsrcs = _jdomain(_jadaptive(c), "adaptive_empty").prepare_sources(
        I["src"], I["flux"], dr=R.DR, avg_dens=float(I["nd"].mean()))
    want_slots = [s is not None for s in jsrcs]
    n = _ranks("adaptive_empty")
    for r in range(n):
        o = w.out("adaptive_empty", r)
        assert list(o["slots"]) == want_slots
        assert float(np.max(o["s1_b1"])) == 0.0     # the empty top bucket
        for k, js in enumerate(jsrcs):
            for b, jt in enumerate(js or ()):
                key = f"s{k}_b{b}"
                assert (key in o) == (jt is not None)
                if jt is not None:
                    jt = np.asarray(getattr(jt, "pos", jt))
                    m = jt.shape[0] // n
                    np.testing.assert_array_equal(o[key],
                                                  jt[r * m:(r + 1) * m])
        close(o["phi"], phi.numpy(), **GAMMA)


def test_halo_bytes_match_the_halo_model(world):
    """The bytes one domain step's exchange sends per rank (gather of nHI,
    adjoint reduce of Gamma) equal the analytic halo model of
    tests/test_domain.py, 2 h (Lj Lk + (Li+h) Lk + (Li+h)(Lj+h)) float64
    words, far below the reference's replicated 2 N^3; nothing else moves
    but the four convergence scalars."""
    w, _ = world
    N = C["traffic"]["N"]
    for r in range(_ranks("traffic")):
        o = w.out("traffic", r)
        assert bool(o["boundary"])
        h = int(o["hlo"]) + int(o["hhi"])
        Li, Lj, Lk = (int(v) for v in o["L"])
        model = 2 * h * (Lj * Lk + (Li + h) * Lk + (Li + h) * (Lj + h)) * 8
        assert int(o["halo"]) == model
        assert int(o["halo"]) < 2 * N ** 3 * 8
        assert list(o["kinds"]) == ["halo", "scalars"]
        assert int(o["other"]) == 4 * 8


def test_model_c2ray_test_domain_mesh(world, tmp_path):
    """C2Ray_Test(mesh=make_domain_mesh(2, 2, 2)) against mesh=None."""
    w, inputs = world
    check_model(w, inputs, C, "model_test", R.DOMAIN_WORLD, tmp_path)


def test_model_helium_domain_mesh(world, tmp_path):
    """C2Ray_Test with engine he under the domain mesh against
    mesh=None."""
    w, inputs = world
    check_model(w, inputs, C, "model_he", R.DOMAIN_WORLD, tmp_path)


def test_model_cubep3m_adaptive_domain_mesh(world, tmp_path):
    """C2Ray_CubeP3M (engine adaptive) under a domain mesh against
    mesh=None."""
    w, inputs = world
    check_model(w, inputs, C, "model_cubep3m", R.DOMAIN_WORLD, tmp_path)


def test_domain_refuses_the_flat_engine():
    """The JAX layer's message: the domain path needs an engine with
    trace_extended."""
    c = dict(N=8, batch=2)
    I = dict(zip(R.TABLE_KEYS, __import__("test_raytrace").TABLES))
    with pytest.raises(TypeError, match="requires the cheb/pallas engine"):
        DomainDecomposition(R.flat_engine(c, I),
                            make_domain_mesh(1, 1, 1, device="cpu"))


@pytest.mark.parametrize("engine", ["cheb", "he"])
def test_one_rank_domain_is_bit_equal(engine):
    """A 1x1x1 domain mesh (no torch.distributed) gives the single-device
    evolve bit for bit."""
    from pyc2ray_torch.evolve import evolve3D_he
    from pyc2ray_torch.parallel import evolve3D_domain, evolve3D_he_domain
    mesh = make_domain_mesh(1, 1, 1, device="cpu")
    if engine == "cheb":
        c = dict(C["evolve_2x4"], R=3.0)
        I = _evolve_fields(8, [[4, 4, 4], [1, 6, 2], [7, 0, 5]],
                           [1.0, 0.5, 2.0], nd=1e-3)
        args = (R.chem(), I["temp"], I["nd"], I["xh"])
        want = evolve3D(c["dt"], R.DR, I["flux"], I["src"],
                        R.cheb_engine(c), *args, quiet=True)
        got = evolve3D_domain(c["dt"], R.DR, I["flux"], I["src"],
                              DomainDecomposition(R.cheb_engine(c), mesh),
                              *args, quiet=True)
    else:
        c = C["helium"]
        I = _he_fields(8)
        args = (R.he_params(), I["temp"], I["nd"], I["xh"], I["y1"],
                I["y2"])
        want = evolve3D_he(c["dt"], R.DR_HE, I["flux"], I["src"],
                           R.he_engine(c), *args, quiet=True)
        got = evolve3D_he_domain(c["dt"], R.DR_HE, I["flux"], I["src"],
                                 DomainDecomposition(R.he_engine(c), mesh),
                                 *args, quiet=True)
    for g, ref in zip(got, want):
        np.testing.assert_array_equal(g, ref)


def test_ranks_import_no_jax(world):
    w, _ = world
    check_ranks_import_no_jax(w, R.DOMAIN_WORLD)
