"""The port's drivers of examples/ without the model layer
(pyc2ray_torch.examples: raytracing_benchmark, stromgren_ifront,
shadow_test, multisource, stromgren_cosmo) against the JAX scripts at the
same tiny arguments, each a subprocess on the CPU (tests/driver_runs.py):
the same lines, numbers equal to the digits printed (rtol 1e-9 on the
printed values), the same PASSED/FAILED verdicts and exit codes. The harness: the same result keys and num_bins;
no timing is compared."""

import json
import pickle
from pathlib import Path

from driver_runs import (MULTISOURCE, MULTISOURCE_FILE, check_pair, run_both,
                         select)


def test_raytracing_benchmark_same_results_as_jax(tmp_path):
    args = ["-N", "16", "--numsrc", "3", "--R", "3", "5", "--reps", "1",
            "--batch", "2", "--sed", "bb", "--compress", "0",
            "-o", "t.pkl", "--json", "r.json"]
    port, jax = run_both(
        tmp_path, "pyc2ray_torch.examples.raytracing_benchmark",
        "examples/raytracing_benchmark/run_test.py", args)
    assert port[0] == 0 and jax[0] == 0, port[2][-3000:] + jax[2][-3000:]
    pattern = r"^R=|^sweep complete"
    lines = select(port[1], pattern)
    assert [ln.split(":")[0] for ln in lines] == \
        [ln.split(":")[0] for ln in select(jax[1], pattern)]
    assert lines[-1] == "sweep complete" and len(lines) == 3
    jdir = tmp_path / "jax" / "examples" / "raytracing_benchmark"
    got = json.loads((tmp_path / "port" / "r.json").read_text())
    want = json.loads((jdir / "r.json").read_text())
    assert got.keys() == want.keys()
    assert got["num_bins"] == want["num_bins"] == 32
    assert got["timings"].keys() == want["timings"].keys()
    for k, v in got["timings"].items():
        assert v.keys() == want["timings"][k].keys()
        assert v["batch"] == 2 and v["window"] is None and v["t"] > 0
    assert got["device"] == "cpu"
    with open(tmp_path / "port" / "t.pkl", "rb") as f:
        pkl = pickle.load(f)
    assert set(pkl["timings"]) == {(3.0, 3), (5.0, 3)}


def test_stromgren_ifront_same_lines_as_jax(tmp_path):
    port, jax = run_both(tmp_path, "pyc2ray_torch.examples.stromgren_ifront",
                         "examples/stromgren_ifront/run_test.py",
                         ["-N", "16", "--steps", "3"])
    lines = check_pair(port, jax)
    assert len(lines) == 7 and lines[-1] == "PASSED"


def test_shadow_test_same_lines_as_jax(tmp_path):
    port, jax = run_both(tmp_path, "pyc2ray_torch.examples.shadow_test",
                         "examples/shadow_test/run_test.py", ["-N", "16"])
    assert check_pair(port, jax)[-1] == "PASSED"


def _stat(path):
    try:
        st = path.stat()
    except FileNotFoundError:
        return None
    return st.st_mtime_ns, st.st_size


def test_multisource_same_lines_as_jax(tmp_path):
    """Both runs write their source file beside themselves: the JAX
    script's fixed /tmp path is left as it was."""
    fixed = Path(MULTISOURCE_FILE)
    before = _stat(fixed)
    port, jax = run_both(tmp_path, "pyc2ray_torch.examples.multisource",
                         MULTISOURCE, ["-N", "16", "-numsrc", "4"])
    lines = check_pair(port, jax)
    assert lines[-2:] == ["tolerance 1e-10 (cpu backend)", "PASSED"]
    assert (tmp_path / "port" / "_multisource_test.txt").exists()
    jdir = tmp_path / "jax" / "examples" / "multisource"
    assert (jdir / "_multisource_test.txt").read_text() == \
        (tmp_path / "port" / "_multisource_test.txt").read_text()
    assert _stat(fixed) == before


def test_stromgren_cosmo_same_lines_as_jax(tmp_path):
    port, jax = run_both(tmp_path, "pyc2ray_torch.examples.stromgren_cosmo",
                         "examples/stromgren_cosmo/run_test.py", ["-N", "12"])
    lines = check_pair(port, jax, keep=r"^z=|^ionized volume|^final "
                                       r"redshift|^PASSED|^FAILED")
    assert len(lines) == 7 and lines[-1] == "PASSED"
    assert (tmp_path / "port" / "results" / "pyC2Ray.log").exists()
