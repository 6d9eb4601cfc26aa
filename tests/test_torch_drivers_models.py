"""The port's drivers of examples/ through the model layer
(pyc2ray_torch.examples: heating_test, single_source_test, eor_simulation,
multihost_pod) against the JAX scripts at the same tiny arguments, each a
subprocess on the CPU (tests/driver_runs.py): the driver's own lines and
the model layer's summaries, numbers equal to the digits printed (rtol
1e-9 on the printed values in float64, 1e-5 in float32, the EoR run's
parameters.yml), the golden's eight statistics within 1e-12 absolute, the
same PASSED/FAILED verdicts and exit codes. The EoR run's written fields
(xfrac, IonRates of each slice) are held to the JAX script's at 1e-5."""

from driver_runs import check_pair, compare_fields, run_both


def test_heating_test_same_lines_as_jax(tmp_path):
    port, jax = run_both(tmp_path, "pyc2ray_torch.examples.heating_test",
                         "examples/heating_test/run_test.py",
                         ["-N", "12", "--steps", "2"])
    lines = check_pair(port, jax, start="r [cells]")
    assert lines[-1] == "ALL TESTS PASSED"
    assert sum("PASSED" in ln for ln in lines) == 6


def test_single_source_golden_same_statistics_as_jax(tmp_path):
    port, jax = run_both(
        tmp_path, "pyc2ray_torch.examples.single_source_test",
        "examples/single_source_test/run_test.py",
        ["-N", "16", "--steps", "2"])
    lines = check_pair(port, jax, start="TEST RESULTS", atol=1e-12,
                       labels=[("(TPU):    ", "(port):   ")])
    assert len(lines) == 12 and lines[-1] == "ALL TESTS PASSED"


def test_eor_simulation_synthetic_same_lines_as_jax(tmp_path):
    """Two slices: the JAX script scans the committed inputs' redshifts at
    construction, also with --synthetic (the port scans the synthetic
    set), so only slices that both sets hold agree."""
    port, jax = run_both(tmp_path, "pyc2ray_torch.examples.eor_simulation",
                         "examples/eor_simulation/run_test.py",
                         ["-N", "12", "--synthetic", "--num_slices", "2",
                          "--num_steps", "1"])
    lines = check_pair(port, jax, keep=r"^=== slice|^ min, |^EoR run",
                       rtol=1e-5)
    assert len(lines) == 11 and lines[-1] == "EoR run complete (2 steps)."
    out = tmp_path / "port" / "results"
    jout = tmp_path / "jax" / "examples" / "eor_simulation" / "results"
    assert compare_fields(out, jout, "xfrac_*.dat", 1e-5) == \
        ["xfrac_19.284.dat", "xfrac_20.134.dat"]
    compare_fields(out, jout, "IonRates_*.dat", 1e-5, bits=32)
    assert (tmp_path / "port" / "inputs_synthetic" / "sources").is_dir()


def test_multihost_pod_one_rank_same_lines_as_jax(tmp_path):
    port, jax = run_both(tmp_path, "pyc2ray_torch.examples.multihost_pod",
                         "examples/multihost_pod/run_test.py",
                         ["-N", "16", "--steps", "1", "--numsrc", "4"])
    lines = check_pair(port, jax, keep=r"process\(es\)|^OK:")
    assert lines[0] == ("1 process(es), 1 device(s), mesh = {'di': 1, "
                        "'dj': 1, 'dk': 1}")
    assert (tmp_path / "port" / "results" / "pyC2Ray.log").exists()
