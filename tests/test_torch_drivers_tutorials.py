"""The port's tutorials (pyc2ray_torch.tutorials: chemistry_solver,
raytracing, helium_thermal) against the JAX scripts of tutorials/, and the
port's examples/make_plots.py, each a subprocess on the CPU
(tests/driver_runs.py): the same lines, numbers equal to the digits
printed (rtol 1e-9 on the printed values, float64; the raytracing
tutorial's Gamma also at an absolute 1e-300, where one deep cell
underflows to 0 in one package and stays at 3e-306 in the other) and
exit 0. make_plots draws its three figures (Agg) and prints the JAX
script's lines, its I-front error among them."""

import pytest

from driver_runs import check_pair, run_both


def test_chemistry_solver_same_lines_as_jax(tmp_path):
    port, jax = run_both(tmp_path, "pyc2ray_torch.tutorials.chemistry_solver",
                         "tutorials/chemistry_solver.py", [])
    lines = check_pair(port, jax)
    assert len(lines) == 12 and lines[0].startswith("t =   1.0 Myr")


@pytest.mark.parametrize("engine", ["cheb", "flat"])
def test_raytracing_tutorial_same_lines_as_jax(tmp_path, engine):
    port, jax = run_both(tmp_path, "pyc2ray_torch.tutorials.raytracing",
                         "tutorials/raytracing.py", ["--engine", engine])
    lines = check_pair(port, jax, atol=1e-300)
    assert len(lines) == 22 and lines[-1].startswith("photon budget")


def test_helium_thermal_same_lines_as_jax(tmp_path):
    port, jax = run_both(tmp_path, "pyc2ray_torch.tutorials.helium_thermal",
                         "tutorials/helium_thermal.py", [])
    lines = check_pair(port, jax)
    assert lines[-1] == "OK"


def test_make_plots_draws_three_figures(tmp_path):
    pytest.importorskip("matplotlib")
    port, jax = run_both(tmp_path, "pyc2ray_torch.examples.make_plots",
                         "examples/make_plots.py", ["-N", "16", "--steps", "3"])
    out = tmp_path / "port" / "plots"
    jout = tmp_path / "jax" / "examples" / "plots"
    lines = check_pair(port, jax, labels=[(str(jout), str(out))])
    assert len(lines) == 3
    assert lines[0].startswith(f"{out / 'ifront_radius.png'}  (max |r - "
                               f"analytic| = ")
    for name in ("ifront_radius.png", "ifront_slices.png", "shadow.png"):
        assert (out / name).stat().st_size > 1000
