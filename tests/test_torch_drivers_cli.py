"""The port's thirteen drivers (pyc2ray_torch.examples,
pyc2ray_torch.tutorials) take their JAX scripts' arguments with the same
names and defaults (read from the scripts' source, which is not run),
plus --device (default cuda) and --workdir; without a card, --device
cuda raises instead of falling back to the CPU."""

import ast
import importlib
import tempfile

import pytest
import torch

from driver_runs import ROOT

DRIVERS = {
    "examples.raytracing_benchmark":
        "examples/raytracing_benchmark/run_test.py",
    "examples.stromgren_ifront": "examples/stromgren_ifront/run_test.py",
    "examples.shadow_test": "examples/shadow_test/run_test.py",
    "examples.multisource": "examples/multisource/run_test.py",
    "examples.stromgren_cosmo": "examples/stromgren_cosmo/run_test.py",
    "examples.heating_test": "examples/heating_test/run_test.py",
    "examples.single_source_test": "examples/single_source_test/run_test.py",
    "examples.eor_simulation": "examples/eor_simulation/run_test.py",
    "examples.multihost_pod": "examples/multihost_pod/run_test.py",
    "examples.make_plots": "examples/make_plots.py",
    "tutorials.chemistry_solver": "tutorials/chemistry_solver.py",
    "tutorials.raytracing": "tutorials/raytracing.py",
    "tutorials.helium_thermal": "tutorials/helium_thermal.py",
}
# where each JAX script writes, as the port's --workdir default
WORKDIRS = {"examples.stromgren_cosmo": ROOT / "examples" / "stromgren_cosmo",
            "examples.eor_simulation": ROOT / "examples" / "eor_simulation",
            "examples.multihost_pod": ROOT / "examples" / "multihost_pod",
            "examples.make_plots": ROOT / "examples",
            "examples.multisource": tempfile.gettempdir()}


def jax_arguments(script):
    """{option: default} of the script's add_argument calls; a default
    that is not a literal is the string "<expr>"."""
    tree = ast.parse((ROOT / script).read_text())
    out = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        if "default" in kw:
            try:
                default = ast.literal_eval(kw["default"])
            except ValueError:
                default = "<expr>"
        elif "action" in kw and ast.literal_eval(kw["action"]) == \
                "store_true":
            default = False
        else:
            default = None
        out[node.args[0].value] = default
    return out


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_takes_the_jax_arguments(name):
    mod = importlib.import_module(f"pyc2ray_torch.{name}")
    actions = {a.option_strings[0]: a.default
               for a in mod.build_parser()._actions
               if a.option_strings[0] != "-h"}
    assert actions.pop("--device") == "cuda"
    workdir = actions.pop("--workdir")
    assert str(workdir) == str(WORKDIRS.get(name, "."))
    want = jax_arguments(DRIVERS[name])
    if name == "examples.make_plots":
        # the JAX default is os.path.join(<examples>, "plots")
        assert want.pop("-o") == "<expr>" and actions.pop("-o") == "plots"
    assert actions == want


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_on_cuda_without_a_card_raises(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"pyc2ray_torch.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
