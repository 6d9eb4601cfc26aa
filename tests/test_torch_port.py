"""Isolation and device rules of the PyTorch port: it imports neither JAX
nor the JAX package, and its entry points default to CUDA without
falling back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyc2ray_torch import resolve_device
from pyc2ray_torch.ops.raytrace_cheb import ChebRaytracer
from pyc2ray_torch.radiation.spectral_bins import SpectralBins

ROOT = pathlib.Path(__file__).resolve().parents[1]
GREY = SpectralBins(s=np.array([1.0]), w_photo=np.array([1.0]),
                    w_heat=np.array([0.0]), num_bins=1)


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pyc2ray_torch\n"
        "for m in pkgutil.walk_packages(pyc2ray_torch.__path__, "
        "'pyc2ray_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'pyc2ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = sorted((ROOT / "pyc2ray_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "pyc2ray_tpu"}, f


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ChebRaytracer(8, 3.0, 6.3e-18, GREY)
    assert ChebRaytracer(8, 3.0, 6.3e-18, GREY,
                         device="cpu").device.type == "cpu"
