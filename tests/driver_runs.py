"""Running a port driver and its JAX script side by side, and comparing
what they print (tests/test_torch_drivers_*.py).

The port driver runs as ``python -m pyc2ray_torch.<pkg>.<name> --device
cpu --workdir <tmp>/port``. The JAX script runs from a copy under
``<tmp>/jax`` laid out as the repository (its run_test.py, its
parameters.yml and single_source_test's, which two scripts read), with
JAX_PLATFORMS=cpu, one CPU device, and ``pyc2ray_tpu`` reached through a
symlink beside a copy of native/: the JAX loader of the C++ oracle then
builds its library in the copy, never in the repository's native/, where
other test processes load it; the multisource script's source file,
fixed at /tmp/_multisource_test.txt, is moved beside the copy. Both run
at once.

``compare`` holds the numbers as printed: most lines print 3-4
significant digits ('.3e', '.6f'), so its rtol of 1e-9 asks for the same
printed digits, a relative agreement of ~5e-4 to 5e-5, and no more; the
golden's statistics print 8-13 digits. ``compare_fields`` holds the
binary fields a driver writes under its workdir to its JAX script's.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
_VERDICT = re.compile(r"PASSED|FAILED")
MULTISOURCE = "examples/multisource/run_test.py"
MULTISOURCE_FILE = "/tmp/_multisource_test.txt"


def _env(tmp, pythonpath):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # one CPU device, as a user has
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(pythonpath),
               PYC2RAY_TORCH_CACHE=str(tmp / "cache"),
               PYC2RAY_TPU_COMPILE_CACHE=str(tmp / "cache"))
    return env


def _jax_tree(tmp, script):
    """The copy the JAX script runs from; returns its path there."""
    root = tmp / "jax"
    src = ROOT / script
    dst = root / script
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, dst)
    for name in ("parameters.yml",):
        if (src.parent / name).exists():
            shutil.copy(src.parent / name, dst.parent / name)
    sst = root / "examples" / "single_source_test"
    sst.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "examples" / "single_source_test" / "parameters.yml",
                sst / "parameters.yml")
    if script == MULTISOURCE:
        # its source file goes to a fixed path outside the checkout; the
        # copy writes it beside itself instead
        text = dst.read_text()
        assert f'"{MULTISOURCE_FILE}"' in text
        dst.write_text(text.replace(MULTISOURCE_FILE,
                                    str(dst.parent / "_multisource_test.txt")))
    if script.startswith("examples/eor_simulation"):
        # the script scans ./inputs at construction, also with --synthetic
        (dst.parent / "inputs").symlink_to(
            ROOT / "examples" / "eor_simulation" / "inputs")
    (root / "pyc2ray_tpu").symlink_to(ROOT / "pyc2ray_tpu")
    (root / "native").mkdir()
    for name in ("Makefile", "c2ray_native.cpp"):
        shutil.copy(ROOT / "native" / name, root / "native" / name)
    return dst


def run_both(tmp, module, script, args, jax=True):
    """Start the port driver ``module`` and (``jax``) the JAX ``script``
    (a path in the repository) with ``args``. Returns (rc, stdout, stderr)
    of the port and of the JAX script (None without ``jax``)."""
    tmp = Path(tmp)
    port_dir = tmp / "port"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args, "--device", "cpu",
         "--workdir", str(port_dir)],
        cwd=tmp, env=_env(tmp, ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    if jax:
        dst = _jax_tree(tmp, script)
        procs.append(subprocess.Popen(
            [sys.executable, dst.name, *args], cwd=dst.parent,
            env=_env(tmp, tmp / "jax"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=TIMEOUT)
        finally:
            p.kill()
        out.append((p.returncode, o, e))
    return out[0], (out[1] if jax else None)


def select(text, keep=None, start=None):
    """The non-empty lines of ``text`` from the first one containing
    ``start`` on, those matching the regular expression ``keep`` where it
    is given."""
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    if start is not None:
        lines = lines[next(i for i, ln in enumerate(lines) if start in ln):]
    if keep is not None:
        lines = [ln for ln in lines if re.search(keep, ln)]
    return lines


def numbers(line):
    return [float(m) for m in _NUM.findall(line)]


def compare(port_lines, jax_lines, rtol, atol=0.0, labels=()):
    """Line by line: the same text once the numbers are taken out (after
    replacing the JAX labels by the port's, ``labels`` = (jax, port)
    pairs; spacing aside), the same PASSED/FAILED verdicts, and every
    number within ``rtol`` and ``atol``."""
    assert len(port_lines) == len(jax_lines), (port_lines, jax_lines)
    assert port_lines, "no lines to compare"
    for p, j in zip(port_lines, jax_lines):
        for a, b in labels:
            j = j.replace(a, b)
        assert _NUM.sub("#", p).split() == _NUM.sub("#", j).split(), (p, j)
        assert _VERDICT.findall(p) == _VERDICT.findall(j), (p, j)
        np.testing.assert_allclose(numbers(p), numbers(j), rtol=rtol,
                                   atol=atol, err_msg=f"{p!r} vs {j!r}")


def check_pair(port, jax, keep=None, start=None, rtol=1e-9, atol=0.0,
               labels=(), rc=0):
    """Both runs exit with ``rc``; their selected lines agree
    (``compare``). Returns the port's selected lines."""
    assert port[0] == rc, port[1][-3000:] + port[2][-3000:]
    assert jax[0] == rc, jax[1][-3000:] + jax[2][-3000:]
    lines = select(port[1], keep, start)
    compare(lines, select(jax[1], keep, start), rtol, atol, labels)
    return lines


def compare_fields(port_dir, jax_dir, pattern, rtol, bits=64):
    """The cbin files ``pattern`` (a glob) under ``port_dir`` and
    ``jax_dir``: the same names, and the same arrays within ``rtol``.
    Returns the names."""
    from pyc2ray_torch.io import read_cbin
    names = sorted(p.name for p in Path(port_dir).glob(pattern))
    assert names, f"no {pattern} under {port_dir}"
    assert names == sorted(p.name for p in Path(jax_dir).glob(pattern))
    for name in names:
        got = read_cbin(Path(port_dir) / name, bits=bits, order="F")
        want = read_cbin(Path(jax_dir) / name, bits=bits, order="F")
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=name)
    return names
