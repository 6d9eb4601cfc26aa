"""What the port's drivers share: where the JAX scripts' inputs live, their
argument parser with the two arguments every driver adds, and the
parameter files."""

import argparse
import os
from pathlib import Path

from ..device import resolve_device
from ..utils.paramutils import read_paramfile

__all__ = ["REPO", "EXAMPLES", "driver_parser", "add_port_arguments",
           "setup", "load_params"]

REPO = Path(__file__).resolve().parents[2]
EXAMPLES = REPO / "examples"       # parameters.yml and inputs/, read only


class _DriverParser(argparse.ArgumentParser):
    def add_argument(self, *args, **kwargs):
        kwargs.setdefault("help", "default: %(default)s")
        return super().add_argument(*args, **kwargs)


def driver_parser(doc):
    """An argument parser whose help shows the module docstring's first
    paragraph and every argument's default."""
    return _DriverParser(
        description=doc.split("\n\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)


def add_port_arguments(parser, workdir, writes=None):
    """--device and --workdir; ``workdir`` is the default (where the JAX
    script writes), ``writes`` what the driver writes there (None:
    nothing)."""
    parser.add_argument("--device", default="cuda",
                        help="cuda or cpu (the plain PyTorch versions of "
                             "the kernels); no CPU fallback")
    what = (f"where the driver writes {writes}; relative output paths are "
            f"taken under it" if writes else
            "where the driver would write: it writes nothing")
    parser.add_argument("--workdir", default=str(workdir), help=what)


def setup(args):
    """The torch.device of ``args.device`` and the working directory, made
    if missing."""
    device = resolve_device(args.device)
    workdir = Path(args.workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    return device, workdir


def load_params(name, results):
    """examples/<name>/parameters.yml as a dict, its outputs under
    ``results`` (a directory, made if missing)."""
    params = read_paramfile(str(EXAMPLES / name / "parameters.yml"))
    os.makedirs(results, exist_ok=True)
    params["Output"]["results_basename"] = os.path.join(str(results), "")
    return params
