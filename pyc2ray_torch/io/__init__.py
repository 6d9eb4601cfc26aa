from .cbin import save_cbin, read_cbin, XfracFile, DensityFile
from .checkpoint import save_checkpoint, load_checkpoint, latest_checkpoint

__all__ = ["save_cbin", "read_cbin", "XfracFile", "DensityFile",
           "save_checkpoint", "load_checkpoint", "latest_checkpoint"]
