"""Device selection shared by the port's entry points."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda"):
    """Return the torch.device an entry point runs on.

    The default is the GPU. Asking for CUDA where there is none raises:
    the port never falls back to the CPU on its own; a caller that wants
    the plain PyTorch path passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
