"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card. Without one
    this raises instead of carrying on silently on the CPU: the plain
    PyTorch path runs only when the caller asks for it (device="cpu")."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpullama_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run its plain PyTorch path")
    return torch.device("cuda")
