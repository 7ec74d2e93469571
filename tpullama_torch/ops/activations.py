"""Activation / GLU ops in PyTorch (port of tpullama/ops/activations.py;
ggml unary and GLU op semantics)."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(gate) * up (ggml_swiglu split form)."""
    return silu(gate) * up
