"""Activation / GLU ops in PyTorch (port of tpullama/ops/activations.py;
ggml unary and GLU op semantics)."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form (GGML_OP_GELU; jax.nn.gelu(approximate=True))."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(gate) * up (ggml_swiglu split form)."""
    return silu(gate) * up


def swiglu_oai(gate: torch.Tensor, up: torch.Tensor, alpha: float = 1.702,
               limit: float = 7.0) -> torch.Tensor:
    """gpt-oss's gated activation (ggml_swiglu_oai): gate clamped above at
    `limit`, up clipped to [-limit, limit], then g * sigmoid(alpha g) *
    (u + 1)."""
    g = torch.clamp(gate, max=limit)
    u = torch.clamp(up, -limit, limit)
    return g * torch.sigmoid(alpha * g) * (u + 1.0)
