"""Activation / GLU ops in PyTorch (port of tpullama/ops/activations.py;
ggml unary and GLU op semantics)."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form (GGML_OP_GELU; jax.nn.gelu(approximate=True))."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def relu_sqr(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU, relu(x)^2 (LLM_FFN_RELU_SQR: nemotron, arcee)."""
    return torch.relu(x) ** 2


def xielu(x: torch.Tensor, alpha_n, alpha_p, beta, eps) -> torch.Tensor:
    """xIELU (apertus; ggml-cpu/unary-ops.cpp op_xielu) with the alphas'
    softplus already applied: alpha_p x^2 + beta x for x > 0, else
    (expm1(min(x, eps)) - x) alpha_n + beta x; eps is negative. The
    coefficients are scalars or 0-d tensors."""
    neg = (torch.expm1(torch.clamp(x, max=eps)) - x) * alpha_n + beta * x
    return torch.where(x > 0, alpha_p * x * x + beta * x, neg)


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
