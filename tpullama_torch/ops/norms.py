"""Normalization ops in PyTorch (port of tpullama/ops/norms.py; ggml
GGML_OP_RMS_NORM semantics: scale = 1/sqrt(mean(x^2) + eps) over the last
axis, computed in fp32; GGML_OP_NORM: (x - mean) / sqrt(var + eps))."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight=None, eps: float = 1e-5, bias=None) -> torch.Tensor:
    """RMSNorm over the last axis with fp32 accumulation; `bias` is added
    after scaling. Returns x's dtype."""
    xf = x.float()
    mean2 = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * (1.0 / torch.sqrt(mean2 + eps))
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (the biased variance), then
    `weight` and `bias`. Returns x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) / torch.sqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
