"""Normalization ops in PyTorch (port of tpullama/ops/norms.py; ggml
GGML_OP_RMS_NORM semantics: scale = 1/sqrt(mean(x^2) + eps) over the last
axis, computed in fp32)."""

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
