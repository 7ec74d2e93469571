"""Rotary position embeddings with YaRN extension, in PyTorch (port of
tpullama/ops/rope.py; reference math ggml-cpu/ops.cpp rope_yarn and
ggml.c corr dims):

  theta_extrap(i) = pos * freq_base^(-2i/n_dims) / freq_factor(i)
  theta_interp    = freq_scale * theta_extrap
  theta           = mix by YaRN ramp when ext_factor != 0
  mscale          = attn_factor * (1 + 0.1*log(1/freq_scale)) when yarn

Modes: NORM (interleaved pairs x[2i], x[2i+1]) and NEOX (half-split pairs
x[i], x[i + n_dims/2]). Dims beyond n_dims pass through unrotated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

ROPE_TYPE_NORM = 0
ROPE_TYPE_NEOX = 2


@dataclass(frozen=True)
class RopeParams:
    n_dims: int
    mode: int = ROPE_TYPE_NEOX
    freq_base: float = 10000.0
    freq_scale: float = 1.0
    ext_factor: float = 0.0
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    n_ctx_orig: int = 0


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float, base: float) -> float:
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))


def yarn_corr_dims(p: RopeParams) -> tuple[float, float]:
    start = math.floor(_yarn_corr_dim(p.n_dims, p.n_ctx_orig, p.beta_fast, p.freq_base))
    end = math.ceil(_yarn_corr_dim(p.n_dims, p.n_ctx_orig, p.beta_slow, p.freq_base))
    return max(0.0, start), min(p.n_dims - 1.0, end)


def rope_cache(p: RopeParams, positions: torch.Tensor, freq_factors=None):
    """cos/sin tables for integer `positions` (...,); returns (cos, sin) of
    shape (..., n_dims//2) in fp32, already scaled by mscale, on the
    positions' device."""
    half = p.n_dims // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    # torch.full, not torch.tensor: no host-to-device copy, so a CUDA graph
    # can capture the step
    theta_scale = torch.pow(torch.full((), p.freq_base, dtype=torch.float32,
                                       device=positions.device),
                            -2.0 * i / p.n_dims)
    pos = positions.float()[..., None]
    theta_extrap = pos * theta_scale
    if freq_factors is not None:
        theta_extrap = theta_extrap / freq_factors.float()
    theta_interp = p.freq_scale * theta_extrap
    mscale = p.attn_factor
    if p.ext_factor != 0.0:
        lo, hi = yarn_corr_dims(p)
        y = (i - lo) / max(0.001, hi - lo)
        ramp = (1.0 - torch.clamp(y, 0.0, 1.0)) * p.ext_factor
        theta = theta_interp * (1 - ramp) + theta_extrap * ramp
        mscale = mscale * (1.0 + 0.1 * math.log(1.0 / p.freq_scale))
    else:
        theta = theta_interp
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               mode: int = ROPE_TYPE_NEOX, n_dims: int | None = None) -> torch.Tensor:
    """Apply the rotation. x: (..., n_head, head_dim); cos/sin broadcastable
    to (..., n_dims//2) — for (batch, seq, head, dim) inputs pass cos of
    shape (batch, seq, 1, n_dims//2). Returns x's dtype."""
    d = x.shape[-1]
    if n_dims is None:
        n_dims = d
    rot = x[..., :n_dims]
    rest = x[..., n_dims:]
    xf = rot.float()
    if mode == ROPE_TYPE_NEOX:
        x0 = xf[..., : n_dims // 2]
        x1 = xf[..., n_dims // 2 :]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    elif mode == ROPE_TYPE_NORM:
        x0 = xf[..., 0::2]
        x1 = xf[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(xf.shape)
    else:
        raise NotImplementedError(f"rope mode {mode}")
    out = out.to(x.dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out
