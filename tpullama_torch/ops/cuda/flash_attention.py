"""Prefill flash attention: the CUDA kernel's wrapper and its plain version.

Port of tpullama/ops/pallas/flash_attention.py:flash_attention. On a CUDA
tensor the wrapper launches csrc/flash_attention.cu (bf16 q, k and v on
the tensor cores, any f32 operand as f32 FMAs); on a CPU tensor it
computes the plain version (ops/cuda/common.flash_plain). Any GQA group
Hq % Hkv == 0 is taken: the kernel cuts the (position, head) query rows of
a kv head into tiles of 64 (common.row_plan). Int8 K/V scales are not
taken yet (they arrive with the int8 KV cache).
"""

from __future__ import annotations

import torch

from .common import check_inputs, flash_plain

LAUNCHES = {"flash_attention": 0}


def flash_attention(q, k, v, mask, scale: float, softcap: float = 0.0,
                    sinks=None, alibi_slopes=None):
    """q: (B, Tq, Hq, D); k, v: (B, Hkv, S, D) head-major; mask: additive f32
    broadcastable to (B, 1, Tq, S) — 0 (or -|dpos| for ALiBi) where
    visible, <= -1e30 where hidden. Returns (B, Tq, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_plain(q, k, v, mask, scale, softcap, sinks, alibi_slopes)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    from .build import check, library, ptr, stream

    m, sinks, slopes = check_inputs("flash_attention", q, k, v, mask, sinks, alibi_slopes)
    B, Tq, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    check(library().tpl_flash_attention(
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        ptr(q), ptr(k), ptr(v), ptr(m), ptr(slopes), ptr(sinks), ptr(out),
        B, Tq, Hq, Hkv, S, D, float(scale), float(softcap), stream()), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
