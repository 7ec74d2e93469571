"""Prefill flash attention: the CUDA kernel's wrapper and its plain version.

Port of tpullama/ops/pallas/flash_attention.py:flash_attention. On a CUDA
tensor the wrapper launches csrc/flash_attention.cu (bf16 q, k and v on
the tensor cores, any f32 operand as f32 FMAs); on a CPU tensor it
computes the plain version (ops/cuda/common.flash_plain). Any GQA group
Hq % Hkv == 0 and any head dim up to common.MAX_HEAD_DIM are taken: the
kernel cuts the (position, head) query rows of a kv head into tiles of 64
(common.row_plan). An int8 cache comes with its per-(head, token) f32
scales (k_scale, v_scale): bf16 q runs it on the tensor cores (the int8
rows converted to bf16 in shared memory, exactly), f32 q as f32 FMAs; its
launches count apart, as flash_attention_int8. A launch with ALiBi slopes
(the kernel's ALiBi branch: each visible cell's mask value times its
head's slope) counts apart too, with "_alibi" after the name.
"""

from __future__ import annotations

import torch

from .common import check_inputs, check_scales, flash_plain, kv_code, launch_name

LAUNCHES = {"flash_attention" + route: 0 for route in ("", "_int8", "_alibi", "_int8_alibi")}


def flash_attention(q, k, v, mask, scale: float, softcap: float = 0.0,
                    sinks=None, alibi_slopes=None, k_scale=None, v_scale=None):
    """q: (B, Tq, Hq, D); k, v: (B, Hkv, S, D) head-major (int8 with
    k_scale, v_scale (B, Hkv, S) f32); mask: additive f32 broadcastable to
    (B, 1, Tq, S) — 0 (or -|dpos| for ALiBi) where visible, <= -1e30 where
    hidden. Returns (B, Tq, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_plain(q, k, v, mask, scale, softcap, sinks, alibi_slopes,
                           k_scale, v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    from .build import check, library, ptr, stream

    m, sinks, slopes = check_inputs("flash_attention", q, k, v, mask, sinks, alibi_slopes)
    int8 = check_scales("flash_attention", k, k_scale, v_scale)
    B, Tq, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    check(library().tpl_flash_attention(
        int(q.dtype == torch.bfloat16), kv_code(k),
        ptr(q), ptr(k), ptr(v), ptr(m), ptr(slopes), ptr(sinks), ptr(k_scale), ptr(v_scale), ptr(out),
        B, Tq, Hq, Hkv, S, D, float(scale), float(softcap), stream()), "flash_attention")
    LAUNCHES[launch_name("flash_attention", int8, slopes)] += 1
    return out
