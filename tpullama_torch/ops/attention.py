"""Attention in PyTorch: the plain reference op, the causal mask, and the
dispatch to the CUDA kernels (port of tpullama/ops/attention.py).

Semantics of the reference's build_attn_mha fallback path: fp32 KQ,
scale, optional logit softcap (tanh), additive mask, optional attention
sinks as an extra softmax logit per head, GQA via kv-head broadcast. K/V
are HEAD-MAJOR (B, Hkv, S, D), the KV cache's layout; an int8 cache comes
with per-(head, token) f32 scales (B, Hkv, S).
"""

from __future__ import annotations

import torch


def attention(q, k, v, mask=None, scale: float | None = None, softcap: float = 0.0,
              sinks=None, alibi_slopes=None, k_scale=None, v_scale=None):
    """q: (B, Tq, Hq, D); k, v: (B, Hkv, Tk, D); mask: additive f32,
    broadcastable to (B, Hq, Tq, Tk) and 4-D. alibi_slopes: (Hq,) slopes
    multiplied into the mask (which then carries -|p_q - p_k|).
    k_scale/v_scale: (B, Hkv, Tk) dequant scales of an int8 cache: K's
    multiplies the scaled logits per key (before softcap, mask and ALiBi),
    V's the probabilities after normalisation. Returns (B, Tq, Hq, Dv) in
    q's dtype."""
    B, Tq, Hq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    if scale is None:
        scale = 1.0 / (D**0.5)
    group = Hq // Hkv
    qf = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, group, Tq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.float()[:, :, None, None, :]
    logits = logits.reshape(B, Hq, Tq, Tk)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        if mask.ndim != 4:
            raise ValueError(f"attention mask must be 4-D (B,H,Tq,Tk); got {tuple(mask.shape)}")
        if alibi_slopes is not None:
            logits = logits + alibi_slopes.float().reshape(1, Hq, 1, 1) * mask.float()
        else:
            logits = logits + mask.float()
    if sinks is not None:
        sink = sinks.float().reshape(1, Hq, 1, 1).expand(B, Hq, Tq, 1)
        all_logits = torch.cat([logits, sink], dim=-1)
        e = torch.exp(all_logits - all_logits.amax(dim=-1, keepdim=True))
        probs = e[..., :-1] / e.sum(dim=-1, keepdim=True)
    else:
        probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
    probs_g = probs.reshape(B, Hkv, group, Tq, Tk)
    if v_scale is not None:
        probs_g = probs_g * v_scale.float()[:, :, None, None, :]
    Dv = v.shape[-1]
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs_g, v.float()).reshape(B, Hq, Tq, Dv)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention_auto(q, k, v, mask=None, scale: float | None = None, softcap: float = 0.0,
                   sinks=None, alibi_slopes=None, k_scale=None, v_scale=None):
    """attention() with the port's kernel dispatch: on CUDA tensors a
    decode-sized query (Tq <= 4) goes to the flash-decode kernel and every
    other Tq to the flash-attention kernel (an int8 cache with its scales
    included); CPU tensors take the plain op."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    kv_scales = dict(k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return attention(q, k, v, mask=mask, scale=scale, softcap=softcap,
                         sinks=sinks, alibi_slopes=alibi_slopes, **kv_scales)
    if mask is None:
        raise ValueError("attention_auto: the CUDA kernels are driven by the additive mask")
    if q.shape[1] <= 4:
        from .cuda.flash_decode import flash_decode

        return flash_decode(q, k, v, mask, scale, softcap=softcap, sinks=sinks,
                            alibi_slopes=alibi_slopes, **kv_scales)
    from .cuda.flash_attention import flash_attention

    return flash_attention(q, k, v, mask, scale, softcap=softcap, sinks=sinks,
                           alibi_slopes=alibi_slopes, **kv_scales)


def make_causal_mask(q_pos, kv_pos, kv_valid=None, window: int = 0):
    """Additive mask with the reference's visibility predicate: visible iff
    cell valid and kv_pos <= q_pos and not SWA-masked. q_pos: (B, Tq) int;
    kv_pos: (B, Tk) int; kv_valid: (B, Tk) bool. Returns (B, 1, Tq, Tk) f32
    of {0, -inf}."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    vis = kp <= qp
    if window > 0:
        vis = vis & (kp > qp - window)
    if kv_valid is not None:
        vis = vis & kv_valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=vis.device)
    neg = torch.full((), float("-inf"), dtype=torch.float32, device=vis.device)
    return torch.where(vis, zero, neg)[:, None, :, :]
