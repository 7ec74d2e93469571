"""Llama-family forward pass in PyTorch.

Port of tpullama/models/llama.py:llama_forward for the llama family
(llama, llama-2/3, mistral, qwen2 biases, chatglm's fused biased [Q|K|V]
and fused [gate|up], Mixtral-style MoE; no SWA or parallel modes): per
layer [rms_norm -> q/k/v (+bias) -> rope -> write K/V into the cache ->
attention -> o-proj -> residual -> rms_norm -> SwiGLU FFN or MoE FFN ->
residual], final norm, lm_head. With the fused layer on, a one-token step
of one sequence runs o-proj, residual, rms_norm and the fused [gate|up]
SwiGLU as one kernel (ops/cuda/fused_layer.py), as the JAX package does
under TPULLAMA_FUSED_LAYER.

The JAX package scans a stacked layer axis and gets a new cache back from
each step (the cache argument is donated). Here the layers are nn.Modules
called in a Python loop, each holding views of the stacked weights, and
each writes its new K/V rows IN PLACE into its view of one preallocated
(L, B, Hkv, S, D) cache tensor (index_put_), so no cache copy is made.
Packed weights go through the fused dequant-matmul (ops/cuda/qmm.py),
packed experts through the gathered one (ops/moe.py); attention through
attention_auto (the flash kernels on CUDA tensors).
"""

from __future__ import annotations


import torch
from torch import nn

from ..ops.activations import silu
from ..ops.attention import attention_auto
from ..ops.cuda.fused_layer import fused_ok, fused_postattn, resolve_fused_layer
from ..ops.cuda.qmm import quantized_matmul, resolve_tile_k
from ..ops.moe import moe_ffn
from ..ops.norms import rms_norm
from ..ops.rope import RopeParams, apply_rope, rope_cache
from .hparams import HParams

# packed expert stacks: flat (n_layer * n_expert, ...) planes
_EXPERT_STACKS = ("ffn_gate_exps", "ffn_up_exps", "ffn_gateup_exps", "ffn_down_exps")

# keys whose presence disqualifies the fused post-attention path (each
# one is an extra op the fused kernel does not model; the JAX package's
# llama.py:28-33)
_FUSED_EXCLUDE = (
    "attn_gate", "attn_sub_norm", "attn_output_scale", "attn_output_bias",
    "post_attn_norm", "attn_norm_2", "ffn_norm_bias", "post_ffn_norm",
    "ffn_up_bias", "ffn_down_bias", "ffn_up_scale", "ffn_down_scale",
    "ffn_sub_norm", "_cvec", "_deepstack", "_xielu",
)


def linear(x: torch.Tensor, w, meta=None, tile_k: int | None = None) -> torch.Tensor:
    """x: (..., n_in) @ w: (n_out, n_in) -> (..., n_out). A dict of packed
    planes goes through the fused dequant-matmul (`tile_k`: its K-chunks,
    ops/cuda/qmm.choose_kchunks) and returns x's dtype. A dense weight of
    another dtype than x is multiplied in the promoted dtype, as the JAX
    package's dot_general promotes (the fused path's f32 act against a
    bf16 ffn_down)."""
    if isinstance(w, dict):
        lead = x.shape[:-1]
        y = quantized_matmul(x.reshape(-1, x.shape[-1]), w, meta.ggml_type,
                             meta.group, meta.n_out, meta.n_in, order=meta.order,
                             tile_k=tile_k)
        return y.reshape(*lead, meta.n_out).to(x.dtype)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt).T
    return x @ w.T


def rope_params(hp: HParams) -> RopeParams:
    return RopeParams(
        n_dims=hp.n_rot,
        mode=hp.rope_type,
        freq_base=hp.rope_freq_base,
        freq_scale=hp.rope_freq_scale,
        ext_factor=hp.rope_yarn_ext_factor,
        attn_factor=hp.rope_attn_factor,
        beta_fast=hp.rope_beta_fast,
        beta_slow=hp.rope_beta_slow,
        n_ctx_orig=hp.n_ctx_orig_yarn or hp.n_ctx_train,
    )


def scatter_rows(cache: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor) -> None:
    """Write per-token rows into a HEAD-MAJOR cache in place.
    cache: (B, H, S, D); vals: (B, T, H, D); slots: (B, T) cell indices."""
    B, H = cache.shape[0], cache.shape[1]
    b_ix = torch.arange(B, device=cache.device)[:, None, None]
    h_ix = torch.arange(H, device=cache.device)[None, :, None]
    cache.index_put_((b_ix, h_ix, slots[:, None, :].long()),
                     vals.transpose(1, 2).to(cache.dtype))


class LlamaLayer(nn.Module):
    """One transformer block over views of the stacked layer weights.
    `fused_layer`: take the fused post-attention path where the JAX
    package would (its static conditions, llama.py:661-666, and fused_ok)
    on one-token steps of one sequence. `tile_k`: the packed matmuls'
    K-chunks."""

    def __init__(self, w: dict, meta: dict, hp: HParams, fused_layer: bool = False,
                 tile_k: int | None = None):
        super().__init__()
        self.w = w
        self.meta = meta
        self.hp = hp
        self.tile_k = tile_k
        self.fused = (fused_layer and hp.ffn_fused_up and "ffn_gate_inp" not in w
                      and "ffn_norm" in w and not any(k in w for k in _FUSED_EXCLUDE)
                      and fused_ok(hp, w, meta))

    def forward(self, x, cos, sin, k_cache, v_cache, slots, mask):
        hp, w, m, tk = self.hp, self.w, self.meta, self.tile_k
        B, T, _ = x.shape
        Hq, Hkv = hp.n_head, hp.n_head_kv
        Dk, Dv = hp.n_embd_head_k, hp.n_embd_head_v
        h = rms_norm(x, w["attn_norm"], hp.f_norm_rms_eps)
        if "attn_qkv" in w:
            # fused QKV (chatglm): rows [Q | K | V]
            qkv = linear(h, w["attn_qkv"], m.get("attn_qkv"), tk)
            if "attn_qkv_bias" in w:
                qkv = qkv + w["attn_qkv_bias"]
            n_q, n_kv = Hq * Dk, Hkv * Dk
            q, k, v = qkv[..., :n_q], qkv[..., n_q:n_q + n_kv], qkv[..., n_q + n_kv:]
        else:
            q = linear(h, w["attn_q"], m.get("attn_q"), tk)
            k = linear(h, w["attn_k"], m.get("attn_k"), tk)
            v = linear(h, w["attn_v"], m.get("attn_v"), tk)
            if "attn_q_bias" in w:
                q = q + w["attn_q_bias"]
                k = k + w["attn_k_bias"]
                v = v + w["attn_v_bias"]
        q = q.reshape(B, T, Hq, Dk)
        k = k.reshape(B, T, Hkv, Dk)
        v = v.reshape(B, T, Hkv, Dv)
        if hp.rope_type >= 0:
            q = apply_rope(q, cos, sin, hp.rope_type, hp.n_rot)
            k = apply_rope(k, cos, sin, hp.rope_type, hp.n_rot)
        scatter_rows(k_cache, slots, k)
        scatter_rows(v_cache, slots, v)
        kq_scale = hp.f_attention_scale if hp.f_attention_scale != 0.0 else 1.0 / (Dk**0.5)
        att = attention_auto(q, k_cache, v_cache, mask=mask, scale=kq_scale,
                             softcap=hp.attn_logit_softcap)
        att = att.reshape(B, T, Hq * Dv)
        if self.fused and B == 1 and T == 1:
            # the JAX package's fused branch (llama.py:683-700); it never
            # tests B and would take B * Dq columns for B > 1, so the port
            # runs it on one sequence only
            act, r1 = fused_postattn(att.reshape(1, -1), x.reshape(1, -1), w["attn_output"],
                                     w["ffn_norm"], w["ffn_up"],
                                     group=m["attn_output"].group, eps=hp.f_norm_rms_eps)
            dn = linear(act.reshape(1, 1, -1), w["ffn_down"], m.get("ffn_down"), tk)
            y = r1.reshape(1, 1, -1) + dn.float()
            return y.reshape(B, T, -1).to(x.dtype)
        x = x + linear(att, w["attn_output"], m.get("attn_output"), tk)
        h = rms_norm(x, w["ffn_norm"], hp.f_norm_rms_eps)
        if "ffn_gate_inp" in w:
            # MoE branch (the JAX package's llama.py:734-777: softmax gating,
            # norm_w, SiLU for the llama arch)
            if "ffn_gateup_exps" in m:
                metas = {"gateup": m["ffn_gateup_exps"], "down": m["ffn_down_exps"]}
            elif "ffn_up_exps" in m:
                metas = {"gate": m["ffn_gate_exps"], "up": m["ffn_up_exps"],
                         "down": m["ffn_down_exps"]}
            else:
                metas = None
            return x + moe_ffn(
                h, w["ffn_gate_inp"], w.get("ffn_gate_exps"),
                w.get("ffn_gateup_exps", w.get("ffn_up_exps")), w["ffn_down_exps"],
                n_expert_used=hp.n_expert_used, gating=hp.expert_gating_func,
                norm_w=hp.moe_norm_topk, w_scale=hp.expert_weights_scale, act=hp.moe_act,
                quant_meta_exps=metas)
        if hp.ffn_fused_up:
            # fused gate+up (ggml_swiglu: first half activated, second linear)
            up2 = linear(h, w["ffn_up"], m.get("ffn_up"), tk)
            n_ff = up2.shape[-1] // 2
            gate, up = up2[..., :n_ff], up2[..., n_ff:]
        else:
            gate = linear(h, w["ffn_gate"], m.get("ffn_gate"), tk)
            up = linear(h, w["ffn_up"], m.get("ffn_up"), tk)
        act = silu(gate.float()).to(gate.dtype) * up
        return x + linear(act, w["ffn_down"], m.get("ffn_down"), tk)


class LlamaModel(nn.Module):
    """The llama stack over a LoadedModel's params (built once per Context).
    `fused_layer` (default: TPULLAMA_FUSED_LAYER) and `qmm_tile_k` (the
    packed matmuls' K-chunks; default: TPULLAMA_QMM_TILE_K, else the tile
    table) are the JAX package's two opt-ins, read once here."""

    def __init__(self, params: dict, hp: HParams, quant_meta: dict | None = None,
                 fused_layer: bool | None = None, qmm_tile_k: int | None = None):
        super().__init__()
        self.params = params
        self.hp = hp
        self.quant_meta = quant_meta or {}
        self.fused_layer = resolve_fused_layer(fused_layer)
        self.qmm_tile_k = resolve_tile_k(qmm_tile_k)
        lmeta = self.quant_meta.get("layers", {})
        stacks = params["layers"]

        def view(key, t, li):
            if not isinstance(t, dict):
                return t[li]
            if key in _EXPERT_STACKS:  # this layer's (n_expert, ...) experts
                E = hp.n_expert
                return {k: a[li * E:(li + 1) * E] for k, a in t.items()}
            return {k: a[li] for k, a in t.items()}

        self.layers = nn.ModuleList(
            LlamaLayer({k: view(k, t, li) for k, t in stacks.items()}, lmeta, hp,
                       self.fused_layer, self.qmm_tile_k)
            for li in range(hp.n_layer)
        )
        self.rp = rope_params(hp)

    def forward(self, tokens, positions, kv_k, kv_v, cache_slots, attn_mask,
                logit_rows=None):
        """tokens, positions, cache_slots: (B, T) int; kv_k/kv_v: (L, B, Hkv,
        S, D) caches written in place; attn_mask: (B, 1, T, S) additive f32.
        logit_rows: optional (B, R) row indices — the lm_head runs on those
        rows only (the rows a caller reads). Returns f32 logits (B, T or R,
        n_vocab)."""
        hp, p = self.hp, self.params
        x = p["tok_embd"][tokens.long()]
        cos = sin = None
        if hp.rope_type >= 0:
            cos, sin = rope_cache(self.rp, positions, p.get("rope_freqs"))
            cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        for li, layer in enumerate(self.layers):
            x = layer(x, cos, sin, kv_k[li], kv_v[li], cache_slots, attn_mask)
        x = rms_norm(x, p.get("output_norm"), hp.f_norm_rms_eps)
        if logit_rows is not None:
            x = torch.gather(x, 1, logit_rows.long()[:, :, None].expand(-1, -1, x.shape[-1]))
        out_w = p.get("output", p["tok_embd"])
        return linear(x, out_w, self.quant_meta.get("output"), self.qmm_tile_k).float()


def llama_forward(params: dict, hp: HParams, tokens, positions, kv_k, kv_v,
                  cache_slots, attn_mask, quant_meta: dict | None = None):
    """Functional form of LlamaModel (the JAX package's signature): one
    decode/prefill step; the new tokens' K/V are written into kv_k/kv_v in
    place. Returns (logits, (kv_k, kv_v))."""
    net = LlamaModel(params, hp, quant_meta)
    return net(tokens, positions, kv_k, kv_v, cache_slots, attn_mask), (kv_k, kv_v)
