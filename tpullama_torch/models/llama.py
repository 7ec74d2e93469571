"""Llama-family forward pass in PyTorch.

Port of tpullama/models/llama.py:llama_forward for the llama family
(llama, llama-2/3, mistral, qwen2 biases, chatglm's fused biased [Q|K|V]
and fused [gate|up], Mixtral-style MoE, the MoE archs qwen2moe,
qwen3moe, granitemoe and gpt-oss, the heterogeneous dense/MoE stacks
of glm4moe, dots1, ernie4_5-moe and bailingmoe2, the gemma and cohere
families, llama4, hunyuan-moe, and the dense flag archs, qwen3, phi3,
glm4, granite, minicpm, orion, stablelm, plamo, smollm3, hunyuan-dense,
the non-gated phi2, falcon, gptneox, starcoder2, codeshell, gpt2 and
starcoder, the squared-relu and xIELU nemotron, arcee and apertus, the
ALiBi mpt, bloom, jais, refact and baichuan-13B, the post-norm olmo2,
exaone4 and chameleon swin, olmo, chameleon, bitnet, olmoe, and the rest
of hparams.FLAG_ARCHS; no parallel modes): token rows (times embd_scale;
plus the learned position rows of gpt2 and starcoder; then bloom's
embedding LayerNorm) -> per layer [norm (none where hp.pre_norm is off:
the residual stream itself) -> q/k/v (+bias; times bitnet's scales) ->
mpt's and olmo's clamp, the full-width q/k norms of mpt, olmo2 and olmoe
-> per-head q/k norm (chameleon's LayerNorms with biases) ->
rope (none on a NoPE layer) -> hunyuan's per-head q/k norm, llama4's
weightless one on its rope layers, llama4's Q temperature on its NoPE
layers -> write K/V into the
cache -> attention (with gpt-oss's per-head sinks, gemma2's softcap, the
ALiBi slopes times the mask's -|distance|) -> bitnet's attn_sub_norm ->
o-proj (times bitnet's scale; +bias; post_attn_norm; times
f_residual_scale) -> residual -> norm (a post-norm block's FFN reads the
residual sum, chameleon swin's the normed attention output) -> gated FFN
(SiLU, or GELU for the gemmas; each projection times bitnet's scale and
+bias where the file has them; bitnet's ffn_sub_norm before ffn_down),
or the non-gated up (+bias) -> activation ->
down (+bias) of hp.ffn_gated False (GELU, nemotron's and arcee's squared
ReLU, apertus's xIELU with its per-layer coefficients; FFN_ACTS, which
refuses any other name), or MoE FFN plus the
shared expert (qwen2moe: gated by its own sigmoid) (post_ffn_norm; times
f_residual_scale) -> residual], final norm, lm_head, then output_bias,
final_logit_scale and the final softcap in f32, and chameleon's image
rows at the f32 minimum. The norms are RMS norms,
or LayerNorms where hp.norm_type is "layer" (command-r, cohere2, orion,
stablelm), each plus its bias where the file has one (orion's and
stablelm's attn_norm, ffn_norm and output_norm). With
hp.parallel_residual (command-r, cohere2, plamo, phi2, falcon, gptneox)
the FFN reads the attention norm's output (or its own ffn_norm, or
falcon-40b's attn_norm_2, of the layer input) and the layer adds both
branches to its input at once. gemma2's, gemma3's and glm4's
sandwich norms (post_attn_norm, post_ffn_norm) are RMS norms, as in the
JAX package.

Sliding-window layers (hp.swa_layers: gpt-oss's even layers, gemma2's,
gemma3's five of six, cohere2's three of four, llama4's chunked three of
four) take the second of the Context's mask pair (full, windowed or
chunked) and a rope table with rope_freq_base_swa; with hp.rope_swa_only
(cohere2) the full layers take no rope, and no NoPE layer of
hp.no_rope_layer_step (smollm3's and llama4's every 4th) does. Two
differences by design: gemma3's SWA layers rotate at freq_scale 1, as the
published model does (llama.cpp's rope_freq_scale_train_swa, HF's local
rotary embedding), where the JAX package keeps the model's linear scale
there (ROADMAP.md Queue 3 item 11); and the SWA layers' table divides by
the file's rope_freqs as the full layers' does (llama4's llama3 scaling,
llama.cpp's get_rope_factors on every layer), where the JAX package
builds it without them (Queue 3 item 13). Both agree with the JAX package
on files without rope scaling or rope_freqs. With the
two-stack cache (runtime/context.py: kv_k, kv_v {"full": ..., "swa": ...})
each layer writes and reads its own stack at its index there, an SWA layer
at its ring cells cache_slots_swa. With the fused layer on,
a one-token step of one sequence runs o-proj, residual, rms_norm and the
fused [gate|up] SwiGLU as one kernel (ops/cuda/fused_layer.py), as the
JAX package does under TPULLAMA_FUSED_LAYER.

The JAX package scans a stacked layer axis and gets a new cache back from
each step (the cache argument is donated); a heterogeneous stack
(params["layer_list"], one dict of dense tensors per layer: dense lead
layers with a SwiGLU FFN, MoE layers with the router, its selection bias
exp_probs_b and a shared expert) it runs in an unrolled loop. Here the
layers are nn.Modules called in a Python loop, each holding views of the
stacked weights (or its own dict of the list), and
each writes its new K/V rows IN PLACE into its view of one preallocated
(L, B, Hkv, S, D) cache tensor (index_put_), so no cache copy is made. An
int8 cache is a (values, scales) pair per K and V: int8 (L, B, Hkv, S, D)
rows and f32 (L, B, Hkv, S) scales; each new row is quantized on write
(quantize_q8, the JAX package's symmetric per-(token, head) q8) and the
scales go to attention with the rows.
Packed weights go through the fused dequant-matmul (ops/cuda/qmm.py),
packed experts through the gathered one (ops/moe.py); attention through
attention_auto (the flash kernels on CUDA tensors).
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch
from torch import nn

from ..ops.activations import gelu, relu_sqr, silu, xielu
from ..ops.attention import attention_auto
from ..ops.cuda.fused_layer import fused_ok, fused_postattn, resolve_fused_layer
from ..ops.cuda.qmm import quantized_matmul, resolve_tile_k
from ..ops.moe import moe_ffn
from ..ops.norms import layer_norm, rms_norm
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


def _xielu_rows(x: torch.Tensor, w: dict) -> torch.Tensor:
    a_n, a_p, beta, eps = w["_xielu"].unbind()
    return xielu(x, a_n, a_p, beta, eps)


# the FFN's activation by hp.act, on f32 values, with the layer's weights
# (xielu reads its per-layer coefficients, w["_xielu"]); the JAX package's
# branches, llama.py:846-863 and :880-883
FFN_ACTS = {"silu": lambda x, w: silu(x), "gelu": lambda x, w: gelu(x),
            "relu_sqr": lambda x, w: relu_sqr(x), "xielu": _xielu_rows}


def ffn_act(hp: HParams):
    """hp.act's activation from FFN_ACTS; any other name is refused by the
    arch and the name (no activation stands in for another)."""
    act = FFN_ACTS.get(hp.act)
    if act is None:
        raise NotImplementedError(
            f"tpullama_torch: arch {hp.arch!r} with FFN activation {hp.act!r} is not ported")
    return act


def alibi_slopes(n_head: int, max_bias: float, device=None) -> torch.Tensor:
    """ALiBi's per-head slopes over the full head count (ggml_soft_max_ext's
    schedule, the JAX package's llama.py:255-275): n2 the largest power of
    two <= n_head; head h < n2 takes m0^(h + 1), m0 = 2^(-max_bias / n2),
    each head past n2 m1^(2 (h - n2) + 1), m1 = 2^(-max_bias / 2 / n2).
    Returns (n_head,) f32."""
    n2 = 1 << int(math.floor(math.log2(n_head)))
    m0 = 2.0 ** (-max_bias / n2)
    m1 = 2.0 ** (-max_bias / 2.0 / n2)
    return torch.tensor([m0 ** (h + 1) if h < n2 else m1 ** (2 * (h - n2) + 1)
                         for h in range(n_head)], dtype=torch.float32, device=device)


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
    cache: (B, H, S, D); vals: (B, T, H, D); slots: (B, T) cell indices.
    The same writes an int8 cache's scales: cache (B, H, S), vals (B, T,
    H)."""
    B, H = cache.shape[0], cache.shape[1]
    b_ix = torch.arange(B, device=cache.device)[:, None, None]
    h_ix = torch.arange(H, device=cache.device)[None, :, None]
    cache.index_put_((b_ix, h_ix, slots[:, None, :].long()),
                     vals.transpose(1, 2).to(cache.dtype))


def quantize_q8(a: torch.Tensor):
    """Symmetric int8 over the last axis (the JAX package's llama.py:566-575):
    s = amax / 127, q = clip(round(a / max(s, 1e-12)), -127, 127), round
    half to even as jnp.round. Returns (int8 q, f32 s without the last
    axis)."""
    af = a.float()
    s = af.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(af / torch.clamp(s, min=1e-12)).clamp_(-127, 127).to(torch.int8)
    return q, s[..., 0]


def layer_cache(c, li: int):
    """Layer li's view of a stacked cache: a tensor, or an int8 cache's
    (values, scales) pair."""
    return tuple(t[li] for t in c) if isinstance(c, tuple) else c[li]


def norm_fn(hp: HParams, x: torch.Tensor, weight, bias=None) -> torch.Tensor:
    """A block norm: LayerNorm with f_norm_eps where hp.norm_type is
    "layer", else RMS norm with f_norm_rms_eps, either plus `bias` where
    the file has one (orion's and stablelm's LayerNorms; the JAX
    package's llama.py:284-288)."""
    if hp.norm_type == "layer":
        return layer_norm(x, weight, bias, eps=hp.f_norm_eps)
    return rms_norm(x, weight, hp.f_norm_rms_eps, bias)


class LlamaLayer(nn.Module):
    """One transformer block over views of the stacked layer weights.
    `fused_layer`: take the fused post-attention path where the JAX
    package would (its static conditions, llama.py:661-666, and fused_ok)
    on one-token steps of one sequence. `tile_k`: the packed matmuls'
    K-chunks."""

    def __init__(self, w: dict, meta: dict, hp: HParams, fused_layer: bool = False,
                 tile_k: int | None = None, nope: bool = False):
        super().__init__()
        self.w = w
        self.meta = meta
        self.hp = hp
        self.tile_k = tile_k
        self.nope = nope  # a NoPE layer of hp.no_rope_layer_step
        self.act = ffn_act(hp)
        self.fused = (fused_layer and hp.pre_norm and not hp.parallel_residual
                      and hp.ffn_fused_up and hp.norm_type != "layer" and not hp.swin_norm
                      and "ffn_gate_inp" not in w and not hp.f_residual_scale
                      and "ffn_norm" in w and not any(k in w for k in _FUSED_EXCLUDE)
                      and fused_ok(hp, w, meta))

    def forward(self, x, cos, sin, k_cache, v_cache, slots, mask, q_temp=None, alibi=None):
        """cos, sin: the layer's rope table, None for a layer without rope
        (a cohere2 full layer, a NoPE layer, or an arch without rope).
        q_temp: llama4's (B, T) f32 Q temperature, which a NoPE layer
        multiplies into q. alibi: the (Hq,) f32 ALiBi slopes, which
        attention multiplies into the mask's -|distance| values."""
        hp, w, m, tk = self.hp, self.w, self.meta, self.tile_k
        sinks = w.get("attn_sinks")
        B, T, _ = x.shape
        Hq, Hkv = hp.n_head, hp.n_head_kv
        Dk, Dv = hp.n_embd_head_k, hp.n_embd_head_v
        # a post-norm block (olmo2, exaone4, chameleon swin) feeds attention
        # the residual stream itself; olmo's norms have no tensors
        h = norm_fn(hp, x, w.get("attn_norm"), w.get("attn_norm_bias")) if hp.pre_norm else x
        h_attn = h
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
        if "attn_q_scale" in w:
            # bitnet: one-element scales after the products, as tensors (the
            # JAX package's llama.py:317-322)
            q = q * w["attn_q_scale"]
            k = k * w["attn_k_scale"]
            v = v * w["attn_v_scale"]
        if hp.f_clamp_kqv:
            # mpt and olmo: q, k and v clamped after their biases and
            # scales (ggml_clamp; the JAX package's llama.py:323-327)
            c = hp.f_clamp_kqv
            q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
        if "attn_q_norm" in w and hp.qk_norm_full:
            # mpt, olmo2, olmoe: the q/k norms (+bias) over the full
            # projection width, before the reshape (llama.py:336-339)
            q, k = self.qk_norm(q, k)
        q = q.reshape(B, T, Hq, Dk)
        k = k.reshape(B, T, Hkv, Dk)
        v = v.reshape(B, T, Hkv, Dv)
        if "attn_q_norm" in w and not hp.qk_norm_full and not hp.qk_norm_after_rope:
            # per-head q/k norm before rope (qwen3moe, gemma3: RMS; a
            # command-r file's: LayerNorm; the JAX package's llama.py:341-343)
            q, k = self.qk_norm(q, k)
        if cos is not None:
            q = apply_rope(q, cos, sin, hp.rope_type, hp.n_rot)
            k = apply_rope(k, cos, sin, hp.rope_type, hp.n_rot)
        if "attn_q_norm" in w and not hp.qk_norm_full and hp.qk_norm_after_rope:
            # hunyuan: the per-head q/k norm after rope (llama.py:364-367)
            q, k = self.qk_norm(q, k)
        if hp.qk_norm_weightless and not self.nope:
            # llama4's weightless RMS norm after rope, on its rope layers
            # (models/llama-iswa.cpp:88-93)
            q = rms_norm(q, None, hp.f_norm_rms_eps)
            k = rms_norm(k, None, hp.f_norm_rms_eps)
        if q_temp is not None and self.nope:
            q = q * q_temp.to(q.dtype)[..., None, None]
        # the kernels read q whole: a view of the fused [Q|K|V] rows that no
        # rotation copied (gpt2, starcoder) is copied here
        q = q.contiguous()
        kq_scale = hp.f_attention_scale if hp.f_attention_scale != 0.0 else 1.0 / (Dk**0.5)
        if isinstance(k_cache, tuple):
            # int8 cache: quantize the new rows, write values and scales
            for cache, rows in ((k_cache, k), (v_cache, v)):
                qv, sv = quantize_q8(rows)
                scatter_rows(cache[0], slots, qv)
                scatter_rows(cache[1], slots, sv)
            att = attention_auto(q, k_cache[0], v_cache[0], mask=mask, scale=kq_scale,
                                 softcap=hp.attn_logit_softcap, sinks=sinks,
                                 alibi_slopes=alibi, k_scale=k_cache[1], v_scale=v_cache[1])
        else:
            scatter_rows(k_cache, slots, k)
            scatter_rows(v_cache, slots, v)
            att = attention_auto(q, k_cache, v_cache, mask=mask, scale=kq_scale,
                                 softcap=hp.attn_logit_softcap, sinks=sinks,
                                 alibi_slopes=alibi)
        att = att.reshape(B, T, Hq * Dv)
        if "attn_sub_norm" in w:
            # bitnet: an RMS norm of the attention output before the
            # o-projection (llama.py:654-657)
            att = rms_norm(att, w["attn_sub_norm"], hp.f_norm_rms_eps)
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
        att = linear(att, w["attn_output"], m.get("attn_output"), tk)
        if "attn_output_scale" in w:
            att = att * w["attn_output_scale"]
        if "attn_output_bias" in w:
            att = att + w["attn_output_bias"]
        if "post_attn_norm" in w:
            att = rms_norm(att, w["post_attn_norm"], hp.f_norm_rms_eps)
        if hp.f_residual_scale:
            att = att * hp.f_residual_scale
        if hp.parallel_residual:
            # the FFN reads the attention norm's output (command-r, phi2,
            # falcon), or its own norm of the layer input where the file
            # has one (gptneox's ffn_norm, falcon-40b's attn_norm_2)
            if "ffn_norm" in w:
                h = norm_fn(hp, x, w["ffn_norm"], w.get("ffn_norm_bias"))
            elif "attn_norm_2" in w:
                h = norm_fn(hp, x, w["attn_norm_2"], w.get("attn_norm_2_bias"))
            else:
                h = h_attn
        else:
            x = x + att
            if hp.pre_norm:
                h = norm_fn(hp, x, w.get("ffn_norm"), w.get("ffn_norm_bias"))
            elif hp.swin_norm:
                # chameleon swin: the FFN reads the post-normed attention
                # output, not the residual sum (llama.py:724-729)
                h = att
            else:
                h = x
        if "ffn_gate_inp" in w:
            # MoE branch (the JAX package's llama.py:734-817: the arch's
            # gating and norm_w, SiLU experts, then the shared expert)
            if "ffn_gateup_exps" in m:
                metas = {"gateup": m["ffn_gateup_exps"], "down": m["ffn_down_exps"]}
            elif "ffn_up_exps" in m:
                metas = {"gate": m["ffn_gate_exps"], "up": m["ffn_up_exps"],
                         "down": m["ffn_down_exps"]}
            else:
                metas = None
            down = moe_ffn(
                h, w["ffn_gate_inp"], w.get("ffn_gate_exps"),
                w.get("ffn_gateup_exps", w.get("ffn_up_exps")), w["ffn_down_exps"],
                n_expert_used=hp.n_expert_used, gating=hp.expert_gating_func,
                norm_w=hp.moe_norm_topk, w_scale=hp.expert_weights_scale, act=hp.moe_act,
                exp_probs_b=w.get("exp_probs_b"), gate_inp_b=w.get("ffn_gate_inp_b"),
                gate_exps_b=w.get("ffn_gate_exps_b"), up_exps_b=w.get("ffn_up_exps_b"),
                down_exps_b=w.get("ffn_down_exps_b"), n_expert_groups=hp.n_expert_groups,
                n_group_used=hp.n_group_used, select_logits=hp.moe_select_logits,
                weight_before_ffn=hp.moe_weight_before_ffn, quant_meta_exps=metas)
            if "ffn_gate_shexp" in w:
                down = down + self.shared_expert(h)
        else:
            act_fn = self.act
            if hp.ffn_fused_up:
                # fused gate+up (ggml_swiglu: first half activated, second linear)
                up2 = linear(h, w["ffn_up"], m.get("ffn_up"), tk)
                n_ff = up2.shape[-1] // 2
                gate, up = up2[..., :n_ff], up2[..., n_ff:]
                act = act_fn(gate.float(), w).to(gate.dtype) * up
            elif not hp.ffn_gated:
                # up (+bias) -> act in f32 -> down (+bias), no gate (the JAX
                # package's llama.py:842-868)
                up = linear(h, w["ffn_up"], m.get("ffn_up"), tk)
                if "ffn_up_bias" in w:
                    up = up + w["ffn_up_bias"]
                act = act_fn(up.float(), w).to(up.dtype)
            else:
                # the gated FFN, with each projection's bias where the file
                # has one (llama.py:873-893)
                gate = linear(h, w["ffn_gate"], m.get("ffn_gate"), tk)
                if "ffn_gate_scale" in w:  # bitnet's scales, before the biases
                    gate = gate * w["ffn_gate_scale"]
                if "ffn_gate_bias" in w:
                    gate = gate + w["ffn_gate_bias"]
                up = linear(h, w["ffn_up"], m.get("ffn_up"), tk)
                if "ffn_up_scale" in w:
                    up = up * w["ffn_up_scale"]
                if "ffn_up_bias" in w:
                    up = up + w["ffn_up_bias"]
                act = act_fn(gate.float(), w).to(gate.dtype) * up
                if "ffn_sub_norm" in w:
                    # bitnet: an RMS norm between the GLU and ffn_down
                    # (llama.py:871-891)
                    act = rms_norm(act, w["ffn_sub_norm"], hp.f_norm_rms_eps)
            down = linear(act, w["ffn_down"], m.get("ffn_down"), tk)
            if "ffn_down_scale" in w:
                down = down * w["ffn_down_scale"]
            if "ffn_down_bias" in w:
                down = down + w["ffn_down_bias"]
        if "post_ffn_norm" in w:
            down = rms_norm(down, w["post_ffn_norm"], hp.f_norm_rms_eps)
        if hp.f_residual_scale:
            down = down * hp.f_residual_scale
        if hp.parallel_residual:
            return x + att + down
        return x + down

    def qk_norm(self, q, k):
        """The q/k norms (per head, or over the full width with
        qk_norm_full): LayerNorms, with their biases where the file has
        them, under norm_type "layer" or qk_norm_ln, else RMS norms (the
        JAX package's llama.py:329-334)."""
        hp, w = self.hp, self.w
        if hp.norm_type == "layer" or hp.qk_norm_ln:
            return (layer_norm(q, w["attn_q_norm"], w.get("attn_q_norm_bias"), hp.f_norm_eps),
                    layer_norm(k, w["attn_k_norm"], w.get("attn_k_norm_bias"), hp.f_norm_eps))
        return (rms_norm(q, w["attn_q_norm"], hp.f_norm_rms_eps),
                rms_norm(k, w["attn_k_norm"], hp.f_norm_rms_eps))

    def shared_expert(self, h):
        """The shared expert (the JAX package's llama.py:807-817): SiLU of
        gate times up, then down; qwen2moe scales it by sigmoid(h .
        ffn_gate_inp_shexp) in f32."""
        w, m, tk = self.w, self.meta, self.tile_k
        gate = linear(h, w["ffn_gate_shexp"], m.get("ffn_gate_shexp"), tk)
        up = linear(h, w["ffn_up_shexp"], m.get("ffn_up_shexp"), tk)
        act = silu(gate.float()).to(gate.dtype) * up
        out = linear(act, w["ffn_down_shexp"], m.get("ffn_down_shexp"), tk)
        if "ffn_gate_inp_shexp" in w:
            g = linear(h, w["ffn_gate_inp_shexp"].reshape(1, -1)).float()
            out = out * torch.sigmoid(g).to(out.dtype)
        return out


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

        def view(key, t, li):
            if not isinstance(t, dict):
                return t[li]
            if key in _EXPERT_STACKS:  # this layer's (n_expert, ...) experts
                E = hp.n_expert
                return {k: a[li * E:(li + 1) * E] for k, a in t.items()}
            return {k: a[li] for k, a in t.items()}

        if "layer_list" in params:
            # a heterogeneous stack: each layer's own dense tensors
            weights = params["layer_list"]
        else:
            stacks = params["layers"]
            weights = [{k: view(k, t, li) for k, t in stacks.items()}
                       for li in range(hp.n_layer)]
            if hp.xielu_params:
                # apertus: each layer's (alpha_n', alpha_p', beta, eps) row,
                # as the JAX package's forward stacks them (llama.py:1036-1037)
                rows = torch.tensor(hp.xielu_params, dtype=torch.float32,
                                    device=params["tok_embd"].device)
                for li, w in enumerate(weights):
                    w["_xielu"] = rows[li]
        nope = hp.nope_layers
        self.layers = nn.ModuleList(
            LlamaLayer(w, lmeta, hp, self.fused_layer, self.qmm_tile_k, nope[li])
            for li, w in enumerate(weights))
        self.rp = rope_params(hp)
        # ALiBi's per-head slopes, on the device once
        self.alibi = (alibi_slopes(hp.n_head, hp.f_max_alibi_bias, params["tok_embd"].device)
                      if hp.f_max_alibi_bias > 0.0 else None)
        # the SWA layers, and each layer's index in its stack of a two-stack
        # cache (the JAX package's _stack_idx)
        self.swa = tuple(bool(s) for s in hp.swa_layers) if any(hp.swa_layers) else ()
        count = {False: 0, True: 0}
        self.stack_idx = []
        for is_swa in self.swa:
            self.stack_idx.append(count[is_swa])
            count[is_swa] += 1
        # each layer's rope table: "full", "swa", or None (an arch without
        # rope, cohere2's full layers, a NoPE layer)
        swa = self.swa or (False,) * hp.n_layer
        self.rope_kinds = tuple(
            None if hp.rope_type < 0 or nope[li] or (hp.rope_swa_only and not swa[li])
            else "swa" if swa[li] else "full" for li in range(hp.n_layer))
        # gemma3's SWA layers rotate unscaled (ROADMAP.md Queue 3 item 11)
        self.rp_swa = replace(self.rp, freq_base=hp.rope_freq_base_swa,
                              freq_scale=1.0 if hp.arch == "gemma3" else self.rp.freq_scale
                              ) if self.swa else None

    def forward(self, tokens, positions, kv_k, kv_v, cache_slots, attn_mask,
                logit_rows=None, return_embd: bool = False, cache_slots_swa=None):
        """tokens, positions, cache_slots: (B, T) int; kv_k/kv_v: (L, B, Hkv,
        S, D) caches written in place, or an int8 cache's (values, (L, B,
        Hkv, S) f32 scales) pairs, or the two-stack cache's {"full": ...,
        "swa": ...} of such (then cache_slots_swa (B, T) holds the ring's
        cells); attn_mask: (B, 1, T, S) additive f32, for a model with SWA
        layers the pair (full, windowed) (two stacks: over S and the ring's
        cells). logit_rows: optional (B, R) row indices — the lm_head runs on
        those rows only (the rows a caller reads). Returns f32 logits (B, T
        or R, n_vocab); with return_embd, (logits, the final-norm hidden
        states of every row as f32 (B, T, n_embd)), the JAX package's
        return_embd."""
        hp, p = self.hp, self.params
        x = p["tok_embd"][tokens.long()]
        if hp.embd_scale:
            x = (x.float() * hp.embd_scale).to(x.dtype)
        if "position_embd" in p:
            # learned absolute positions (gpt2, starcoder) at the step's
            # positions on the device; a parked row's -1 reads the last
            # row, as jnp.take wraps it (Context refuses an n_ctx past the
            # table's rows)
            x = x + p["position_embd"][positions.long()].to(x.dtype)
        if "token_embd_norm" in p:
            # bloom's embedding LayerNorm (+bias) (the JAX package's
            # llama.py:199-207)
            x = norm_fn(hp, x, p["token_embd_norm"], p.get("token_embd_norm_bias"))
        # each rope table the layers take, rope_freqs in both (Queue 3 item
        # 13); the JAX package's identity rotation of a layer without rope
        # (cohere2's full layers, NoPE layers) is no rotation here
        tables = {None: (None, None)}
        for kind in set(self.rope_kinds) - {None}:
            cos, sin = rope_cache(self.rp_swa if kind == "swa" else self.rp, positions,
                                  p.get("rope_freqs"))
            tables[kind] = (cos[:, :, None, :], sin[:, :, None, :])
        q_temp = None
        if hp.attn_temp_scale and hp.no_rope_layer_step:
            # llama4's Q temperature of its NoPE layers, from the positions
            # on the device (llm_graph_input_attn_temp, llama-graph.cpp:70-85)
            q_temp = torch.log(torch.floor((positions.float() + 1.0) / hp.attn_temp_floor_scale)
                               + 1.0) * hp.attn_temp_scale + 1.0
        two_stack = isinstance(kv_k, dict)
        mask_full, mask_swa = attn_mask if isinstance(attn_mask, tuple) else (attn_mask,) * 2
        for li, layer in enumerate(self.layers):
            is_swa = bool(self.swa) and self.swa[li]
            kc, vc, slots = kv_k, kv_v, cache_slots
            idx = li
            if two_stack:
                stack = "swa" if is_swa else "full"
                kc, vc, idx = kv_k[stack], kv_v[stack], self.stack_idx[li]
                slots = cache_slots_swa if is_swa else cache_slots
            x = layer(x, *tables[self.rope_kinds[li]], layer_cache(kc, idx),
                      layer_cache(vc, idx), slots, mask_swa if is_swa else mask_full, q_temp,
                      self.alibi)
        x = norm_fn(hp, x, p.get("output_norm"), p.get("output_norm_bias"))
        embd = x.float() if return_embd else None
        if logit_rows is not None:
            x = torch.gather(x, 1, logit_rows.long()[:, :, None].expand(-1, -1, x.shape[-1]))
        out_w = p.get("output", p["tok_embd"])
        logits = linear(x, out_w, self.quant_meta.get("output"), self.qmm_tile_k).float()
        # the JAX package's order (llama.py:1009-1016), in f32
        if "output_bias" in p:
            logits = logits + p["output_bias"].float()
        if hp.final_logit_scale:
            logits = logits * hp.final_logit_scale
        if hp.final_logit_softcap:
            logits = hp.final_logit_softcap * torch.tanh(logits / hp.final_logit_softcap)
        if hp.arch == "chameleon":
            # the image tokens' rows 4..8195 at the f32 minimum, on the device
            # (models/chameleon.cpp:160-172; the JAX package's
            # llama.py:1134-1139), so a replayed step's sampler sees them
            logits[..., 4:8196] = torch.finfo(torch.float32).min
        return (logits, embd) if return_embd else logits


def llama_forward(params: dict, hp: HParams, tokens, positions, kv_k, kv_v,
                  cache_slots, attn_mask, quant_meta: dict | None = None,
                  cache_slots_swa=None):
    """Functional form of LlamaModel (the JAX package's signature): one
    decode/prefill step; the new tokens' K/V are written into kv_k/kv_v in
    place. Returns (logits, (kv_k, kv_v))."""
    net = LlamaModel(params, hp, quant_meta)
    return net(tokens, positions, kv_k, kv_v, cache_slots, attn_mask,
               cache_slots_swa=cache_slots_swa), (kv_k, kv_v)
