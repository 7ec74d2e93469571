"""Model hyperparameters loaded from GGUF metadata: the llama family and
chatglm.

The part of tpullama/models/hparams.py that the port reads. Key strings
follow the reference's key-name table exactly (src/llama-arch.cpp:119-268);
the fields are those of src/llama-hparams.h that a llama-family model,
Mixtral-style MoE included, or a chatglm model sets. Other architectures'
fields and per-arch branches come across with the slice that ports them;
until then from_gguf refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass

ROPE_SCALING_NONE = "none"
ROPE_SCALING_YARN = "yarn"

# the architectures whose forward is the plain llama block (chatglm's with
# a fused biased [Q|K|V] and a fused [gate|up] FFN)
LLAMA_FAMILY = ("llama", "mistral", "qwen2", "chatglm")
# rope type per arch (llama_model_rope_type, src/llama-model.cpp:7777+):
# NORM (0, adjacent pairs) for these, NEOX (2, split halves) for the rest
_NORM_ROPE = ("llama", "chatglm")


@dataclass
class HParams:
    arch: str = "llama"
    n_vocab: int = 0
    n_ctx_train: int = 0
    n_embd: int = 0
    n_layer: int = 0
    n_ff: int = 0
    n_head: int = 0
    n_head_kv: int = 0
    n_embd_head_k: int = 0
    n_embd_head_v: int = 0
    n_rot: int = 0
    f_norm_rms_eps: float = 1e-5

    # rope
    rope_type: int = 2  # NEOX default; set per arch
    rope_freq_base: float = 10000.0
    rope_freq_scale: float = 1.0
    rope_scaling: str = ROPE_SCALING_NONE
    rope_yarn_ext_factor: float = 0.0
    rope_attn_factor: float = 1.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    n_ctx_orig_yarn: int = 0

    # attention extras
    f_attention_scale: float = 0.0
    attn_logit_softcap: float = 0.0
    n_swa: int = 0  # sliding window size (0 = none); not ported yet

    # FFN
    ffn_fused_up: bool = False  # chatglm: [gate|up] fused in ffn_up

    # MoE (Mixtral-style llama GGUFs carry it; build_moe_ffn's options)
    n_expert: int = 0
    n_expert_used: int = 0
    n_expert_groups: int = 0  # group-limited routing: not ported, refused
    expert_weights_scale: float = 0.0
    expert_weights_norm: bool = False
    expert_gating_func: int = 1  # 1=softmax, 2=sigmoid, 3=post-top-k softmax
    moe_norm_topk: bool = True  # renormalize the top-k weights (norm_w)
    moe_act: str = "silu"

    @classmethod
    def from_gguf(cls, reader) -> "HParams":
        kv = reader.kv
        arch = kv.get("general.architecture", "llama")
        if arch not in LLAMA_FAMILY:
            raise NotImplementedError(f"tpullama_torch: arch {arch!r} is not ported yet")

        def g(key, default=None):
            return kv.get(f"{arch}.{key}", default)

        n_embd = int(g("embedding_length", 0))
        n_head = int(g("attention.head_count", 1))
        n_head_kv = int(g("attention.head_count_kv", n_head))
        n_embd_head_k = int(g("attention.key_length", n_embd // max(n_head, 1)))
        n_embd_head_v = int(g("attention.value_length", n_embd // max(n_head, 1)))
        n_rot = int(g("rope.dimension_count", n_embd_head_k))
        n_vocab = int(g("vocab_size", len(kv.get("tokenizer.ggml.tokens", [])) or 0))

        rope_scaling = str(g("rope.scaling.type", ROPE_SCALING_NONE) or ROPE_SCALING_NONE)
        rope_freq_scale = 1.0
        factor = g("rope.scaling.factor")
        if factor is not None and rope_scaling != ROPE_SCALING_NONE:
            rope_freq_scale = 1.0 / float(factor)
        ext_factor = 0.0
        if rope_scaling == ROPE_SCALING_YARN:
            ext_factor = float(g("rope.scaling.yarn_ext_factor", 1.0) or 1.0)

        return cls(
            arch=arch,
            n_vocab=n_vocab,
            n_ctx_train=int(g("context_length", 0)),
            n_embd=n_embd,
            n_layer=int(g("block_count", 0)),
            n_ff=int(g("feed_forward_length", 0) or 0),
            n_head=n_head,
            n_head_kv=n_head_kv,
            n_embd_head_k=n_embd_head_k,
            n_embd_head_v=n_embd_head_v,
            n_rot=n_rot,
            f_norm_rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
            rope_type=0 if arch in _NORM_ROPE else 2,
            rope_freq_base=float(g("rope.freq_base", 10000.0)),
            rope_freq_scale=rope_freq_scale,
            rope_scaling=rope_scaling,
            rope_yarn_ext_factor=ext_factor,
            rope_attn_factor=float(g("rope.scaling.attn_factor", 1.0)),
            rope_beta_fast=float(g("rope.scaling.yarn_beta_fast", 32.0)),
            rope_beta_slow=float(g("rope.scaling.yarn_beta_slow", 1.0)),
            n_ctx_orig_yarn=int(g("rope.scaling.original_context_length", 0) or g("context_length", 0)),
            f_attention_scale=float(g("attention.scale", 0.0)),
            attn_logit_softcap=float(g("attn_logit_softcapping", 0.0)),
            n_swa=int(g("attention.sliding_window", 0) or 0),
            n_expert=int(g("expert_count", 0) or 0),
            n_expert_used=int(g("expert_used_count", 0) or 0),
            n_expert_groups=int(g("expert_group_count", 0) or 0),
            expert_weights_scale=float(g("expert_weights_scale", 0.0) or 0.0),
            expert_weights_norm=bool(g("expert_weights_norm", False)),
            expert_gating_func=int(g("expert_gating_func", 1) or 1),
            # fused-swiglu FFN (LLM_FFN_SWIGLU on a 2*n_ff up projection)
            ffn_fused_up=arch == "chatglm",
        )
