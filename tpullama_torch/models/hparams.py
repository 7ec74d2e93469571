"""Model hyperparameters loaded from GGUF metadata: the llama family,
chatglm, the MoE archs that run through the llama forward (qwen2moe,
qwen3moe, granitemoe, gpt-oss with its alternating sliding-window layers,
and the heterogeneous dense/MoE stacks of glm4moe, dots1, ernie4_5-moe and
bailingmoe2), the gemma and cohere families (gemma, gemma2, gemma3,
command-r, cohere2), llama4 (chunked windows, NoPE layers with a Q
temperature, raw-logit sigmoid routing with input-side weights) and
hunyuan-moe, and the dense archs that run on those flags alone
(FLAG_ARCHS: qwen3, mistral3, internlm2, xverse, ernie4_5, exaone, phi3,
glm4, granite, minicpm, orion, stablelm, plamo, seed_oss, pangu-embedded,
qwen, smollm3, hunyuan-dense, the non-gated FFN archs phi2, falcon,
gptneox, starcoder2, codeshell, gpt2 and starcoder, the squared-relu and
xIELU archs nemotron, arcee and apertus, the ALiBi archs mpt, bloom,
jais, refact and baichuan, the post-norm archs olmo2, exaone4 and
chameleon's swin variant, olmo's weightless LayerNorms, chameleon and
bitnet), and olmoe.

The part of tpullama/models/hparams.py that the port reads. Key strings
follow the reference's key-name table exactly (src/llama-arch.cpp:119-268);
the fields are those of src/llama-hparams.h that these archs set, with the
JAX package's per-arch branches for them (qwen2moe's unnormalized top-k
weights, granite's scale stack and minicpm's legacy defaults for it,
phi3's and glm4's fused [gate|up], glm4moe's and bailingmoe2's trailing
NextN layers, gpt-oss's SWA pattern, post-top-k softmax and swiglu_oai,
gemma's embedding scale and GELU, gemma2's and gemma3's SWA patterns,
softcaps and attention scales, command-r's, orion's and stablelm's
LayerNorm, command-r's and plamo's parallel residual, command-r's logit
scale, cohere2's NoPE full layers, llama4's chunked pattern, NoPE
layers, Q temperature, weightless q/k norm and routing flags, smollm3's
NoPE layers, hunyuan's q/k norms after rope, the non-gated GELU FFN of
phi2, falcon, gptneox, starcoder2, codeshell, gpt2 and starcoder with
their LayerNorms, phi2's, falcon's and gptneox's parallel residual, the
rope-less gpt2 and starcoder, nemotron's and arcee's squared relu,
apertus's per-layer xIELU coefficients, and the ALiBi slope ceiling of
mpt, bloom, jais, refact and baichuan-13B with mpt's qkv clamp and
full-width q/k norms and jais's 1/D attention scale, olmo's
non-parametric LayerNorm and qkv clamp, olmo2's and olmoe's full-width
q/k RMS norms, the post-norm blocks of olmo2, exaone4 and chameleon's
swin variant, exaone4-32B's SWA layout with NoPE full layers, chameleon's
per-head LayerNorm q/k norms, and olmoe's un-normalised top-k weights).
Other architectures' fields and
branches come across with the slice that ports them; until then from_gguf
refuses them by name with their ROADMAP item.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

ROPE_SCALING_NONE = "none"
ROPE_SCALING_YARN = "yarn"

# the architectures whose forward is the plain llama block (chatglm's with
# a fused biased [Q|K|V] and a fused [gate|up] FFN; qwen3moe's per-head q/k
# norms; the MoE archs' shared experts and granite's scale stack; the
# heterogeneous dense/MoE stacks, loaded as a per-layer list; gpt-oss's
# sinks, biases and SWA layers; gemma's embedding scale and GELU, gemma2's
# and gemma3's sandwich norms, softcaps and SWA layers; command-r's
# LayerNorm and parallel residual, cohere2's NoPE full layers; llama4's
# chunked and NoPE layers, hunyuan's q/k norms after rope), and the dense
# archs that run on those flags alone (FLAG_ARCHS)
FLAG_ARCHS = ("qwen3", "mistral3", "internlm2", "xverse", "ernie4_5", "exaone", "phi3",
              "glm4", "granite", "minicpm", "orion", "stablelm", "plamo", "seed_oss",
              "pangu-embedded", "qwen", "smollm3", "hunyuan-dense", "phi2", "falcon",
              "gptneox", "starcoder2", "codeshell", "gpt2", "starcoder", "nemotron", "arcee",
              "apertus", "mpt", "bloom", "jais", "refact", "baichuan", "olmo", "olmo2",
              "exaone4", "chameleon", "bitnet")
LLAMA_FAMILY = ("llama", "mistral", "qwen2", "chatglm", "qwen2moe", "qwen3moe", "granitemoe",
                "glm4moe", "dots1", "ernie4_5-moe", "bailingmoe2", "gpt-oss", "gemma",
                "gemma2", "gemma3", "command-r", "cohere2", "llama4",
                "hunyuan-moe", "olmoe") + FLAG_ARCHS
# the other MoE archs the JAX package runs through its llama forward, each
# refused by name until its slice (ROADMAP.md Queue 1 item 5)
MOE_NOT_PORTED = ("bailingmoe", "afmoe", "minimax-m2",
                  "grovemoe", "phimoe", "dbrx", "grok", "arctic",
                  "qwen3vlmoe", "llada-moe", "smallthinker")
# the dense archs the JAX package's tests run through its llama forward
# from per-arch flags the port does not have yet, and the archs with a
# forward, cache or runtime of their own (deci's and openelm's per-layer
# heads, MLA, gemma3n, the encoders, the recurrent and hybrid stacks,
# diffusion, the audio decoder), each refused by name until its slice
# (ROADMAP.md Queue 1 item 7)
FLAG_NOT_PORTED = ("qwen2vl", "qwen3vl", "cogvlm", "olmo3")
OWN_FORWARD_NOT_PORTED = ("deci", "openelm", "deepseek2", "plm", "minicpm3", "gemma3n",
                          "bert", "nomic-bert", "nomic-bert-moe", "jina-bert-v2",
                          "jina-bert-v3", "neo-bert", "gemma-embedding", "t5", "t5encoder",
                          "mamba", "mamba2", "falcon-mamba", "rwkv6", "rwkv7", "arwkv7",
                          "rwkv6qwen2", "jamba", "granite-hybrid", "granitehybrid",
                          "falcon-h1", "lfm2", "lfm2moe", "nemotron_h", "plamo2",
                          "qwen3next", "llada", "dream", "rnd1", "wavtokenizer-dec")
# rope type per arch (llama_model_rope_type, src/llama-model.cpp:7777+; the
# JAX package's NORM_ARCHES): NORM (0, adjacent pairs) for these, NEOX (2,
# split halves) for the rest
_NORM_ROPE = ("llama", "llama4", "chatglm", "granitemoe", "ernie4_5-moe", "command-r",
              "cohere2", "internlm2", "minicpm", "xverse", "granite", "ernie4_5", "mistral3",
              "glm4", "smollm3", "baichuan", "arcee", "olmo", "chameleon")
# LLAMA_ROPE_TYPE_NONE (-1): no rotation (the JAX package's NONE_ARCHES,
# which wins over NORM_ARCHES for starcoder); the others of that set have
# a forward of their own or come with their slice
_NONE_ROPE = ("gpt2", "gptj", "mpt", "bloom", "starcoder", "refact", "bert", "jina-bert-v2",
              "t5", "jamba", "mamba", "mamba2", "jais", "nemotron_h", "wavtokenizer-dec")
# the non-gated FFN archs: LayerNorm (with biases) block norms, up (+bias)
# -> GELU -> down (+bias) (LLM_FFN_GELU + LLM_FFN_SEQ); mpt and bloom add
# ALiBi
_NON_GATED = ("phi2", "falcon", "gptneox", "starcoder2", "codeshell", "gpt2", "starcoder",
              "mpt", "bloom")


def check_arch(arch: str) -> None:
    """Raise for an arch the port does not load, by name with its ROADMAP
    item: the MoE archs of the JAX package's llama forward (item 5), its
    other flag archs and the archs with a forward of their own (item 7)."""
    if arch in MOE_NOT_PORTED:
        raise NotImplementedError(
            f"tpullama_torch: arch {arch!r} is not ported yet (ROADMAP.md Queue 1 item 5)")
    if arch in FLAG_NOT_PORTED or arch in OWN_FORWARD_NOT_PORTED:
        raise NotImplementedError(
            f"tpullama_torch: arch {arch!r} is not ported yet (ROADMAP.md Queue 1 item 7)")
    if arch not in LLAMA_FAMILY:
        raise NotImplementedError(f"tpullama_torch: arch {arch!r} is not ported yet")


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
    f_norm_eps: float = 1e-5  # LayerNorm's (norm_type "layer")

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
    f_max_alibi_bias: float = 0.0  # ALiBi slope ceiling (0 = no ALiBi)
    f_clamp_kqv: float = 0.0  # q, k and v clamped to +-value after their biases (mpt)
    f_logit_scale: float = 0.0  # {arch}.logit_scale as written
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0  # cap * tanh(logits / cap) after the lm_head
    n_swa: int = 0  # sliding window size (0 = none)
    swa_type: str = "standard"  # "standard" | "chunked" (llama4)
    swa_layers: tuple = ()  # per-layer bool: uses the sliding window
    attn_temp_scale: float = 0.0  # llama4: the NoPE layers' Q temperature
    attn_temp_floor_scale: int = 8192
    qk_norm_weightless: bool = False  # llama4: weightless RMS q/k norm after rope
    rope_freq_base_swa: float = 10000.0  # rope base of the SWA layers
    rope_swa_only: bool = False  # rope on the SWA layers alone; the full ones NoPE (cohere2)

    # the scale stack (0 = off): token rows (granite; gemma sqrt(n_embd)),
    # each residual branch, the final logits (granite: 1 / logit_scale,
    # command-r: logit_scale)
    embd_scale: float = 0.0
    embd_scale_tokens_only: bool = False  # gemma3: raw embedding inputs unscaled
    f_residual_scale: float = 0.0
    final_logit_scale: float = 0.0

    # block layout
    # the FFN's activation: "silu" | "gelu" (gemma, the non-gated archs) |
    # "relu_sqr" (nemotron, arcee) | "xielu" (apertus)
    act: str = "silu"
    norm_type: str = "rms"  # "rms" | "layer" (command-r, cohere2: LayerNorm)
    norm_nonparam: bool = False  # olmo: LayerNorms without weight or bias tensors
    # False: no norm before attention and FFN, which read the residual
    # stream; post norms norm their outputs (olmo2, exaone4, chameleon swin)
    pre_norm: bool = True
    no_rope_layer_step: int = 0  # every Nth layer is NoPE (smollm3, llama4)
    qk_norm_after_rope: bool = False  # hunyuan: the per-head q/k norms after rope
    # the q/k norms over the full projection width (mpt, olmo2, olmoe)
    qk_norm_full: bool = False
    # per-head q/k norms as LayerNorm (+bias) under RMS block norms (chameleon)
    qk_norm_ln: bool = False
    # chameleon swin: attn_norm and ffn_norm norm the block outputs, and the
    # FFN reads the normed attention output
    swin_norm: bool = False
    parallel_residual: bool = False  # attention and FFN from one norm, summed (command-r)

    # FFN
    ffn_gated: bool = True  # gated GLU, else up (+bias) -> act -> down (+bias)
    ffn_fused_up: bool = False  # chatglm: [gate|up] fused in ffn_up
    # apertus: per layer (alpha_n', alpha_p', beta, eps), the softplus
    # transforms pre-applied (ggml_xielu, ggml.c:2712)
    xielu_params: tuple = ()

    # MoE (Mixtral-style llama GGUFs carry it; build_moe_ffn's options)
    n_expert: int = 0
    n_expert_used: int = 0
    n_expert_shared: int = 0
    n_expert_groups: int = 0  # group-limited routing: expert groups
    n_group_used: int = 0  # ... of which the top n_group_used are kept
    expert_weights_scale: float = 0.0
    expert_weights_norm: bool = False
    expert_gating_func: int = 1  # 1=softmax, 2=sigmoid, 3=post-top-k softmax
    moe_norm_topk: bool = True  # renormalize the top-k weights (norm_w)
    moe_act: str = "silu"
    moe_select_logits: bool = False  # llama4: top-k over the raw router logits
    moe_weight_before_ffn: bool = False  # llama4: the weights scale the expert inputs
    no_rope_mod0: bool = False  # NoPE at il % step == 0 instead of (il + 1) % step == 0
    n_ff_exp: int = 0  # each routed expert's FFN width (qwen2moe, qwen3moe)
    n_ff_shexp: int = 0  # the shared expert's FFN width
    n_moe_layer_step: int = 0  # every Nth layer is MoE (ernie4_5-moe past its dense lead, llama4)
    nextn_layers: int = 0  # trailing MTP layers excluded from the forward (glm4moe)
    n_layer_dense_lead: int = 0  # leading dense-FFN layers (dots1, glm4moe, ernie4_5-moe)

    @property
    def has_heterogeneous_layers(self) -> bool:
        """Mixed dense/MoE layer stacks: loaded as a per-layer list and run
        layer by layer (the tensor sets differ per layer, so they cannot
        be stacked): llama4 with interleaved MoE among them. The JAX
        package's property also names archs the port refuses (openelm,
        deci, afmoe, nomic-bert-moe)."""
        return (self.arch in ("dots1", "glm4moe", "ernie4_5-moe", "bailingmoe2")
                or (self.arch == "llama4" and self.n_expert > 0 and self.n_moe_layer_step > 1))

    @property
    def nope_layers(self) -> tuple:
        """Per layer: a NoPE layer of no_rope_layer_step (smollm3's and
        llama4's every 4th, (il + 1) % step == 0; il % step == 0 under
        no_rope_mod0), the JAX package's _is_nope."""
        step = self.no_rope_layer_step
        if not step:
            return (False,) * self.n_layer
        return tuple((il if self.no_rope_mod0 else il + 1) % step == 0
                     for il in range(self.n_layer))

    @classmethod
    def from_gguf(cls, reader) -> "HParams":
        kv = reader.kv
        arch = kv.get("general.architecture", "llama")
        check_arch(arch)

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

        hp = cls(
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
            f_norm_eps=float(g("attention.layer_norm_epsilon", 1e-5)),
            rope_type=-1 if arch in _NONE_ROPE else 0 if arch in _NORM_ROPE else 2,
            rope_freq_base=float(g("rope.freq_base", 10000.0)),
            rope_freq_scale=rope_freq_scale,
            rope_scaling=rope_scaling,
            rope_yarn_ext_factor=ext_factor,
            rope_attn_factor=float(g("rope.scaling.attn_factor", 1.0)),
            rope_beta_fast=float(g("rope.scaling.yarn_beta_fast", 32.0)),
            rope_beta_slow=float(g("rope.scaling.yarn_beta_slow", 1.0)),
            n_ctx_orig_yarn=int(g("rope.scaling.original_context_length", 0) or g("context_length", 0)),
            f_attention_scale=float(g("attention.scale", 0.0)),
            f_logit_scale=float(g("logit_scale", 0.0)),
            attn_logit_softcap=float(g("attn_logit_softcapping", 0.0)),
            final_logit_softcap=float(g("final_logit_softcapping", 0.0)),
            n_swa=int(g("attention.sliding_window", 0) or 0),
            n_expert=int(g("expert_count", 0) or 0),
            n_expert_used=int(g("expert_used_count", 0) or 0),
            n_expert_shared=int(g("expert_shared_count", 0) or 0),
            n_expert_groups=int(g("expert_group_count", 0) or 0),
            n_group_used=int(g("expert_group_used_count", 0) or 0),
            expert_weights_scale=float(g("expert_weights_scale", 0.0) or 0.0),
            expert_weights_norm=bool(g("expert_weights_norm", False)),
            expert_gating_func=int(g("expert_gating_func", 1) or 1),
            n_ff_exp=int(g("expert_feed_forward_length", 0) or 0),
            n_ff_shexp=int(g("expert_shared_feed_forward_length", 0) or 0),
            n_layer_dense_lead=int(g("leading_dense_block_count", 0) or 0),
            # fused-swiglu FFN (LLM_FFN_SWIGLU on a 2*n_ff up projection;
            # glm4 adds gemma2's post norms, by their tensors)
            ffn_fused_up=arch in ("chatglm", "glm4", "phi3"),
        )
        if arch == "qwen2moe":
            # top-k weights not renormalized; the shared expert has its own
            # sigmoid gate (llm_build_qwen2moe)
            hp.moe_norm_topk = False
        if arch in ("granite", "granitemoe"):
            hp.embd_scale = float(g("embedding_scale", 0.0) or 0.0)
            hp.f_residual_scale = float(g("residual_scale", 0.0) or 0.0)
            if hp.f_logit_scale:
                hp.final_logit_scale = 1.0 / hp.f_logit_scale
        if arch == "minicpm":
            # granite's scale stack with fixed legacy defaults
            # (llama-model.cpp:741-755)
            hp.embd_scale = float(g("embedding_scale", 12.0) or 12.0)
            hp.f_residual_scale = float(
                g("residual_scale", 1.4 / math.sqrt(hp.n_layer) if hp.n_layer else 0.0) or 0.0)
            ls = float(g("logit_scale", 256.0 / n_embd if n_embd else 1.0) or 1.0)
            if ls:
                hp.final_logit_scale = 1.0 / ls
        if arch in ("orion", "stablelm"):
            # LayerNorm (with biases) pre-norms over a gated SiLU FFN
            hp.norm_type = "layer"
        if arch == "plamo":
            # parallel residual, the FFN reading the attention norm's
            # output (models/plamo.cpp:75-89)
            hp.parallel_residual = True
        if arch in _NON_GATED:
            # LayerNorm (+bias) norms, a plain GELU FFN with biases
            # (llm_build_phi2, _falcon, _gptneox, _starcoder2, _codeshell,
            # _gpt2, _starcoder)
            hp.norm_type = "layer"
            hp.ffn_gated = False
            hp.act = "gelu"
        if arch in ("phi2", "falcon"):
            # attention and FFN from the attention norm, summed onto the
            # input (falcon-40b's FFN reads its attn_norm_2 instead)
            hp.parallel_residual = True
        if arch in ("mpt", "bloom"):
            hp.f_max_alibi_bias = float(g("attention.max_alibi_bias", 8.0) or 8.0)
        if arch == "mpt":
            # the qkv clamp after the biases, the q/k LayerNorms (+bias)
            # over the full projection width (llm_build_mpt)
            hp.f_clamp_kqv = float(g("attention.clamp_kqv", 0.0) or 0.0)
            hp.qk_norm_full = True
        if arch == "jais":
            # LayerNorm (+bias) over ALiBi attention with a 1/D scale, a gated
            # SiLU FFN with biases (llm_build_jais)
            hp.norm_type = "layer"
            hp.f_max_alibi_bias = float(g("attention.max_alibi_bias", 8.0) or 8.0)
            if n_embd_head_v:
                hp.f_attention_scale = 1.0 / float(n_embd_head_v)
        if arch == "refact":
            # RMS norms and a gated SiLU FFN over ALiBi attention
            hp.f_max_alibi_bias = 8.0
        if arch == "baichuan" and hp.n_layer == 40:
            # baichuan-13B: ALiBi and no rope (llm_build_baichuan's
            # LLM_TYPE_13B branch); the 7B is a llama with NORM rope
            hp.rope_type = -1
            hp.f_max_alibi_bias = 8.0
        if arch in ("nemotron", "arcee"):
            # the non-gated squared-relu FFN (LLM_FFN_RELU_SQR), with biases
            # and LayerNorms (+bias) for nemotron, over RMS norms for arcee
            hp.ffn_gated = False
            hp.act = "relu_sqr"
            if arch == "nemotron":
                hp.norm_type = "layer"
        if arch == "apertus":
            # the non-gated xIELU FFN with per-layer coefficients, the
            # alphas' softplus pre-applied (ggml.c:2712-2726); the keys have
            # no arch prefix
            hp.ffn_gated = False
            hp.act = "xielu"

            def softplus(v):
                return float(np.log1p(np.exp(v)))

            def per_layer(key, default):
                v = kv.get(key, default)
                if isinstance(v, (list, tuple, np.ndarray)):
                    return [float(x) for x in v]
                return [float(v)] * hp.n_layer

            a_n, a_p = per_layer("xielu.alpha_n", 0.8), per_layer("xielu.alpha_p", 0.8)
            beta, eps = per_layer("xielu.beta", 0.5), per_layer("xielu.eps", -1e-6)
            hp.xielu_params = tuple((b + softplus(an), softplus(ap), b, e)
                                    for an, ap, b, e in zip(a_n, a_p, beta, eps))
        if arch == "olmo":
            # non-parametric LayerNorms (no norm tensors at all), the qkv
            # clamp, a gated SiLU FFN (llm_build_olmo)
            hp.norm_type = "layer"
            hp.norm_nonparam = True
            hp.f_clamp_kqv = float(g("attention.clamp_kqv", 0.0) or 0.0)
        if arch in ("olmo2", "olmoe"):
            # full-width q/k RMS norms before the reshape; olmo2's blocks
            # post-norm (llm_build_olmo2), olmoe's top-k weights
            # un-normalised (llm_build_olmoe)
            hp.qk_norm_full = True
            if arch == "olmo2":
                hp.pre_norm = False
            else:
                hp.moe_norm_topk = False
        if arch == "exaone4":
            # post-norm blocks with per-head q/k RMS norms before rope; at
            # exactly 64 layers (32B) SWA layers il % 4 != 3, rope on them
            # alone (the full layers NoPE, exaone4.cpp:37), window 4096 by
            # default
            hp.pre_norm = False
            if hp.n_layer == 64:
                hp.swa_layers = tuple(il % 4 != 3 for il in range(hp.n_layer))
                hp.rope_freq_base_swa = hp.rope_freq_base
                hp.rope_swa_only = True
                if hp.n_swa == 0:
                    hp.n_swa = 4096
        if arch == "chameleon":
            # per-head LayerNorm q/k norms with biases at torch's default
            # eps, before rope (llama-model.cpp:1954-1958); the swin variant
            # norms its block outputs
            hp.qk_norm_ln = True
            hp.f_norm_eps = 1e-5
            hp.swin_norm = bool(g("swin_norm", False))
            if hp.swin_norm:
                hp.pre_norm = False
        if arch == "gptneox":
            # the parallel residual by default, the FFN with its own
            # ffn_norm of the layer input (models/gptneox.cpp:68-110)
            hp.parallel_residual = bool(g("use_parallel_residual", True))
        if arch in ("dots1", "glm4moe"):
            # deepseek-style MoE: norm_topk from expert_weights_norm,
            # selection bias (exp_probs_b), dense lead layers, shared
            # experts (models/dots1.cpp, models/glm4-moe.cpp)
            hp.moe_norm_topk = hp.expert_weights_norm
        if arch == "glm4moe":
            if g("expert_gating_func") is None:
                hp.expert_gating_func = 2  # sigmoid default (GLM-4.5)
            hp.nextn_layers = int(g("nextn_predict_layers", 0) or 0)
            hp.n_layer -= hp.nextn_layers  # MTP layers are in the file but skipped
        if arch == "ernie4_5-moe":
            hp.n_moe_layer_step = int(g("interleave_moe_layer_step", 1) or 1)
        if arch == "bailingmoe2":
            # glm4moe-shaped: dense lead, trailing NextN layers skipped,
            # per-head q/k norms, the weights scale applied, a shared expert
            hp.moe_norm_topk = hp.expert_weights_norm
            hp.nextn_layers = int(g("nextn_predict_layers", 0) or 0)
            hp.n_layer -= hp.nextn_layers
        if arch == "gpt-oss":
            # alternating SWA (the even layers), one rope base for both
            # kinds; post-top-k softmax gating, weights not renormalized,
            # swiglu_oai experts, 1/sqrt(n_rot) attention scale
            hp.swa_layers = tuple(il % 2 < 1 for il in range(hp.n_layer))
            hp.rope_freq_base_swa = hp.rope_freq_base
            hp.moe_norm_topk = False
            hp.expert_gating_func = 3
            hp.moe_act = "swiglu_oai"
            if hp.f_attention_scale == 0.0 and n_rot:
                hp.f_attention_scale = 1.0 / math.sqrt(n_rot)
        if arch in ("command-r", "cohere2"):
            # LayerNorm (no biases), attention and FFN from the attention
            # norm summed onto the residual, logits times logit_scale
            hp.norm_type = "layer"
            hp.parallel_residual = True
            hp.final_logit_scale = hp.f_logit_scale
        if arch == "cohere2":
            # SWA pattern 4 (3 SWA : 1 full); rope on the SWA layers alone,
            # the full ones NoPE (models/cohere2-iswa.cpp:61)
            hp.swa_layers = tuple(il % 4 < 3 for il in range(hp.n_layer))
            hp.rope_freq_base_swa = hp.rope_freq_base
            hp.rope_swa_only = True
        if arch in ("hunyuan-dense", "hunyuan-moe"):
            # per-head q/k RMS norms after rope
            hp.qk_norm_after_rope = True
        if arch == "smollm3":
            hp.no_rope_layer_step = 4  # every 4th layer NoPE
        if arch == "llama4":
            # llama-model.cpp:655-689: chunked SWA 8192 of pattern 4 (3
            # chunked + 1 full NoPE layer) with the NoPE layers' Q
            # temperature, unless the file writes a window of 0; the
            # weightless q/k norm after rope (but on 128 experts); sigmoid
            # routing over raw-logit selection with input-side weights;
            # dense layers interleaved by n_moe_layer_step
            hp.n_moe_layer_step = int(g("interleave_moe_layer_step", 1) or 1)
            swa = g("attention.sliding_window")
            if swa is not None and int(swa) == 0:
                hp.no_rope_layer_step = 0
            else:
                hp.swa_type = "chunked"
                hp.n_swa = 8192
                hp.swa_layers = tuple(il % 4 < 3 for il in range(hp.n_layer))
                hp.rope_freq_base_swa = hp.rope_freq_base
                hp.attn_temp_scale = 0.1
                hp.attn_temp_floor_scale = 8192
                hp.no_rope_layer_step = 4
            hp.qk_norm_weightless = hp.n_expert != 128
            hp.moe_norm_topk = False
            hp.expert_gating_func = 2
            hp.moe_select_logits = True
            hp.moe_weight_before_ffn = True
        if arch in ("gemma", "gemma2", "gemma3"):
            hp.embd_scale = math.sqrt(n_embd) if n_embd else 0.0
            hp.act = "gelu"
        if arch == "gemma3":
            # SWA pattern 6: every 6th layer full (llama-model.cpp:1261-1286)
            hp.embd_scale_tokens_only = True
            hp.swa_layers = tuple(il % 6 < 5 for il in range(hp.n_layer))
            hp.rope_freq_base_swa = 10000.0
            if hp.n_swa == 0:
                hp.n_swa = 1024
            if hp.f_attention_scale == 0.0:
                if hp.n_layer == 62:  # 27B
                    hp.f_attention_scale = 1.0 / math.sqrt(n_embd / max(n_head, 1))
                else:
                    hp.f_attention_scale = 1.0 / math.sqrt(n_embd_head_k)
        elif arch == "gemma2":
            hp.swa_layers = tuple(il % 2 < 1 for il in range(hp.n_layer))
            hp.rope_freq_base_swa = hp.rope_freq_base
            if hp.attn_logit_softcap == 0.0:
                hp.attn_logit_softcap = 50.0
            if hp.final_logit_softcap == 0.0:
                hp.final_logit_softcap = 30.0
            if hp.n_layer == 46 and hp.f_attention_scale == 0.0:  # 27B
                hp.f_attention_scale = 1.0 / math.sqrt(n_embd / max(n_head, 1))
        return hp
