"""GGUF / GGML format constants.

Semantics follow the GGUF v3 spec as implemented by the reference
(ggml/include/gguf.h:1-46, ggml/src/gguf.cpp) and the ggml type enum
(ggml/include/ggml.h:381-421). Block sizes/layouts follow
ggml/src/ggml-common.h:170-434.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

QK_K = 256  # super-block size for K-quants
K_SCALE_SIZE = 12


class GGMLType(enum.IntEnum):
    """Tensor data types (ggml/include/ggml.h:381-421). Values are the
    on-disk GGUF tensor-type ids and must not change."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2/Q4_3 (removed upstream)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


@dataclass(frozen=True)
class TypeTraits:
    block_size: int  # elements per block
    type_size: int  # bytes per block
    is_quantized: bool


# ggml_type_traits equivalents (ggml/src/ggml.c type_traits table).
GGML_TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4, False),
    GGMLType.F16: TypeTraits(1, 2, False),
    GGMLType.BF16: TypeTraits(1, 2, False),
    GGMLType.F64: TypeTraits(1, 8, False),
    GGMLType.I8: TypeTraits(1, 1, False),
    GGMLType.I16: TypeTraits(1, 2, False),
    GGMLType.I32: TypeTraits(1, 4, False),
    GGMLType.I64: TypeTraits(1, 8, False),
    GGMLType.Q4_0: TypeTraits(32, 2 + 16, True),
    GGMLType.Q4_1: TypeTraits(32, 4 + 16, True),
    GGMLType.Q5_0: TypeTraits(32, 2 + 4 + 16, True),
    GGMLType.Q5_1: TypeTraits(32, 4 + 4 + 16, True),
    GGMLType.Q8_0: TypeTraits(32, 2 + 32, True),
    GGMLType.Q8_1: TypeTraits(32, 4 + 32, True),
    GGMLType.MXFP4: TypeTraits(32, 1 + 16, True),
    GGMLType.Q2_K: TypeTraits(QK_K, 2 * 2 + QK_K // 16 + QK_K // 4, True),
    GGMLType.Q3_K: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 8 + 12, True),
    GGMLType.Q4_K: TypeTraits(QK_K, 2 * 2 + K_SCALE_SIZE + QK_K // 2, True),
    GGMLType.Q5_K: TypeTraits(QK_K, 2 * 2 + K_SCALE_SIZE + QK_K // 2 + QK_K // 8, True),
    GGMLType.Q6_K: TypeTraits(QK_K, 2 + QK_K // 16 + 3 * QK_K // 4, True),
    GGMLType.Q8_K: TypeTraits(QK_K, 4 + QK_K + QK_K // 16 * 2, True),
    GGMLType.TQ1_0: TypeTraits(QK_K, 2 + QK_K // 64 + (QK_K - 4 * QK_K // 64) // 5, True),
    GGMLType.TQ2_0: TypeTraits(QK_K, 2 + QK_K // 4, True),
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 2 + QK_K // 8 * 2, True),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 2 + QK_K // 8 * 2 + QK_K // 32, True),
    GGMLType.IQ2_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 16, True),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 2 + 3 * QK_K // 8, True),
    GGMLType.IQ3_S: TypeTraits(QK_K, 2 + 13 * (QK_K // 32) + QK_K // 64, True),
    GGMLType.IQ1_S: TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 16, True),
    GGMLType.IQ1_M: TypeTraits(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32, True),
    GGMLType.IQ4_NL: TypeTraits(32, 2 + 16, True),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2, True),
}


def row_nbytes(ggml_type: GGMLType, n_elements: int) -> int:
    t = GGML_TYPE_TRAITS[ggml_type]
    if n_elements % t.block_size != 0:
        raise ValueError(
            f"{ggml_type.name}: row length {n_elements} not a multiple of "
            f"block size {t.block_size}"
        )
    return n_elements // t.block_size * t.type_size


class GGUFValueType(enum.IntEnum):
    """KV metadata value types (gguf.h / gguf-py constants)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


# numpy struct codes for scalar KV types (little-endian)
GGUF_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


class Keys:
    """GGUF metadata key templates (exact strings from the reference's
    key-name table, src/llama-arch.cpp:119-268). `{arch}` is substituted
    with the value of `general.architecture`."""

    # general
    ARCHITECTURE = "general.architecture"
    QUANTIZATION_VERSION = "general.quantization_version"
    ALIGNMENT = "general.alignment"
    NAME = "general.name"
    FILE_TYPE = "general.file_type"

    # shape
    CONTEXT_LENGTH = "{arch}.context_length"
    EMBEDDING_LENGTH = "{arch}.embedding_length"
    BLOCK_COUNT = "{arch}.block_count"
    FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
    VOCAB_SIZE = "{arch}.vocab_size"

    # attention
    ATTN_HEAD_COUNT = "{arch}.attention.head_count"
    ATTN_HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
    ATTN_KEY_LENGTH = "{arch}.attention.key_length"
    ATTN_VALUE_LENGTH = "{arch}.attention.value_length"
    ATTN_LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
    ATTN_LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
    ATTN_SLIDING_WINDOW = "{arch}.attention.sliding_window"
    ATTN_SCALE = "{arch}.attention.scale"
    ATTN_Q_LORA_RANK = "{arch}.attention.q_lora_rank"
    ATTN_KV_LORA_RANK = "{arch}.attention.kv_lora_rank"
    ATTN_CLAMP_KQV = "{arch}.attention.clamp_kqv"
    ATTN_MAX_ALIBI_BIAS = "{arch}.attention.max_alibi_bias"
    ATTN_LOGIT_SOFTCAP = "{arch}.attn_logit_softcapping"
    FINAL_LOGIT_SOFTCAP = "{arch}.final_logit_softcapping"

    # rope
    ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
    ROPE_FREQ_BASE = "{arch}.rope.freq_base"
    ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
    ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
    ROPE_SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"
    ROPE_SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
    ROPE_SCALING_FINETUNED = "{arch}.rope.scaling.finetuned"
    ROPE_SCALING_YARN_LOG_MUL = "{arch}.rope.scaling.yarn_log_multiplier"
    ROPE_SCALING_YARN_EXT_FACTOR = "{arch}.rope.scaling.yarn_ext_factor"
    ROPE_SCALING_YARN_BETA_FAST = "{arch}.rope.scaling.yarn_beta_fast"
    ROPE_SCALING_YARN_BETA_SLOW = "{arch}.rope.scaling.yarn_beta_slow"

    # MoE
    EXPERT_COUNT = "{arch}.expert_count"
    EXPERT_USED_COUNT = "{arch}.expert_used_count"
    EXPERT_SHARED_COUNT = "{arch}.expert_shared_count"
    EXPERT_GROUP_COUNT = "{arch}.expert_group_count"
    EXPERT_GROUP_USED_COUNT = "{arch}.expert_group_used_count"
    EXPERT_WEIGHTS_SCALE = "{arch}.expert_weights_scale"
    EXPERT_WEIGHTS_NORM = "{arch}.expert_weights_norm"
    EXPERT_GATING_FUNC = "{arch}.expert_gating_func"
    EXPERT_FEED_FORWARD_LENGTH = "{arch}.expert_feed_forward_length"
    EXPERT_SHARED_FEED_FORWARD_LENGTH = "{arch}.expert_shared_feed_forward_length"

    # ssm
    SSM_CONV_KERNEL = "{arch}.ssm.conv_kernel"
    SSM_INNER_SIZE = "{arch}.ssm.inner_size"
    SSM_STATE_SIZE = "{arch}.ssm.state_size"
    SSM_TIME_STEP_RANK = "{arch}.ssm.time_step_rank"
    SSM_GROUP_COUNT = "{arch}.ssm.group_count"
    SSM_DT_B_C_RMS = "{arch}.ssm.dt_b_c_rms"

    # tokenizer
    TOKENIZER_MODEL = "tokenizer.ggml.model"
    TOKENIZER_PRE = "tokenizer.ggml.pre"
    TOKENIZER_LIST = "tokenizer.ggml.tokens"
    TOKENIZER_TOKEN_TYPE = "tokenizer.ggml.token_type"
    TOKENIZER_SCORES = "tokenizer.ggml.scores"
    TOKENIZER_MERGES = "tokenizer.ggml.merges"
    TOKENIZER_BOS_ID = "tokenizer.ggml.bos_token_id"
    TOKENIZER_EOS_ID = "tokenizer.ggml.eos_token_id"
    TOKENIZER_EOT_ID = "tokenizer.ggml.eot_token_id"
    TOKENIZER_EOM_ID = "tokenizer.ggml.eom_token_id"
    TOKENIZER_UNK_ID = "tokenizer.ggml.unknown_token_id"
    TOKENIZER_SEP_ID = "tokenizer.ggml.seperator_token_id"
    TOKENIZER_PAD_ID = "tokenizer.ggml.padding_token_id"
    TOKENIZER_ADD_BOS = "tokenizer.ggml.add_bos_token"
    TOKENIZER_ADD_EOS = "tokenizer.ggml.add_eos_token"
    TOKENIZER_ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
    TOKENIZER_REMOVE_EXTRA_WS = "tokenizer.ggml.remove_extra_whitespaces"
    TOKENIZER_CHAT_TEMPLATE = "tokenizer.chat_template"
    TOKENIZER_FIM_PRE_ID = "tokenizer.ggml.fim_pre_token_id"
    TOKENIZER_FIM_SUF_ID = "tokenizer.ggml.fim_suf_token_id"
    TOKENIZER_FIM_MID_ID = "tokenizer.ggml.fim_mid_token_id"

    # split files (tools/gguf-split semantics; llama.h:1350-1355)
    SPLIT_NO = "split.no"
    SPLIT_COUNT = "split.count"
    SPLIT_TENSORS_COUNT = "split.tensors.count"


# Canonical tensor name templates (src/llama-arch.cpp:312-332).
class TensorNames:
    TOKEN_EMBD = "token_embd.weight"
    OUTPUT_NORM = "output_norm.weight"
    OUTPUT = "output.weight"
    ROPE_FREQS = "rope_freqs.weight"

    ATTN_NORM = "blk.{bid}.attn_norm.weight"
    ATTN_Q = "blk.{bid}.attn_q.weight"
    ATTN_K = "blk.{bid}.attn_k.weight"
    ATTN_V = "blk.{bid}.attn_v.weight"
    ATTN_OUT = "blk.{bid}.attn_output.weight"
    ATTN_Q_NORM = "blk.{bid}.attn_q_norm.weight"
    ATTN_K_NORM = "blk.{bid}.attn_k_norm.weight"
    ATTN_POST_NORM = "blk.{bid}.post_attention_norm.weight"
    FFN_NORM = "blk.{bid}.ffn_norm.weight"
    FFN_POST_NORM = "blk.{bid}.post_ffw_norm.weight"
    FFN_GATE = "blk.{bid}.ffn_gate.weight"
    FFN_DOWN = "blk.{bid}.ffn_down.weight"
    FFN_UP = "blk.{bid}.ffn_up.weight"
    FFN_GATE_INP = "blk.{bid}.ffn_gate_inp.weight"
    FFN_GATE_EXPS = "blk.{bid}.ffn_gate_exps.weight"
    FFN_DOWN_EXPS = "blk.{bid}.ffn_down_exps.weight"
    FFN_UP_EXPS = "blk.{bid}.ffn_up_exps.weight"
    FFN_GATE_SHEXP = "blk.{bid}.ffn_gate_shexp.weight"
    FFN_DOWN_SHEXP = "blk.{bid}.ffn_down_shexp.weight"
    FFN_UP_SHEXP = "blk.{bid}.ffn_up_shexp.weight"
