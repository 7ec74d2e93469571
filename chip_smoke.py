#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpullama_torch) end to end on one CUDA card.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases card,build,kernels

Phases, each printing one JSON line with its seconds:
  card      nvidia-smi's name and power limit of the card
  build     nvcc builds the kernels from tpullama_torch/csrc
  kernels   every kernel against its plain PyTorch version on the card, at
            the serving path's shapes, with kernel, plain and library
            times and the bound from the card's data-sheet rates; gpt-oss's
            attention (64/8 heads, D = 64, sinks) over both stacks (4224
            and 385 cells) and its attn_output among them, and
            gemma-3-12b's (16/8 heads, D = 256, over 4224 cells and the
            1281-cell ring) with its Q4_K [gate] and down at T = 4 and 1024;
            Llama-4-Scout's (40/8 heads over its 16512-cell full stack and
            its 8449-cell chunked ring), its attention, shared-expert and
            lm_head matrices at T = 4 and 1024 and its experts in one-row
            (B = 4) and 8-row tiles (1024 slots over 16 experts); phi-2's
            (32 heads of 80, G = 1, over 2176 cells, beside the same shapes
            at D = 128) with its Q4_K attn_qkv, ffn_up and ffn_down at T = 4
            and 1024 and its Q6_K lm_head at T = 4; bigcode/starcoder's (48
            heads of 128 over one KV head, G = 48, over 8320 cells);
            BLOOM-7b1's (32 heads of 128, G = 1, over 4736 cells) through
            the kernels' ALiBi branch with BLOOM's slopes under the
            Context's distance mask (-|dpos| on visible cells), against
            SDPA with the additive mask slope * -|dpos| (the same
            function); every case with ALiBi slopes runs under that mask;
            OLMo-2-1124-7B's Q4_K [gate] and down (11008 x 4096 and 4096 x
            11008) at T = 4 and 1024
  model     a synthetic Llama-3-8B-shaped GGUF (4 of its 32 layers; Q4_K
            layers, Q6_K output,
            Q4_K token table, random block bytes from a seed) is written
            to a temp dir and loaded packed onto the card
  crosscheck the same widths at 2 layers: prefill logits and an 8-token
            greedy Context.generate on the card (kernels) against the
            port on the CPU (plain versions)
  serve     ServerEngine(n_slots=4, n_ctx=4096, bf16) answers 4
            concurrent greedy requests and 1 seeded sampled request; a
            greedy request run again returns the same text. Then, after
            the path's launch counts are read, torch.profiler splits a
            packed 4x256 prefill chunk and a B=4 decode step of its
            Context into host wall time and the card's busy time by kernel;
            the decode step replays its CUDA graph, and the same step run
            eagerly is profiled beside it
  moe_model, moe_crosscheck, moe_serve
            the same three on a Mixtral-8x7B-shaped MoE llama (8 experts,
            2 per token; 2 of its 32 layers, 1 in the cross-check), whose
            expert FFNs run through the gathered qmm kernels
  graphs, moe_graphs, glm_graphs
            each served model's one-token decode steps as CUDA graphs: two
            Contexts over the loaded model with the same prefilled lanes,
            one replaying its step programs' graphs, the other running the
            private eager step they capture: 8 decode_batch steps with one
            lane inactive (equal logits), a greedy decode_batch_burst of 8
            and, on one lane, a greedy decode_burst of 16 (equal ids and
            bookkeeping); a sampled decode_burst equal on a rerun from the
            same seed, and at temperature 1e-4 with top-k 1 the greedy
            ids; each capture's seconds and reserved bytes
  glm_model, glm_crosscheck, glm_serve
            the same three on a ChatGLM3-6B-shaped model (7 of its 28
            layers; 1 in
            the cross-check) with the fused post-attention layer and 4
            K-chunks on (fused_layer=True, qmm_tile_k=4), served with one
            slot: every decode step runs qmm_ktiled on attn_qkv and the
            fused_postattn kernel on each layer. The cross-check also
            holds the card's run with both off, on the same planes, to the
            same tokens; the profile checks one decode step's launches
  qwen_crosscheck
            the cross-check at Qwen2-1.5B's widths (2 of its 28 layers):
            GQA group 6 (12/2 heads) through both attention kernels, q/k/v
            biases, and ffn_down's K = 8960 through qmm_gemv and qmm_tiled
  openllama_crosscheck
            the cross-check at OpenLLaMA-3B's widths (2 of its 26 layers,
            every matrix Q8_0, as 3200 is no multiple of 256): head dim
            100 through both attention kernels
  http      the Llama model behind tpullama_torch.server.http.serve (4
            slots of 4096 cells, the JAX package's f32 engine): 4
            concurrent streamed greedy /v1/completions, a streamed and a
            plain /v1/chat/completions, the same with a JSON-schema
            response_format (equal text, which the grammar accepts),
            /v1/embeddings of 4 inputs (unit norm, equal on a rerun and to
            Context.embeddings), /rerank (501), /health, /metrics, /slots;
            TTFT and output tok/s as an HTTP client sees them
  spec      speculative decoding on the Llama model: generate_speculative
            with the model as its own draft (tokens of the greedy loop up
            to the first near-tie; acceptance >= 0.5 with f32 activations,
            printed with bf16); a draft at Llama-3.2-1B's widths (16
            layers, tied output, llama3 rope_freqs) for ServerEngine's 4
            slots on the serve phase's requests, bf16 and with f32
            activations (the same tokens under that rule; tok/s,
            acceptance, a round split into drafting and verifying), and
            for serve(draft_model=) (the draft counters on /metrics)
  q5km_model, q5km_crosscheck, q5km_serve
            the model, cross-check and serve phases on Llama-3-8B at full
            width, 8 of its 32 layers, in llama.cpp's Q5_K_M layout
            (LAYOUTS: attn_v/ffn_down Q6_K in the use_more_bits layers of
            8 (0, 3, 6, 7) and Q5_K in the others, so loaded dense; every
            other matrix Q5_K through the q1 set of
            qmm_gemv/qmm_tiled); the 1-layer cut with its vocabulary cut
            to 16384 rows is loaded with and without the native host
            library (timed, the same bits), and the 4 requests are run
            twice together (dense projections are not batch-invariant);
            the profile checks the qmm launches
            of a decode step and of a prefill chunk
  quant_crosscheck
            1-layer cross-checks at Llama-3.2-1B's widths in the Q3_K_M-like,
            Q2_K-like, Q5_0/Q5_1, Q4_0 and IQ4_XS layouts; the Q5_0/Q5_1
            model also split into shards and loaded from split futures,
            from its first shard and whole (the same parameters), and run
            through the CLI from the first shard (the whole file's text)
  qwen3moe_model, qwen3moe_crosscheck, qwen3moe_serve
            the model, cross-check and serve phases on a Qwen3-30B-A3B-shaped
            qwen3moe model (4 of its 48 layers; 1 in the cross-check) in the
            Q2_K layout: 128 experts of FFN 768, 8 a token, Q2_K [gate | up]
            and Q3_K down experts through the q1/q2 sets of qmm_gathered,
            per-head q/k norms, 32 x 128 query columns on a 2048 hidden
  qwen2moe_crosscheck
            the cross-check (1 layer, a 16-token prompt) at Qwen2-57B-A14B's
            widths in the Q5_0/Q5_1 layout: 64 Q5_1 experts of FFN 2560, 8 a
            token, not renormalized, and a 20480-wide Q5_1 shared expert
            behind its sigmoid gate
  granitemoe_crosscheck
            the cross-check (2 layers) at granite-3.0-3b-a800m's widths, Q4_K:
            the scale stack (embedding, residual, final logit scale), 40
            experts of FFN 512 through qmm_gathered_t, a tied 49155-row
            lm_head
  qwen3mxfp4_model, qwen3mxfp4_crosscheck, qwen3mxfp4_serve
            the Qwen3-30B-A3B path again (4 of 48 layers, 1 in the
            cross-check) in llama.cpp's MXFP4_MOE layout: MXFP4 expert stacks,
            stored transposed (64 and 24 scale columns), through both
            routes of qmm_gathered_t (the profile checks one eager decode
            step's one-row tiles and one packed chunk's 8-row tiles), and
            every other matrix Q8_0
  mxfp4_crosscheck
            one Mixtral-8x7B layer with every matrix MXFP4 (the MXFP4 file
            type of tools/quantize.py), written once, card against CPU in
            three card runs: the LUT planes, the A/r planes
            (load_model(mxfp4_ar=True)) and the LUT planes with
            qmm_tile_k=4: kernels 1-4 on MXFP4 sets (attention and lm_head
            at K = 4096, [gate | up] row-major, down transposed), the same
            greedy tokens in all three
  glm4moe_model, glm4moe_crosscheck, glm4moe_serve
            the model, cross-check and serve phases on a GLM-4.5-Air-shaped
            glm4moe model, a heterogeneous dense/MoE stack (3 of its 46
            layers: the dense lead and 2 MoE layers of 128 experts, 8 a
            token, sigmoid routing with the selection bias, one shared
            expert; 96 x 128 query columns over 8 KV heads, partial rope,
            q/k/v biases) plus its NextN layer, which the loader skips:
            every layer dense bf16 (~16.4 GB), as both packages keep such
            a stack, the Q6_K lm_head packed; the cross-check runs the
            dense lead and 1 MoE layer; the profile reports the dense
            expert branch's share of an eager step and of a prefill chunk
  gptoss_model, gptoss_crosscheck, gptoss_serve
            the model, cross-check and serve phases on a gpt-oss-20b-shaped
            model (4 of its 24 layers: two sliding-window layers and two
            full; 64 x 64 query columns over 8 KV heads on a 2880 hidden,
            q/k/v/o biases and per-head sinks, 32 experts of FFN 2880, 4 a
            token, with the router's and the experts' biases and
            swiglu_oai, YaRN rope, vocab 201088) in the layout of
            llama.cpp's gpt-oss GGUFs (MXFP4 experts, Q8_0 elsewhere):
            every matrix but attn_output (K = 4096) dense bf16, as both
            packages load K = 2880 (~8.9 GB). Its Contexts keep the iswa
            two-stack cache: the full layers' cells and the SWA layers'
            ring of n_swa + n_ubatch + 1 = 385 cells. The cross-check (one
            SWA and one full layer, f32) prefills a 600-token prompt in
            256-token chunks so the ring wraps, card against CPU, with both
            stacks' positions cell for cell, and the ring's greedy tokens
            against swa_full's one stack; the serve phase prints the two
            stacks' bytes against swa_full's, and its profile the dense
            expert branch's share
  gemma3_model, gemma3_crosscheck, gemma3_serve
            the model, cross-check and serve phases on a gemma-3-12b-shaped
            model (6 of its 48 layers: one SWA pattern, 5 sliding-window
            layers of window 1024 and 1 full; 16 x 256 query columns over
            8 KV heads on a 3840 hidden, per-head q/k norms, sandwich
            norms, GELU, linear rope scaling on the full layers, vocab
            262208 tied) with every layer matrix Q4_K and a Q6_K token
            table, dense bf16 on the card as the lm_head. The model phase's
            file serves the cross-check too: all 6 layers in f32, card
            against CPU, a 1400-token prompt in 256-token chunks wrapping
            the ring of 1024 + 256 + 1 = 1281 cells, 8 greedy tokens, then
            the first 2 layers (SWA layers only) on one windowed stack.
            Served with 4
            slots at n_ctx 4096 on the two-stack cache
  cohere2_crosscheck
            the cross-check at command-r7b's widths (4 of its 32 layers: 3
            SWA layers of window 4096 and 1 full layer without rope;
            LayerNorm, the parallel residual, logit_scale 0.25, vocab
            256000 tied) at n_ctx 8192, where the ring of 4096 + 256 + 1
            cells is smaller than the full stack, so two stacks stand
  qwen3_model, qwen3_crosscheck, qwen3_serve
            the model, cross-check and serve phases on a Qwen3-8B-shaped
            qwen3 model (4 of its 36 layers; 2 in the cross-check): per-head
            q/k norms on a dense FFN of 12288, 32 / 8 heads of 128, every
            layer matrix and the token table Q4_K, the 151936-row lm_head
            Q6_K, served with 4 slots at n_ctx 4096; the profile checks
            that a step and a chunk run every packed matrix through qmm
  llama4_model, llama4_crosscheck, llama4_ring, llama4_serve
            the model, cross-check and serve phases on a
            Llama-4-Scout-17B-16E-shaped llama4 model (4 of its 48 layers:
            three chunked layers of 8192 and one NoPE full layer with the Q
            temperature; 40 x 128 query columns over 8 KV heads on a 5120
            hidden, the weightless q/k norm after rope, 16 experts of FFN
            8192, 1 a token, sigmoid routing over the raw logits with the
            weights scaling the experts' inputs, an ungated shared expert,
            llama3 rope_freqs, vocab 202048): every layer matrix, expert
            stack and the token table Q4_K, the lm_head Q6_K; [gate | up]
            experts stored transposed (qmm_gathered_t), down row-major
            (qmm_gathered). The cross-check runs all 4 layers in f32 at
            n_ctx 8704 (two stacks), a 200-token prompt and 8 greedy
            tokens; llama4_ring, on the card
            alone, an 8600-token prompt at the true chunk, past position
            8192 and around the ring of 8449 cells, against a swa_full
            Context; served with 4 slots at n_ctx 16384, one request's
            prompt 8600 tokens, each request's tokens against its own
            greedy loop
  phi2_model, phi2_crosscheck, phi2_serve
            the model, cross-check and serve phases on a microsoft/phi-2-
            shaped phi2 model at 8 of its 32 layers: 32 heads of 80 (MHA), rope
            over 32 of the 80 dims (NEOX), LayerNorm with biases, the
            parallel residual (the FFN reads the attention norm), a
            non-gated GELU FFN of 10240 with biases, the biased fused
            attn_qkv and a biased Q6_K lm_head (vocab 51200), every layer
            matrix and the token table Q4_K; the cross-check runs 2 layers
            in f32; served with 4 slots at n_ctx 2048; the profile checks
            that a step and a chunk run every packed matrix through qmm
  starcoder_crosscheck
            the cross-check at bigcode/starcoder's widths (1 of its 40
            layers): learned positions (8192 rows), 48 heads of 128 over one
            KV head (G = 48), no rope, a GELU FFN of 24576 with biases, the
            tied lm_head; a 4160-token prompt in 1024-token chunks reads
            position rows past 4096; n_ctx 8193 is refused by name
  bloom_model, bloom_crosscheck, bloom_serve
            the model, cross-check and serve phases on a bigscience/bloom-
            7b1-shaped bloom model at 8 of its 30 layers: 32 heads of 128
            (MHA), ALiBi (max bias 8) and no rope, the embedding LayerNorm,
            LayerNorms with biases, the biased fused attn_qkv, a non-gated
            GELU FFN of 16384 with biases, every layer matrix Q4_K, the
            tied Q6_K token table as the dense bf16 lm_head (vocab
            250880); the cross-check runs 2 layers in f32; served with 4
            slots at n_ctx 4608, one prompt of ~3000 tokens, each request
            against its own greedy loop; the profile checks that a step
            launches flash_decode_batched with slopes and a chunk
            flash_attention with slopes once per layer
  olmo2_model, olmo2_crosscheck, olmo2_serve
            the model, cross-check and serve phases on an allenai/OLMo-2-
            1124-7B-shaped olmo2 model at 4 of its 32 layers: post-norm
            blocks (attention and FFN read the residual stream, the post
            norms norm their outputs), q/k RMS norms over the full 4096
            width, 32 heads of 128 (MHA), NEOX rope, a gated SiLU FFN of
            11008, every layer matrix Q4_K, the Q6_K lm_head (vocab 100352);
            the cross-check runs 2 layers in f32; served with 4 slots at
            n_ctx 4096; the profile checks that a step and a chunk run
            every packed matrix through qmm and that fused_postattn never
            runs
  int8kv    the served Llama model with an int8 KV cache against a bf16
            one: Contexts of 4 lanes of 8192 cells, bf16 activations,
            4 prompts of 6100-7000 tokens prefilled, a greedy burst of 32;
            each cache's bytes (memory_breakdown), prefill and burst rates,
            the replayed step profiled (flash_decode's ms a launch) and its
            launches (the cache's attention kernel once per layer); the
            greedy ids' agreement is reported (random weights)
  int8kv_crosscheck
            the 2-layer cut (Llama-3-8B's widths, f32 activations) with an
            int8 cache, card against the CPU port: prefill logits, int8
            rows within a quantization step, greedy tokens up to the first
            near-tie, seq_rm + seq_add + seq_div and decoding on, seq_cp,
            embeddings, a sampled burst rerun from its seed
  state     the state path on the same cut: seq_save / seq_load of a lane
            (f32 and int8 caches; the CPU port restores the card's file),
            slot save / erase / restore over HTTP (serve(slot_save_path=)),
            and the CLI twice with --prompt-cache (the second restores and
            prints what the CPU prints from the card's file)
  cli       tpullama_torch.tools.cli.main on a 2-layer Q8_0 file at
            Llama-3-8B's widths (dense bf16 weights, the CLI's default), 16
            greedy tokens on the card with --burst 16 and --burst 1, and
            with --device cpu: the same text; then --grammar and
            --json-schema on the card and the CPU: the same text, which
            the grammar accepts, and Grammar.apply's host ms per token
Every model phase loads through the native host library, which must have
built on the card's machine. Each cross-check's CPU side (but ChatGLM's,
whose fused layer and K-chunks read the packed planes) dequantizes its
matrices once at load, on the card, its experts too (dense_reference). The
Llama cross-check also holds Context.embeddings (each pooling) and
seq_add / seq_div on the card against the CPU, and a replayed step after
seq_add against the eager step. The crosscheck, serve, http, spec, cli,
quant_crosscheck, int8kv, int8kv_crosscheck, state, the MoE archs',
GLM-4.5-Air's, gpt-oss's, gemma-3-12b's, command-r7b's, Qwen3-8B's,
Llama-4-Scout's, phi-2's, bigcode/starcoder's, BLOOM-7b1's and
OLMo-2-1124-7B's paths each run
with every launch count set to 0 just before
and read just after, and fail unless each kernel that path must run was launched. Then one JSON line lists every
kernel with its launches on each path and its numbers at the served shape
from the kernels phase, and the last line is the run's result. Any failed
check raises, so the script exits non-zero and prints no result line.
Without a CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace

import numpy as np

# H100 SXM data-sheet rates (dense): memory bandwidth, bf16 tensor-core
# and f32 (non-tensor-core) peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
FLUSH_BYTES = 512 << 20  # written between timed launches: evicts the 50 MB L2
NEG_HIDDEN = -5e29  # additive mask values at or below this hide a cell

ALL_PHASES = ("card", "build", "kernels", "model", "crosscheck", "serve", "graphs", "http",
              "spec", "cli", "moe_model", "moe_crosscheck", "moe_serve", "moe_graphs", "glm_model",
              "glm_crosscheck", "glm_serve", "glm_graphs", "qwen_crosscheck",
              "openllama_crosscheck", "q5km_model", "q5km_crosscheck", "q5km_serve",
              "quant_crosscheck", "int8kv", "int8kv_crosscheck", "state", "qwen3moe_model",
              "qwen3moe_crosscheck", "qwen3moe_serve", "qwen2moe_crosscheck",
              "granitemoe_crosscheck", "qwen3mxfp4_model", "qwen3mxfp4_crosscheck",
              "qwen3mxfp4_serve", "mxfp4_crosscheck", "glm4moe_model", "glm4moe_crosscheck",
              "glm4moe_serve", "gptoss_model", "gptoss_crosscheck", "gptoss_serve",
              "gemma3_model", "gemma3_crosscheck", "gemma3_serve", "cohere2_crosscheck",
              "qwen3_model", "qwen3_crosscheck", "qwen3_serve", "llama4_model",
              "llama4_crosscheck", "llama4_ring", "llama4_serve", "phi2_model", "phi2_crosscheck",
              "phi2_serve", "starcoder_crosscheck", "bloom_model", "bloom_crosscheck",
              "bloom_serve", "olmo2_model", "olmo2_crosscheck", "olmo2_serve")


# every line the run prints, whole, also goes to this file (the kernels
# line alone can outgrow what a terminal or a log tail keeps)
LOG_PATH = os.path.join("chiprun_out", "chip_smoke.jsonl")
_log: list = []


def emit(obj) -> None:
    say(json.dumps(obj))


def say(line: str) -> None:
    print(line, flush=True)
    for f in _log:
        f.write(line + "\n")
        f.flush()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# ---------------------------------------------------------------- model


@dataclass(frozen=True)
class Widths:
    """A llama-family configuration (n_expert > 0: a Mixtral-style MoE,
    whose n_ff is each expert's; arch "chatglm": fused biased [Q|K|V],
    fused [gate|up], n_rot rotated dims). LLAMA3_8B holds the published
    widths of meta-llama/Meta-Llama-3-8B (config.json), cut to 4 of its
    32 layers (every layer has the same shapes and launches);
    MIXTRAL_8X7B those
    of mistralai/Mixtral-8x7B-v0.1 (config.json; sliding window null), cut
    to 2 of its 32 layers: every layer has the same shapes and launches;
    CHATGLM3_6B those of THUDM/chatglm3-6b (config.json: hidden 4096, 28
    layers, 32 heads, multi_query_group_num 2, ffn 13696,
    padded_vocab_size 65024, seq_length 8192; rope over half of each
    head, chatglm.rope.dimension_count 64), cut to 7 of its 28 layers
    for the same reason (the whole run's time limit); QWEN2_1_5B those of
    Qwen/Qwen2-1.5B (config.json: hidden 1536, 28 layers, 12 heads, 2 KV
    heads, intermediate 8960, vocab 151936, rope_theta 1e6, rms_norm_eps
    1e-6; q/k/v biases), written with an untied output matrix and used at
    2 layers in the cross-check alone; OPENLLAMA_3B those of
    openlm-research/open_llama_3b (config.json: hidden 3200, 26 layers,
    32 heads, head dim 100, intermediate 8640, vocab 32000, rms_norm_eps
    1e-6), every matrix Q8_0 (`q8`: 3200 is no multiple of Q4_K's 256),
    used at 2 layers in the cross-check alone; LLAMA32_1B those of
    meta-llama/Llama-3.2-1B (config.json: hidden 2048, 16 layers, 32 heads,
    8 KV heads, head dim 64, intermediate 8192, vocab 128256, rope_theta
    500000 with llama3 scaling factor 32, low 1, high 4, original 8192,
    tie_word_embeddings true, rms_norm_eps 1e-5), the speculative draft,
    cut to 8 of its 16 layers for the same reason.
    The MoE archs (n_ff each routed expert's FFN): QWEN3_30B_A3B those of
    Qwen/Qwen3-30B-A3B (config.json: hidden 2048, 48 layers, 32 heads, 4
    KV heads, head_dim 128, so 32 x 128 = 4096 query columns on a 2048
    hidden; 128 experts, 8 per token, moe_intermediate_size 768,
    norm_topk_prob true; vocab 151936, rope_theta 1e6, rms_norm_eps 1e-6,
    max_position_embeddings 40960, untied; per-head q/k RMS norms), cut to
    4 of its 48 layers (every layer has the same shapes and launches), in
    the Q2_K layout; QWEN2_57B_A14B those of Qwen/Qwen2-57B-A14B
    (config.json: hidden 3584, 28 layers, 28 heads, 4 KV heads, 64
    experts, 8 per token, moe_intermediate_size 2560,
    shared_expert_intermediate_size 20480 with its sigmoid gate,
    norm_topk_prob false; vocab 151936, rope_theta 1e6, rms_norm_eps 1e-6;
    q/k/v biases), in the Q5_0/Q5_1 layout, used at 1 layer in the
    cross-check alone; GRANITE_3B_A800M those of
    ibm-granite/granite-3.0-3b-a800m (config.json: hidden 1536, 32 layers,
    24 heads, 8 KV heads, 40 experts, 8 per token, intermediate_size 512;
    vocab 49155, tie_word_embeddings true, rope_theta 10000, rms_norm_eps
    1e-6; embedding_multiplier 12.0, residual_multiplier 0.22,
    logits_scaling 6.0, attention_multiplier 0.015625, written as
    llama.cpp's converter writes them: embedding_scale, residual_scale,
    logit_scale, attention.scale), Q4_K, used at 2 layers in the
    cross-check alone. The heterogeneous dense/MoE stack (glm4moe):
    GLM_4_5_AIR holds those of zai-org/GLM-4.5-Air (config.json: hidden
    4096, 46 layers plus num_nextn_predict_layers 1, 96 heads, 8 KV heads,
    head_dim 128, partial_rotary_factor 0.5 (64 rope dims), rope_theta 1e6,
    intermediate_size 10944 (the dense lead, first_k_dense_replace 1),
    moe_intermediate_size 1408, 128 routed experts, 8 per token,
    n_shared_experts 1, norm_topk_prob true, routed_scaling_factor 1.0,
    sigmoid routing with the e_score_correction_bias, attention_bias true,
    use_qk_norm false, vocab 151552, rms_norm_eps 1e-5,
    max_position_embeddings 131072, untied), written as llama.cpp's
    converter writes them (post_attention_norm as the FFN norm,
    exp_probs_b.bias, expert_gating_func 2, nextn_predict_layers and the
    NextN layer's nextn.* tensors) and cut to 3 of its 46 layers (the
    dense lead and 2 MoE layers; every MoE layer has the same shapes and
    launches) plus the NextN layer, which the loaders skip. gpt-oss:
    GPT_OSS_20B holds those of openai/gpt-oss-20b (config.json: hidden
    2880, 24 layers, 64 heads of head_dim 64 over 8 KV heads, attention
    bias true and per-head sinks, 32 local experts of intermediate_size
    2880, 4 a token, with the router's and each expert's biases and
    swiglu_limit 7.0, sliding_window 128 on the even layers (layer_types
    alternating sliding / full), vocab 201088, rope_theta 150000 with YaRN
    factor 32 over original_max_position_embeddings 4096, rms_norm_eps
    1e-5, max_position_embeddings 131072, untied), written as llama.cpp's
    converter writes them (post_attention_norm as the FFN norm, attn_sinks,
    the biases as *.bias, attention.sliding_window, rope.scaling.*) in the
    layout of llama.cpp's gpt-oss GGUFs (MXFP4 experts, every other matrix,
    token_embd and output Q8_0) and cut to 4 of its 24 layers: two SWA and
    two full, every layer of a kind with the same shapes and launches.
    `llama3_rope`: the llama3 scaling written as rope_freqs.weight, as
    llama.cpp's converter does; `tied`: no output.weight (the token table
    is the lm_head); `quant`: the tensor types of a llama.cpp file type
    (LAYOUTS) instead of Q4_K; `head_dim`: attention.key_length and
    value_length when not n_embd / n_head; `n_ff_shexp`: a shared expert
    of that width; `scales`: granite's (embedding_scale, residual_scale,
    logit_scale, attention.scale); `n_ff_exp`: each routed expert's FFN
    width where `n_ff` is the dense lead's; `dense_lead`: leading dense
    layers; `nextn`: trailing NextN layers written past `n_layer`;
    `n_swa`: the sliding window of the SWA layers; `yarn`: YaRN rope
    scaling (factor, original context); `rope_linear`: linear rope scaling's
    factor; `logit_scale`: command-r's final logit scale; `embd_type`: the
    token table's type (a tied table takes the output's, Q6_K, as
    llama.cpp's quantizer gives it). The gemma and cohere families:
    GEMMA3_12B holds those of google/gemma-3-12b-pt (config.json,
    text_config: hidden 3840, 48 layers, 16 heads over 8 KV heads,
    head_dim 256, so 16 x 256 = 4096 query columns on a 3840 hidden;
    intermediate 15360, gelu_pytorch_tanh, vocab 262208, tied;
    sliding_window 1024 with sliding_window_pattern 6 (5 SWA layers : 1
    full), rope_theta 1e6 with rope_scaling linear factor 8 on the full
    layers, rope_local_base_freq 1e4, query_pre_attn_scalar 256,
    rms_norm_eps 1e-6, max_position_embeddings 131072), written as
    llama.cpp's converter writes them (per-head q/k norms,
    post_attention_norm and post_ffw_norm, attention.sliding_window,
    rope.scaling.type linear and factor 8), every layer matrix Q4_K (the
    Q4_K_M type of all but its use_more_bits layers, whose Q6_K attn_v and
    ffn_down both loaders would keep dense across the stack) and the tied
    token table Q6_K, cut to 6 of its 48 layers: one whole SWA pattern,
    every later one with the same shapes and launches. COHERE2_7B holds
    those of CohereForAI/c4ai-command-r7b-12-2024 (config.json: hidden
    4096, 32 layers, 32 heads over 8 KV heads, intermediate 14336, vocab
    256000, sliding_window 4096 with sliding_window_pattern 4 (3 SWA
    layers : 1 full, the full ones without rope), rope_theta 50000,
    logit_scale 0.25, layer_norm_eps 1e-5, tied, max_position_embeddings
    132096), written as llama.cpp's converter writes them (LayerNorm
    weights, no FFN norm, logit_scale), cut to 4 of its 32 layers (3 SWA +
    1 full) and used in the cross-check alone. The dense flag archs:
    QWEN3_8B holds those of Qwen/Qwen3-8B (config.json: hidden 4096, 36
    layers, 32 heads over 8 KV heads, head_dim 128, intermediate 12288,
    vocab 151936, rope_theta 1e6, rms_norm_eps 1e-6,
    max_position_embeddings 40960, tie_word_embeddings false; per-head q/k
    RMS norms, no biases), written as llama.cpp's converter writes them
    (attn_q_norm and attn_k_norm), every layer matrix and the token table
    Q4_K, the output Q6_K, cut to 4 of its 36 layers (every layer has the
    same shapes and launches), as the Q5_K_M Llama path is. llama4:
    LLAMA4_SCOUT holds those of meta-llama/Llama-4-Scout-17B-16E
    (config.json, text_config: hidden 5120, 48 layers, 40 heads of 128
    over 8 KV heads, 16 experts of intermediate_size 8192, 1 a token,
    one shared expert of the same width, interleave_moe_layer_step 1,
    vocab 202048, rope_theta 5e5 with llama3 scaling factor 16, low 1,
    high 1, original 8192, attention_chunk_size 8192 with every 4th layer
    NoPE, use_qk_norm true, floor_scale 8192, attn_scale 0.1, rms_norm_eps
    1e-5, max_position_embeddings 10485760, untied), written as llama.cpp's
    converter writes them (interleave_moe_layer_step, expert and shared
    expert widths, rope_freqs from the llama3 factors; no window key, so
    both packages take the chunk of 8192 and the temperature's constants
    from the arch), cut to 4 of its 48 layers: one whole period of the
    pattern, three chunked layers and one NoPE full layer, every later
    period with the same shapes and launches. The non-gated FFN archs:
    PHI_2 holds those of microsoft/phi-2 (config.json: hidden 2560, 32
    layers, 32 heads of 80 (MHA), partial_rotary_factor 0.4 (32 rope
    dims, NEOX), intermediate 10240 with gelu_new (the tanh form),
    layer_norm_eps 1e-5, rope_theta 10000, vocab 51200 with the lm_head's
    bias, max_position_embeddings 2048, untied), written as llama.cpp's
    converter writes them (LayerNorm weights and biases, no FFN norm: the
    FFN reads the attention norm, the biased fused attn_qkv of 7680 rows,
    output.bias), every layer matrix and the token table Q4_K, the
    lm_head Q6_K, cut to 8 of its 32 layers (every layer has the same
    shapes and launches). STARCODER holds those of
    bigcode/starcoder (config.json: n_embd 6144, 40 layers, 48 heads of
    128 over one KV head (multi_query), so attn_qkv has 6400 rows;
    n_inner 24576 with GELU (tanh), 8192 learned positions
    (n_positions), layer_norm_epsilon 1e-5, vocab 49152, tied), written
    as llama.cpp's converter writes them (position_embd, LayerNorm
    weights and biases, every projection's bias, no rope keys), the
    position table F16 as llama.cpp's quantizer leaves it, the tied
    token table Q6_K, cut to 1 of its 40 layers and used in the
    cross-check alone. The ALiBi archs: BLOOM_7B1 holds those of
    bigscience/bloom-7b1 (config.json: hidden_size 4096, 30 layers, 32
    heads of 128 (MHA), the 4 x 4096 = 16384-wide GELU (tanh) MLP,
    layer_norm_epsilon 1e-5, vocab 250880, tied word embeddings; ALiBi
    positions, no rope, trained at 2048 tokens; llama.cpp takes BLOOM's
    max_alibi_bias as 8), written as llama.cpp's converter writes them
    (token_embd_norm with its bias, LayerNorm weights and biases, the
    biased fused attn_qkv, attn_output, ffn_up and ffn_down with biases,
    no rope keys and no max_alibi_bias key), every layer matrix Q4_K and
    the tied token table Q6_K, cut to 8 of its 30 layers (every layer has
    the same shapes and launches). The post-norm archs: OLMO2_7B holds
    those of allenai/OLMo-2-1124-7B (config.json: hidden_size 4096, 32
    layers, 32 heads of 128 over 32 KV heads (MHA), intermediate_size
    11008 with SiLU, vocab_size 100352 untied, rms_norm_eps 1e-6,
    rope_theta 500000, max_position_embeddings 4096; q/k RMS norms over
    the full projection width, post-attention and post-feedforward norms
    and no pre-norms), written as llama.cpp's converter writes them
    (attn_q_norm and attn_k_norm of 4096, post_attention_norm and
    post_ffw_norm, no attn_norm or ffn_norm), every layer matrix Q4_K
    (11008 = 43 x 256), the lm_head Q6_K, cut to 4 of its 32 layers (every
    layer has the same shapes and launches)."""

    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_head_kv: int = 8
    n_ff: int = 14336
    n_vocab: int = 128256
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    n_ctx_train: int = 8192
    n_expert: int = 0
    n_expert_used: int = 0
    arch: str = "llama"
    n_rot: int = 0  # 0: the whole head
    q8: bool = False  # every matrix Q8_0 (token table and output included)
    tied: bool = False
    llama3_rope: tuple = ()  # (factor, low_freq_factor, high_freq_factor, original ctx)
    quant: str = ""  # a layout of LAYOUTS ("": Q4_K matrices, Q6_K output)
    head_dim: int = 0  # 0: n_embd / n_head
    n_ff_shexp: int = 0
    scales: tuple = ()
    n_ff_exp: int = 0
    dense_lead: int = 0
    nextn: int = 0
    n_swa: int = 0
    yarn: tuple = ()
    rope_linear: float = 0.0
    logit_scale: float = 0.0
    embd_type: str = "Q4_K"

    @property
    def hd(self) -> int:
        return self.head_dim or self.n_embd // self.n_head


LLAMA3_8B = Widths(n_layer=4)
MIXTRAL_8X7B = Widths(n_layer=2, n_vocab=32000, rope_theta=1e6, n_ctx_train=32768,
                      n_expert=8, n_expert_used=2)
CHATGLM3_6B = Widths(n_layer=7, n_head_kv=2, n_ff=13696, n_vocab=65024, rope_theta=10000.0,
                     arch="chatglm", n_rot=64)
# the ChatGLM path's two opt-ins, the JAX package's TPULLAMA_FUSED_LAYER and
# TPULLAMA_QMM_TILE_K
GLM_OPTS = dict(fused_layer=True, qmm_tile_k=4)
QWEN2_1_5B = Widths(n_embd=1536, n_layer=28, n_head=12, n_head_kv=2, n_ff=8960,
                    n_vocab=151936, rope_theta=1e6, rms_eps=1e-6, n_ctx_train=32768,
                    arch="qwen2")
OPENLLAMA_3B = Widths(n_embd=3200, n_layer=26, n_head=32, n_head_kv=32, n_ff=8640,
                      n_vocab=32000, rope_theta=10000.0, rms_eps=1e-6, n_ctx_train=2048,
                      q8=True)
LLAMA32_1B = Widths(n_embd=2048, n_layer=8, n_head=32, n_head_kv=8, n_ff=8192,
                    n_ctx_train=131072, tied=True, llama3_rope=(32.0, 1.0, 4.0, 8192))
# Llama-3-8B at full width in llama.cpp's Q5_K_M layout, cut to 8 of its 32
# layers (the use_more_bits rule still mixes Q6_K and Q5_K in attn_v and
# ffn_down, so both stay dense)
LLAMA3_8B_Q5KM = replace(LLAMA3_8B, n_layer=8, quant="Q5_K_M")
QWEN3_30B_A3B = Widths(n_embd=2048, n_layer=4, n_head=32, n_head_kv=4, head_dim=128, n_ff=768,
                       n_vocab=151936, rope_theta=1e6, rms_eps=1e-6, n_ctx_train=40960,
                       n_expert=128, n_expert_used=8, arch="qwen3moe", quant="Q2_K")
QWEN2_57B_A14B = Widths(n_embd=3584, n_layer=28, n_head=28, n_head_kv=4, n_ff=2560,
                        n_ff_shexp=20480, n_vocab=151936, rope_theta=1e6, rms_eps=1e-6,
                        n_ctx_train=32768, n_expert=64, n_expert_used=8, arch="qwen2moe",
                        quant="Q5_0_Q5_1")
GRANITE_3B_A800M = Widths(n_embd=1536, n_layer=32, n_head=24, n_head_kv=8, n_ff=512,
                          n_vocab=49155, rope_theta=10000.0, rms_eps=1e-6, n_ctx_train=4096,
                          n_expert=40, n_expert_used=8, arch="granitemoe", tied=True,
                          scales=(12.0, 0.22, 6.0, 0.015625))
# MXFP4: Qwen3-30B-A3B (4 of 48 layers) in llama.cpp's MXFP4_MOE layout,
# its experts' scale planes (64 and 24 columns) no multiple of 128, so
# stored transposed; one layer of Mixtral-8x7B with every matrix MXFP4
# (tools/quantize.py's MXFP4 file type): attention and lm_head at K = 4096
# through qmm_gemv / qmm_tiled (and qmm_ktiled with qmm_tile_k=4),
# [gate | up] row-major (128 scale columns), down transposed (448)
QWEN3_30B_A3B_MXFP4 = replace(QWEN3_30B_A3B, quant="MXFP4_MOE")
MIXTRAL_8X7B_MXFP4 = replace(MIXTRAL_8X7B, n_layer=1, quant="MXFP4")
GLM_4_5_AIR = Widths(n_embd=4096, n_layer=3, n_head=96, n_head_kv=8, head_dim=128, n_ff=10944,
                     n_ff_exp=1408, n_ff_shexp=1408, n_vocab=151552, rope_theta=1e6,
                     rms_eps=1e-5, n_ctx_train=131072, n_expert=128, n_expert_used=8,
                     arch="glm4moe", n_rot=64, dense_lead=1, nextn=1)
GPT_OSS_20B = Widths(n_embd=2880, n_layer=4, n_head=64, n_head_kv=8, head_dim=64, n_ff=2880,
                     n_vocab=201088, rope_theta=150000.0, rms_eps=1e-5, n_ctx_train=131072,
                     n_expert=32, n_expert_used=4, arch="gpt-oss", quant="MXFP4_MOE", n_swa=128,
                     yarn=(32.0, 4096))
GEMMA3_12B = Widths(n_embd=3840, n_layer=6, n_head=16, n_head_kv=8, head_dim=256, n_ff=15360,
                    n_vocab=262208, rope_theta=1e6, rms_eps=1e-6, n_ctx_train=131072,
                    arch="gemma3", tied=True, n_swa=1024, rope_linear=8.0, embd_type="Q6_K")
COHERE2_7B = Widths(n_embd=4096, n_layer=4, n_head=32, n_head_kv=8, n_ff=14336, n_vocab=256000,
                    rope_theta=50000.0, n_ctx_train=132096, arch="cohere2", tied=True,
                    n_swa=4096, logit_scale=0.25, embd_type="Q6_K")
QWEN3_8B = Widths(n_embd=4096, n_layer=4, n_head=32, n_head_kv=8, head_dim=128, n_ff=12288,
                  n_vocab=151936, rope_theta=1e6, rms_eps=1e-6, n_ctx_train=40960, arch="qwen3")
LLAMA4_SCOUT = Widths(n_embd=5120, n_layer=4, n_head=40, n_head_kv=8, n_ff=8192, n_ff_shexp=8192,
                      n_vocab=202048, rope_theta=5e5, rms_eps=1e-5, n_ctx_train=10485760,
                      n_expert=16, n_expert_used=1, arch="llama4",
                      llama3_rope=(16.0, 1.0, 1.0, 8192))
PHI_2 = Widths(n_embd=2560, n_layer=8, n_head=32, n_head_kv=32, n_ff=10240, n_vocab=51200,
               rope_theta=10000.0, rms_eps=1e-5, n_ctx_train=2048, arch="phi2", n_rot=32)
STARCODER = Widths(n_embd=6144, n_layer=1, n_head=48, n_head_kv=1, n_ff=24576, n_vocab=49152,
                   rms_eps=1e-5, n_ctx_train=8192, arch="starcoder", tied=True,
                   embd_type="Q6_K")
BLOOM_7B1 = Widths(n_embd=4096, n_layer=8, n_head=32, n_head_kv=32, n_ff=16384, n_vocab=250880,
                   rms_eps=1e-5, n_ctx_train=2048, arch="bloom", tied=True, embd_type="Q6_K")
OLMO2_7B = Widths(n_embd=4096, n_layer=4, n_head=32, n_head_kv=32, n_ff=11008, n_vocab=100352,
                  rope_theta=500000.0, rms_eps=1e-6, n_ctx_train=4096, arch="olmo2")


def use_more_bits(il: int, n: int) -> bool:
    """llama.cpp's use_more_bits (src/llama-quant.cpp): the layers of a
    K-quant mix whose attn_v and ffn_down get more bits."""
    return il < n // 8 or il >= 7 * n // 8 or (il - n // 8) % 3 == 2


def _layout(*, embd, attn_q, attn_v, attn_o, ffn, ffn_down, attn_k=None, output="Q6_K",
            exps=None):
    """A layout's type per tensor role: (role, layer, n_layer) -> GGML type
    name; attn_v / ffn_down may be functions of (layer, n_layer). Expert
    stacks and the shared expert take the FFN roles' types, as llama.cpp's
    quantizer gives them, unless `exps` names the expert stacks' own type
    (llama.cpp's MXFP4_MOE)."""
    roles = {"token_embd": embd, "output": output, "attn_q": attn_q,
             "attn_k": attn_k or attn_q, "attn_v": attn_v, "attn_output": attn_o,
             "ffn_gate": ffn, "ffn_up": ffn, "ffn_down": ffn_down}
    for sfx in ("_exps", "_shexp"):
        roles.update({"ffn_gate" + sfx: ffn, "ffn_up" + sfx: ffn, "ffn_down" + sfx: ffn_down})
    if exps:
        roles.update({r + "_exps": exps for r in ("ffn_gate", "ffn_up", "ffn_down")})

    def type_of(role, il, n):
        t = roles[role]
        return t(il, n) if callable(t) else t

    return type_of


# llama.cpp file types (llama_tensor_get_type, src/llama-quant.cpp) as this
# script writes them: Q5_K_M (attn_v and ffn_down Q6_K in the use_more_bits
# layers, Q5_K elsewhere; every other matrix and token_embd Q5_K), and the
# cross-check's layouts: Q3_K_M-like, Q2_K-like, Q5_0/Q5_1 (attention
# Q5_0, FFN Q5_1), pure Q4_0 and IQ4_XS; every one with a Q6_K output.
# MXFP4 layouts: MXFP4_MOE (llama.cpp's: the expert stacks MXFP4, every
# other matrix, token_embd and output Q8_0, its default type) and MXFP4
# (tpullama/tools/quantize.py's MXFP4 file type: every matrix, token_embd
# and output MXFP4).
LAYOUTS = {
    "Q5_K_M": _layout(embd="Q5_K", attn_q="Q5_K", attn_o="Q5_K", ffn="Q5_K",
                      attn_v=lambda il, n: "Q6_K" if use_more_bits(il, n) else "Q5_K",
                      ffn_down=lambda il, n: "Q6_K" if use_more_bits(il, n) else "Q5_K"),
    "Q3_K_M": _layout(embd="Q3_K", attn_q="Q3_K", attn_v="Q5_K", attn_o="Q4_K", ffn="Q3_K",
                      ffn_down="Q4_K"),
    "Q2_K": _layout(embd="Q2_K", attn_q="Q2_K", attn_v="Q3_K", attn_o="Q2_K", ffn="Q2_K",
                    ffn_down="Q3_K"),
    "Q5_0_Q5_1": _layout(embd="Q5_0", attn_q="Q5_0", attn_v="Q5_0", attn_o="Q5_0", ffn="Q5_1",
                         ffn_down="Q5_1"),
    "Q4_0": _layout(embd="Q4_0", attn_q="Q4_0", attn_v="Q4_0", attn_o="Q4_0", ffn="Q4_0",
                    ffn_down="Q4_0"),
    "IQ4_XS": _layout(embd="IQ4_XS", attn_q="IQ4_XS", attn_v="IQ4_XS", attn_o="IQ4_XS",
                      ffn="IQ4_XS", ffn_down="IQ4_XS"),
    "MXFP4_MOE": _layout(embd="Q8_0", attn_q="Q8_0", attn_v="Q8_0", attn_o="Q8_0", ffn="Q8_0",
                         ffn_down="Q8_0", output="Q8_0", exps="MXFP4"),
    "MXFP4": _layout(embd="MXFP4", attn_q="MXFP4", attn_v="MXFP4", attn_o="MXFP4", ffn="MXFP4",
                     ffn_down="MXFP4", output="MXFP4"),
}
_LAYER_ROLES = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")


def packed_roles(w: Widths) -> set:
    """The layer matrices the loader packs for a layout: one packable type
    in every layer (a type that changes between layers is loaded dense)."""
    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.qweights import PACKED_TYPES

    out = set()
    for role in _LAYER_ROLES:
        types = {LAYOUTS[w.quant](role, il, w.n_layer) for il in range(w.n_layer)}
        if len(types) == 1 and GGMLType[types.pop()] in PACKED_TYPES:
            out.add(role)
    return out


def llama3_rope_freqs(w: Widths) -> np.ndarray:
    """The per-frequency divisors llama.cpp's converter writes as
    rope_freqs.weight for rope_scaling type llama3: 1 for short
    wavelengths, the factor for long ones, a smooth blend between."""
    factor, low, high, old_ctx = w.llama3_rope
    dim = w.hd
    out = []
    for f in 1.0 / w.rope_theta ** (np.arange(0, dim, 2) / dim):
        wavelen = 2 * math.pi / f
        if wavelen < old_ctx / high:
            out.append(1.0)
        elif wavelen > old_ctx / low:
            out.append(factor)
        else:
            smooth = (old_ctx / wavelen - low) / (high - low)
            out.append(1.0 / ((1 - smooth) / factor + smooth))
    return np.asarray(out, np.float32)


def _fp16_bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.astype(np.float16)).view(np.uint8).reshape(*a.shape, 2)


RAW_CHUNK = 1 << 22  # 64-bit words a host thread draws at once


def rand_bytes(rng: np.random.Generator, n: int) -> np.ndarray:
    """n random bytes, a writable array: the bit generator's raw 64-bit
    words, ~5x faster than Generator.bytes (the models' writes are GBs).
    Past RAW_CHUNK words they are drawn on the host's threads (numpy's bit
    generators release the GIL), each from a copy of the generator
    advanced to its chunk, so the bytes and the generator's state after
    are those of one sequential draw."""
    words = -(-n // 8)
    bg = rng.bit_generator
    if words <= RAW_CHUNK:
        return bg.random_raw(words).view(np.uint8)[:n]
    out = np.empty(words, np.uint64)
    state = bg.state
    starts = range(0, words, RAW_CHUNK)

    def chunk(start: int) -> None:
        g = type(bg)()
        g.state = state
        g.advance(start)
        out[start:start + RAW_CHUNK] = g.random_raw(min(RAW_CHUNK, words - start))

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(chunk, starts))
    bg.advance(words)
    # advance() drops a buffered 32-bit half, which random_raw leaves alone
    bg.state = {**bg.state, "has_uint32": state["has_uint32"], "uinteger": state["uinteger"]}
    return out.view(np.uint8)[:n]


def q4k_blocks(rng: np.random.Generator, n_blocks: int) -> np.ndarray:
    """Random Q4_K blocks (ggml block_q4_K: fp16 d, fp16 dmin, 12 bytes of
    6-bit scales and mins, 128 bytes of nibbles) whose dequantized values
    d*sc*q - dmin*m have mean near 0 and std near 0.02: sc = m in [24, 40],
    dmin = 7.5 d, so each 32-value sub-block is d*sc*(q - 7.5)."""
    b = rand_bytes(rng, n_blocks * 144).reshape(n_blocks, 144)
    d = (1.4e-4 * rng.uniform(0.8, 1.2, n_blocks)).astype(np.float32)
    b[:, 0:4] = np.concatenate([_fp16_bytes(d), _fp16_bytes(7.5 * d)], axis=1)
    b[:, 4:16] = k4_scale_bytes(rng.integers(24, 41, (n_blocks, 8), dtype=np.uint8))
    return b


def k4_scale_bytes(sc: np.ndarray) -> np.ndarray:
    """The 12 bytes of ggml's get_scale_min_k4 packing of 6-bit scales and
    mins, both sc (n_blocks, 8), built apart and written to the blocks at
    once (strided column writes into the block rows cost more)."""
    lo = sc[:, :4] | ((sc[:, 4:] >> 4) << 6)
    return np.concatenate([lo, lo, (sc[:, 4:] & 0xF) * np.uint8(0x11)], axis=1)


def q6k_blocks(rng: np.random.Generator, n_blocks: int) -> np.ndarray:
    """Random Q6_K blocks (ql[128], qh[64], int8 scales[16], fp16 d):
    value d*sc*(q - 32), q uniform in 0..63, sc in [4, 12], so the std is
    near 0.02."""
    b = rand_bytes(rng, n_blocks * 210).reshape(n_blocks, 210)
    b[:, 192:208] = rng.integers(4, 13, (n_blocks, 16), dtype=np.uint8)
    d = (1.35e-4 * rng.uniform(0.8, 1.2, n_blocks)).astype(np.float32)
    b[:, 208:210] = _fp16_bytes(d)
    return b


def q8_0_blocks(rng: np.random.Generator, n_blocks: int) -> np.ndarray:
    """Random Q8_0 blocks (fp16 d, 32 int8 quants): value d*q, q uniform
    in -128..127, d near 2.7e-4, so the std is near 0.02."""
    b = rand_bytes(rng, n_blocks * 34).reshape(n_blocks, 34)
    b[:, 0:2] = _fp16_bytes((2.7e-4 * rng.uniform(0.8, 1.2, n_blocks)).astype(np.float32))
    return b


def quant_blocks(rng: np.random.Generator, qtype, n_blocks: int) -> np.ndarray:
    """Random blocks of any type the layouts write, values of std near 0.02
    and finite fp16 scales: random quants (and 6-bit or nibble scales),
    fp16 d (and min) set for that std."""
    from tpullama_torch.gguf import GGML_TYPE_TRAITS, GGMLType

    if qtype in (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0):
        return {GGMLType.Q4_K: q4k_blocks, GGMLType.Q6_K: q6k_blocks,
                GGMLType.Q8_0: q8_0_blocks}[qtype](rng, n_blocks)
    ts = GGML_TYPE_TRAITS[qtype].type_size
    b = rand_bytes(rng, n_blocks * ts).reshape(n_blocks, ts)
    u = rng.uniform(0.8, 1.2, n_blocks).astype(np.float32)
    if qtype == GGMLType.Q4_0:  # d (q - 8)
        b[:, 0:2] = _fp16_bytes(4.3e-3 * u)
    elif qtype == GGMLType.Q5_0:  # d (q - 16)
        b[:, 0:2] = _fp16_bytes(2.2e-3 * u)
    elif qtype == GGMLType.Q5_1:  # d q + m, m = -15.5 d
        b[:, 0:2] = _fp16_bytes(2.2e-3 * u)
        b[:, 2:4] = _fp16_bytes(-15.5 * 2.2e-3 * u)
    elif qtype == GGMLType.Q5_K:  # d sc q - dmin m, m = sc in [24, 40], dmin = 15.5 d
        b[:, 0:4] = np.concatenate([_fp16_bytes(6.8e-5 * u), _fp16_bytes(15.5 * 6.8e-5 * u)],
                                   axis=1)
        b[:, 4:16] = k4_scale_bytes(rng.integers(24, 41, (n_blocks, 8), dtype=np.uint8))
    elif qtype == GGMLType.Q3_K:  # d (sc - 32) (q - 4), random 6-bit sc
        b[:, 108:110] = _fp16_bytes(4.7e-4 * u)
    elif qtype == GGMLType.Q2_K:  # d s q - dmin m, m = s in [8, 15], dmin = 1.5 d
        s_ = rng.integers(8, 16, (n_blocks, 16), dtype=np.uint8)
        b[:, 0:16] = s_ | (s_ << 4)
        b[:, 80:82] = _fp16_bytes(1.55e-3 * u)
        b[:, 82:84] = _fp16_bytes(1.5 * 1.55e-3 * u)
    elif qtype == GGMLType.IQ4_XS:  # d (ls - 32) kvalues_iq4nl[q]
        b[:, 0:2] = _fp16_bytes(1.55e-5 * u)
    elif qtype == GGMLType.MXFP4:  # 2^(e - 128) kvalues_mxfp4[q]: e in 119..121, rms ~5.9
        b[:, 0] = rng.integers(119, 122, n_blocks, dtype=np.uint8)
    else:
        raise ValueError(f"quant_blocks: {qtype.name}")
    return b


def spm_byte_vocab(n_vocab: int):
    """The byte-level SPM vocab (<unk>, <s>, </s>, 256 byte tokens, the
    escaped space) padded with filler pieces to n_vocab tokens."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)] + ["▁"]
    types = [2, 3, 3] + [6] * 256 + [1]
    scores = [-1e9, -1e9, -1e9] + [-1e6] * 256 + [-1000.0]
    n_fill = n_vocab - len(tokens)
    tokens += [f"fill{i}" for i in range(n_fill)]
    types += [1] * n_fill
    scores += [-float(i + 1) for i in range(n_fill)]
    return tokens, np.asarray(scores, np.float32), np.asarray(types, np.int32)


def write_llama_gguf(path: str, w: Widths, seed: int) -> None:
    """A llama-family GGUF at widths `w`: every layer matrix (expert
    stacks and the shared expert included) and token_embd Q4_K, output
    Q6_K, norms, biases, the routers and the per-head q/k norms F32 (as
    llama.cpp's quantizer leaves them), random block bytes from `seed` (no
    output with `w.tied`; rope_freqs F32 with `w.llama3_rope`). chatglm's
    ffn_down rows hold n_ff = 13696 values, not a multiple of Q4_K's 256,
    so they are Q8_0, as llama.cpp's quantizer falls back for such rows;
    with `w.q8` every matrix is; with `w.quant` each tensor takes its
    LAYOUTS type. The MoE archs' keys are llama.cpp's converter's:
    expert_feed_forward_length (qwen), expert_shared_feed_forward_length,
    attention.key_length / value_length, granite's scales. glm4moe
    writes llama.cpp's GLM-4.5 layout: q/k/v biases, post_attention_norm
    as the FFN norm, `dense_lead` dense SwiGLU layers, then MoE layers with
    the router, exp_probs_b.bias and one shared expert of `n_ff_shexp`,
    and `nextn` NextN layers past `n_layer` (an MoE layer plus
    nextn.eh_proj and its norms); matrices whose rows are no multiple of
    256 (the dense lead's ffn_down, K = 10944, and the down experts and
    shared down, K = 1408) are Q8_0. gpt-oss writes llama.cpp's layout:
    q/k/v/o biases, attn_sinks, post_attention_norm as the FFN norm, the
    router with its bias, the expert stacks with their biases (all F32 but
    the matrices), the sliding window and the YaRN keys. gemma3 writes
    llama.cpp's layout: per-head q/k norms, post_attention_norm and
    post_ffw_norm beside the FFN norm, linear rope scaling; cohere2 its
    LayerNorm weights and epsilon, no FFN norm (the FFN reads the attention
    norm's output) and logit_scale; qwen3 its per-head q/k norms; llama4
    its interleave step of 1 (every layer MoE, the router F32, the experts
    Q4_K) with an ungated shared expert, and no q/k norm tensors (its
    q/k norm is weightless); phi2, starcoder and bloom their LayerNorm
    weights and biases, the biased fused attn_qkv and attn_output, ffn_up
    and ffn_down with biases and no gate, phi2 no FFN norm and output.bias,
    starcoder the F16 position_embd, bloom token_embd_norm with its bias,
    starcoder and bloom no rope keys; olmo2 its full-width q/k norms and
    the post norms, and no pre-norm tensors (a post-norm block)."""
    from tpullama_torch.gguf import GGML_TYPE_TRAITS, GGMLType, GGUFWriter

    rng = np.random.default_rng(seed)
    g = GGUFWriter()
    a = w.arch
    g.add_str("general.architecture", a)
    g.add_str("general.name", "synthetic-chatglm3-6b-shape" if a == "chatglm" else
              "synthetic-qwen2-1.5b-shape" if a == "qwen2" else
              "synthetic-qwen3-30b-a3b-shape" if a == "qwen3moe" else
              "synthetic-qwen2-57b-a14b-shape" if a == "qwen2moe" else
              "synthetic-granite-3.0-3b-a800m-shape" if a == "granitemoe" else
              "synthetic-glm-4.5-air-shape" if a == "glm4moe" else
              "synthetic-gpt-oss-20b-shape" if a == "gpt-oss" else
              "synthetic-gemma-3-12b-shape" if a == "gemma3" else
              "synthetic-c4ai-command-r7b-shape" if a == "cohere2" else
              "synthetic-qwen3-8b-shape" if a == "qwen3" else
              "synthetic-llama-4-scout-17b-16e-shape" if a == "llama4" else
              "synthetic-phi-2-shape" if a == "phi2" else
              "synthetic-starcoder-shape" if a == "starcoder" else
              "synthetic-bloom-7b1-shape" if a == "bloom" else
              "synthetic-olmo-2-1124-7b-shape" if a == "olmo2" else
              "synthetic-openllama-3b-shape" if w.q8 else
              "synthetic-llama3.2-1b-shape" if w.tied else
              "synthetic-mixtral-8x7b-shape" if w.n_expert else "synthetic-llama3-8b-shape")
    g.add_u32(f"{a}.context_length", w.n_ctx_train)
    g.add_u32(f"{a}.embedding_length", w.n_embd)
    g.add_u32(f"{a}.block_count", w.n_layer + w.nextn)
    g.add_u32(f"{a}.feed_forward_length", w.n_ff)
    g.add_u32(f"{a}.attention.head_count", w.n_head)
    g.add_u32(f"{a}.attention.head_count_kv", w.n_head_kv)
    rope = a not in ("starcoder", "bloom")  # learned positions or ALiBi: no rope keys
    if rope:
        g.add_u32(f"{a}.rope.dimension_count", w.n_rot or w.hd)
    if w.head_dim:
        g.add_u32(f"{a}.attention.key_length", w.head_dim)
        g.add_u32(f"{a}.attention.value_length", w.head_dim)
    # the non-gated archs: LayerNorm blocks with biases, up (+bias) -> GELU
    # -> down (+bias), the fused biased [Q|K|V]
    nongated = a in ("phi2", "starcoder", "bloom")
    layer_norm = a in ("command-r", "cohere2") or nongated
    g.add_f32(f"{a}.attention.layer_norm_{'' if layer_norm else 'rms_'}epsilon", w.rms_eps)
    if rope:
        g.add_f32(f"{a}.rope.freq_base", w.rope_theta)
    g.add_u32(f"{a}.vocab_size", w.n_vocab)
    if w.n_expert:
        g.add_u32(f"{a}.expert_count", w.n_expert)
        g.add_u32(f"{a}.expert_used_count", w.n_expert_used)
    if a in ("qwen2moe", "qwen3moe", "gpt-oss", "llama4"):
        g.add_u32(f"{a}.expert_feed_forward_length", w.n_ff)
    if a == "llama4":
        g.add_u32(f"{a}.interleave_moe_layer_step", 1)
    if w.n_swa:
        g.add_u32(f"{a}.attention.sliding_window", w.n_swa)
    if w.rope_linear:
        g.add_str(f"{a}.rope.scaling.type", "linear")
        g.add_f32(f"{a}.rope.scaling.factor", w.rope_linear)
    if w.logit_scale:
        g.add_f32(f"{a}.logit_scale", w.logit_scale)
    if w.yarn:
        g.add_str(f"{a}.rope.scaling.type", "yarn")
        g.add_f32(f"{a}.rope.scaling.factor", w.yarn[0])
        g.add_u32(f"{a}.rope.scaling.original_context_length", w.yarn[1])
    if a == "glm4moe":
        g.add_u32(f"{a}.leading_dense_block_count", w.dense_lead)
        g.add_u32(f"{a}.expert_feed_forward_length", w.n_ff_exp)
        g.add_u32(f"{a}.expert_shared_count", 1)
        g.add_f32(f"{a}.expert_weights_scale", 1.0)
        g.add_bool(f"{a}.expert_weights_norm", True)
        g.add_u32(f"{a}.expert_gating_func", 2)
        g.add_u32(f"{a}.nextn_predict_layers", w.nextn)
    elif w.n_ff_shexp:
        g.add_u32(f"{a}.expert_shared_feed_forward_length", w.n_ff_shexp)
    if w.scales:
        for key, v in zip(("embedding_scale", "residual_scale", "logit_scale",
                           "attention.scale"), w.scales):
            g.add_f32(f"{a}.{key}", v)
    tokens, scores, types = spm_byte_vocab(w.n_vocab)
    g.add_str("tokenizer.ggml.model", "llama")
    g.add_array("tokenizer.ggml.tokens", tokens)
    g.add_array("tokenizer.ggml.scores", scores)
    g.add_array("tokenizer.ggml.token_type", types)
    g.add_u32("tokenizer.ggml.bos_token_id", 1)
    g.add_u32("tokenizer.ggml.eos_token_id", 2)
    g.add_u32("tokenizer.ggml.unknown_token_id", 0)
    g.add_bool("tokenizer.ggml.add_bos_token", True)
    g.add_bool("tokenizer.ggml.add_eos_token", False)

    def quant(name, shape, qtype):
        if w.q8:
            qtype = GGMLType.Q8_0
        if w.quant:
            role = name.removesuffix(".weight").split(".")[-1]
            il = int(name.split(".")[1]) if name.startswith("blk.") else 0
            qtype = GGMLType[LAYOUTS[w.quant](role, il, w.n_layer)]
        bs = GGML_TYPE_TRAITS[qtype].block_size
        g.add_tensor(name, shape, qtype, raw=quant_blocks(rng, qtype, math.prod(shape) // bs))

    def norm(name, n):
        g.add_tensor(name, (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32),
                     GGMLType.F32)

    def bias(name, *shape):
        g.add_tensor(name, (0.1 * rng.standard_normal(shape)).astype(np.float32), GGMLType.F32)

    E, F, kv, hq = w.n_embd, w.n_ff, w.hd * w.n_head_kv, w.hd * w.n_head
    Q4 = GGMLType.Q4_K
    quant("token_embd.weight", (w.n_vocab, E), GGMLType[w.embd_type])
    norm("output_norm.weight", E)
    if nongated:
        bias("output_norm.bias", E)
    if a == "bloom":
        norm("token_embd_norm.weight", E)
        bias("token_embd_norm.bias", E)
    if not w.tied:
        quant("output.weight", (w.n_vocab, E), GGMLType.Q6_K)
    if a == "phi2":
        bias("output.bias", w.n_vocab)
    if a == "starcoder":
        # llama.cpp's quantizer leaves the position table as converted (F16)
        g.add_tensor("position_embd.weight",
                     (0.02 * rng.standard_normal((w.n_ctx_train, E))).astype(np.float32),
                     GGMLType.F16)
    if w.llama3_rope:
        g.add_tensor("rope_freqs.weight", llama3_rope_freqs(w), GGMLType.F32)
    # the router's logits have std ~1.3 on unit-scale inputs: varied routing
    n_x = w.n_expert
    def q4_or_q8(n_in):
        # rows of whole Q4_K blocks, else Q8_0
        return Q4 if n_in % 256 == 0 else GGMLType.Q8_0

    for il in range(w.n_layer + w.nextn):
        p = f"blk.{il}."
        if a != "olmo2":
            norm(p + "attn_norm.weight", E)
        if nongated:
            bias(p + "attn_norm.bias", E)
            quant(p + "attn_qkv.weight", (hq + 2 * kv, E), Q4)
            bias(p + "attn_qkv.bias", hq + 2 * kv)
        elif a == "chatglm":
            quant(p + "attn_qkv.weight", (E + 2 * kv, E), Q4)
            g.add_tensor(p + "attn_qkv.bias",
                         (0.1 * rng.standard_normal(E + 2 * kv)).astype(np.float32),
                         GGMLType.F32)
        else:
            quant(p + "attn_q.weight", (hq, E), Q4)
            quant(p + "attn_k.weight", (kv, E), Q4)
            quant(p + "attn_v.weight", (kv, E), Q4)
            if a in ("qwen2", "qwen2moe", "glm4moe", "gpt-oss"):
                for nm, n in (("attn_q", hq), ("attn_k", kv), ("attn_v", kv)):
                    bias(p + nm + ".bias", n)
            if a in ("qwen3", "qwen3moe", "gemma3"):
                norm(p + "attn_q_norm.weight", w.hd)
                norm(p + "attn_k_norm.weight", w.hd)
            if a == "olmo2":
                # the q/k RMS norms over the full projection width
                norm(p + "attn_q_norm.weight", hq)
                norm(p + "attn_k_norm.weight", kv)
        quant(p + "attn_output.weight", (E, hq), Q4)
        if nongated:
            bias(p + "attn_output.bias", E)
        if a == "gpt-oss":
            bias(p + "attn_output.bias", E)
            bias(p + "attn_sinks.weight", w.n_head)
        if a in ("gemma3", "olmo2"):
            norm(p + "post_attention_norm.weight", E)
            norm(p + "post_ffw_norm.weight", E)
        if a not in ("cohere2", "phi2", "olmo2"):
            norm(p + ("post_attention_norm.weight" if a in ("glm4moe", "gpt-oss")
                      else "ffn_norm.weight"), E)
        if a in ("starcoder", "bloom"):
            bias(p + "ffn_norm.bias", E)
        if nongated:
            quant(p + "ffn_up.weight", (F, E), Q4)
            bias(p + "ffn_up.bias", F)
            quant(p + "ffn_down.weight", (E, F), q4_or_q8(F))
            bias(p + "ffn_down.bias", E)
        elif a == "chatglm":
            quant(p + "ffn_up.weight", (2 * F, E), Q4)
            quant(p + "ffn_down.weight", (E, F), GGMLType.Q8_0)
        elif n_x and il >= w.dense_lead:
            Fx = w.n_ff_exp or F
            g.add_tensor(p + "ffn_gate_inp.weight",
                         (0.02 * rng.standard_normal((n_x, E))).astype(np.float32),
                         GGMLType.F32)
            if a == "glm4moe":
                g.add_tensor(p + "exp_probs_b.bias",
                             (0.1 * rng.standard_normal(n_x)).astype(np.float32), GGMLType.F32)
            quant(p + "ffn_gate_exps.weight", (n_x, Fx, E), Q4)
            quant(p + "ffn_up_exps.weight", (n_x, Fx, E), Q4)
            quant(p + "ffn_down_exps.weight", (n_x, E, Fx), q4_or_q8(Fx))
            if a == "gpt-oss":
                bias(p + "ffn_gate_inp.bias", n_x)
                for nm, n in (("gate", Fx), ("up", Fx), ("down", E)):
                    bias(p + f"ffn_{nm}_exps.bias", n_x, n)
            if w.n_ff_shexp:
                Fs = w.n_ff_shexp
                if a not in ("glm4moe", "llama4"):  # qwen2moe's sigmoid gate of the shared expert
                    g.add_tensor(p + "ffn_gate_inp_shexp.weight",
                                 (0.02 * rng.standard_normal((1, E))).astype(np.float32),
                                 GGMLType.F32)
                quant(p + "ffn_gate_shexp.weight", (Fs, E), Q4)
                quant(p + "ffn_up_shexp.weight", (Fs, E), Q4)
                quant(p + "ffn_down_shexp.weight", (E, Fs), q4_or_q8(Fs))
        else:
            quant(p + "ffn_gate.weight", (F, E), Q4)
            quant(p + "ffn_up.weight", (F, E), Q4)
            quant(p + "ffn_down.weight", (E, F), q4_or_q8(F))
        if il >= w.n_layer:  # a NextN layer's multi-token-prediction head
            quant(p + "nextn.eh_proj.weight", (E, 2 * E), Q4)
            for nm in ("enorm", "hnorm", "shared_head_norm"):
                norm(p + f"nextn.{nm}.weight", E)
    g.write(path)



# ---------------------------------------------------------------- timing


class Timer:
    """Device time of a call with cold L2: before each timed launch a
    512 MiB buffer is written, which also keeps the card busy while the
    host enqueues the call, so the events bracket device work only."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
        # host wall seconds by part of the phase: "kernel" and "library"
        # timings (ms's `part`) and the plain versions' calls (once)
        self.split: dict = {}

    @contextlib.contextmanager
    def wall(self, part: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.split[part] = self.split.get(part, 0.0) + time.perf_counter() - t0

    def flush_l2(self) -> None:
        self.flush.zero_()

    def once(self, fn):
        """One call of fn after the flush, between CUDA events: (its
        result, ms). A plain version runs once, for the comparison, and
        that run's time is its `plain_ms`: the plain version is what the
        kernel is checked against, not a yardstick of its speed."""
        torch = self.torch
        with self.wall("plain"):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.flush_l2()
            s.record()
            out = fn()
            e.record()
            torch.cuda.synchronize()
        return out, s.elapsed_time(e)

    def ms(self, fn, iters: int, part: str = "kernel") -> float:
        torch = self.torch
        with self.wall(part):
            fn()
            fn()
            torch.cuda.synchronize()
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
            for s, e in ev:
                self.flush_l2()
                s.record()
                fn()
                e.record()
            torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters


def bound_ms(n_bytes: float, flops: float, kind: str) -> tuple[float, str]:
    """Least time for the work on an H100: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(t) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------- kernels


def random_planes(ggml_type, N: int, K: int, scale_dtype, gen, device, ar: bool = False) -> dict:
    """Random planar fields of one packed matrix, made on the card:
    uniform stripe bytes and per-group scales so values have std ~0.02.
    MXFP4: the LUT planes {q4_lut, scale}, or with `ar` the A/r planes
    {q4a, q1r, scale}, scales powers of two (E8M0's)."""
    import torch

    from tpullama_torch.gguf import GGMLType

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=device)

    def scales(G, base):
        return base * (0.8 + 0.4 * torch.rand((N, G), generator=gen, device=device))

    if ggml_type == GGMLType.MXFP4:
        # LUT values have rms ~5.9, random A/r ones (2 (a - 8) + r) ~9.2
        e = torch.randint(-1, 2, (N, K // 32), generator=gen, device=device).float()
        s = (torch.exp2(e) * (2.0 ** -9 if ar else 2.0 ** -8)).to(scale_dtype)
        if ar:
            return {"q4a": u8(N, K // 2), "q1r": u8(N, K // 8), "scale": s}
        return {"q4_lut": u8(N, K // 2), "scale": s}

    if ggml_type == GGMLType.Q6_K:
        s = scales(K // 16, 1.1e-3)
        return {"q4": u8(N, K // 2), "q2": u8(N, K // 4), "scale": s.to(scale_dtype),
                "minv": (32.0 * s).to(scale_dtype)}
    if ggml_type == GGMLType.Q8_0:
        return {"q8": u8(N, K), "scale": scales(K // 32, 2.7e-4).to(scale_dtype)}
    if ggml_type in (GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K):
        # values 0..31 (std ~9.2) about 15.5
        s = scales(K // 32, 2.2e-3)
        return {"q4": u8(N, K // 2), "q1": u8(N, K // 8), "scale": s.to(scale_dtype),
                "minv": (15.5 * s).to(scale_dtype)}
    if ggml_type == GGMLType.Q3_K:
        # values 0..7 about 4 (repack's minv = 4 * scale)
        s = scales(K // 16, 8.7e-3)
        return {"q2": u8(N, K // 4), "q1": u8(N, K // 8), "scale": s.to(scale_dtype),
                "minv": (4.0 * s).to(scale_dtype)}
    if ggml_type == GGMLType.Q2_K:
        s = scales(K // 16, 1.8e-2)
        return {"q2": u8(N, K // 4), "scale": s.to(scale_dtype),
                "minv": (1.5 * s).to(scale_dtype)}
    s = scales(K // 32, 4.4e-3)
    return {"q4": u8(N, K // 2), "scale": s.to(scale_dtype),
            "minv": (7.5 * s).to(scale_dtype)}


def qmm_cases(timer, gen, device, out: list) -> None:
    import torch

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm

    Q4, Q6, Q8 = GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0
    Q5K, Q5_0, Q5_1, Q3, Q2 = (GGMLType.Q5_K, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q3_K,
                               GGMLType.Q2_K)
    bf16, f32 = torch.bfloat16, torch.float32
    # (type, N, K, activation dtype, scale dtype, T values): the serving
    # path's shapes in bf16 (T = 1 for Context.decode, 4 for the server's
    # B = 4 decode step, 256 for one prompt chunk, 1024 for the server's
    # packed 4 x 256 prefill chunk; T = 8, the decode body's widest x, at
    # the FFN's shapes), then the f32 and Q8_0 variants the kernel covers
    served = (1, 4, 256, 1024)
    cases = [(Q4, 4096, 4096, bf16, bf16, served),
             (Q4, 1024, 4096, bf16, bf16, served),
             (Q4, 14336, 4096, bf16, bf16, (1, 4, 8, 256, 1024)),
             (Q4, 4096, 14336, bf16, bf16, (1, 4, 8, 256, 1024)),
             (Q6, 128256, 4096, bf16, bf16, served),
             (Q4, 4096, 4096, f32, f32, (1, 256)),
             (Q6, 4096, 4096, f32, f32, (1, 256)),
             (Q8, 4096, 4096, f32, bf16, (1, 256)),
             # widths the kernels refused before (K % 512 for Q4, % 1024
             # for Q8_0): Qwen2-1.5B's ffn_down, Qwen2-7B's hidden at
             # Q8_0, and 768 / 512
             (Q4, 1536, 8960, bf16, bf16, (1, 256)),
             (Q4, 1024, 768, bf16, bf16, (1, 256)),
             (Q6, 1024, 768, bf16, bf16, (1, 256)),
             (Q8, 3584, 3584, bf16, bf16, (1, 256)),
             (Q8, 1024, 512, f32, bf16, (1, 256)),
             # gpt-oss-20b's attn_output (K = 64 x 64 = 4096 onto a 2880
             # hidden; the only packed layer matrix there): the decode step
             # and the packed prefill chunk of 4 lanes, Context.decode's
             (Q8, 2880, 4096, bf16, bf16, (1, 4, 256, 1024)),
             # gemma-3-12b's [gate] and down (K = 3840 = 15 x 256 and
             # 15360): the B = 4 decode step and the packed prefill chunk
             (Q4, 15360, 3840, bf16, bf16, (4, 1024)),
             (Q4, 3840, 15360, bf16, bf16, (4, 1024)),
             # Qwen3-8B's [gate] and down (12288 = 48 x 256) and its Q6_K
             # lm_head (151936 rows): the B = 4 decode step and the chunk
             (Q4, 12288, 4096, bf16, bf16, (4, 1024)),
             (Q4, 4096, 12288, bf16, bf16, (4, 1024)),
             (Q6, 151936, 4096, bf16, bf16, (4,)),
             # Llama-4-Scout's attn_q / attn_output (5120 x 5120), its
             # shared expert's [gate] (8192 x 5120) and down (5120 x 8192)
             # and its Q6_K lm_head (202048 rows): the B = 4 decode step and
             # the packed chunk
             (Q4, 5120, 5120, bf16, bf16, (4, 1024)),
             (Q4, 8192, 5120, bf16, bf16, (4, 1024)),
             (Q4, 5120, 8192, bf16, bf16, (4, 1024)),
             (Q6, 202048, 5120, bf16, bf16, (4,)),
             # phi-2's attn_qkv (7680 x 2560), ffn_up (10240 x 2560),
             # ffn_down (2560 x 10240) and its Q6_K lm_head (51200 rows): the
             # B = 4 decode step and the packed chunk
             (Q4, 7680, 2560, bf16, bf16, (4, 1024)),
             (Q4, 10240, 2560, bf16, bf16, (4, 1024)),
             (Q4, 2560, 10240, bf16, bf16, (4, 1024)),
             (Q6, 51200, 2560, bf16, bf16, (4,)),
             # OLMo-2-1124-7B's [gate] (11008 x 4096) and down (4096 x
             # 11008, K = 43 x 256): the B = 4 decode step and the chunk
             (Q4, 11008, 4096, bf16, bf16, (4, 1024)),
             (Q4, 4096, 11008, bf16, bf16, (4, 1024))]
    # the q1 / q2 sets (csrc/qmm_lowbit.cu) at the Llama FFN's shapes, the
    # decode step's T = 4 and the packed prefill chunk's T = 1024, then one
    # f32-x and one f32-scale case
    cases += [(qt, N, K, bf16, bf16, (4, 1024)) for qt in (Q5K, Q5_0, Q5_1, Q3, Q2)
              for N, K in ((14336, 4096), (4096, 14336))]
    cases += [(Q5K, 4096, 4096, f32, bf16, (1, 256)), (Q3, 4096, 4096, bf16, f32, (1, 256))]
    # MXFP4's LUT and A/r planes (csrc/qmm_mxfp4.cu) at the FFN's shape
    MX = GGMLType.MXFP4
    cases += [(MX, 14336, 4096, bf16, bf16, (4, 1024), ar) for ar in (False, True)]
    group = {Q4: 32, Q6: 16, Q8: 32, Q5K: 32, Q5_0: 32, Q5_1: 32, Q3: 16, Q2: 16, MX: 32}
    for qt, N, K, xdt, sdt, Ts, *ar in cases:
        ar = bool(ar and ar[0])
        fields = random_planes(qt, N, K, sdt, gen, device, ar=ar)
        g = group[qt]
        w_lib = None
        for T in Ts:
            x = torch.randn((T, K), generator=gen, device=device).to(xdt)
            got = qmm.quantized_matmul(x, fields, qt, g, N, K)
            want, plain_ms = timer.once(lambda: qmm.quantized_matmul_plain(x, fields, qt, g,
                                                                            N, K))
            err = float((got - want).abs().max())
            # f32 sums in another order: 1e-4 of the output's scale is far
            # above that and far below any layout or decode fault
            tol = 1e-4 * float(want.abs().max()) + 1e-5
            check(bool(torch.isfinite(got).all()) and err <= tol,
                  f"qmm {qt.name} N={N} K={K} T={T}: err {err} > tol {tol}")
            ms = timer.ms(lambda: qmm.quantized_matmul(x, fields, qt, g, N, K), 20)
            if w_lib is None:
                # the yardstick: a cuBLAS product with the weight dequantized
                # to the activation type ahead of time, in natural order
                w = qmm.dequant_stored(fields, qt, g)
                w_lib = w.reshape(N, g, K // g).transpose(1, 2).reshape(N, K)
                del w
            wl = w_lib.to(xdt)
            lib_ms = timer.ms(lambda: torch.matmul(x, wl.T), 20, "library")
            del wl
            n_bytes = sum(nbytes(a) for a in fields.values()) + nbytes(x) + T * N * 4
            b_ms, b_by = bound_ms(n_bytes, 2.0 * T * N * K, "bf16" if xdt == bf16 else "f32")
            name = "qmm_gemv" if T <= qmm.GEMV_MAX_T else "qmm_tiled"
            rec = {"phase": "kernels", "kernel": name, "route": qmm.route(name, T),
                   "type": type_label(qt, ar), "N": N, "K": K,
                   "T": T, "x": str(xdt).split(".")[-1], "scales": str(sdt).split(".")[-1],
                   "max_abs_err": err, "tol": tol,
                   "max_rel_err": err / max(float(want.abs().max()), 1e-30),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            if (qt, N, K) == (Q8, 2880, 4096):
                rec["case"] = f"gptoss attn_output T={T}"
            elif (qt, K) in ((Q4, 3840), (Q4, 15360)):
                rec["case"] = f"gemma3 {'ffn_gate' if K == 3840 else 'ffn_down'} T={T}"
            elif (N, K) in ((12288, 4096), (4096, 12288), (151936, 4096)):
                role = {12288: "ffn_gate", 4096: "ffn_down", 151936: "output"}[N]
                rec["case"] = f"qwen3 {role} T={T}"
            elif (N, K) in ((5120, 5120), (8192, 5120), (5120, 8192), (202048, 5120)):
                role = {(5120, 5120): "attn_q", (8192, 5120): "ffn_gate_shexp",
                        (5120, 8192): "ffn_down_shexp", (202048, 5120): "output"}[N, K]
                rec["case"] = f"llama4 {role} T={T}"
            elif (N, K) in ((7680, 2560), (10240, 2560), (2560, 10240), (51200, 2560)):
                role = {7680: "attn_qkv", 10240: "ffn_up", 2560: "ffn_down", 51200: "output"}[N]
                rec["case"] = f"phi2 {role} T={T}"
            elif (N, K) in ((11008, 4096), (4096, 11008)):
                rec["case"] = f"olmo2 {'ffn_gate' if N == 11008 else 'ffn_down'} T={T}"
            emit(rec)
            out.append(rec)
        del w_lib, fields
        torch.cuda.empty_cache()


def type_label(ggml_type, ar: bool = False) -> str:
    """A kernels-phase record's type: the GGML type, MXFP4's A/r planes as
    MXFP4_AR."""
    return "MXFP4_AR" if ar else ggml_type.name


def natural_bf16(fields, ggml_type, N: int, K: int, g: int, order: str = "stripe"):
    """The library's weight: a packed matrix dequantized to bf16 in natural
    element order, for a cuBLAS product."""
    import torch

    from tpullama_torch.ops.cuda import qmm

    w = qmm.dequant_stored(fields, ggml_type, g)
    nat = torch.empty_like(w)
    # stored column p holds natural element idx[p]
    idx = qmm.permute_x(torch.arange(K, device=w.device, dtype=torch.float32)[None], g,
                        order)[0].long()
    nat[:, idx] = w
    del w
    return nat.to(torch.bfloat16)


def ktiled_cases(timer, gen, device, out: list) -> None:
    """qmm_ktiled at ChatGLM3-6B's attn_qkv (4608 x 4096, Q4_K, bf16) for
    the B = 1 decode step (T = 1) at nk = 2, 4, 8, at T = 4 (nk = 4) and the
    256-token prefill chunk at nk = 4, and at the Llama-3-8B widths 4096 x
    4096 and 14336 x 4096 (T = 1, nk = 4), each beside qmm_gemv on the same
    planes; then MXFP4's LUT planes at the attn_qkv shape (T = 1 and 256,
    nk = 4)."""
    import torch

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm

    Q4, bf16, K = GGMLType.Q4_K, torch.bfloat16, 4096
    cases = [(Q4, 4608, ((1, 2), (1, 4), (1, 8), (4, 4), (256, 4))), (Q4, 4096, ((1, 4),)),
             (Q4, 14336, ((1, 4),)), (GGMLType.MXFP4, 4608, ((1, 4), (256, 4)))]
    for qt, N, runs in cases:
        fields = random_planes(qt, N, K, bf16, gen, device)
        w_lib = natural_bf16(fields, qt, N, K, 32)
        gemv_done = False
        for T, nk in runs:
            x = torch.randn((T, K), generator=gen, device=device).to(bf16)
            todo = [("qmm_ktiled", nk)]
            if T == 1 and not gemv_done and qt == Q4:
                todo.append(("qmm_gemv", None))
                gemv_done = True
            for name, tile_k in todo:
                def kern():
                    return qmm.quantized_matmul(x, fields, qt, 32, N, K, tile_k=tile_k)

                def plain():
                    if tile_k is None:
                        return qmm.quantized_matmul_plain(x, fields, qt, 32, N, K)
                    return qmm.quantized_matmul_ktiled_plain(x, fields, qt, 32, N, K, tile_k)

                before = dict(qmm.LAUNCHES)
                got = kern()
                want, plain_ms = timer.once(plain)
                check(qmm.LAUNCHES[name] == before[name] + 1, f"{name} was not the route")
                err = float((got - want).abs().max())
                tol = 1e-4 * float(want.abs().max()) + 1e-5
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"{name} N={N} K={K} T={T} nk={tile_k}: err {err} > tol {tol}")
                ms = timer.ms(kern, 20)
                lib_ms = timer.ms(lambda: torch.matmul(x, w_lib.T), 20, "library")
                n_bytes = sum(nbytes(a) for a in fields.values()) + nbytes(x) + T * N * 4
                b_ms, b_by = bound_ms(n_bytes, 2.0 * T * N * K, "bf16")
                rec = {"phase": "kernels", "kernel": name, "route": qmm.route(name, T),
                       "type": qt.name, "N": N, "K": K, "T": T, "nk": tile_k, "x": "bfloat16",
                       "scales": "bfloat16", "max_abs_err": err,
                       "tol": tol, "max_rel_err": err / max(float(want.abs().max()), 1e-30),
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
                emit(rec)
                out.append(rec)
        del fields, w_lib
        torch.cuda.empty_cache()


def fused_cases(timer, gen, device, out: list) -> None:
    """fused_postattn at ChatGLM3-6B's shape (E = Dq = 4096, [gate|up] 2 x
    13696 rows, Q4_K fourblock planes with bf16 scales, bf16 activations)
    and at two widths fused_ok admits that the wrapper once refused (E =
    16384: x staged in two slices; Dq = 4224 = 33 x 128), each against its
    plain version; beside it the port's own unfused chain (qmm_gemv
    o-projection, residual, rms_norm, qmm_gemv [gate|up], silu * up) and
    that chain on pre-dequantized bf16 weights through torch.matmul (the
    library time)."""
    for E, Dq, Fd in ((4096, 4096, 13696), (16384, 4096, 13696), (4096, 4224, 13696)):
        fused_case(timer, gen, device, out, E, Dq, Fd)


def fused_case(timer, gen, device, out: list, E: int, Dq: int, Fd: int) -> None:
    import torch
    import torch.nn.functional as F

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import fused_layer, qmm
    from tpullama_torch.ops.norms import rms_norm

    Q4, bf16 = GGMLType.Q4_K, torch.bfloat16
    eps = 1e-5
    o = random_planes(Q4, E, Dq, bf16, gen, device)
    gu = random_planes(Q4, 2 * Fd, E, bf16, gen, device)
    att = torch.randn((1, Dq), generator=gen, device=device).to(bf16)
    x = torch.randn((1, E), generator=gen, device=device).to(bf16)
    w = (1.0 + 0.1 * torch.randn((E,), generator=gen, device=device)).to(bf16)

    def kern():
        return fused_layer.fused_postattn(att, x, o, w, gu, group=32, eps=eps)

    def plain():
        return fused_layer.fused_postattn_plain(att, x, o, w, gu, group=32, eps=eps)

    def unfused():
        r1 = x.float() + qmm.quantized_matmul(att, o, Q4, 32, E, Dq, order="fourblock")
        g = qmm.quantized_matmul(rms_norm(r1, w, eps), gu, Q4, 32, 2 * Fd, E, order="fourblock")
        return F.silu(g[:, :Fd]) * g[:, Fd:], r1

    wo = natural_bf16(o, Q4, E, Dq, 32, "fourblock")
    wgu = natural_bf16(gu, Q4, 2 * Fd, E, 32, "fourblock")

    def library():
        r1 = x.float() + torch.matmul(att, wo.T).float()
        g = torch.matmul(rms_norm(r1, w, eps).to(bf16), wgu.T).float()
        return F.silu(g[:, :Fd]) * g[:, Fd:], r1

    before = fused_layer.LAUNCHES["fused_postattn"]
    act, r1 = kern()
    (want_act, want_r1), plain_ms = timer.once(plain)
    check(fused_layer.LAUNCHES["fused_postattn"] == before + 1, "fused_postattn did not launch")
    errs, tols = [], []
    for got, want in ((act, want_act), (r1, want_r1)):
        errs.append(float((got - want).abs().max()))
        # f32 sums in another order (both sides dequantize bit-equal weights)
        tols.append(1e-4 * float(want.abs().max()) + 1e-5)
        check(bool(torch.isfinite(got).all()) and errs[-1] <= tols[-1],
              f"fused_postattn E={E} Dq={Dq}: err {errs[-1]} > tol {tols[-1]}")
    ms = timer.ms(kern, 20)
    unfused_ms = timer.ms(unfused, 20)
    lib_ms = timer.ms(library, 20, "library")
    n_bytes = (sum(nbytes(a) for a in o.values()) + sum(nbytes(a) for a in gu.values())
               + nbytes(att) + nbytes(x) + nbytes(w) + nbytes(act) + nbytes(r1))
    b_ms, b_by = bound_ms(n_bytes, 2.0 * (E * Dq + 2 * Fd * E), "bf16")
    rec = {"phase": "kernels", "kernel": "fused_postattn", "route": "gemv", "type": "Q4_K",
           "E": E, "Dq": Dq,
           "Fd": Fd, "x": "bfloat16", "scales": "bfloat16", "max_abs_err": max(errs),
           "max_abs_err_act_r1": errs, "tol_act_r1": tols, "ms": ms, "plain_ms": plain_ms,
           "unfused_ms": unfused_ms, "library_ms": lib_ms,
           "library": "the unfused chain on pre-dequantized bf16 weights (torch.matmul)",
           "bound_ms": b_ms, "bound_by": b_by, "plane_bytes": n_bytes}
    emit(rec)
    out.append(rec)
    del o, gu, wo, wgu
    torch.cuda.empty_cache()


def decode_sel(tokens: int, E: int, distinct: int, gen, device):
    """Top-2 (token, k) slots of `tokens` tokens over `distinct` (even) of
    E experts, each token's two distinct: token i picks experts pool[2i %
    distinct] and pool[(2i + 1) % distinct] of a random pool, so the slots
    come unsorted and an expert shared by several tokens recurs."""
    import torch

    pool = torch.randperm(E, generator=gen, device=device)[:distinct]
    return pool[torch.arange(2 * tokens, device=device) % distinct].to(torch.int32)


def gathered_cases(timer, gen, device, out: list) -> None:
    """Both gathered kernels against their plain versions over 8 experts,
    with the routing of the served MoE path: the B = 4 decode step (8
    (token, k) slots, one-row tiles) and the packed 4 x 256 prefill chunk
    (2048 slots, dispatched into 8-row tiles); [gate | up] and down also at
    512 slots (a 1 x 256 chunk), so each tensor-core route is timed at two
    slot counts. The [gate | up] and down decode steps also run at 8, 6 and
    2 distinct experts (decode_sel): both one-row kernels read each expert
    once per run of up to 4 tiles, so their bounds count the distinct
    experts' bytes; at 62 one-row slots (a 31-token chunk, the most below
    the dispatch) each expert is read about twice. The q1/q2 sets of the
    row-major kernel (csrc/qmm_gathered_lowbit.cu) at Mixtral's [gate | up]
    (8 one-row tiles over 8 experts, 2048 slots in 8-row tiles), and at
    Qwen3-30B-A3B's served shapes: [gate | up] 1536 x 2048 in Q2_K and down
    2048 x 768 in Q3_K over 128 experts, the B = 4 decode step's 32
    one-row tiles (8 experts a token). MXFP4's LUT and A/r planes
    (csrc/qmm_gathered_mxfp4.cu): row-major at Mixtral's [gate | up] (8
    one-row tiles over 8 experts, 2048 slots in 8-row tiles), transposed at
    Qwen3-30B-A3B's [gate | up] and down (32 one-row tiles, 2048 slots in
    8-row tiles over 128 experts) and at Mixtral's down (8 one-row tiles
    over 8 experts, 2048 slots)."""
    import torch
    import torch.nn.functional as F

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm, qmm_gathered
    from tpullama_torch.ops.moe import moe_dispatch

    Q4, Q6, Q8 = GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0
    Q5K, Q5_0, Q5_1, Q3, Q2 = (GGMLType.Q5_K, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q3_K,
                               GGMLType.Q2_K)
    bf16, f32 = torch.bfloat16, torch.float32
    served, small = ((8, 1), (2048, 8)), ((8, 1), (512, 8))
    # (transposed, type, n_out per expert, K, scale dtypes, (slots, tile_t)
    # routings[, experts, experts a token]): Mixtral's [gate | up]
    # (row-major) and down (transposed) stacks, then the other field sets
    # and padded rows (320 of 384), then the q1/q2 sets
    decode = ((8, 1, 8), (8, 1, 6), (8, 1, 2), (62, 1))
    cases = [(False, Q4, 2 * 14336, 4096, (bf16,), decode + ((512, 8), (2048, 8))),
             (True, Q4, 4096, 14336, (bf16,), ((8, 1),) + decode + ((512, 8), (2048, 8))),
             (False, Q6, 4096, 4096, (f32, bf16), small),
             (True, Q8, 4096, 4096, (f32, bf16), small),
             (False, Q4, 320, 4096, (f32, bf16), small),
             (True, Q4, 320, 4096, (f32, bf16), small),
             # K = 768 (24 scale columns): row-major, and the transposed
             # down stack of a 768-wide expert FFN at Mixtral's width
             (False, Q4, 1536, 768, (bf16,), small),
             (True, Q4, 4096, 768, (bf16,), small)]
    cases += [(False, qt, 2 * 14336, 4096, (bf16,), ((8, 1, 8), (2048, 8)))
              for qt in (Q5K, Q5_0, Q5_1, Q3, Q2)]
    cases += [(False, Q2, 2 * 768, 2048, (bf16,), ((32, 1),), 128, 8),
              (False, Q3, 2048, 768, (bf16,), ((32, 1),), 128, 8)]
    # Llama-4-Scout's experts (16 of FFN 8192, 1 a token): [gate | up]
    # transposed (K = 5120: 160 scale columns) and down row-major (K =
    # 8192: 256), the B = 4 decode step's 4 one-row tiles and the packed
    # 4 x 256 chunk's 1024 slots in 8-row tiles
    scout = ((4, 1), (1024, 8))
    cases += [(True, Q4, 2 * 8192, 5120, (bf16,), scout, 16, 1),
              (False, Q4, 5120, 8192, (bf16,), scout, 16, 1)]
    MX = GGMLType.MXFP4
    for ar in (False, True):
        cases += [(False, MX, 2 * 14336, 4096, (bf16,), ((8, 1, 8), (2048, 8)), 8, 2, ar),
                  (True, MX, 2 * 768, 2048, (bf16,), ((32, 1), (2048, 8)), 128, 8, ar),
                  (True, MX, 2048, 768, (bf16,), ((32, 1), (2048, 8)), 128, 8, ar),
                  (True, MX, 4096, 14336, (bf16,), ((8, 1, 8), (2048, 8)), 8, 2, ar)]
    group = {Q4: 32, Q6: 16, Q8: 32, Q5K: 32, Q5_0: 32, Q5_1: 32, Q3: 16, Q2: 16, MX: 32}
    for planes_t, qt, N, K, sdts, routings, *rest in cases:
        # experts, experts a token, MXFP4's A/r planes
        E, k_used, ar = (*rest, *(8, 2, False)[len(rest):])
        g = group[qt]
        R = -(-N // 128) * 128
        name = "qmm_gathered_t" if planes_t else "qmm_gathered"
        # the library's weights: every expert dequantized to bf16 in natural order
        rows = random_planes(qt, E * R, K, f32, gen, device, ar=ar)
        rows = {k: v.reshape(E, R, -1) for k, v in rows.items()}
        for v in rows.values():
            v[:, N:] = 0  # the loader zero-pads each expert's rows
        w_lib = torch.stack([
            qmm.dequant_stored({k: v[e] for k, v in rows.items()}, qt, g)[:N]
            .reshape(N, g, K // g).transpose(1, 2).reshape(N, K).to(bf16)
            for e in range(E)])
        for sdt in sdts:
            fields = {k: (v.to(sdt) if k in ("scale", "minv") else v) for k, v in rows.items()}
            if planes_t:  # (E, kcols, R); group rows padded to 16
                fields = {k: v.transpose(1, 2).contiguous() for k, v in fields.items()}
                fields = {k: (F.pad(v, (0, 0, 0, -v.shape[1] % 16))
                              if k in ("scale", "minv") else v) for k, v in fields.items()}
            per_expert = sum(nbytes(a) for a in fields.values()) / E
            for S, tt, *spread in routings:
                if spread:
                    sel = decode_sel(S // 2, E, spread[0], gen, device)
                else:  # top-k of E distinct experts per token
                    sel = torch.rand((S // k_used, E), generator=gen,
                                     device=device).argsort(-1)[:, :k_used]
                    sel = sel.reshape(S).to(torch.int32)
                x_slots = torch.randn((S, K), generator=gen, device=device)
                if tt == 1:
                    tiles, x = sel, x_slots
                else:
                    perm, tiles, _, _ = moe_dispatch(sel, E, tt)
                    x = torch.cat([x_slots, x_slots.new_zeros((1, K))])[perm]

                def kern():
                    return qmm_gathered.quantized_matmul_gathered(
                        x, fields, tiles, qt, g, N, K, tile_t=tt, planes_t=planes_t)

                def plain():
                    return qmm_gathered.quantized_matmul_gathered_plain(
                        x, fields, tiles, qt, g, N, K, tile_t=tt, planes_t=planes_t)

                got = kern()
                want, plain_ms = timer.once(plain)
                err = float((got - want).abs().max())
                tol = 1e-4 * float(want.abs().max()) + 1e-5
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"{name} {qt.name} N={N} K={K} slots={S}: err {err} > tol {tol}")
                if tt == 1:
                    # a tile's row does not depend on who else picked its expert
                    alone = qmm_gathered.quantized_matmul_gathered(
                        x[:1], fields, tiles[:1], qt, g, N, K, planes_t=planes_t)
                    check(torch.equal(alone[0], got[0]),
                          f"{name} {qt.name} N={N}: tile 0 alone differs from its run")
                ms = timer.ms(kern, 20)
                xb = x_slots.to(bf16)
                if tt == 1 and S <= 32:
                    lib = "torch.bmm on the gathered bf16 expert weights"
                    w_sel = w_lib[sel.long()].transpose(1, 2)
                    lib_ms = timer.ms(lambda: torch.bmm(xb[:, None, :], w_sel), 20, "library")
                    del w_sel
                else:
                    lib = "torch.matmul per expert on its rows, summed"
                    lib_ms = 0.0
                    for e in range(E):
                        xe, we = xb[sel == e], w_lib[e]
                        lib_ms += timer.ms(lambda: torch.matmul(xe, we.T), 10, "library")
                distinct = int(torch.unique(sel).numel())
                n_bytes = distinct * per_expert + nbytes(x_slots) + S * N * 4
                b_ms, b_by = bound_ms(n_bytes, 2.0 * S * N * K, "bf16")
                rec = {"phase": "kernels", "kernel": name,
                       "route": qmm_gathered.route(tt, planes_t), "type": type_label(qt, ar),
                       "N": N, "K": K,
                       "experts": E, "slots": S, "tile_t": tt, "rows": int(x.shape[0]),
                       "distinct_experts": distinct, "x": "float32",
                       "scales": str(sdt).split(".")[-1], "max_abs_err": err, "tol": tol,
                       "max_rel_err": err / max(float(want.abs().max()), 1e-30),
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library": lib,
                       "bound_ms": b_ms, "bound_by": b_by}
                if (E, k_used) == (16, 1):
                    role = "ffn_gateup_exps" if planes_t else "ffn_down_exps"
                    rec["case"] = f"llama4 {role} slots={S}"
                emit(rec)
                out.append(rec)
            del fields
        del rows, w_lib
        torch.cuda.empty_cache()


def attn_inputs(B, Tq, Hq, Hkv, D, S, dtype, gen, device, kv_pos, q_pos, window: int = 0,
                chunk: int = 0, alibi: bool = False):
    """Random q/k/v at head-major cache layout and the Context's additive
    mask: visible iff the cell holds a position at or before the query's
    (and with `window`, after the query's position less the window: the
    mask of a sliding-window layer; with `chunk`, at or after the start of
    the query's chunk: llama4's chunked layers). A visible cell carries 0,
    or with `alibi` the ALiBi model's -|kv_pos - q_pos|, which the kernels
    multiply by each head's slope; a hidden one -1e30."""
    import torch

    q = torch.randn((B, Tq, Hq, D), generator=gen, device=device).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=device).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=device).to(dtype)
    kp = torch.as_tensor(kv_pos, device=device)[:, None, :]
    qp = torch.as_tensor(q_pos, device=device)[:, :, None]
    vis = (kp >= 0) & (kp <= qp)
    if window:
        vis &= kp > qp - window
    if chunk:
        vis &= kp >= qp // chunk * chunk
    shown = -(kp - qp).abs().to(torch.float32) if alibi else torch.zeros((), device=device)
    mask = torch.where(vis, shown, -1e30).to(torch.float32)[:, None]
    return q, k, v, mask


def int8_cache(k, v):
    """k and v quantized per row as the model writes an int8 cache
    (models/llama.quantize_q8): (k int8, v int8, (k scales, v scales))."""
    from tpullama_torch.models.llama import quantize_q8

    (kq, ks), (vq, vs) = quantize_q8(k), quantize_q8(v)
    return kq, vq, (ks, vs)


def attn_case(timer, name, fn, q, k, v, mask, out, scales=None, case=None, **kw):
    """One attention kernel case against its plain version. `scales`: an
    int8 cache's (k_scale, v_scale); its library yardstick is SDPA over the
    cache dequantized to q's dtype (no PyTorch call takes int8 K/V with
    scales), and its bound counts the int8 rows and the f32 scales. With
    `sinks` alone among the options the yardstick is SDPA over one more key
    column whose K and V rows are zero and whose mask value is each head's
    sink: the same function (that column's logit is the sink, its value
    row adds nothing); with `alibi_slopes` alone, SDPA with a per-head
    additive mask of each visible cell's slope times its -|dpos| (the same
    function, the mask rounded to q's dtype). `case` labels the record
    (the kernels line lists labelled records beside each kernel's served
    shape)."""
    import torch
    import torch.nn.functional as F

    from tpullama_torch.ops.cuda.common import flash_plain, route

    B, Tq, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    if scales is not None:
        kw = dict(kw, k_scale=scales[0], v_scale=scales[1])
    got = fn(q, k, v, mask, scale, **kw)
    want, plain_ms = timer.once(lambda: flash_plain(q, k, v, mask, scale, **kw))
    err = float((got.float() - want.float()).abs().max())
    # both sides compute in f32; a bf16 output may round one step apart
    tol = (2.0 ** -7 if q.dtype == torch.bfloat16 else 1e-5) * float(want.float().abs().max()) + 1e-6
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"{name} B={B} Tq={Tq} S={S}: err {err} > tol {tol}")
    ms = timer.ms(lambda: fn(q, k, v, mask, scale, **kw), 20)
    lib_ms = lib_call = None
    options = sorted(a for a in kw if a not in ("k_scale", "v_scale"))
    if options in ([], ["sinks"], ["alibi_slopes"]):
        m_lib = mask.to(q.dtype)
        qt = q.transpose(1, 2)
        k_lib, v_lib = k, v
        lib_call = "scaled_dot_product_attention"
        if scales is not None:
            k_lib = (k.float() * scales[0][..., None]).to(q.dtype)
            v_lib = (v.float() * scales[1][..., None]).to(q.dtype)
            lib_call += f" over the cache dequantized to {str(q.dtype).split('.')[-1]}"
        if options == ["alibi_slopes"]:
            slopes = kw["alibi_slopes"].float().reshape(1, Hq, 1, 1)
            m_lib = torch.where(mask > NEG_HIDDEN, mask * slopes, mask).to(q.dtype)
            lib_call += " with the additive mask slope * -|dpos| of each head"
        elif options:
            zero = k_lib.new_zeros((B, Hkv, 1, D))
            k_lib, v_lib = torch.cat([k_lib, zero], dim=2), torch.cat([v_lib, zero], dim=2)
            sink = kw["sinks"].to(q.dtype).reshape(1, Hq, 1, 1).expand(B, Hq, Tq, 1)
            m_lib = torch.cat([m_lib.expand(B, Hq, Tq, S), sink], dim=-1)
            lib_call += " with a zero key column masked by the sinks"
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, k_lib, v_lib, attn_mask=m_lib, scale=scale, enable_gqa=True), 20, "library")
        del k_lib, v_lib, m_lib
    vis = mask[:, 0] > NEG_HIDDEN  # (B, Tq, S)
    n_pairs = int(vis.sum())
    n_cells = int(vis.any(dim=1).sum())  # cache rows some query needs
    # each visible cache row once, and an int8 cache's f32 scale with it
    elt = k.element_size() * D + (4 if scales is not None else 0)
    n_bytes = (nbytes(q) + 2 * n_cells * Hkv * elt + nbytes(mask) + nbytes(q))
    flops = 4.0 * n_pairs * Hq * D
    b_ms, b_by = bound_ms(n_bytes, flops, "bf16" if q.dtype == torch.bfloat16 else "f32")
    rec = {"phase": "kernels", "kernel": name, "route": route(q, k), "B": B, "Tq": Tq,
           "Hq": Hq, "Hkv": Hkv, "D": D, "S": S, "dtype": str(q.dtype).split(".")[-1],
           "kv": str(k.dtype).split(".")[-1], "extras": options, "visible_pairs": n_pairs,
           "tflop_s": flops / ms / 1e9, "gb_s": n_bytes / ms / 1e6,
           "max_abs_err": err, "tol": tol,
           "max_rel_err": err / max(float(want.float().abs().max()), 1e-30),
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library_call": lib_call,
           "bound_ms": b_ms, "bound_by": b_by}
    if case:
        rec["case"] = case
    emit(rec)
    out.append(rec)


def ring_positions(lengths, n_swa: int, n_ubatch: int) -> np.ndarray:
    """The (B, S_swa) positions of the two-stack cache's ring after each
    lane wrote positions 0 .. n - 1 (lengths): cell c holds the newest
    position congruent to c modulo S_swa - 1, the scratch cell S_swa - 1
    none (runtime/context.py)."""
    R = n_swa + n_ubatch + 1
    kv = np.full((len(lengths), R), -1, np.int32)
    for b, n in enumerate(lengths):
        p = np.arange(max(0, n - (R - 1)), n)
        kv[b, p % (R - 1)] = p
    return kv


def iswa_attention_cases(timer, gen, device, out: list, W: Widths, label: str,
                         sinks: bool = False, int8: tuple = (False,)) -> None:
    """A served model's attention on the two-stack cache (n_ctx 4096,
    n_ubatch 256): over the full layers' 4224 cells and over the SWA
    layers' ring of n_swa + 256 + 1 cells under the windowed mask; decode at
    B = 1 (flash_decode) and B = 4 (flash_decode_batched), the packed 4 x
    256 prefill chunk (flash_attention); bf16, with each of `int8` the int8
    cache too, with `sinks` per-head sinks. Each record is labelled
    `label` and its stack."""
    import torch

    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode

    Hq, Hkv, D, S, n_ub, Tq = W.n_head, W.n_head_kv, W.hd, 4224, 256, 256
    kw = {"sinks": torch.randn((Hq,), generator=gen, device=device)} if sinks else {}
    lengths4, lanes = [4000, 3000, 1000, 300], [(0, 256), (700, 216), (1800, 100), (3500, 0)]
    for stack, window, n_cells in (("full", 0, S), ("ring", W.n_swa, W.n_swa + n_ub + 1)):
        case = f"{label} {stack} S={n_cells}"

        def cache_pos(ns):
            if stack == "ring":
                return ring_positions(ns, W.n_swa, n_ub)
            kv = np.full((len(ns), S), -1, np.int32)
            for b, n in enumerate(ns):
                kv[b, :n] = np.arange(n)
            return kv

        for i8 in int8:
            suffix = "_int8" if i8 else ""
            for lengths, name in (([4000], "flash_decode"), (lengths4, "flash_decode_batched")):
                q, k, v, mask = attn_inputs(len(lengths), 1, Hq, Hkv, D, n_cells, torch.bfloat16,
                                            gen, device, cache_pos(lengths),
                                            np.asarray(lengths, np.int32)[:, None] - 1, window)
                sc = None
                if i8:
                    k, v, sc = int8_cache(k, v)
                attn_case(timer, name + suffix, flash_decode, q, k, v, mask, out, scales=sc,
                          case=case, **kw)
            qp = np.full((4, Tq), -1, np.int32)
            for b, (n_past, n_new) in enumerate(lanes):
                qp[b, :n_new] = np.arange(n_past, n_past + n_new)
            q, k, v, mask = attn_inputs(4, Tq, Hq, Hkv, D, n_cells, torch.bfloat16, gen, device,
                                        cache_pos([a + n for a, n in lanes]), qp, window)
            sc = None
            if i8:
                k, v, sc = int8_cache(k, v)
            attn_case(timer, "flash_attention" + suffix, flash_attention, q, k, v, mask, out,
                      scales=sc, case=case, **kw)
            del q, k, v, mask


def chunked_attention_cases(timer, gen, device, out: list) -> None:
    """Llama-4-Scout's attention as served at n_ctx 16384 on the two-stack
    cache (n_ubatch 256): its NoPE full layer over the full stack's 16512
    cells under the causal mask, its chunked layers over the ring of
    8192 + 256 + 1 cells under the chunked mask; 40 / 8 heads of 128 (G =
    5). Decode at B = 1 (flash_decode) and B = 4 (flash_decode_batched)
    with lanes past the chunk start at 8192, and the packed 4 x 256 prefill
    chunk (flash_attention) with a lane crossing it; bf16. Each record is
    labelled "llama4" and its stack."""
    import torch

    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode

    W, n_ctx, chunk = LLAMA4_SCOUT, 16384, 8192
    Hq, Hkv, D, n_ub, Tq = W.n_head, W.n_head_kv, W.hd, 256, 256
    S = -(-(n_ctx + 1) // 128) * 128
    lengths4 = [16000, 12000, 8300, 300]
    lanes = [(15000, 256), (8100, 216), (4000, 100), (0, 256)]
    for stack, n_cells in (("full", S), ("chunked ring", chunk + n_ub + 1)):
        ck = chunk if stack != "full" else 0

        def cache_pos(ns):
            if ck:
                return ring_positions(ns, chunk, n_ub)
            kv = np.full((len(ns), S), -1, np.int32)
            for b, n in enumerate(ns):
                kv[b, :n] = np.arange(n)
            return kv

        case = f"llama4 {stack} S={n_cells}"
        for lengths, name in (([12000], "flash_decode"), (lengths4, "flash_decode_batched")):
            q, k, v, mask = attn_inputs(len(lengths), 1, Hq, Hkv, D, n_cells, torch.bfloat16,
                                        gen, device, cache_pos(lengths),
                                        np.asarray(lengths, np.int32)[:, None] - 1, chunk=ck)
            attn_case(timer, name, flash_decode, q, k, v, mask, out, case=case)
        qp = np.full((4, Tq), -1, np.int32)
        for b, (n_past, n_new) in enumerate(lanes):
            qp[b, :n_new] = np.arange(n_past, n_past + n_new)
        q, k, v, mask = attn_inputs(4, Tq, Hq, Hkv, D, n_cells, torch.bfloat16, gen, device,
                                    cache_pos([a + n for a, n in lanes]), qp, chunk=ck)
        attn_case(timer, "flash_attention", flash_attention, q, k, v, mask, out, case=case)
        del q, k, v, mask


def nongated_attention_cases(timer, gen, device, out: list) -> None:
    """phi-2's attention as served at n_ctx 2048 (32 heads of 80, G = 1,
    over 2176 cells), the same shapes at D = 128 (the instance D = 80 runs
    in, every column of it used), and bigcode/starcoder's at n_ctx 8192
    (48 heads of 128 over one KV head: G = 48, three 16-row tiles a KV
    head, over 8320 cells): decode at B = 1 (flash_decode) and B = 4
    (flash_decode_batched), and the packed 4 x 256 prefill chunk
    (flash_attention), bf16. Each record labelled by its model and cells."""
    import torch

    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode

    Tq = 256
    for label, Hq, Hkv, D, n_ctx in (("phi2", 32, 32, 80, 2048),
                                     ("phi2 at D=128", 32, 32, 128, 2048),
                                     ("starcoder", 48, 1, 128, 8192)):
        S = -(-(n_ctx + 1) // 128) * 128
        case = f"{label} S={S}"
        for lengths, name in (([n_ctx - 48], "flash_decode"),
                              ([n_ctx - 48, n_ctx * 3 // 4, n_ctx * 3 // 8, 300],
                               "flash_decode_batched")):
            kv = np.full((len(lengths), S), -1, np.int32)
            for b, n in enumerate(lengths):
                kv[b, :n] = np.arange(n)
            qp = np.asarray(lengths, np.int32)[:, None] - 1
            q, k, v, mask = attn_inputs(len(lengths), 1, Hq, Hkv, D, S, torch.bfloat16, gen,
                                        device, kv, qp)
            attn_case(timer, name, flash_decode, q, k, v, mask, out, case=case)
        lanes = [(0, 256), (n_ctx // 3, 216), (n_ctx * 3 // 4, 100), (n_ctx - 300, 0)]
        kv = np.full((4, S), -1, np.int32)
        qp = np.full((4, Tq), -1, np.int32)
        for b, (n_past, n_new) in enumerate(lanes):
            kv[b, :n_past + n_new] = np.arange(n_past + n_new)
            qp[b, :n_new] = np.arange(n_past, n_past + n_new)
        q, k, v, mask = attn_inputs(4, Tq, Hq, Hkv, D, S, torch.bfloat16, gen, device, kv, qp)
        attn_case(timer, "flash_attention", flash_attention, q, k, v, mask, out, case=case)
        del q, k, v, mask


def alibi_attention_cases(timer, gen, device, out: list) -> None:
    """BLOOM-7b1's attention as served at n_ctx 4608 (32 heads of 128, G =
    1, over 4736 cells) through the kernels' ALiBi branch, BLOOM's slopes
    (max bias 8, models/llama.alibi_slopes) under the Context's distance
    mask: decode at B = 1 over the ~3000-token request (flash_decode), at
    B = 4 (flash_decode_batched), and the packed 4 x 256 prefill chunk
    (flash_attention), bf16; each named by its launch counter."""
    import torch

    from tpullama_torch.models.llama import alibi_slopes
    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode

    W, Tq = BLOOM_7B1, 256
    Hq, D, S = W.n_head, W.hd, -(-(SERVE_OPTS["bloom_"]["n_ctx"] + 1) // 128) * 128
    slopes = alibi_slopes(Hq, 8.0, device)
    for lengths, name in (([3040], "flash_decode_alibi"),
                          ([3040, 812, 582, 332], "flash_decode_batched_alibi")):
        kv = np.full((len(lengths), S), -1, np.int32)
        for b, n in enumerate(lengths):
            kv[b, :n] = np.arange(n)
        qp = np.asarray(lengths, np.int32)[:, None] - 1
        q, k, v, mask = attn_inputs(len(lengths), 1, Hq, Hq, D, S, torch.bfloat16, gen, device,
                                    kv, qp, alibi=True)
        attn_case(timer, name, flash_decode, q, k, v, mask, out, alibi_slopes=slopes)
    lanes = [(0, 256), (700, 216), (1800, 100), (2900, 0)]
    kv = np.full((4, S), -1, np.int32)
    qp = np.full((4, Tq), -1, np.int32)
    for b, (n_past, n_new) in enumerate(lanes):
        kv[b, :n_past + n_new] = np.arange(n_past + n_new)
        qp[b, :n_new] = np.arange(n_past, n_past + n_new)
    q, k, v, mask = attn_inputs(4, Tq, Hq, Hq, D, S, torch.bfloat16, gen, device, kv, qp,
                                alibi=True)
    attn_case(timer, "flash_attention_alibi", flash_attention, q, k, v, mask, out,
              alibi_slopes=slopes)
    del q, k, v, mask


def attention_cases(timer, gen, device, out: list) -> None:
    import torch

    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode

    bf16 = torch.bfloat16
    Hq, Hkv, D, S = 32, 8, 128, 4224

    def decode_pos(lengths, S=S):
        kv = np.full((len(lengths), S), -1, np.int32)
        for b, n in enumerate(lengths):
            kv[b, :n] = np.arange(n)
        return kv, np.asarray(lengths, np.int32)[:, None] - 1

    # decode at B = 1 (Context.decode) and B = 4 (the server's decode_batch)
    for lengths, name in (([4000], "flash_decode"),
                          ([4000, 3000, 1000, 300], "flash_decode_batched")):
        kv, qp = decode_pos(lengths)
        q, k, v, mask = attn_inputs(len(lengths), 1, Hq, Hkv, D, S, bf16, gen, device, kv, qp)
        attn_case(timer, name, flash_decode, q, k, v, mask, out)

    # prefill chunks of Tq = 256: (cached tokens, new tokens) per lane.
    # Rows past a lane's new tokens are padding (position -1, every key
    # hidden). B = 1 is Context.decode's chunk; B = 4 is the server's
    # packed chunk (Context.decode_multi), whose lanes differ in length and
    # history, one of them without a chunk (every row padding)
    Tq = 256
    for lanes in ([(700, 216)], [(0, 256), (700, 216), (1800, 100), (3500, 0)]):
        kv = np.full((len(lanes), S), -1, np.int32)
        qp = np.full((len(lanes), Tq), -1, np.int32)
        for b, (n_past, n_new) in enumerate(lanes):
            kv[b, :n_past + n_new] = np.arange(n_past + n_new)
            qp[b, :n_new] = np.arange(n_past, n_past + n_new)
        q, k, v, mask = attn_inputs(len(lanes), Tq, Hq, Hkv, D, S, bf16, gen, device, kv, qp)
        attn_case(timer, "flash_attention", flash_attention, q, k, v, mask, out)
        del q, k, v, mask

    # GLM-4.5-Air's served shapes: 96 query heads over 8 KV heads (G = 12),
    # D = 128; the B = 4 decode step and the packed 4 x 256 prefill chunk
    kv, qp = decode_pos([4000, 3000, 1000, 300])
    q, k, v, mask = attn_inputs(4, 1, 96, Hkv, D, S, bf16, gen, device, kv, qp)
    attn_case(timer, "flash_decode_batched", flash_decode, q, k, v, mask, out)
    lanes = [(0, 256), (700, 216), (1800, 100), (3500, 0)]
    kv = np.full((4, S), -1, np.int32)
    qp = np.full((4, Tq), -1, np.int32)
    for b, (n_past, n_new) in enumerate(lanes):
        kv[b, :n_past + n_new] = np.arange(n_past + n_new)
        qp[b, :n_new] = np.arange(n_past, n_past + n_new)
    q, k, v, mask = attn_inputs(4, Tq, 96, Hkv, D, S, bf16, gen, device, kv, qp)
    attn_case(timer, "flash_attention", flash_attention, q, k, v, mask, out)
    del q, k, v, mask

    # GQA groups beyond powers of two, which the kernels refused before:
    # Qwen2-1.5B's 12/2 (G = 6), Qwen2-7B's 28/4 (G = 7), 12/1 (G = 12) and
    # Falcon-7B's 71/1 MQA (head dim 64); decode at Tq = 1 and 4 (G * Tq up
    # to 284 rows per kv head) and a 256-row prefill chunk of two lanes
    Sg = 1024
    for Hq_g, Hkv_g, D_g in ((12, 2, 128), (28, 4, 128), (12, 1, 128), (71, 1, 64)):
        for Tq_g in (1, 4):
            lengths = np.asarray([900, 500], np.int32)
            kv, _ = decode_pos(lengths, Sg)
            qp = lengths[:, None] - Tq_g + np.arange(Tq_g, dtype=np.int32)
            q, k, v, mask = attn_inputs(2, Tq_g, Hq_g, Hkv_g, D_g, Sg, bf16, gen, device, kv, qp)
            attn_case(timer, "flash_decode_batched", flash_decode, q, k, v, mask, out)
        kv = np.full((2, Sg), -1, np.int32)
        qp = np.full((2, Tq), -1, np.int32)
        for b, (n_past, n_new) in enumerate([(0, 256), (500, 100)]):
            kv[b, :n_past + n_new] = np.arange(n_past + n_new)
            qp[b, :n_new] = np.arange(n_past, n_past + n_new)
        q, k, v, mask = attn_inputs(2, Tq, Hq_g, Hkv_g, D_g, Sg, bf16, gen, device, kv, qp)
        attn_case(timer, "flash_attention", flash_attention, q, k, v, mask, out)
        del q, k, v, mask

    # head dims the kernels refused before, each padded inside the kernel
    # to 64, 128 or 256: 16 (the tiny fixtures), 80, 96, 100 (OpenLLaMA-3B,
    # rows of bf16 pairs) and 256, beside 128 at the same shapes; decode of
    # 4 lanes and a 256-row prefill chunk of two lanes over 1024 cells, GQA
    # group 4, bf16 and f32
    for D_h in (16, 80, 96, 100, 128, 256):
        for dt in (bf16, torch.float32):
            lengths = np.asarray([900, 700, 500, 300], np.int32)
            kv, qp = decode_pos(lengths, Sg)
            q, k, v, mask = attn_inputs(4, 1, Hq, Hkv, D_h, Sg, dt, gen, device, kv, qp)
            attn_case(timer, "flash_decode_batched", flash_decode, q, k, v, mask, out)
            kv = np.full((2, Sg), -1, np.int32)
            qp = np.full((2, Tq), -1, np.int32)
            for b, (n_past, n_new) in enumerate([(0, 256), (500, 100)]):
                kv[b, :n_past + n_new] = np.arange(n_past + n_new)
                qp[b, :n_new] = np.arange(n_past, n_past + n_new)
            q, k, v, mask = attn_inputs(2, Tq, Hq, Hkv, D_h, Sg, dt, gen, device, kv, qp)
            attn_case(timer, "flash_attention", flash_attention, q, k, v, mask, out)
            del q, k, v, mask

    # the options the kernels take beyond the llama path, in f32 and bf16
    extras = dict(softcap=30.0,
                  sinks=torch.randn((Hq,), generator=gen, device=device),
                  alibi_slopes=torch.rand((Hq,), generator=gen, device=device))
    # under the ALiBi model's distance mask, so that the slopes reach the
    # scores (a 0 / -1e30 mask would give every visible cell 0 x slope)
    for dt in (torch.float32, bf16):
        kv, qp = decode_pos([500, 77], 512)
        q, k, v, mask = attn_inputs(2, 1, Hq, Hkv, D, 512, dt, gen, device, kv, qp, alibi=True)
        attn_case(timer, "flash_decode_batched", flash_decode, q, k, v, mask, out, **extras)
        kv = np.tile(np.arange(512, dtype=np.int32), (2, 1))
        qp = np.tile(np.arange(448, 512, dtype=np.int32), (2, 1))
        q, k, v, mask = attn_inputs(2, 64, Hq, Hkv, D, 512, dt, gen, device, kv, qp, alibi=True)
        attn_case(timer, "flash_attention", flash_attention, q, k, v, mask, out, **extras)

    # the int8 cache (ContextParams(kv_dtype=torch.int8)), each row quantized
    # as the model writes it: the served shapes above (decode at B = 1 and
    # B = 4, the packed 4 x 256 prefill chunk), then head dims 64, 100 and
    # 256 and f32 q (the FMA route) at the head-dim loop's shapes
    for lengths, name in (([4000], "flash_decode_int8"),
                          ([4000, 3000, 1000, 300], "flash_decode_batched_int8")):
        kv, qp = decode_pos(lengths)
        q, k, v, mask = attn_inputs(len(lengths), 1, Hq, Hkv, D, S, bf16, gen, device, kv, qp)
        kq, vq, sc = int8_cache(k, v)
        attn_case(timer, name, flash_decode, q, kq, vq, mask, out, scales=sc)
    lanes = [(0, 256), (700, 216), (1800, 100), (3500, 0)]
    kv = np.full((4, S), -1, np.int32)
    qp = np.full((4, Tq), -1, np.int32)
    for b, (n_past, n_new) in enumerate(lanes):
        kv[b, :n_past + n_new] = np.arange(n_past + n_new)
        qp[b, :n_new] = np.arange(n_past, n_past + n_new)
    q, k, v, mask = attn_inputs(4, Tq, Hq, Hkv, D, S, bf16, gen, device, kv, qp)
    kq, vq, sc = int8_cache(k, v)
    del k, v
    attn_case(timer, "flash_attention_int8", flash_attention, q, kq, vq, mask, out, scales=sc)
    del q, kq, vq, mask
    for D_h, dt in ((64, bf16), (100, bf16), (256, bf16), (128, torch.float32)):
        lengths = np.asarray([900, 700, 500, 300], np.int32)
        kv, qp = decode_pos(lengths, Sg)
        q, k, v, mask = attn_inputs(4, 1, Hq, Hkv, D_h, Sg, dt, gen, device, kv, qp)
        kq, vq, sc = int8_cache(k, v)
        attn_case(timer, "flash_decode_batched_int8", flash_decode, q, kq, vq, mask, out,
                  scales=sc)
        kv = np.full((2, Sg), -1, np.int32)
        qp = np.full((2, Tq), -1, np.int32)
        for b, (n_past, n_new) in enumerate([(0, 256), (500, 100)]):
            kv[b, :n_past + n_new] = np.arange(n_past + n_new)
            qp[b, :n_new] = np.arange(n_past, n_past + n_new)
        q, k, v, mask = attn_inputs(2, Tq, Hq, Hkv, D_h, Sg, dt, gen, device, kv, qp)
        kq, vq, sc = int8_cache(k, v)
        attn_case(timer, "flash_attention_int8", flash_attention, q, kq, vq, mask, out,
                  scales=sc)
        del q, k, v, kq, vq, mask


# ---------------------------------------------------------------- phases


def word_prompt(rng: np.random.Generator, n_bytes: int) -> str:
    words = ("the a model token cache layer kernel decode prefill card memory "
             "stream server request answer quantized weight block scale value "
             "attention query key head batch slot").split()
    out = []
    while len(" ".join(out)) < n_bytes:
        out.append(words[int(rng.integers(len(words)))])
    return " ".join(out)[:n_bytes]


def phase_model(tmp: str, widths: Widths = LLAMA3_8B, device: str = "cuda",
                phase: str = "model", fused_layer: bool = False, keep_file: bool = False):
    """Write the model at `widths` (seed 0) and load it packed in bf16 onto
    `device`, with checks of what packed. With `keep_file` the file stays
    at tmp/<phase>.gguf for a cross-check that reads the whole model."""
    import torch

    from tpullama_torch import native
    from tpullama_torch.models import load_model

    t0 = time.perf_counter()
    path = os.path.join(tmp, f"{phase}.gguf")
    write_llama_gguf(path, widths, seed=0)
    t_write = time.perf_counter() - t0
    t1 = time.perf_counter()
    model = load_model(path, dtype=torch.bfloat16, device=device, packed=True,
                       fused_layer=fused_layer)
    if device == "cuda":
        torch.cuda.synchronize()
    t_load = time.perf_counter() - t1
    file_bytes = os.path.getsize(path)
    if not keep_file:
        os.remove(path)
    lm = (model.quant_meta or {}).get("layers", {})
    attn = {"attn_q", "attn_k", "attn_v", "attn_output"}
    if widths.dense_lead:
        # a heterogeneous stack: both loaders keep every layer tensor dense
        # (bf16 here), packed or not; the output alone packs; the NextN
        # layers past n_layer are skipped
        check(set(model.quant_meta or {}) == {"output"} and not lm,
              f"only the output is packed: {sorted(model.quant_meta or {})}")
        layers = model.params["layer_list"]
        check(len(layers) == widths.n_layer == model.hparams.n_layer
              and model.hparams.nextn_layers == widths.nextn,
              f"{len(layers)} layers loaded of {widths.n_layer} (+{widths.nextn} NextN)")
        check(all(t.dtype == torch.bfloat16 for w in layers for t in w.values()),
              "every layer tensor is dense bf16")
        for il, w in enumerate(layers):
            want = ({"ffn_gate", "ffn_up", "ffn_down"} if il < widths.dense_lead else
                    {"ffn_gate_inp", "exp_probs_b", "ffn_gate_exps", "ffn_up_exps",
                     "ffn_down_exps", "ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"})
            check(want <= set(w), f"layer {il}: {sorted(w)}")
    elif widths.arch == "gpt-oss":
        # K = 2880 is no multiple of 256: both loaders keep q, k, v, the
        # expert stacks, the token table and the lm_head dense (bf16); the
        # attention output (K = 64 x 64 = 4096) alone packs
        check(set(model.quant_meta or {}) == {"layers"} and set(lm) == {"attn_output"},
              f"only attn_output is packed: {sorted(model.quant_meta or {})} {sorted(lm)}")
        layers = model.params["layers"]
        for key in ("attn_q", "attn_k", "attn_v", "ffn_gate_exps", "ffn_up_exps",
                    "ffn_down_exps"):
            check(layers[key].dtype == torch.bfloat16 and layers[key].shape[0] == widths.n_layer,
                  f"{key} is a dense bf16 stack")
        check({"attn_sinks", "attn_output_bias", "ffn_gate_inp_b", "ffn_gate_exps_b",
               "ffn_up_exps_b", "ffn_down_exps_b"} <= set(layers),
              f"gpt-oss tensors {sorted(layers)}")
        check(model.params["output"].dtype == torch.bfloat16, "the lm_head is dense bf16")
        check(model.hparams.swa_layers == tuple(il % 2 == 0 for il in range(widths.n_layer))
              and model.hparams.n_swa == widths.n_swa, "SWA on the even layers")
    elif widths.n_expert:
        shexp = {"ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"} if widths.n_ff_shexp else set()
        want = (packed_roles(widths) & attn if widths.quant else attn) | shexp
        check(set(lm) == want | {"ffn_gateup_exps", "ffn_down_exps"},
              f"every layer matrix and expert stack is packed: {sorted(lm)}")
        # the loader's planes_t rule: a one-stripe set (Q4_0/Q4_1/Q4_K,
        # Q8_0, MXFP4) whose scale plane (K / 32 columns) is no multiple of
        # 128 is stored transposed (Mixtral's down, K = 14336: 448 columns;
        # Qwen3-30B-A3B's [gate | up] and down, 64 and 24); the q1/q2 sets
        # never are
        for key, K in (("ffn_gateup_exps", widths.n_embd), ("ffn_down_exps", widths.n_ff)):
            one_stripe = lm[key].ggml_type.name in ("Q4_0", "Q4_1", "Q4_K", "Q8_0", "MXFP4")
            check(lm[key].planes_t == (one_stripe and K % 4096 != 0),
                  f"{key} ({lm[key].ggml_type.name}, K={K}) planes_t={lm[key].planes_t}")
    elif widths.quant:
        want = packed_roles(widths)
        check(set(lm) == want, f"packed {sorted(lm)}, want {sorted(want)}")
        for role in _LAYER_ROLES:
            t = model.params["layers"][role]
            check(isinstance(t, dict) == (role in want)
                  and (isinstance(t, dict) or t.dtype == torch.bfloat16),
                  f"{role}: packed planes iff its type is one across layers, else dense bf16")
    elif widths.arch == "phi2":
        hp = model.hparams
        check(set(lm) == {"attn_qkv", "attn_output", "ffn_up", "ffn_down"}
              and "output" in model.quant_meta, f"every layer matrix is packed: {sorted(lm)}")
        check(not hp.ffn_gated and hp.parallel_residual and hp.norm_type == "layer"
              and (hp.n_rot, hp.rope_type) == (widths.n_rot, 2)
              and "ffn_norm" not in model.params["layers"] and "output_bias" in model.params,
              f"phi2's block: gated {hp.ffn_gated}, n_rot {hp.n_rot}, rope {hp.rope_type}")
    elif widths.arch == "bloom":
        hp = model.hparams
        check(set(lm) == {"attn_qkv", "attn_output", "ffn_up", "ffn_down"},
              f"every layer matrix is packed: {sorted(lm)}")
        check(not hp.ffn_gated and not hp.parallel_residual and hp.norm_type == "layer"
              and hp.rope_type == -1 and hp.f_max_alibi_bias == 8.0
              and {"token_embd_norm", "token_embd_norm_bias"} <= set(model.params),
              f"bloom's block: gated {hp.ffn_gated}, rope {hp.rope_type}, "
              f"ALiBi {hp.f_max_alibi_bias}")
    elif widths.arch == "olmo2":
        hp, layers = model.hparams, model.params["layers"]
        check(set(lm) == attn | {"ffn_gate", "ffn_up", "ffn_down"}
              and "output" in model.quant_meta, f"every layer matrix is packed: {sorted(lm)}")
        check(not hp.pre_norm and hp.qk_norm_full and hp.rope_type == 2
              and not {"attn_norm", "ffn_norm"} & set(layers)
              and {"post_attn_norm", "post_ffn_norm"} <= set(layers)
              and tuple(layers["attn_q_norm"].shape) == (widths.n_layer, widths.n_embd)
              and tuple(layers["attn_k_norm"].shape) == (widths.n_layer,
                                                         widths.n_head_kv * widths.hd),
              f"olmo2's post-norm block: pre_norm {hp.pre_norm}, rope {hp.rope_type}, "
              f"{sorted(layers)}")
    elif widths.arch == "chatglm":
        check(set(lm) == {"attn_qkv", "attn_output", "ffn_up"},
              f"attn_qkv, attn_output and ffn_up are packed: {sorted(lm)}")
        want = {"attn_qkv": "stripe", "attn_output": "fourblock" if fused_layer else "stripe",
                "ffn_up": "fourblock" if fused_layer else "stripe"}
        check({k: m.order for k, m in lm.items()} == want, f"stored orders {want}")
        # 13696 columns: no Q4_K width, so both loaders keep it dense
        dn = model.params["layers"]["ffn_down"]
        check(not isinstance(dn, dict) and dn.dtype == torch.bfloat16,
              "ffn_down is a dense bf16 stack")
    else:
        check(set(lm) == attn | {"ffn_gate", "ffn_up", "ffn_down"},
              "every layer matrix is packed")
        if widths.arch == "qwen3":
            qk = [model.params["layers"].get(k) for k in ("attn_q_norm", "attn_k_norm")]
            check(all(t is not None and tuple(t.shape) == (widths.n_layer, widths.hd)
                      for t in qk), "per-head q/k norms of head_dim per layer")
    if widths.tied:
        check("output" not in model.params and model.params["tok_embd"].dtype == torch.bfloat16,
              "the dense bf16 token table is the lm_head")
    if widths.n_swa:
        swa = model.hparams.swa_layers
        check(len(swa) == widths.n_layer and any(swa) and not all(swa)
              and model.hparams.n_swa == widths.n_swa, f"SWA and full layers: {swa}")
    if widths.arch == "llama4":
        # the arch's chunked pattern: 3 chunked layers of 8192 and a NoPE
        # full layer a period; the llama3 scaling as rope_freqs
        hp = model.hparams
        period = tuple(il % 4 < 3 for il in range(widths.n_layer))
        check(hp.swa_type == "chunked" and hp.n_swa == 8192 and hp.swa_layers == period
              and hp.nope_layers == tuple(not c for c in period) and hp.qk_norm_weightless,
              f"llama4's chunked and NoPE layers: {hp.swa_layers} {hp.nope_layers}")
        check(tuple(model.params["rope_freqs"].shape) == (widths.hd // 2,),
              "the llama3 scaling's rope_freqs")
    # the loader decodes and repacks through the native host library (it
    # builds on first use); on the card's machine it must have built
    used_native = native.resolve_native(None) and native.get_lib() is not None
    if device == "cuda":
        check(used_native, "the native host library was not used (no g++ or -fopenmp?)")
    emit({"phase": phase, "layers": model.hparams.n_layer, "n_embd": model.hparams.n_embd,
          "n_vocab": model.hparams.n_vocab, "experts": model.hparams.n_expert,
          "quant": widths.quant or None, "native": used_native,
          "types": {k: m.ggml_type.name for k, m in lm.items()},
          "planes_t": {k: m.planes_t for k, m in lm.items() if k.endswith("_exps")},
          "orders": {k: m.order for k, m in lm.items()},
          "write_s": t_write, "file_bytes": file_bytes, "load_s": t_load,
          "device_bytes": model.nbytes(), "seconds": time.perf_counter() - t0})
    return model


def card_reference(gpu):
    """A CPU reference model from a card model's own weights: every dense
    tensor copied to the host as it is on the card, then dense_reference,
    which dequantizes each packed matrix's planes where they lie, on the
    card, into dense host tensors. The card's and the host's runs then
    hold the same bits of every weight, whatever the load did."""
    import copy

    from tpullama_torch.models import LoadedModel

    def host(t):
        if isinstance(t, dict):
            # a packed matrix's planes stay on the card for dense_reference
            return t if set(t) <= PLANE_KEYS else {k: host(v) for k, v in t.items()}
        if isinstance(t, list):
            return [host(v) for v in t]
        return t.cpu()

    return dense_reference(LoadedModel(hparams=gpu.hparams, params=host(gpu.params), reader=None,
                                       vocab=gpu.vocab, quant_meta=copy.deepcopy(gpu.quant_meta)))


# the planes of a packed matrix (ops/qweights.py's field names)
PLANE_KEYS = {"q4", "q2", "q1", "q8", "q4_lut", "q4a", "q1r", "scale", "minv"}


def dense_reference(model):
    """A CPU reference model's packed matrices dequantized once, to dense
    f32 in natural order: the same exact weights its plain versions would
    dequantize at every call, so its steps run plain matmuls. The
    dequantization (dequant_stored: integer unpacking, then one rounded
    product and one rounded difference per value, each its own elementwise
    op) runs on the card where there is one, ~100x the host's rate, and
    gives the host's bits: the first matrix's first rows are held equal to
    the host's own dequantization. The expert stacks become dense (L, E,
    rows, K) f32 stacks (gate and up apart, the padded rows dropped), so
    the reference's experts run the dense expert branch (per pair at one
    token, sorted by expert at more) on those exact weights, where the
    plain gathered product would dequantize each selected expert again at
    every call (~2 s for one of Llama-4-Scout's on the host). The dense
    rows reach the host through one reused page-locked buffer, then a
    host copy on the host's threads (a copy from the card into pageable
    memory runs at a fraction of the link's rate, and Scout's expert
    stacks are 32 GB of f32). Returns the model."""
    import torch

    from tpullama_torch.ops.cuda import qmm

    via = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    checked = []
    staging: list = []

    def to_host(w, out):
        """w (on `via`) into the host tensor `out` of its shape."""
        if via.type != "cuda":
            out.copy_(w)
            return
        if not staging or staging[0].numel() < w.numel():
            staging[:] = [torch.empty(w.numel(), dtype=w.dtype, pin_memory=True)]
        buf = staging[0][:w.numel()].view(w.shape)
        buf.copy_(w)
        out.copy_(buf)

    def stored(fields, m):
        """One matrix's planes dequantized on `via`, (rows, K) in natural
        column order."""
        on = {k: v.to(via) for k, v in fields.items()}
        w = qmm.dequant_stored(on, m.ggml_type, m.group)
        # stored column p holds natural element idx[p]
        idx = qmm.permute_x(torch.arange(m.n_in, dtype=torch.float32, device=via)[None],
                            m.group, m.order)[0].long()
        out = torch.empty_like(w)
        out[:, idx] = w
        if via.type == "cuda" and not checked:
            host = qmm.dequant_stored({k: v[:8].cpu() for k, v in fields.items()},
                                      m.ggml_type, m.group)
            check(torch.equal(w[:8].cpu(), host), "the card's dequantization differs from "
                  "the host's")
            checked.append(True)
        return out

    def dense(fields, m):
        w = stored(fields, m)[:m.n_out]
        out = torch.empty(w.shape, dtype=w.dtype)
        to_host(w, out)
        return out

    qm = model.quant_meta or {}
    if "output" in qm:
        model.params["output"] = dense(model.params["output"], qm.pop("output"))
    lm = qm.get("layers", {})
    layers = model.params.get("layers", {})
    for key in [k for k in lm if not k.endswith("_exps")]:
        m, st = lm.pop(key), layers[key]
        layers[key] = torch.stack([dense({k: v[il] for k, v in st.items()}, m)
                                   for il in range(next(iter(st.values())).shape[0])])
    hp = model.hparams
    E, L = hp.n_expert, hp.n_layer
    F = lm["ffn_down_exps"].n_in if "ffn_down_exps" in lm else 0  # each expert's FFN
    for key in [k for k in lm if k.endswith("_exps")]:
        m, st = lm.pop(key), layers.pop(key)
        rows, G = m.n_out // E, m.n_in // m.group
        # the [gate | up] stack's halves are padded apart; down's rows true
        parts = ({"ffn_gate_exps": 0, "ffn_up_exps": rows // 2}
                 if key == "ffn_gateup_exps" else {key: 0})
        n = F if key == "ffn_gateup_exps" else rows
        for part in parts:
            layers[part] = torch.empty((L, E, n, m.n_in), dtype=torch.float32)
        for i in range(L * E):
            f = {k: v[i].to(via) for k, v in st.items()}
            if m.planes_t:  # (kcols, rows_p), the group rows padded to 16
                f = {k: (v[:G] if k in ("scale", "minv") else v).T.contiguous()
                     for k, v in f.items()}
            w = stored(f, m)
            for part, r0 in parts.items():
                to_host(w[r0:r0 + n], layers[part][i // E, i % E])
    if not lm:
        qm.pop("layers", None)
    model.quant_meta = qm or None
    return model


def phase_crosscheck(tmp: str, widths: Widths = LLAMA3_8B, device: str = "cuda",
                     n_layer: int = 2, phase: str = "crosscheck", fused_layer: bool = False,
                     qmm_tile_k: int | None = None, runtime_ops: bool = False,
                     compare_native: bool = False, n_prompt: int = 32) -> None:
    """A model at the same widths cut to n_layer layers, f32 activations and
    cache on both sides: `device` (the card) runs the kernels, the CPU the
    plain versions, both with the fused layer and K-chunks as given;
    without them the CPU's matrices are dequantized once at load
    (dense_reference, the experts too). With
    the fused layer on, the card's greedy run with both off, on the same
    fourblock planes, must give the same tokens too. With `runtime_ops`,
    Context.embeddings of the prompt for each pooling (none, mean, cls,
    last) within the logits' tolerance formula, and the seq ops
    (seq_ops_case) on the same two models. With `compare_native`, a copy of
    the cut with its vocabulary cut to NATIVE_CUT_VOCAB rows (every tensor
    type and codec path of the layout, its token table and lm_head a
    fraction of their rows) is loaded through the native host library and
    through the numpy codecs, timed, and the two must hold the same bits.
    The prompt is n_prompt tokens (a shorter one where the CPU's steps are
    slow)."""
    import torch

    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams

    t0 = time.perf_counter()
    path = os.path.join(tmp, f"{phase}.gguf")
    # a cut without NextN layers (the model phase writes and skips them)
    write_llama_gguf(path, replace(widths, n_layer=n_layer, nextn=0), seed=1)
    gpu = load_model(path, dtype=torch.float32, device=device, packed=True,
                     fused_layer=fused_layer)
    load_s = {}
    t1 = time.perf_counter()
    cpu = load_model(path, dtype=torch.float32, device="cpu", packed=True,
                     fused_layer=fused_layer)
    load_s["native"] = time.perf_counter() - t1
    if compare_native:
        cut = os.path.join(tmp, f"{phase}_vocab.gguf")
        write_llama_gguf(cut, replace(widths, n_layer=n_layer, nextn=0,
                                      n_vocab=NATIVE_CUT_VOCAB), seed=1)
        loads = {}
        for use_native in (True, False):
            t1 = time.perf_counter()
            loads[use_native] = load_model(cut, dtype=torch.float32, device="cpu", packed=True,
                                           fused_layer=fused_layer, native=use_native)
            load_s["native_cut_vocab" if use_native else "numpy_cut_vocab"] = (
                time.perf_counter() - t1)
        check(same_params(loads[True].params, loads[False].params),
              "the native and the numpy loads hold different parameters")
        del loads
        os.remove(cut)
    if not fused_layer and qmm_tile_k is None:
        dense_reference(cpu)
    os.remove(path)
    opts = dict(fused_layer=fused_layer, qmm_tile_k=qmm_tile_k)
    prompt = gpu.vocab.tokenize(word_prompt(np.random.default_rng(2), 40), add_special=True)
    prompt = np.asarray(prompt[:n_prompt], np.int32)
    check(len(prompt) == n_prompt, f"prompt has {len(prompt)} tokens")
    cp = ContextParams(n_ctx=256)
    lg = Context(gpu, cp, **opts).decode(prompt, n_logits=n_prompt)
    # with its final-norm hidden states: the CPU side of the embeddings check
    cc = Context(cpu, cp, **opts)
    lc, hidden = cc._decode(prompt, n_prompt, 0, embd=runtime_ops)
    err = float(np.abs(lg - lc).max())
    # f32 end to end; sums run in another order on the card
    tol = 1e-3 * float(np.abs(lc).max()) + 1e-4
    check(np.isfinite(lg).all() and err <= tol, f"prefill logits err {err} > tol {tol}")
    check(int(lg[-1].argmax()) == int(lc[-1].argmax()), "prefill argmax differs")
    out_g = Context(gpu, cp, **opts).generate(prompt, n_predict=8)
    # the CPU's greedy tokens continue its prefilled Context (generate's
    # host loop) rather than prefill again
    out_c = greedy_continue(cc, lc[-1], 8)
    check(out_g == out_c, f"greedy tokens differ: card {out_g} cpu {out_c}")
    lm = (gpu.quant_meta or {}).get("layers", {})
    rec = {"phase": phase, "layers": n_layer, "prompt_tokens": len(prompt),
           "quant": widths.quant or None, "cpu_load_s": load_s,
           "expert_types": {k: (m.ggml_type.name, "transposed" if m.planes_t else "row-major")
                            for k, m in lm.items() if k.endswith("_exps")},
           "prefill_max_abs_err": err, "tol": tol, "argmax": int(lc[-1].argmax()),
           "greedy_tokens": out_g, **opts}
    if runtime_ops:
        rec["seq_ops"] = seq_ops_case(gpu, cpu, prompt)
        # each pooling of the CPU prefill's hidden states by hand
        cg = Context(gpu, cp, **opts)
        hidden = hidden.numpy()
        rec["embeddings_max_abs_err"] = {}
        for pooling, ec in (("none", hidden), ("mean", hidden.mean(axis=0)), ("cls", hidden[0]),
                            ("last", hidden[-1])):
            if pooling != "none":
                ec = ec / np.linalg.norm(ec)
            eg = cg.embeddings(prompt, pooling=pooling)
            err_e = float(np.abs(eg - ec).max())
            tol_e = 1e-3 * float(np.abs(ec).max()) + 1e-4
            check(np.isfinite(eg).all() and eg.shape == ec.shape and err_e <= tol_e,
                  f"embeddings ({pooling}) err {err_e} > tol {tol_e}")
            rec["embeddings_max_abs_err"][pooling] = err_e
    if fused_layer:
        # nk = 1: no valid K-chunks, the untiled qmm kernels
        out_u = Context(gpu, cp, fused_layer=False, qmm_tile_k=1).generate(prompt, n_predict=8)
        check(out_u == out_g, f"fused/K-chunked {out_g} and unfused {out_u} card runs differ")
        rec["unfused_greedy_tokens"] = out_u
    emit({**rec, "seconds": time.perf_counter() - t0})


def phase_positions_crosscheck(tmp: str, card: str, device: str = "cuda",
                               widths: Widths = STARCODER, n_layer: int = 1,
                               n_prompt: int = 4160, chunk: int = 1024,
                               phase: str = "starcoder_crosscheck") -> None:
    """A model with a learned position table (bigcode/starcoder) cut to
    n_layer layers, f32 activations and cache on both sides, the CPU's
    matrices dequantized once (dense_reference): an n_prompt-token prompt,
    past position 4096 so that rows deep in the table are read, prefilled
    in `chunk`-token pieces on the card and on the CPU; the last piece's
    logits within the cross-checks' tolerance and the same argmax, then 8
    greedy tokens (the card's replayed one-token steps against the CPU
    continuing its Context). Context and make_context refuse an n_ctx of
    one more than the table's rows, by the table's name and size, and
    take the table's own."""
    import torch

    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams, make_context

    t0 = time.perf_counter()
    path = os.path.join(tmp, f"{phase}.gguf")
    write_llama_gguf(path, replace(widths, n_layer=n_layer), seed=1)
    gpu = load_model(path, dtype=torch.float32, device=device, packed=True)
    cpu = dense_reference(load_model(path, dtype=torch.float32, device="cpu", packed=True))
    os.remove(path)
    rows = int(gpu.params["position_embd"].shape[0])
    check(rows == widths.n_ctx_train and gpu.hparams.rope_type == -1,
          f"{rows} position rows, rope type {gpu.hparams.rope_type}")
    for make in (lambda n: Context(gpu, ContextParams(n_ctx=n)),
                 lambda n: make_context(gpu, ContextParams(n_ctx=n))):
        try:
            make(rows + 1)
            refused = ""
        except ValueError as e:
            refused = str(e)
        check(f"n_ctx={rows + 1}" in refused and f"(position_embd) of {rows} rows" in refused,
              f"n_ctx {rows + 1} was not refused by the table's name and size: {refused!r}")
        check(make(rows).p.n_ctx == rows, f"n_ctx {rows} was refused")
    text = word_prompt(np.random.default_rng(2), 2 * n_prompt)
    prompt = gpu.vocab.tokenize(text, add_special=True)[:n_prompt]
    check(len(prompt) == n_prompt > 4096, f"prompt has {len(prompt)} tokens")
    cp = ContextParams(n_ctx=n_prompt + 64)
    secs = {}
    last = {}
    ctxs = {"card": Context(gpu, cp), "cpu": Context(cpu, cp)}
    for side, ctx in ctxs.items():
        t1 = time.perf_counter()
        for st in range(0, n_prompt, chunk):
            piece = np.asarray(prompt[st:st + chunk], np.int32)
            # the lm_head on every row of the last piece, one row before it
            last[side] = ctx.decode(piece, n_logits=len(piece) if st + chunk >= n_prompt else 1)
        secs[side] = time.perf_counter() - t1
    lg, lc = last["card"], last["cpu"]
    err = float(np.abs(lg - lc).max())
    tol = 1e-3 * float(np.abs(lc).max()) + 1e-4
    check(np.isfinite(lg).all() and err <= tol, f"prefill logits err {err} > tol {tol}")
    check(int(lg[-1].argmax()) == int(lc[-1].argmax()), "prefill argmax differs")
    out_g = greedy_continue(ctxs["card"], lg[-1], 8)
    out_c = greedy_continue(ctxs["cpu"], lc[-1], 8)
    check(out_g == out_c, f"greedy tokens differ: card {out_g} cpu {out_c}")
    emit({"phase": phase, "card": card, "layers": n_layer, "prompt_tokens": n_prompt,
          "chunk": chunk, "positions_read": [0, n_prompt + len(out_g) - 2],
          "position_rows": rows, "refused_n_ctx": rows + 1, "prefill_s": secs,
          "last_chunk_logits": int(lg.shape[0]), "prefill_max_abs_err": err, "tol": tol,
          "argmax": int(lc[-1].argmax()), "greedy_tokens": out_g,
          "seconds": time.perf_counter() - t0})


def phase_swa_crosscheck(tmp: str, card: str, device: str = "cuda",
                         widths: Widths = GPT_OSS_20B, n_layer: int = 2, n_prompt: int = 600,
                         n_ubatch: int = 256, n_ctx: int = 1024, n_greedy: int = 16,
                         phase: str = "gptoss_crosscheck", path: str | None = None,
                         single_stack_layers: int = 0, served=None):
    """A model with sliding-window layers (gpt-oss, gemma3, cohere2) at its
    widths cut to n_layer layers (both kinds among them), f32 activations
    and cache, on the two-stack cache: a prompt of n_prompt tokens,
    prefilled in n_ubatch chunks (longer than the ring of n_swa + n_ubatch
    + 1 cells, the ring wraps), on `device` (the kernels) against the CPU
    port (plain versions, its packed matrices dequantized once;
    dense_reference): the last 32 prompt logits within 1e-3 of their
    largest magnitude plus 1e-4, n_greedy greedy tokens identical, both
    stacks' positions and the host mirror equal cell for cell after them;
    then on the card the same prompt on swa_full's one stack gives the same
    greedy tokens. `path`: a file of n_layer layers already written (the
    model phase's), read instead of writing the cut. With
    `single_stack_layers`, the first that many layers of both models (all
    of them SWA layers) run the same prompt again on one windowed stack,
    card against CPU. With `served` (a loaded model of n_layer layers, the
    served one), the card runs its weights with f32 activations
    (f32_activations) and the CPU reference is built from the card's own
    planes and tensors (card_reference): no file is written or read, where
    Llama-4-Scout's would be read twice (6.4 GB) and its experts densified
    from the host's load (32 GB of f32). Returns the card's f32 model."""
    import torch

    from tpullama_torch.models import LoadedModel, load_model
    from tpullama_torch.runtime import Context, ContextParams

    t0 = time.perf_counter()
    models_split = {}
    if served is not None:
        gpu = f32_activations(served)
        models_split["f32_activations"] = time.perf_counter() - t0
        cpu = card_reference(gpu)
        models_split["card_reference"] = time.perf_counter() - t0 - models_split["f32_activations"]
    else:
        if path is None:
            path = os.path.join(tmp, f"{phase}.gguf")
            write_llama_gguf(path, replace(widths, n_layer=n_layer), seed=1)
        gpu = load_model(path, dtype=torch.float32, device=device, packed=True)
        cpu = dense_reference(load_model(path, dtype=torch.float32, device="cpu", packed=True))
        os.remove(path)
    check(gpu.hparams.n_layer == n_layer, f"{gpu.hparams.n_layer} layers, not {n_layer}")
    t_models = time.perf_counter() - t0
    prompt = gpu.vocab.tokenize(word_prompt(np.random.default_rng(2), n_prompt + 40),
                                add_special=True)
    prompt = np.asarray(prompt[:n_prompt], np.int32)
    check(len(prompt) == n_prompt, f"prompt has {len(prompt)} tokens")
    cp = ContextParams(n_ctx=n_ctx, n_ubatch=n_ubatch)

    def pair_run(g_model, c_model, params):
        """Prefill and greedy tokens, card against CPU; returns the card's
        Context, its last logits' error and tolerance, its tokens and the
        two prefill seconds."""
        cg, cc = Context(g_model, params), Context(c_model, params)
        t1 = time.perf_counter()
        lg = cg.decode(prompt, n_logits=32)
        t_card = time.perf_counter() - t1
        t1 = time.perf_counter()
        lc = cc.decode(prompt, n_logits=32)
        t_cpu = time.perf_counter() - t1
        err = float(np.abs(lg - lc).max())
        tol = 1e-3 * float(np.abs(lc).max()) + 1e-4
        check(np.isfinite(lg).all() and err <= tol, f"prefill logits err {err} > tol {tol}")
        out_g = greedy_continue(cg, lg[-1], n_greedy)
        out_c = greedy_continue(cc, lc[-1], n_greedy)
        check(out_g == out_c, f"greedy tokens differ: card {out_g} cpu {out_c}")
        if isinstance(cg.kv_pos, dict):
            for stack in ("full", "swa"):
                check(torch.equal(cg.kv_pos[stack].cpu(), cc.kv_pos[stack]),
                      f"the {stack} stack's positions differ")
        else:
            check(torch.equal(cg.kv_pos.cpu(), cc.kv_pos), "the positions differ")
        check(np.array_equal(cg._pos_host, cc._pos_host)
              and np.array_equal(cg.n_past, cc.n_past), "the host mirrors differ")
        return cg, err, tol, out_g, {"card": t_card, "cpu": t_cpu}

    ring = gpu.hparams.n_swa + n_ubatch + 1
    cg, err, tol, out_g, prefill_s = pair_run(gpu, cpu, cp)
    check(cg._S_swa == ring and isinstance(cg.kv_k, dict),
          f"a ring of {cg._S_swa} cells, not {ring}")
    full = Context(gpu, replace(cp, swa_full=True))
    check(not isinstance(full.kv_k, dict), "swa_full keeps one stack")
    lf = full.decode(prompt, n_logits=1)
    out_f = greedy_continue(full, lf[-1], n_greedy)
    check(out_f == out_g, f"the ring's tokens {out_g} differ from swa_full's {out_f}")
    rec = {"phase": phase, "card": card, "layers": n_layer, "swa_layers": gpu.hparams.swa_layers,
           "models_s": t_models, "models_split_s": models_split,
           "served_weights": served is not None,
           "prompt_tokens": n_prompt, "n_ctx": n_ctx, "n_ubatch": n_ubatch, "ring_cells": ring,
           "ring_wrapped": n_prompt > ring, "full_cells": cg._S, "prefill_max_abs_err": err,
           "tol": tol, "prefill_s": prefill_s, "greedy_tokens": out_g,
           "swa_full_greedy_tokens": out_f}
    del cg, full
    if single_stack_layers:
        # the first layers alone: SWA layers only, so one stack of n_ctx
        # cells under the windowed mask, as the JAX Context keeps them
        def first_layers(m):
            n = single_stack_layers
            hp = replace(m.hparams, n_layer=n, swa_layers=m.hparams.swa_layers[:n])
            layers = {k: ({f: a[:n] for f, a in v.items()} if isinstance(v, dict) else v[:n])
                      for k, v in m.params["layers"].items()}
            return LoadedModel(hparams=hp, params={**m.params, "layers": layers}, reader=None,
                               vocab=m.vocab, quant_meta=m.quant_meta, device=m.device)

        g1, c1 = first_layers(gpu), first_layers(cpu)
        check(all(g1.hparams.swa_layers), "the first layers are SWA layers")
        cg1, err1, tol1, out1, s1 = pair_run(g1, c1, cp)
        check(cg1._S_swa == 0 and not isinstance(cg1.kv_k, dict),
              "the SWA layers alone keep one stack")
        rec["single_stack"] = {"layers": single_stack_layers, "cells": cg1._S,
                               "prefill_max_abs_err": err1, "tol": tol1, "prefill_s": s1,
                               "greedy_tokens": out1}
    emit({**rec, "seconds": time.perf_counter() - t0})
    del cpu
    return gpu


def top2_greedy(ctx, logits, n: int) -> tuple[list, list]:
    """greedy_continue's tokens with each step's top-2 logit gap."""
    toks, gaps = [], []
    for _ in range(n):
        top2 = np.partition(logits, -2)[-2:]
        gaps.append(float(top2[1] - top2[0]))
        toks.append(int(np.argmax(logits)))
        if ctx.model.vocab.is_eog(toks[-1]):
            break
        logits = ctx.decode(np.asarray([toks[-1]], np.int32))[-1]
    return toks, gaps


def phase_chunk_ring(gpu, card: str, phase: str = "llama4_ring", n_prompt: int = 8600,
                     n_ctx: int = 8704, n_ubatch: int = 256, n_greedy: int = 8) -> None:
    """llama4's chunked layers at the true chunk of n_swa = 8192 on the
    card, f32 activations and cache: one lane at n_ctx 8704, where the ring
    of 8192 + 256 + 1 cells stands beside the full stack; a prompt of
    n_prompt tokens in n_ubatch chunks passes position 8192 (a chunk start
    and the NoPE layers' first temperature step) and wraps the ring. Held
    against a swa_full Context (one stack of n_ctx cells under the chunked
    mask) on the same model and prompt: the last row's logits within 1e-3
    of their largest magnitude plus 1e-4, and n_greedy greedy tokens equal
    up to the first near-tie of the swa_full run (a top-2 gap below that
    tolerance); the ring's cells hold each position at its residue."""
    import torch

    from tpullama_torch.runtime import Context, ContextParams

    t0 = time.perf_counter()
    hp = gpu.hparams
    chunk = hp.n_swa
    check(hp.swa_type == "chunked", f"{hp.arch} has no chunked layers")
    sync = torch.cuda.synchronize if gpu.device.type == "cuda" else (lambda: None)
    prompt = gpu.vocab.tokenize(word_prompt(np.random.default_rng(4), n_prompt + 100),
                                add_special=True)
    prompt = np.asarray(prompt[:n_prompt], np.int32)
    ring = chunk + n_ubatch + 1
    check(len(prompt) == n_prompt and n_prompt > chunk and n_prompt > ring - 1,
          f"a prompt of {len(prompt)} tokens crosses {chunk} and wraps {ring - 1} cells")
    cp = ContextParams(n_ctx=n_ctx, n_ubatch=n_ubatch)
    cr = Context(gpu, cp)
    check(cr._S_swa == ring and isinstance(cr.kv_k, dict), f"a ring of {cr._S_swa} cells")
    t1 = time.perf_counter()
    lr = cr.decode(prompt, n_logits=1)
    sync()
    t_ring = time.perf_counter() - t1
    cells = cr.kv_pos["swa"][0].cpu().numpy()
    want = ring_positions([n_prompt], chunk, n_ubatch)[0]
    check(np.array_equal(cells, want), "the ring's cells do not hold each position at p % "
          f"{ring - 1}")
    full = Context(gpu, replace(cp, swa_full=True))
    check(not isinstance(full.kv_k, dict), "swa_full keeps one stack")
    t1 = time.perf_counter()
    lf = full.decode(prompt, n_logits=1)
    sync()
    t_full = time.perf_counter() - t1
    err = float(np.abs(lr - lf).max())
    tol = 1e-3 * float(np.abs(lf).max()) + 1e-4
    check(np.isfinite(lr).all() and err <= tol, f"ring against swa_full: err {err} > tol {tol}")
    out_r = greedy_continue(cr, lr[-1], n_greedy)
    out_f, gaps = top2_greedy(full, lf[-1], n_greedy)
    k = same_under_tie_rule(out_r, {"tokens": out_f, "gaps": gaps, "tol": tol},
                            "the ring's greedy tokens against swa_full's")
    emit({"phase": phase, "card": card, "prompt_tokens": n_prompt, "n_ctx": n_ctx,
          "chunk": chunk, "ring_cells": ring, "full_cells": cr._S,
          "prefill_s": {"ring": t_ring, "swa_full": t_full}, "last_logits_max_abs_err": err,
          "tol": tol, "greedy_tokens": out_r, "swa_full_greedy_tokens": out_f,
          "greedy_compared": k, "seconds": time.perf_counter() - t0})


def swa_memory(model, eng, card: str, phase: str) -> None:
    """The served Context's two stacks (memory_breakdown) beside a swa_full
    Context's one, at the same lanes, cells and dtype."""
    from tpullama_torch.runtime import Context

    two = eng.ctx.memory_breakdown()
    one = Context(model, replace(eng.ctx.p, swa_full=True)).memory_breakdown()
    check(two["kv_cache"] < one["kv_cache"]
          and two["kv_cache"] == two["kv_cache_full_layers"] + two["kv_cache_swa_layers"],
          f"the two stacks {two} are no smaller than swa_full's {one}")
    emit({"phase": phase, "card": card, "ring_cells": eng.ctx._S_swa, "full_cells": eng.ctx._S,
          "two_stacks": two, "swa_full": one, "kv_saved_bytes": one["kv_cache"] - two["kv_cache"]})


def phase_mxfp4_crosscheck(tmp: str, card: str, device: str = "cuda",
                           widths: Widths = MIXTRAL_8X7B_MXFP4, n_prompt: int = 32,
                           phase: str = "mxfp4_crosscheck") -> None:
    """One file with every matrix in MXFP4 (MIXTRAL_8X7B_MXFP4, 1 layer),
    written once, card against CPU in three card runs: the LUT planes as
    loaded, the A/r planes (load_model(mxfp4_ar=True)), and the LUT planes
    with 4 K-chunks (Context(qmm_tile_k=4): attention and the lm_head
    through qmm_ktiled). The CPU side loads the LUT planes once and
    dequantizes its matrices once (dense_reference, the experts
    too). Each run's prefill logits within 1e-3 of their max + 1e-4 of
    the CPU's and its 8 greedy tokens equal to the CPU's (f32 activations
    and cache), so the A/r and LUT card runs give the same tokens too: the
    re-code loses nothing. Every packed matrix is MXFP4, so each kernel the
    path launches ran an MXFP4 set: kernels 1-4 (qmm_gemv / qmm_tiled,
    qmm_ktiled, row-major qmm_gathered for [gate | up], transposed
    qmm_gathered_t for down)."""
    import torch

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams

    t0 = time.perf_counter()
    path = os.path.join(tmp, f"{phase}.gguf")
    write_llama_gguf(path, widths, seed=1)
    t1 = time.perf_counter()
    cpu = dense_reference(load_model(path, dtype=torch.float32, device="cpu", packed=True))
    cpu_load_s = time.perf_counter() - t1
    prompt = cpu.vocab.tokenize(word_prompt(np.random.default_rng(2), 40), add_special=True)
    prompt = np.asarray(prompt[:n_prompt], np.int32)
    check(len(prompt) == n_prompt, f"prompt has {len(prompt)} tokens")
    cp = ContextParams(n_ctx=256)
    cc = Context(cpu, cp)
    lc = cc.decode(prompt, n_logits=n_prompt)
    out_c = greedy_continue(cc, lc[-1], 8)
    tol = 1e-3 * float(np.abs(lc).max()) + 1e-4
    rec = {"phase": phase, "card": card, "layers": widths.n_layer, "prompt_tokens": n_prompt,
           "quant": widths.quant, "cpu_load_s": cpu_load_s, "tol": tol, "greedy_tokens": out_c,
           "load_s": {}, "runs": {}}
    gpu, loaded = None, None
    for run, ar, tile_k in (("lut", False, None), ("lut_tile_k4", False, 4), ("ar", True, None)):
        if loaded != ar:  # each set's planes loaded once
            gpu = None
            if device == "cuda":
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            gpu = load_model(path, dtype=torch.float32, device=device, packed=True, mxfp4_ar=ar)
            rec["load_s"]["ar" if ar else "lut"], loaded = time.perf_counter() - t1, ar
        lm = gpu.quant_meta["layers"]
        want = {"q4a", "q1r", "scale"} if ar else {"q4_lut", "scale"}
        check(all(m.ggml_type == GGMLType.MXFP4 for m in lm.values())
              and gpu.quant_meta["output"].ggml_type == GGMLType.MXFP4
              and all(set(gpu.params["layers"][k]) == want for k in lm)
              and set(gpu.params["output"]) == {"q4_lut", "scale"},
              f"{run}: every packed layer matrix MXFP4 in {sorted(want)}, the output's LUT")
        check(not lm["ffn_gateup_exps"].planes_t and lm["ffn_down_exps"].planes_t,
              f"{run}: [gate | up] row-major (128 scale columns), down transposed (448)")
        lg = Context(gpu, cp, qmm_tile_k=tile_k).decode(prompt, n_logits=n_prompt)
        err = float(np.abs(lg - lc).max())
        check(np.isfinite(lg).all() and err <= tol, f"{run}: prefill logits err {err} > {tol}")
        out_g = Context(gpu, cp, qmm_tile_k=tile_k).generate(prompt, n_predict=8)
        check(out_g == out_c, f"{run}: greedy tokens differ: card {out_g} cpu {out_c}")
        rec["runs"][run] = {"mxfp4_ar": ar, "qmm_tile_k": tile_k, "prefill_max_abs_err": err,
                            "greedy_tokens": out_g}
    del gpu
    os.remove(path)
    emit({**rec, "seconds": time.perf_counter() - t0})


def greedy_continue(ctx, logits, n: int) -> list:
    """Context.generate's greedy host loop from a Context that holds the
    prompt and its last logits: n tokens, stopping after an end-of-
    generation token."""
    out = []
    for _ in range(n):
        tok = int(np.argmax(logits))
        out.append(tok)
        if ctx.model.vocab.is_eog(tok):
            break
        logits = ctx.decode(np.asarray([tok], np.int32))[-1]
    return out


def same_params(a: dict, b: dict) -> bool:
    """Two parameter trees hold the same tensors, bit for bit."""
    import torch

    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(same_params(a[k], b[k]) for k in a))
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


# the cross-check's layouts, at Llama-3.2-1B's widths with an untied Q6_K
# output (LAYOUTS)
QUANT_CROSS = ("Q3_K_M", "Q2_K", "Q5_0_Q5_1", "Q4_0", "IQ4_XS")
# the vocabulary of the native-against-numpy load (phase_crosscheck's
# compare_native): the numpy codecs' load of Llama-3-8B's 128256-row token
# table and lm_head took 11 s on the card's host
NATIVE_CUT_VOCAB = 16384


def phase_quant_crosscheck(tmp: str, card: str, device: str = "cuda",
                           widths: Widths = replace(LLAMA32_1B, tied=False),
                           layouts: tuple = QUANT_CROSS, phase: str = "quant_crosscheck") -> None:
    """The cross-check (1 layer, card against CPU: prefill logits and
    greedy tokens) on a model of each layout; then the split loads and the
    CLI on the Q5_0/Q5_1 model (split_case, 1 layer)."""
    t0 = time.perf_counter()
    for layout in layouts:
        phase_crosscheck(tmp, replace(widths, quant=layout), device=device, n_layer=1,
                         phase=f"{phase}_{layout}")
    split_case(tmp, replace(widths, quant="Q5_0_Q5_1", n_layer=1), card, device=device,
               phase=f"{phase}_split")
    emit({"phase": phase, "layouts": list(layouts), "seconds": time.perf_counter() - t0})


def split_case(tmp: str, widths: Widths, card: str, device: str = "cuda",
               phase: str = "quant_crosscheck_split") -> None:
    """The model split into shards by the copied gguf-split tool, loaded
    three ways onto `device` (load_model_from_split_futures with the
    shards' bytes fulfilled from a second thread, the first shard's path,
    the whole file): the same parameters, bit for bit. Then the CLI on the
    first shard's path and on the whole file: the same text."""
    import io
    import threading

    import torch

    from tpullama_torch.gguf import fulfill_split_future
    from tpullama_torch.models import load_model
    from tpullama_torch.models.loader import load_model_from_split_futures
    from tpullama_torch.tools.cli import main as cli_main
    from tpullama_torch.tools.gguf_split import split_gguf

    t0 = time.perf_counter()
    whole = os.path.join(tmp, f"{phase}.gguf")
    write_llama_gguf(whole, widths, seed=6)
    shards = split_gguf(whole, os.path.join(tmp, phase), max_tensors=8)
    check(len(shards) > 1, f"{len(shards)} shard")
    kw = dict(dtype=torch.float32, device=device, packed=True)

    def feed():
        for q in shards:
            with open(q, "rb") as f:
                fulfill_split_future(q, phase, f.read())

    th = threading.Thread(target=feed)
    th.start()
    t1 = time.perf_counter()
    from_futures = load_model_from_split_futures(shards, phase, timeout=300, **kw)
    futures_s = time.perf_counter() - t1
    th.join()
    from_first = load_model(shards[0], **kw)
    from_whole = load_model(whole, **kw)
    check(same_params(from_futures.params, from_whole.params),
          "the split-future load differs from the whole file's")
    check(same_params(from_first.params, from_whole.params),
          "the first-shard load differs from the whole file's")
    check(from_futures.quant_meta == from_whole.quant_meta == from_first.quant_meta,
          "the three loads' packed metadata differ")
    del from_futures, from_first, from_whole
    prompt = word_prompt(np.random.default_rng(8), 60)
    texts = []
    for src in (shards[0], whole):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["-m", src, "-p", prompt, "-n", "8", "--temp", "0"]
                          + ([] if device == "cuda" else ["--device", device]))
        check(rc == 0, f"the CLI exited {rc} on {src}")
        texts.append(buf.getvalue())
    check(texts[0] == texts[1] and len(texts[0]) > len(prompt),
          f"the CLI's text from the first shard {texts[0][len(prompt):]!r} differs from the "
          f"whole file's {texts[1][len(prompt):]!r}")
    for q in shards + [whole]:
        os.remove(q)
    emit({"phase": phase, "card": card, "shards": len(shards), "futures_load_s": futures_s,
          "cli_text": texts[0][len(prompt):][:80], "seconds": time.perf_counter() - t0})


def phase_serve(model, card: str, phase: str = "serve", n_slots: int = 4,
                rerun_all: bool = False, n_ctx: int = 4096,
                lengths: tuple = (300, 550, 780, 1000), plain_greedy: bool = False,
                **engine_kw):
    """4 greedy requests (prompts of about `lengths` tokens) submitted
    together (concurrent on 4 slots, in turn
    on 1), then one seeded sampled request alone, then the first greedy
    request again on erased slots (with `rerun_all`, the 4 together again:
    for a model with dense projections, whose cuBLAS products are not
    batch-invariant, as the packed kernels are). With `plain_greedy`, each
    greedy request's tokens equal its own greedy loop on a one-lane Context
    up to that loop's first near-tie (greedy_gaps, same_under_tie_rule).
    Rates come from the Context's counters
    over each window: host clock around work that ends in a device-to-host
    copy of logits or ids. `engine_kw` goes to ServerEngine. Returns the
    engine and one prompt, for phase_serve_profile, and the 4 greedy
    requests' tokens."""
    import torch

    from tpullama_torch.runtime.sampling import SamplerChain
    from tpullama_torch.server import ServerEngine, Task

    def window(perf, before):
        now = (perf.n_prefill, perf.t_prefill_ms, perf.n_decode, perf.t_decode_ms)
        d = [a - b for a, b in zip(now, before)]
        return now, {"prefill_tokens": d[0], "prefill_tok_s": d[0] / d[1] * 1e3 if d[1] else None,
                     "decode_tokens": d[2], "decode_tok_s": d[2] / d[3] * 1e3 if d[3] else None}

    t0 = time.perf_counter()
    eng = ServerEngine(model, n_slots=n_slots, n_ctx=n_ctx, dtype=torch.bfloat16, **engine_kw)
    perf = eng.ctx.perf
    mark = (0, 0.0, 0, 0.0)
    rng = np.random.default_rng(3)
    prompts = [word_prompt(rng, n) for n in lengths]
    vocab = model.vocab
    t1 = time.perf_counter()
    tasks = [eng.submit(Task(prompt_tokens=vocab.tokenize(p, add_special=True), n_predict=32))
             for p in prompts]
    while not all(t.done.is_set() for t in tasks):
        eng.step()
    wall = time.perf_counter() - t1
    mark, concurrent = window(perf, mark)
    sampled = eng.complete(prompts[1], n_predict=32,
                           sampler=SamplerChain.from_params(seed=7, temp=0.8))
    mark, alone = window(perf, mark)
    for t in tasks + [sampled]:
        check(not t.error and t.stop_reason in ("length", "stop"),
              f"task {t.id}: error {t.error!r}, stop {t.stop_reason!r}")
    check(all(len(t.out_tokens) == 32 or t.stop_reason == "stop" for t in tasks),
          "a greedy request ended early without a stop")
    for s in range(n_slots):
        eng.slot_erase(s)
    if rerun_all:
        # dense projections run cuBLAS, whose sums depend on the rows a call
        # holds: the same 4 requests in the same batches give the same tokens
        again_all = [eng.submit(Task(prompt_tokens=t.prompt_tokens, n_predict=32))
                     for t in tasks]
        while not all(t.done.is_set() for t in again_all):
            eng.step()
        check([t.out_tokens for t in again_all] == [t.out_tokens for t in tasks],
              "the greedy requests run again gave other tokens")
        again = again_all[0]
    else:
        again = eng.complete(prompts[0], n_predict=32)
        check(again.out_tokens == tasks[0].out_tokens,
              "a greedy request run again gave other tokens")
    compared = None
    if plain_greedy:
        from tpullama_torch.runtime import ContextParams

        cp = ContextParams(n_ctx=n_ctx, n_ubatch=eng.n_ubatch, dtype=torch.bfloat16)
        compared = [same_under_tie_rule(t.out_tokens, greedy_gaps(model, t.prompt_tokens, 32, cp),
                                        f"served request {i} against its greedy loop")
                    for i, t in enumerate(tasks)]
    n_out = sum(len(t.out_tokens) for t in tasks)
    emit({"phase": phase, "card": card, "requests": len(tasks) + 2, "n_slots": n_slots,
          "n_ctx": n_ctx, "plain_greedy_compared": compared,
          **engine_kw, "prompt_tokens": [len(t.prompt_tokens) for t in tasks],
          "completion_tokens": [len(t.out_tokens) for t in tasks + [sampled, again]],
          "greedy4": {**concurrent, "wall_s": wall, "output_tok_s": n_out / wall,
                      "ttft_ms": [t.ttft_ms for t in tasks]},
          "sampled_alone": {**alone, "ttft_ms": sampled.ttft_ms},
          "sampled_text": sampled.out_text[:80], "seconds": time.perf_counter() - t0})
    return eng, prompts[3], [t.out_tokens for t in tasks]


def phase_serve_profile(eng, prompt: str, card: str, phase: str = "serve_profile",
                        step_kernels: tuple = (), qmm_counts: tuple | None = None,
                        gathered_routes: tuple = (), chunk_kernels: tuple = (),
                        idle_kernels: tuple = ()) -> None:
    """torch.profiler over the served engine's Context, whose lanes still
    hold the requests: one packed B x 256 prefill chunk and one decode
    step of all B lanes. Then one more decode step with every launch count
    at 0: each kernel of `step_kernels` must have launched once per layer.
    With `qmm_counts` = (gemv, tiled), that step must launch qmm_gemv gemv
    times and one more packed chunk qmm_tiled tiled times and qmm_gemv
    gemv - tiled times (a packed output on the chunk's last rows): every
    packed matrix of the model went through the kernels; each kernel of
    `chunk_kernels` must have launched once per layer in that chunk (it
    needs `qmm_counts`). None of `idle_kernels` may launch in the step, nor
    in that chunk. With `gathered_routes`
    (the gathered kernels' names), one eager decode step and one more
    packed chunk, each with the launch counts at 0 and the MoE layers'
    gathered calls recorded: the step must launch those kernels on one-row
    tiles and the chunk on 8-row tiles, each of them, and twice a layer in
    all ([gate | up] and down)."""
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    ctx = eng.ctx
    B = ctx.p.n_seqs
    chunk = eng.vocab.tokenize(prompt, add_special=False)[:256]

    def decode():
        return ctx.decode_batch(np.full(B, 100, np.int32), np.ones(B, bool))

    rec = {"phase": phase, "card": card,
           f"prefill_chunk_{B}x{len(chunk)}": profile_step(
               ctx, lambda: ctx.decode_multi([(s, chunk) for s in range(B)]), B * len(chunk), 2),
           f"decode_batch_b{B}": profile_step(ctx, decode, B, 8)}
    # the same step run eagerly (the step its graph captures), for
    # comparison: 2 steps, as the profiler's parse of an eager window's
    # host events takes seconds a step at thousands of launches
    ctx._run = ctx._step
    try:
        eager = profile_step(ctx, decode, B, 2)
    finally:
        del ctx._run
    rec[f"decode_batch_b{B}_eager"] = {k: eager[k] for k in (
        "wall_ms", "profiled_wall_ms", "device_busy_ms", "idle_share", "device_launches",
        "bound_ms", "dense_expert_ms", "dense_expert_share", "dense_expert_span_ms")
        if k in eager}
    replayed = rec[f"decode_batch_b{B}"]
    if replayed["bound_ms"] is None:
        # an MoE step's bound counts the experts its routing picked: take
        # the eager steps' (the next n_steps steps of the same lanes)
        replayed.update(bound_ms=eager["bound_ms"], bound_by=eager["bound_by"],
                        bound_from="the eager steps' routing")
    rec["graphs"] = graph_records(ctx)
    if ctx.device.type == "cuda":
        check(all(p.graph is not None for p in ctx._programs.values()),
              "a one-token step of the served Context did not run as a CUDA graph")
    reset_launch_counts()
    decode()
    rec["decode_step_launches"] = counts = launch_counts()
    if qmm_counts is not None:
        reset_launch_counts()
        ctx.decode_multi([(s, chunk) for s in range(B)])
        rec["prefill_chunk_launches"] = chunk_counts = launch_counts()
    if ctx.device.type == "cuda":
        rec["replay_event_ms"] = replay_ms(ctx._programs[(0, B, None)])
    routes = {}
    if gathered_routes:
        # the eager step: a replayed graph runs no Python to record
        for what, run in (("decode_step", decode),
                          ("prefill_chunk", lambda: ctx.decode_multi([(s, chunk)
                                                                      for s in range(B)]))):
            ctx._run = ctx._step
            try:
                with recorded_tiles([]) as calls:
                    reset_launch_counts()
                    run()
                    n = {k: launch_counts()[k] for k in gathered_routes}
            finally:
                del ctx._run
            routes[what] = {"launches": n, "calls": [list(c[0]) + [c[1], c[2]]
                                                     for c in sorted(set(calls))]}
            routes[what]["tile_t"] = sorted({c[1] for c in calls})
        rec["gathered_routes"] = routes
    emit({**rec, "seconds": time.perf_counter() - t0})
    n_layer = ctx.hp.n_layer
    if gathered_routes and ctx.device.type == "cuda":
        for what, tile_t in (("decode_step", 1), ("prefill_chunk", 8)):
            n = routes[what]["launches"]
            check(sum(n.values()) == 2 * n_layer and all(n.values())
                  and routes[what]["tile_t"] == [tile_t],
                  f"{what}: {gathered_routes} launched {n} times on tiles of "
                  f"{routes[what]['tile_t']} rows, not {2 * n_layer} in all on {tile_t}")
    for name in step_kernels:
        check(counts[name] == n_layer,
              f"a decode step launched {name} {counts[name]} times, not once per layer")
    for name in chunk_kernels:
        check(chunk_counts[name] == n_layer,
              f"a prefill chunk launched {name} {chunk_counts[name]} times, not once per layer")
    for name in idle_kernels:
        n_chunk = chunk_counts[name] if qmm_counts is not None else 0
        check(counts[name] == n_chunk == 0,
              f"a decode step launched {name} {counts[name]} times and a prefill chunk "
              f"{n_chunk}, not none")
    if qmm_counts is not None and ctx.device.type == "cuda":
        check(counts["qmm_gemv"] == qmm_counts[0],
              f"a decode step launched qmm_gemv {counts['qmm_gemv']} times, not {qmm_counts[0]}")
        check(chunk_counts["qmm_tiled"] == qmm_counts[1],
              f"a prefill chunk launched qmm_tiled {chunk_counts['qmm_tiled']} times, "
              f"not {qmm_counts[1]}")
        check(chunk_counts["qmm_gemv"] == qmm_counts[0] - qmm_counts[1],
              f"a prefill chunk launched qmm_gemv {chunk_counts['qmm_gemv']} times, "
              f"not {qmm_counts[0] - qmm_counts[1]} (the packed output)")


def replay_ms(prog, n: int = 8) -> float:
    """Card time of one replay of a step program's graph, from CUDA events
    around n back-to-back replays on the inputs its last step left (the
    active lanes move on by one cell a replay; the Context's host mirror
    does not follow, so this runs last on a Context that is not used
    again)."""
    import torch

    prog.graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        prog.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_records(ctx) -> list:
    """Each step program of a Context: its lanes, greedy or sampled, and its
    graph's capture seconds, reserved bytes and launches per replay."""
    return [{"lanes": [lo, hi], "sampled": spec is not None, "capture_s": p.capture_s,
             "pool_bytes": p.pool_bytes, "launches": p.launches}
            for (lo, hi, spec), p in ctx._programs.items()]


def eager_context(model, params, **opts):
    """A Context whose one-token steps run the private eager step (the step
    its graphs capture) instead of replaying a graph: the other side of the
    graphs check."""
    from tpullama_torch.runtime import Context

    class EagerContext(Context):
        def _run(self, prog):
            return self._step(prog)

    return EagerContext(model, params, **opts)


def phase_graphs(model, card: str, phase: str = "graphs", n_slots: int = 4, **opts) -> None:
    """Every one-token step of the served model replays a CUDA graph and
    gives what the eager step gives. Two Contexts over `model` (bf16, 512
    cells a lane; `opts`: the fused layer and K-chunks) prefill the same
    n_slots prompts; one replays its step programs' graphs, the other runs
    the eager step: 8 decode_batch steps with lane 1 inactive (n_slots >
    1), fed their own argmax, give equal logits (0 expected: the same
    kernels on the same inputs in the same order); a greedy
    decode_batch_burst of 8 equal ids, n_past and _pos_host. Then on
    one-lane Contexts: a greedy decode_burst of 16 equal ids; a sampled
    decode_burst (temp 0.9, top-k 40, top-p 0.95, min-p 0.05, seed 7) the
    same ids on a rerun from the seed; at temperature 1e-4 with top-k 1 the
    greedy ids."""
    import torch

    from tpullama_torch.runtime import Context, ContextParams
    from tpullama_torch.runtime.sampling import SamplerChain, as_device_spec

    t0 = time.perf_counter()
    vocab = model.vocab
    rng = np.random.default_rng(6)
    prompts = [vocab.tokenize(word_prompt(rng, 300), add_special=True)[:48 + 8 * i]
               for i in range(n_slots)]
    cp = ContextParams(n_ctx=512, n_seqs=n_slots, dtype=torch.bfloat16)
    g, e = Context(model, cp, **opts), eager_context(model, cp, **opts)
    lg = g.decode_multi(list(enumerate(prompts)))
    e.decode_multi(list(enumerate(prompts)))
    active = np.ones(n_slots, bool)
    active[1:2] = False
    tok = np.asarray([int(np.argmax(lg[s])) for s in range(n_slots)], np.int32)
    batch_err = 0.0
    for _ in range(8):
        a, b = g.decode_batch(tok, active), e.decode_batch(tok, active)
        check(np.isfinite(a[active]).all(), "replayed decode_batch logits are not finite")
        batch_err = max(batch_err, float(np.abs(a[active] - b[active]).max()))
        tok = np.argmax(a, axis=-1).astype(np.int32)
    ids_g = g.decode_batch_burst(tok, active, 8)
    ids_e = e.decode_batch_burst(tok, active, 8)
    check(np.array_equal(ids_g, ids_e), f"decode_batch_burst ids differ: {ids_g} vs {ids_e}")
    check(np.array_equal(g.n_past, e.n_past) and np.array_equal(g._pos_host, e._pos_host),
          "decode_batch_burst bookkeeping differs")
    check(batch_err == 0.0, f"replayed decode_batch logits differ from the eager step's by "
          f"{batch_err}")
    graphs = graph_records(g)
    del g, e
    cp1 = ContextParams(n_ctx=512, n_seqs=1, dtype=torch.bfloat16)
    g1, e1 = Context(model, cp1, **opts), eager_context(model, cp1, **opts)
    first = [int(np.argmax(c.decode(np.asarray(prompts[0], np.int32))[-1])) for c in (g1, e1)]
    check(first[0] == first[1], "prefill argmax differs")
    n0 = int(g1.n_past[0])
    greedy = g1.decode_burst(first[0], 16).tolist()
    check(greedy == e1.decode_burst(first[0], 16).tolist(), "greedy decode_burst ids differ")
    check(np.array_equal(g1._pos_host, e1._pos_host), "decode_burst bookkeeping differs")

    def burst(c, chain):
        c.rollback_to(n0)
        return c.decode_burst(first[0], 16, sampler_spec=as_device_spec(chain)).tolist()

    hot = SamplerChain.std(temp=0.9, seed=7)
    sampled = burst(g1, hot)
    check(burst(g1, hot) == sampled, "a sampled decode_burst rerun from its seed differs")
    sampled_eager = burst(e1, hot)
    check(burst(g1, SamplerChain.std(temp=1e-4, top_k=1)) == greedy,
          "decode_burst at temperature 1e-4, top-k 1 is not the greedy burst")
    graphs += graph_records(g1)
    if g1.device.type == "cuda":
        check(all(r["capture_s"] > 0 for r in graphs), "a step program was not captured")
    emit({"phase": phase, "card": card, "lanes": n_slots, **opts,
          "decode_batch_max_abs_diff": batch_err, "batch_burst_ids": ids_g[:, 0].tolist(),
          "greedy_burst": greedy, "sampled_burst": sampled,
          "sampled_equals_eager": sampled == sampled_eager, "graphs": graphs,
          "seconds": time.perf_counter() - t0})


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def http_call(base: str, path: str, body=None, stream: bool = False):
    """One request to the server at `base`: (seconds to the first byte of
    the body, seconds to its end, the parsed body). A streamed body comes
    back as its list of SSE events' JSON (without the final [DONE])."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        ctype = r.headers.get("Content-Type", "")
        if not stream:
            raw = r.read()
            t = time.perf_counter() - t0
            return t, t, json.loads(raw) if ctype.startswith("application/json") else raw.decode()
        events, t_first = [], None
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[6:])
            if t_first is None and ev["choices"][0].get("text", ev["choices"][0].get(
                    "delta", {}).get("content")):
                t_first = time.perf_counter() - t0
            events.append(ev)
        return t_first, time.perf_counter() - t0, events


def http_error(base: str, path: str, body) -> tuple[int, dict]:
    """A request expected to fail: (HTTP status, the parsed JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# a JSON schema of one string and one integer: the grammar-constrained
# requests of the cli and http phases
SCHEMA = {"type": "object", "properties": {"name": {"type": "string"},
                                           "count": {"type": "integer"}},
          "required": ["name", "count"]}
# a small GBNF grammar over words and a full stop
WORDS_GBNF = ('root ::= word (" " word)* "."\n'
              'word ::= "the" | "a" | "model" | "token" | "cache" | "card" | "stream"')


def phase_http(model, card: str, phase: str = "http") -> None:
    """The Llama model served over HTTP by tpullama_torch.server.http.serve
    with the JAX package's defaults (an f32 engine: f32 KV cache), 4 slots
    of 4096 cells: 4 streamed greedy /v1/completions sent together
    (302-1002 prompt tokens, 32 out each), then request 0 again, plain,
    on erased slots (the same text), one chat request streamed and plain
    (the deltas concatenate to the plain text), the same chat with a
    JSON-schema response_format, 4 tokens, streamed and plain (equal
    text, which the schema's grammar accepts), /v1/embeddings of 4 inputs twice (unit
    norm, equal, and equal to Context.embeddings called directly), /rerank
    (501, naming its ROADMAP.md item), and /health, /metrics, /slots. TTFT
    is the client's time to the first streamed text, output tok/s the 4
    requests' tokens (the server's tokens_predicted_total) over their wall
    time."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tpullama_torch.runtime import Context, ContextParams
    from tpullama_torch.server.http import _make_grammar, serve

    t0 = time.perf_counter()
    httpd = serve(model, port=free_port(), n_slots=4, n_ctx=4096, block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        check(http_call(base, "/health")[2] == {"status": "ok"}, "/health")
        rng = np.random.default_rng(3)
        prompts = [word_prompt(rng, n) for n in (300, 550, 780, 1000)]

        def predicted() -> int:
            text = http_call(base, "/metrics")[2]
            return int(next(ln.split()[1] for ln in text.splitlines()
                            if ln.startswith("llamacpp:tokens_predicted_total")))

        def erase_all() -> None:
            for sid in range(4):
                http_call(base, f"/slots/{sid}?action=erase", {})

        n0 = predicted()
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            runs = list(ex.map(lambda p: http_call(
                base, "/v1/completions",
                {"prompt": p, "max_tokens": 32, "temperature": 0, "stream": True},
                stream=True), prompts))
        wall = time.perf_counter() - t1
        n_out = predicted() - n0
        texts = ["".join(ev["choices"][0]["text"] for ev in events) for _, _, events in runs]
        finish = [events[-1]["choices"][0]["finish_reason"] for _, _, events in runs]
        check(all(f in ("length", "stop") for f in finish) and n_out > 0,
              f"finish reasons {finish}, {n_out} tokens")
        check(n_out == 4 * 32 or "stop" in finish, "a greedy request ended early without a stop")
        erase_all()
        again = http_call(base, "/v1/completions",
                          {"prompt": prompts[0], "max_tokens": 32, "temperature": 0})[2]
        check(again["choices"][0]["text"] == texts[0],
              "a greedy request run again over HTTP gave another text")
        check(again["usage"]["completion_tokens"] == 32 or again["choices"][0][
            "finish_reason"] == "stop", "a greedy request ended early without a stop")
        chat = {"messages": [{"role": "user", "content": prompts[1][:400]}], "max_tokens": 24,
                "temperature": 0}
        erase_all()
        _, _, plain = http_call(base, "/v1/chat/completions", chat)
        erase_all()
        _, _, events = http_call(base, "/v1/chat/completions", {**chat, "stream": True},
                                 stream=True)
        streamed = "".join(ev["choices"][0]["delta"].get("content", "") for ev in events)
        check(streamed == plain["choices"][0]["message"]["content"],
              "the streamed chat deltas differ from the plain chat text")
        rf_chat = {**chat, "max_tokens": 4, "response_format": {
            "type": "json_schema", "json_schema": {"schema": SCHEMA}}}
        erase_all()
        t1 = time.perf_counter()
        _, _, rf_plain = http_call(base, "/v1/chat/completions", rf_chat)
        rf_s = time.perf_counter() - t1
        erase_all()
        _, _, rf_events = http_call(base, "/v1/chat/completions", {**rf_chat, "stream": True},
                                    stream=True)
        rf_text = rf_plain["choices"][0]["message"]["content"]
        check(rf_text and rf_text == "".join(ev["choices"][0]["delta"].get("content", "")
                                             for ev in rf_events),
              f"the JSON-schema chat texts differ or are empty: {rf_text!r}")
        try:
            _make_grammar(rf_chat, None).accept_str(rf_text)
        except ValueError as e:
            raise RuntimeError(f"chip_smoke check failed: the schema's grammar refuses "
                               f"{rf_text!r}: {e}") from e
        inputs = [p[:200] for p in prompts]
        t1 = time.perf_counter()
        emb = http_call(base, "/v1/embeddings", {"input": inputs})[2]
        emb_s = time.perf_counter() - t1
        emb_again = http_call(base, "/v1/embeddings", {"input": inputs})[2]
        vecs = np.asarray([d["embedding"] for d in emb["data"]], np.float32)
        check(vecs.shape == (4, model.hparams.n_embd) and np.isfinite(vecs).all()
              and np.abs(np.linalg.norm(vecs, axis=1) - 1).max() < 1e-4,
              f"/v1/embeddings: shape {vecs.shape}, norms {np.linalg.norm(vecs, axis=1)}")
        check(np.array_equal(vecs, np.asarray([d["embedding"] for d in emb_again["data"]],
                                              np.float32)),
              "/v1/embeddings differ on a rerun")
        direct = Context(model, ContextParams(n_ctx=4096))
        want = np.stack([direct.embeddings(model.vocab.tokenize(t, add_special=True))
                         for t in inputs])
        del direct
        if model.device.type == "cuda":
            torch.cuda.empty_cache()
        emb_err = float(np.abs(vecs - want).max())
        check(emb_err <= 1e-3, f"/v1/embeddings differ from Context.embeddings by {emb_err}")
        code, err = http_error(base, "/rerank", {"query": "q", "documents": ["a"]})
        check(code == 501 and "Queue 1 item 7" in err["error"]["message"],
              f"/rerank answered {code} {err}")
        slots = http_call(base, "/slots")[2]
        check(len(slots) == 4 and all(sl["state"] == "idle" for sl in slots), f"/slots {slots}")
        metrics = http_call(base, "/metrics")[2]
    finally:
        httpd.shutdown()
        httpd.engine.stop()
        httpd.server_close()
    emit({"phase": phase, "card": card, "engine": "serve's default: f32 KV cache; bf16 packed model",
          "n_slots": 4, "n_ctx": 4096, "completion_tokens": n_out, "wall_s": wall,
          "output_tok_s": n_out / wall,
          "ttft_ms": [None if r[0] is None else r[0] * 1e3 for r in runs],
          "request_s": [r[1] for r in runs], "chat_tokens": plain["usage"]["completion_tokens"],
          "json_schema_chat": {"text": rf_text[:80],
                               "tokens": rf_plain["usage"]["completion_tokens"],
                               "plain_s": rf_s},
          "embeddings": {"inputs": len(inputs), "ms_per_input": emb_s / len(inputs) * 1e3,
                         "max_abs_err_vs_context": emb_err},
          "rerank": code,
          "metrics": [ln for ln in metrics.splitlines() if not ln.startswith("#")],
          "text0": texts[0][:60], "seconds": time.perf_counter() - t0})


def phase_cli(tmp: str, card: str, phase: str = "cli", widths: Widths = LLAMA3_8B,
              device: str = "cuda") -> dict:
    """tpullama_torch.tools.cli.main on a 2-layer GGUF at Llama-3-8B's
    widths with the CLI's defaults (dense weights, --dtype bfloat16), 16
    greedy tokens, on `device` (the card; its launches are this path's)
    and then with --device cpu (the plain versions): the same printed
    text. Every matrix is Q8_0, which the loader dequantizes on the host
    several times faster than Q4_K/Q6_K (the CLI loads dense: the
    quantization type does not reach the card). Then --grammar (a GBNF
    grammar over words and a full stop) and --json-schema (SCHEMA), 1
    token each at --temp 0 --seed 7 (a grammar makes a seeded sampler
    chain), on the card and with --device cpu: the same text, which the
    grammar accepts, and the host's ms per token in Grammar.apply. Returns
    the first run's launch counts."""
    import io

    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts
    from tpullama_torch.tools.cli import main as cli_main

    t0 = time.perf_counter()
    path = os.path.join(tmp, f"{phase}.gguf")
    write_llama_gguf(path, replace(widths, n_layer=2, q8=True), seed=4)
    prompt = word_prompt(np.random.default_rng(5), 120)
    argv = ["-m", path, "-p", prompt, "-n", "16", "--temp", "0"]
    outs, secs = [], []
    runs = ((device, "16"), (device, "1"), ("cpu", "16"))
    for i, (dev, burst) in enumerate(runs):
        buf = io.StringIO()
        t1 = time.perf_counter()
        if i == 0:
            reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv + ["--burst", burst] + ([] if dev == "cuda" else
                                                       ["--device", dev]))
        if i == 0:
            counts = launch_counts()
            emit({"phase": f"{phase}_launches", "launches": counts})
        secs.append(time.perf_counter() - t1)
        check(rc == 0, f"the CLI exited {rc} on {dev}")
        outs.append(buf.getvalue())
    if device == "cuda":
        for name in PATH_KERNELS[phase]:
            check(counts[name] > 0, f"kernel {name} was not launched on the {phase} path")
    check(outs[0].startswith(prompt) and len(outs[0]) > len(prompt) + 1,
          "the CLI printed no generated text")
    for (dev, burst), out in zip(runs[1:], outs[1:]):
        check(outs[0] == out, f"{device} --burst 16 and {dev} --burst {burst} CLI text differ: "
              f"{outs[0][len(prompt):]!r} vs {out[len(prompt):]!r}")
    from tpullama_torch.runtime.grammar import Grammar
    from tpullama_torch.runtime.json_schema import json_schema_to_gbnf

    constrained = {}
    for name, flags, g_text in (
            ("grammar", ["--grammar", WORDS_GBNF], WORDS_GBNF),
            ("json_schema", ["--json-schema", json.dumps(SCHEMA)], json_schema_to_gbnf(SCHEMA))):
        texts, apply_s = [], []
        for dev in (device, "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), timed_method(Grammar, "apply", apply_s):
                rc = cli_main(["-m", path, "-p", prompt, "-n", "1", "--temp", "0", "--seed", "7",
                               *flags] + ([] if dev == "cuda" else ["--device", dev]))
            check(rc == 0, f"the CLI exited {rc} on {dev} with --{name}")
            texts.append(buf.getvalue()[len(prompt):].rstrip("\n"))
        check(texts[0] == texts[1] and texts[0] != "",
              f"--{name}: {device} and cpu CLI text differ: {texts[0]!r} vs {texts[1]!r}")
        try:
            Grammar.from_gbnf(g_text).accept_str(texts[0])
        except ValueError as e:
            raise RuntimeError(f"chip_smoke check failed: --{name} printed {texts[0]!r}, which "
                               f"its grammar refuses: {e}") from e
        constrained[name] = {"text": texts[0][:80],
                             "grammar_host_ms_per_token": sum(apply_s) / len(apply_s) * 1e3,
                             "tokens": len(apply_s) // 2}
    os.remove(path)
    emit({"phase": phase, "card": card, "layers": 2, "dtype": "bfloat16", "new_tokens": 16,
          "text": outs[0][len(prompt):][:80], "burst16_s": secs[0], "burst1_s": secs[1],
          "cpu_s": secs[2], "constrained": constrained, "seconds": time.perf_counter() - t0})
    return counts


@contextlib.contextmanager
def timed_method(cls, name: str, log: list, launches: bool = False):
    """Append to `log` the host seconds of every call of cls.name made
    inside the block; with `launches`, as (seconds, the kernel launches the
    call added) pairs."""
    from tpullama_torch.ops.cuda import launch_counts

    orig = getattr(cls, name)

    def timed(self, *args, **kw):
        before = launch_counts() if launches else None
        t0 = time.perf_counter()
        out = orig(self, *args, **kw)
        dt = time.perf_counter() - t0
        if launches:
            after = launch_counts()
            log.append((dt, {k: after[k] - v for k, v in before.items() if after[k] != v}))
        else:
            log.append(dt)
        return out

    setattr(cls, name, timed)
    try:
        yield log
    finally:
        setattr(cls, name, orig)


HUGE = (1 << 30) - 1  # Speculative.gen_draft's upper bound for seq_add


def greedy_gaps(model, prompt_tokens, n: int, params) -> dict:
    """Context.generate's greedy loop on one lane (one-token steps, each a
    replayed graph on the card): its tokens, each step's top-2 logit gap,
    and the near-tie tolerance. A verify step reads its logits off another
    route (one prefill, qmm_tiled and flash_attention, against qmm_gemv and
    flash_decode), so the tolerance is the larger of the cross-check's
    formula (1e-3 of the prefill logits' largest |value| + 1e-4) and the
    largest difference between this loop's logits and those of one
    prefill over the same tokens (`route_diff`)."""
    from tpullama_torch.runtime import Context

    ctx = Context(model, params)
    logits = ctx.decode(np.asarray(prompt_tokens, np.int32))[-1]
    tol = 1e-3 * float(np.abs(logits).max()) + 1e-4
    toks, gaps, rows = [], [], []
    for _ in range(n):
        tok = int(np.argmax(logits))
        if model.vocab.is_eog(tok):  # the engine does not emit it
            break
        top2 = np.partition(logits, -2)[-2:]
        gaps.append(float(top2[1] - top2[0]))
        toks.append(tok)
        rows.append(logits)
        logits = ctx.decode(np.asarray([tok], np.int32))[-1]
    del ctx
    pf = Context(model, params).decode(np.asarray(list(prompt_tokens) + toks[:-1], np.int32),
                                       n_logits=len(toks))
    route_diff = float(np.abs(np.stack(rows) - pf).max())
    return {"tokens": toks, "gaps": gaps, "formula_tol": tol, "route_diff": route_diff,
            "tol": max(tol, route_diff)}


def same_under_tie_rule(got: list, ref: dict, what: str, want: list | None = None) -> int:
    """Check got's first tokens against the greedy loop's (`ref`, from
    greedy_gaps; or `want` under ref's gaps), up to its first near-tie (a
    step whose top-2 gap is below ref's tolerance, where the other route's
    rounding may flip the argmax); return how many were compared."""
    want = ref["tokens"] if want is None else want
    k = next((i for i, g in enumerate(ref["gaps"]) if g < ref["tol"]), len(ref["gaps"]))
    check(got[:k] == want[:k], f"{what}: tokens differ before the first near-tie ({k}): "
          f"{got[:k]} vs {want[:k]}; gaps {ref['gaps'][:k + 1]}, tol {ref['tol']}")
    return k


def seq_ops_case(gpu, cpu, prompt) -> dict:
    """seq_rm + seq_add (to 2**30 - 1) and seq_div on lane 0 of 2 (bf16
    cache) on the card (`gpu`'s device) and on the CPU port, over the
    cross-check's two models: K rows within bf16 rounding (2**-7 of the
    largest |K|), positions and n_past exactly, lane 1 untouched. Then on
    one lane a step that replays its graph, seq_add, and the next replayed
    step: the logits an eager Context gives, bit for bit (the card
    alone)."""
    import torch

    from tpullama_torch.runtime import Context, ContextParams

    cp = ContextParams(n_ctx=256, n_seqs=2, dtype=torch.bfloat16)
    g, c = Context(gpu, cp), Context(cpu, cp)
    for ctx in (g, c):
        ctx.decode(np.asarray(prompt, np.int32), seq_id=0)
    g.decode(np.asarray(prompt[:16], np.int32), seq_id=1)
    lane1 = [t[:, 1].clone() for t in (g.kv_k, g.kv_v)]
    t0 = time.perf_counter()
    g.seq_rm(0, 4)
    g.seq_add(4, HUGE, -4)
    g.seq_div(8, 24, 2)
    g.kv_k.cpu()  # waits for the card
    ops_ms = (time.perf_counter() - t0) * 1e3
    c.seq_rm(0, 4)
    c.seq_add(4, HUGE, -4)
    c.seq_div(8, 24, 2)
    kc = c.kv_k[:, 0].float()
    k_err = float((g.kv_k[:, 0].float().cpu() - kc).abs().max())
    k_tol = 2.0 ** -7 * float(kc.abs().max())
    check(k_err <= k_tol, f"seq ops: K rows differ by {k_err} > {k_tol}")
    check(torch.equal(g.kv_pos[0].cpu(), c.kv_pos[0])
          and np.array_equal(g._pos_host[0], c._pos_host[0]) and g.n_past[0] == c.n_past[0],
          "seq ops: positions differ")
    check(all(torch.equal(a, t[:, 1]) for a, t in zip(lane1, (g.kv_k, g.kv_v))),
          "seq ops changed the other lane")
    del g, c
    cp1 = ContextParams(n_ctx=256)
    g, e = Context(gpu, cp1), eager_context(gpu, cp1)
    for ctx in (g, e):
        ctx.decode(np.asarray(prompt, np.int32))
        ctx.decode(np.asarray([100], np.int32))
    check(gpu.device.type != "cuda" or g._programs[(0, 1, None)].graph is not None,
          "the lane's step was not captured")
    replay_diff = 0.0
    for i in range(3):
        for ctx in (g, e):
            ctx.seq_add(2 + i, HUGE, -1)
        lg, le = (ctx.decode(np.asarray([101 + i], np.int32)) for ctx in (g, e))
        check(np.isfinite(lg).all(), "logits after seq_add are not finite")
        replay_diff = max(replay_diff, float(np.abs(lg - le).max()))
    check(replay_diff == 0.0, f"a replay after seq_add differs from the eager step by "
          f"{replay_diff}")
    return {"k_max_abs_err": k_err, "k_tol": k_tol, "ops_ms": ops_ms,
            "replay_vs_eager_max_abs_diff": replay_diff}


def f32_activations(model):
    """The same packed weights with an f32 token table, so the activations
    run in f32 (the packed matmuls take f32 x)."""
    return replace(model, params={**model.params, "tok_embd": model.params["tok_embd"].float()})


def served_spec(model, draft, prompts: list, serve_tokens=None, n_tokens: int = 8) -> dict:
    """ServerEngine(n_slots=4, n_ctx=4096, bf16 cache, 16 drafts a round,
    p_min 0) with `draft` answers the 4 greedy `prompts` with n_tokens each
    (8: the random draft's rounds accept no token, so each round yields
    one, and the whole run's time limit is shared): each lane's tokens are
    its plain greedy loop's (and `serve_tokens`' first ones, if given)
    under the near-tie rule; output tok/s, drafts and acceptance, and one
    round's wall split into drafting and verifying with the kernels each
    part launched."""
    import torch

    from tpullama_torch.runtime import ContextParams
    from tpullama_torch.runtime.speculative import Speculative, SpeculativeParams
    from tpullama_torch.server import ServerEngine, Task

    refs = [greedy_gaps(model, p, n_tokens, ContextParams(n_ctx=4096, dtype=torch.bfloat16))
            for p in prompts]
    eng = ServerEngine(model, n_slots=4, n_ctx=4096, dtype=torch.bfloat16, draft_model=draft,
                       spec_params=SpeculativeParams(n_draft=16, p_min=0.0))
    rounds, drafting = [], []
    with timed_method(ServerEngine, "_spec_step", rounds, launches=True), \
            timed_method(Speculative, "gen_draft", drafting, launches=True):
        t1 = time.perf_counter()
        tasks = [eng.submit(Task(prompt_tokens=p, n_predict=n_tokens)) for p in prompts]
        while not all(t.done.is_set() for t in tasks):
            eng.step()
        wall = time.perf_counter() - t1
    compared, common = [], []
    for i, (t, ref) in enumerate(zip(tasks, refs)):
        check(not t.error, f"spec request {i}: {t.error}")
        compared.append(same_under_tie_rule(t.out_tokens, ref, f"served spec request {i}"))
        common.append(common_prefix(t.out_tokens, ref["tokens"]))
        if serve_tokens is not None:
            same_under_tie_rule(t.out_tokens, ref, f"served spec request {i} against the "
                                "serve phase", want=serve_tokens[i])

    def launches(log):
        out: dict = {}
        for _, c in log:
            for name, n in c.items():
                out[name] = out.get(name, 0) + n
        return out

    draft_l = launches(drafting)
    verify = {n: v - draft_l.get(n, 0) for n, v in launches(rounds).items()}
    for part, names, counts in (("verify", ("qmm_tiled", "flash_attention"), verify),
                                ("drafting", ("qmm_gemv", "flash_decode"), draft_l)):
        for name in names:  # the wrappers count launches on a card only
            check(model.device.type != "cuda" or counts.get(name, 0) > 0,
                  f"{part} launched no {name}")
    m = eng.metrics
    n_out = sum(len(t.out_tokens) for t in tasks)
    round_ms = sum(dt for dt, _ in rounds) / len(rounds) * 1e3
    draft_ms = sum(dt for dt, _ in drafting) / len(drafting) * 1e3
    return {
        "activations": str(model.params["tok_embd"].dtype).split(".")[-1],
        "n_slots": 4, "n_draft": 16, "p_min": 0.0, "wall_s": wall, "output_tok_s": n_out / wall,
        "completion_tokens": [len(t.out_tokens) for t in tasks],
        "compared": compared, "common_prefix": common,
        "tie_tol": [r["tol"] for r in refs], "route_diff": [r["route_diff"] for r in refs],
        "n_drafted": m["n_drafted"], "n_draft_accepted": m["n_draft_accepted"],
        "acceptance": m["n_draft_accepted"] / m["n_drafted"] if m["n_drafted"] else 0.0,
        "rounds": len(rounds), "round_ms": round_ms, "draft_ms": draft_ms,
        "verify_ms": round_ms - draft_ms, "verify_launches": verify,
        "draft_launches": draft_l}


def common_prefix(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def phase_spec(model, tmp: str, card: str, serve_tokens=None, phase: str = "spec",
               draft_widths: Widths = LLAMA32_1B) -> None:
    """Speculative decoding on the Llama model (`model`).
      - Self-draft: generate_speculative with the model as its own draft
        (f32 caches, 16 drafts a round, no confidence gate), 32 tokens: the
        tokens of Context.generate's greedy loop under the near-tie rule,
        and the acceptance: at least 0.5 (about 1 expected) with f32
        activations over the same packed weights; printed for the bf16
        model, whose routes' rounding makes near-ties of random weights'
        close logits.
      - Served: a draft at Llama-3.2-1B's published widths (LLAMA32_1B,
        8 of 16 layers, Q4_K, written and loaded here) drafts for
        ServerEngine(n_slots=4, n_ctx=4096, bf16, 16 drafts, p_min 0: random
        weights never reach the 0.75 gate, and without drafts verify would
        never run above T = 1) on the serve phase's 4 greedy requests, 8
        tokens each (served_spec), with the bf16 models (the numbers; the tokens
        under the rule, whose measured route difference leaves few to
        compare) and again with f32 activations (the tokens: verify
        (qmm_tiled, flash_attention) and drafting (qmm_gemv,
        flash_decode) must each launch their kernels).
      - Over HTTP: serve(draft_model=) answers a greedy completion and
        /metrics shows the draft counters.
    A smaller `draft_widths` rehearses it on the CPU."""
    import torch

    from tpullama_torch.runtime import Context, ContextParams
    from tpullama_torch.runtime.speculative import (Speculative, SpeculativeParams,
                                                    generate_speculative)
    from tpullama_torch.server.http import serve

    t0 = time.perf_counter()
    vocab = model.vocab
    rec = {"phase": phase, "card": card}
    # self-draft, with f32 activations over the same packed weights (an f32
    # token table): the one-token route and verify's prefill route then
    # agree to ~1e-5, so only true near-ties reject a draft. The bf16
    # model's run follows, its acceptance bounded by the near-ties that
    # bf16 rounding between the two routes makes among random weights'
    # close logits: checked for its tokens, its acceptance printed.
    prompt = vocab.tokenize(word_prompt(np.random.default_rng(8), 300), add_special=True)
    cp = ContextParams(n_ctx=1024)
    f32_model = f32_activations(model)
    for name, m in (("self_draft", f32_model), ("self_draft_bf16", model)):
        ref = greedy_gaps(m, prompt, 32, cp)
        spec = Speculative(m, SpeculativeParams(n_draft=16, p_min=0.0), n_ctx=1024)
        t1 = time.perf_counter()
        got, stats = generate_speculative(Context(m, cp), spec, prompt, n_predict=32)
        self_s = time.perf_counter() - t1
        k = same_under_tie_rule(got, ref, name)
        check(stats["n_drafted"] > 0, f"{name} drafted nothing")
        if m is f32_model:
            check(stats["accept_rate"] >= 0.5, f"{name} acceptance {stats}")
        rec[name] = {**stats, "tokens": len(got), "compared": k,
                     "common_prefix": common_prefix(got, ref["tokens"]),
                     "tie_tol": ref["tol"], "formula_tol": ref["formula_tol"],
                     "route_diff": ref["route_diff"], "min_gap": min(ref["gaps"]),
                     "near_ties": sum(g < ref["tol"] for g in ref["gaps"]),
                     "first_near_tie": k if k < len(ref["gaps"]) else None,
                     "seconds": self_s}
        del spec
    del f32_model
    free = torch.cuda.empty_cache if model.device.type == "cuda" else (lambda: None)
    free()
    # served, with the 1B draft
    draft = phase_model(tmp, draft_widths, device=model.device.type, phase="spec_model")
    rng = np.random.default_rng(3)
    prompts = [vocab.tokenize(word_prompt(rng, n), add_special=True) for n in (300, 550, 780, 1000)]
    rec["served"] = served_spec(model, draft, prompts, serve_tokens)
    free()
    rec["served_f32"] = served_spec(f32_activations(model), f32_activations(draft), prompts)
    free()
    # over HTTP
    httpd = serve(model, port=free_port(), n_slots=1, n_ctx=4096, block=False, draft_model=draft,
                  spec_params=SpeculativeParams(n_draft=16, p_min=0.0))
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = http_call(base, "/v1/completions", {"prompt": word_prompt(rng, 200),
                                                  "max_tokens": 16, "temperature": 0})[2]
        metrics = http_call(base, "/metrics")[2]
    finally:
        httpd.shutdown()
        httpd.engine.stop()
        httpd.server_close()
    counters = {ln.split()[0]: float(ln.split()[1]) for ln in metrics.splitlines()
                if ln.startswith("llamacpp:draft_tokens")}
    check(out["choices"][0]["text"] and counters.get("llamacpp:draft_tokens_total", 0) > 0,
          f"serve(draft_model=): text {out['choices'][0]['text']!r}, counters {counters}")
    rec["http"] = {"completion_tokens": out["usage"]["completion_tokens"],
                   "draft_counters": counters}
    del draft
    free()
    emit({**rec, "seconds": time.perf_counter() - t0})


@contextlib.contextmanager
def recorded_tiles(log: list):
    """Append the (field set, tile_t, planes_t) of every gathered product
    the MoE layers call inside the block to `log`."""
    from tpullama_torch.ops import moe

    gathered = moe.quantized_matmul_gathered

    def recording(x, fields, sel, *args, tile_t=1, planes_t=False, **kw):
        log.append((tuple(sorted(fields)), tile_t, planes_t))
        return gathered(x, fields, sel, *args, tile_t=tile_t, planes_t=planes_t, **kw)

    moe.quantized_matmul_gathered = recording
    try:
        yield log
    finally:
        moe.quantized_matmul_gathered = gathered


@contextlib.contextmanager
def recorded_routing(log: list):
    """Append the (B, T, k) expert ids of every MoE router call made inside
    the block to `log` (left on the card)."""
    from tpullama_torch.ops import moe

    route = moe.route

    def recording(*args, **kw):
        sel, weights = route(*args, **kw)
        log.append(sel)
        return sel, weights

    moe.route = recording
    try:
        yield log
    finally:
        moe.route = route


DENSE_EXPERTS = "dense_expert_branch"


@contextlib.contextmanager
def labelled_dense_experts():
    """Label every call of the dense expert branch (ops/moe._ffn_dense)
    inside the block as DENSE_EXPERTS for torch.profiler, which sums the
    card time of the kernels launched under it."""
    from torch.profiler import record_function

    from tpullama_torch.ops import moe

    dense = moe._ffn_dense

    def labelled(*args, **kw):
        with record_function(DENSE_EXPERTS):
            return dense(*args, **kw)

    moe._ffn_dense = labelled
    try:
        yield
    finally:
        moe._ffn_dense = dense


def step_bound(ctx, rows: int, kv_cells: int, routing: list, n_steps: int) -> tuple[float, str]:
    """Least card time of one forward step over `rows` new tokens of a
    Context on a packed model: every packed weight plane, every dense layer
    matrix and each of the kv_cells K/V rows the cache holds read once, and
    2 * rows * N * K operations over the layer matrices plus 2 * N * K per
    lane for the lm_head, at the bf16 peak. An MoE layer counts only the experts its
    routing selected (`routing`: the (B, T, k) expert ids the router chose
    over n_steps steps, layer after layer), each expert's planes once (a
    heterogeneous stack's layer_list: its dense matrices), and its
    experts' operations over rows * k (dense (L, E, rows, cols) expert
    stacks, gpt-oss's: the picked experts' bf16 rows). A two-stack cache's
    SWA layers read the ring's cells inside each lane's window. Norms,
    rope, biases, the router and attention's own operations are left out,
    so this is a lower bound."""
    model = ctx.model
    hp = model.hparams
    p = model.params
    out = p.get("output", p["tok_embd"])  # a tied model's lm_head: the token table
    if isinstance(out, dict):
        m = model.quant_meta["output"]
        n_bytes = sum(nbytes(a) for a in out.values())
        flops = 2.0 * ctx.p.n_seqs * m.n_out * m.n_in
    else:  # a dense lm_head
        n_bytes = nbytes(out)
        flops = 2.0 * ctx.p.n_seqs * out.numel()

    def cell_bytes(cache):
        # one cell's K or V rows of every layer of a stack (an int8 cache:
        # its int8 rows and f32 scales)
        return sum(nbytes(t[:, 0, :, 0]) for t in (cache if isinstance(cache, tuple)
                                                    else (cache,)))

    if isinstance(ctx.kv_k, dict):
        ring = ctx.kv_pos["swa"].cpu().numpy()
        # the cells a lane's window (or llama4's chunk) shows its next token
        lo = ((ctx.n_past // hp.n_swa * hp.n_swa if hp.swa_type == "chunked"
               else ctx.n_past - hp.n_swa)[:, None])
        ring_cells = int(((ring >= 0) & (ring >= lo)).sum())
        n_bytes += 2 * (kv_cells * cell_bytes(ctx.kv_k["full"])
                        + ring_cells * cell_bytes(ctx.kv_k["swa"]))
    else:
        n_bytes += kv_cells * 2 * cell_bytes(ctx.kv_k)
    if "layer_list" in p:
        # a heterogeneous stack: dense tensors per layer; an MoE layer reads
        # the experts its routing picked (on average over its layers), each
        # expert's three dense matrices once
        n_moe = sum("ffn_gate_inp" in w for w in p["layer_list"])
        picked = sum(int(r.unique().numel()) for r in routing) / n_steps / max(n_moe, 1)
        for w in p["layer_list"]:
            for key, t in w.items():
                if key.endswith("_exps"):
                    n_bytes += picked * nbytes(t) / hp.n_expert
                    flops += 2.0 * rows * hp.n_expert_used * t[0].numel()
                elif t.dim() == 2:
                    n_bytes += nbytes(t)
                    flops += 2.0 * rows * t.numel()
        return bound_ms(n_bytes, flops, "bf16")
    lm = model.quant_meta["layers"]
    for key, w in p["layers"].items():
        if not isinstance(w, dict):
            if key.endswith("_exps"):  # a dense (L, E, rows, cols) expert stack
                picked = sum(int(r.unique().numel()) for r in routing) / n_steps
                n_bytes += picked * nbytes(w) / (hp.n_layer * hp.n_expert)
                flops += 2.0 * rows * hp.n_expert_used * hp.n_layer * w[0, 0].numel()
            elif w.dim() == 3 and not key.endswith(("_b", "_bias")):
                # a dense (L, n_out, n_in) matrix stack
                n_bytes += nbytes(w)
                flops += 2.0 * rows * w.numel()
            continue
        if key.endswith("_exps"):
            per_expert = sum(nbytes(a) for a in w.values()) / (hp.n_layer * hp.n_expert)
            picked = sum(int(r.unique().numel()) for r in routing) / n_steps
            n_bytes += per_expert * picked
        else:
            n_bytes += sum(nbytes(a) for a in w.values())
            flops += 2.0 * rows * hp.n_layer * lm[key].n_out * lm[key].n_in
    if "ffn_down_exps" in lm:  # gate, up (F x D) and down (D x F) per selected expert
        F, D = lm["ffn_down_exps"].n_in, hp.n_embd
        flops += 2.0 * rows * hp.n_expert_used * hp.n_layer * 3 * F * D
    return bound_ms(n_bytes, flops, "bf16")


def profile_step(ctx, step, rows: int, n_steps: int, kernels: tuple = ()) -> dict:
    """Where one kind of Context step spends its time: host wall per step
    (synchronised, without the profiler), then a second run of n_steps
    under torch.profiler: its wall, the card's busy time (the sum of the
    kernels the profiler saw) and idle share in that same window, the
    kernels that take the most, and the step's bound. The idle share
    comes from the profiled window alone because each step grows the
    cache, so the two windows do not do the same work. `kernels`: names
    (substrings of the profiler's kernel names) whose card ms per launch
    and launches per step are reported apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: None)
    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    kv_cells = int((ctx._pos_host >= 0).sum())
    with recorded_routing([]) as routing, labelled_dense_experts(), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    b_ms, b_by = step_bound(ctx, rows, kv_cells, routing, n_steps)
    if ctx.hp.n_expert and not routing:
        # a replayed graph runs no Python, so the router's picks went
        # unrecorded: no bound from this window
        b_ms = b_by = None
    # the card's kernels (a labelled range's span on the card is no kernel)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.key != DENSE_EXPERTS]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / n_steps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    per_kernel = {}
    for name in kernels:
        hits = [e for e in dev if name in e.key]
        n = sum(e.count for e in hits)
        per_kernel[name] = {"ms_per_launch": sum(e.self_device_time_total for e in hits) / 1e3
                            / n if n else None, "launches_per_step": n / n_steps}
    rec = {}
    label = [e for e in prof.events()
             if e.name == DENSE_EXPERTS and e.device_type == DeviceType.CPU]
    if label:
        # the dense expert branch: the card time of the kernels launched
        # under its label, and its span on the card (an eager step: a
        # replayed graph runs no Python to label)
        def kernel_us(e):
            return (sum(k.duration for k in getattr(e, "kernels", ()) if k.name != DENSE_EXPERTS)
                    + sum(kernel_us(c) for c in e.cpu_children))

        ms = sum(kernel_us(e) for e in label) / 1e3 / n_steps
        span = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key == DENSE_EXPERTS)
        rec = {"dense_expert_ms": ms, "dense_expert_share": ms / busy_ms if busy_ms else None,
               "dense_expert_span_ms": span / 1e3 / n_steps}
    return {**rec, "rows": rows, "steps": n_steps, "wall_ms": wall_ms, "kernels": per_kernel,
            "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / prof_wall_ms, "bound_ms": b_ms, "bound_by": b_by,
            "device_launches": sum(e.count for e in dev) / n_steps,
            "top": [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3 / n_steps,
                     "share": e.self_device_time_total / 1e3 / n_steps / busy_ms
                     if busy_ms else None, "launches": e.count / n_steps} for e in top]}


def phase_int8kv(model, card: str, phase: str = "int8kv", n_ctx: int = 8192,
                 lengths: tuple = (6100, 6500, 6800, 7000), n_steps: int = 32,
                 chunk: int = 512) -> dict:
    """The served model with an int8 cache against a bf16 one: two Contexts
    of 4 lanes of n_ctx cells, bf16 activations, kv_dtype int8 and bf16,
    prefill the same 4 prompts of `lengths` tokens (decode_multi, `chunk`
    tokens a lane per step), then a greedy decode_batch_burst of n_steps.
    Each: memory_breakdown, prefill and burst rates, the replayed B = 4
    step profiled (wall, card busy, flash_decode's ms a launch), one step's
    launches (the attention kernel of its cache once per layer). The
    int8 and bf16 greedy ids' agreement is reported, not gated (random
    weights)."""
    import torch

    from tpullama_torch.ops.cuda import launch_counts
    from tpullama_torch.runtime import Context, ContextParams

    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    vocab = model.vocab
    prompts = [vocab.tokenize(word_prompt(rng, n + 8), add_special=True)[:n] for n in lengths]
    rec = {"phase": phase, "card": card, "n_ctx": n_ctx, "lanes": 4,
           "prompt_tokens": [len(p) for p in prompts], "new_tokens": n_steps}
    ids = {}
    n_layer = model.hparams.n_layer
    active = np.ones(4, bool)
    for kv in ("int8", "bfloat16"):
        ctx = Context(model, ContextParams(n_ctx=n_ctx, n_seqs=4, dtype=torch.bfloat16,
                                           kv_dtype=getattr(torch, kv)))
        mem = ctx.memory_breakdown()
        sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: None)
        t1 = time.perf_counter()
        last = {}
        for i in range(0, max(len(p) for p in prompts), chunk):
            last.update(ctx.decode_multi([(s, p[i:i + chunk]) for s, p in enumerate(prompts)
                                          if i < len(p)]))
        sync()
        prefill_s = time.perf_counter() - t1
        check(all(np.isfinite(last[s]).all() for s in range(4)),
              f"{kv} cache: prefill logits are not finite")
        first = np.asarray([int(np.argmax(last[s])) for s in range(4)], np.int32)
        t1 = time.perf_counter()
        out = ctx.decode_batch_burst(first, active, n_steps)
        burst_s = time.perf_counter() - t1
        check(out.shape == (n_steps, 4) and int(out.min()) >= 0
              and int(out.max()) < model.hparams.n_vocab, f"{kv} cache: burst ids {out.shape}")
        ids[kv] = np.concatenate([first[None], out])

        def step():
            return ctx.decode_batch(np.full(4, 100, np.int32), active)

        prof = profile_step(ctx, step, 4, 8, kernels=("fd_kernel",))
        # one step's launches, read as a difference: the path's own counts
        # (path_launches) keep running
        before = launch_counts()
        check(np.isfinite(step()).all(), f"{kv} cache: decode_batch logits are not finite")
        counts = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        if ctx.device.type == "cuda":
            check(ctx._programs[(0, 4, None)].graph is not None,
                  f"{kv} cache: the B = 4 step did not run as a CUDA graph")
            name = "flash_decode_batched" + ("_int8" if kv == "int8" else "")
            check(counts.get(name) == n_layer,
                  f"{kv} cache: a decode step launched {name} {counts.get(name)} times")
        rec[kv] = {"memory_breakdown": mem, "kv_cache_gb": mem["kv_cache"] / 1e9,
                   "prefill_s": prefill_s, "prefill_tok_s": sum(map(len, prompts)) / prefill_s,
                   "burst_s": burst_s, "burst_lane_tok_s": 4 * n_steps / burst_s,
                   "step": prof, "decode_step_launches": counts}
        del ctx
        torch.cuda.empty_cache()
    same = ids["int8"] == ids["bfloat16"]
    lead = [int(np.argmin(np.append(same[:, b], False))) for b in range(4)]
    rec["greedy_agreement"] = {"equal_share": float(same.mean()), "equal_prefix": lead}
    # per cell and head: D int8 values and an f32 scale against D bf16 values
    D = model.hparams.n_embd_head_k
    check(rec["int8"]["memory_breakdown"]["kv_cache"] * 2 * D
          == rec["bfloat16"]["memory_breakdown"]["kv_cache"] * (D + 4),
          "the int8 cache's bytes are not (D + 4) / 2D of the bf16 cache's")
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


def load_cut(tmp: str, widths: Widths, n_layer: int, device: str = "cuda"):
    """The cut of `widths` (n_layer layers, seed 1) for the int8 cross-check
    and the state path, written once: on `device` packed with f32 scale
    planes (bit-exact), on the CPU dense, the same f32 weights dequantized
    once at load, so the CPU's steps are plain matmuls instead of a
    dequantization of every matrix per call (the other cross-checks hold
    the qmm kernels to their plain versions); f32 activations on both.
    Returns (path, card model, CPU model, a 32-token prompt); the file
    stays for the CLI, the caller removes it."""
    import torch

    from tpullama_torch.models import load_model

    path = os.path.join(tmp, "cut.gguf")
    write_llama_gguf(path, replace(widths, n_layer=n_layer), seed=1)
    gpu = load_model(path, dtype=torch.float32, device=device, packed=True,
                     packed_scale_dtype=torch.float32)
    cpu = load_model(path, dtype=torch.float32, device="cpu")
    prompt = gpu.vocab.tokenize(word_prompt(np.random.default_rng(2), 40), add_special=True)
    return path, gpu, cpu, np.asarray(prompt[:32], np.int32)


def int8_rows_close(g, c, steps: int = 1) -> tuple[float, float, int]:
    """The largest difference between two int8 caches' dequantized rows
    (g on the card, c on the CPU; every cell but the scratch cell S - 1,
    which only the card's graph warm-ups write), its bound and the count of
    int8 values that differ. Where a row's input differs in its last bits
    (the card's K and V projections sum in another order) its scale (amax
    / 127) moves with it and a value may round to the neighbouring step; a
    re-rotation mixes two such values and rounds again. The bound: `steps`
    steps of the largest scale (1, or 3 after a re-rotation) plus 127 times
    the largest difference of two scales."""
    S = c[0].shape[3]
    gq, gs = (t.cpu()[:, :, :, : S - 1] for t in g)
    cq, cs = (t[:, :, :, : S - 1] for t in c)
    err = float((gq.float() * gs[..., None] - cq.float() * cs[..., None]).abs().max())
    n_diff = int((gq != cq).sum())
    ds = float((gs - cs).abs().max())
    return err, 1.001 * (steps * max(float(gs.max()), float(cs.max())) + 127 * ds), n_diff


def free_cells(ctx, lane: int, n: int) -> list:
    """The cells the next step of n tokens on `lane` writes (the host
    mirror's first free cells, the order the step picks them in)."""
    return np.nonzero(ctx._pos_host[lane, : ctx._S - 1] < 0)[0][:n].tolist()


@contextlib.contextmanager
def card_rows(g, lane: int, cells: list):
    """Inside the block, the model's quantizer (models/llama.quantize_q8)
    returns the card Context g's int8 rows and scales of `lane` at `cells`,
    K then V, layer after layer, instead of quantizing its input: a CPU
    step then attends over the rows the card wrote. An int8 value rounds to
    the other step where the two devices' K or V differ in the last bits,
    and that moves the logits by more than the f32 cross-check's tolerance
    (0.0091 against 0.0074 on Llama-3-8B's 2-layer cut on an H100); over
    the card's rows the card and the CPU differ by f32 arithmetic alone."""
    import tpullama_torch.models.llama as llama

    rows = [tuple(t[:, lane][:, :, cells].cpu() for t in c) for c in (g.kv_k, g.kv_v)]
    n_layer = rows[0][0].shape[0]
    calls = iter([rows[kind][0][li], rows[kind][1][li]]
                 for li in range(n_layer) for kind in (0, 1))
    orig = llama.quantize_q8

    def from_card(a):
        q, sc = next(calls)  # (Hkv, T, D), (Hkv, T)
        B, T, H, _ = a.shape
        check(B == 1 and T == len(cells), f"card_rows: rows of {tuple(a.shape)}")
        return q.transpose(0, 1)[None].contiguous(), sc.transpose(0, 1)[None].contiguous()

    llama.quantize_q8 = from_card
    try:
        yield
    finally:
        llama.quantize_q8 = orig


def cpu_step(c, g, toks, lane: int = 0, n_logits: int = 1):
    """c.decode(toks) on `lane` over the card Context g's rows of the same
    cells (card_rows); g must have run the same step."""
    with card_rows(g, lane, free_cells(c, lane, len(toks))):
        return c.decode(np.asarray(toks, np.int32), n_logits=n_logits, seq_id=lane)


def greedy_pair(g, c, tok: int, n: int, lane: int = 0):
    """n greedy one-token steps from tok on the card Context g and on the CPU
    Context c over the card's rows, each side fed its own argmax: (card
    tokens, {"tokens": the CPU's, "gaps": their top-2 gaps, "tol": the
    cross-check's formula}) for same_under_tie_rule."""
    toks_g, ref = [], {"tokens": [], "gaps": []}
    tg = tc = tok
    for _ in range(n):
        lg = g.decode(np.asarray([tg], np.int32), seq_id=lane)[-1]
        lc = cpu_step(c, g, [tc], lane)[-1]
        top2 = np.partition(lc, -2)[-2:]
        ref["gaps"].append(float(top2[1] - top2[0]))
        tg, tc = int(np.argmax(lg)), int(np.argmax(lc))
        toks_g.append(tg)
        ref["tokens"].append(tc)
        ref["tol"] = max(ref.get("tol", 0.0), 1e-3 * float(np.abs(lc).max()) + 1e-4)
    return toks_g, ref


def phase_int8kv_crosscheck(gpu, cpu, prompt, card: str, phase: str = "int8kv_crosscheck"):
    """The 2-layer cut with an int8 cache, the card (kernels) against the
    port on the CPU (plain versions), f32 activations, 2 lanes. The int8
    rows each device writes are within one quantization step of the
    other's (the count of values that differ is printed); the CPU then
    steps over the card's rows (card_rows), so prefill logits must be
    within the cross-check's tolerance (the CPU's own rows' error is
    printed beside it) and 8 greedy one-token steps (replayed graphs on
    the card) give the same tokens up to the first near-tie. seq_rm +
    seq_add (a context shift: dequantize, rotate, quantize) and seq_div on
    lane 0 of both: rows within 3 steps and the same positions; the card's
    lane then goes to the CPU (seq_save / seq_load, runtime/state.py) and
    4 greedy steps go on under the same rule. seq_cp, after which both
    card lanes give the same logits bit for bit; embeddings (mean) over
    the card's rows within the logits' formula; a sampled decode_burst
    equal on a rerun from its seed."""
    import io

    import torch

    from tpullama_torch.runtime import Context, ContextParams
    from tpullama_torch.runtime.sampling import SamplerChain, as_device_spec
    from tpullama_torch.runtime.state import seq_load, seq_save

    t0 = time.perf_counter()
    rec = {"phase": phase, "card": card, "layers": gpu.hparams.n_layer,
           "prompt_tokens": len(prompt)}
    cp = ContextParams(n_ctx=256, n_seqs=2, kv_dtype=torch.int8)
    g, c, own = Context(gpu, cp), Context(cpu, cp), Context(cpu, cp)
    cells = free_cells(c, 0, len(prompt))
    lg = g.decode(prompt, n_logits=len(prompt))
    lo = own.decode(prompt, n_logits=len(prompt))
    rows = {}
    for what in ("kv_k", "kv_v"):
        rows[what] = int8_rows_close(getattr(g, what), getattr(own, what))
        check(rows[what][0] <= rows[what][1], f"int8 {what} rows differ by {rows[what]}")
    with card_rows(g, 0, cells):
        lc = c.decode(prompt, n_logits=len(prompt))
    err = float(np.abs(lg - lc).max())
    tol = 1e-3 * float(np.abs(lc).max()) + 1e-4
    check(np.isfinite(lg).all() and err <= tol, f"int8 prefill logits err {err} > tol {tol}")
    check(int(lg[-1].argmax()) == int(lc[-1].argmax()), "int8 prefill argmax differs")
    rec.update(prefill_max_abs_err=err, tol=tol, own_rows_max_abs_err=float(
        np.abs(lg - lo).max()), rows=rows)
    del own
    out_g, ref = greedy_pair(g, c, int(np.argmax(lg[-1])), 8)
    rec["greedy_tokens"] = out_g
    rec["greedy_compared"] = same_under_tie_rule(out_g, ref, "int8 greedy")
    # the context shift and self-extend on lane 0 of both
    for ctx in (g, c):
        ctx.seq_rm(1, 5)
        ctx.seq_add(5, HUGE, -4)
        ctx.seq_div(8, 20, 2)
    for what in ("kv_k", "kv_v"):
        e = int8_rows_close(getattr(g, what), getattr(c, what), steps=3)
        check(e[0] <= e[1], f"int8 {what} rows after the seq ops differ by {e}")
        rows[what + "_after_seq_ops"] = e
    check(torch.equal(g.kv_pos.cpu(), c.kv_pos) and np.array_equal(g.n_past, c.n_past)
          and np.array_equal(g._pos_host, c._pos_host), "positions after the seq ops differ")
    buf = io.BytesIO()
    seq_save(g, 0, buf)
    buf.seek(0)
    seq_load(c, 0, buf)
    toks_g, ref = greedy_pair(g, c, out_g[-1], 4)
    rec["after_shift_tokens"] = toks_g
    rec["after_shift_compared"] = same_under_tie_rule(toks_g, ref, "int8 tokens after the shift")
    g.seq_cp(0, 1)
    a = g.decode(np.asarray([toks_g[-1]], np.int32), seq_id=0)
    b = g.decode(np.asarray([toks_g[-1]], np.int32), seq_id=1)
    check(np.array_equal(a, b), "after seq_cp the two int8 lanes give other logits")
    eg = g.embeddings(prompt, pooling="mean")
    with card_rows(g, 0, list(range(len(prompt)))):
        ec = c.embeddings(prompt, pooling="mean")
    e_err = float(np.abs(eg - ec).max())
    check(np.isfinite(eg).all() and e_err <= 1e-3 * float(np.abs(ec).max()) + 1e-4,
          f"int8 embeddings err {e_err}")
    rec["embeddings_max_abs_err"] = e_err
    del g, c
    cp1 = ContextParams(n_ctx=256, kv_dtype=torch.int8)
    s1 = Context(gpu, cp1)
    first = int(np.argmax(s1.decode(prompt)[-1]))
    n0 = int(s1.n_past[0])
    spec = as_device_spec(SamplerChain.std(temp=0.9, seed=7))
    runs = []
    for _ in range(2):
        s1.rollback_to(n0)
        runs.append(s1.decode_burst(first, 8, sampler_spec=spec).tolist())
    check(runs[0] == runs[1], f"a sampled int8 burst rerun from its seed differs: {runs}")
    rec["sampled_burst"] = runs[0]
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)


def phase_state(path: str, gpu, cpu, prompt, card: str, tmp: str, phase: str = "state",
                device: str = "cuda") -> None:
    """The state path on the 2-layer cut (runtime/state.py, the JAX
    package's file format). (1) For an f32 and an int8 cache: lane 0 of a
    2-lane Context prefilled and 4 tokens on, seq_save on the card,
    seq_load into lane 1 (the rows equal bit for bit); 8 greedy tokens on
    each lane are the same; the CPU port loads the card's file into its own
    lane 1 and gives the same tokens up to the first near-tie. (2) Over
    HTTP (serve(slot_save_path=...)): a completion, save slot 0, erase it,
    restore it (n_restored equal to n_saved), and the same completion
    again gives the same text. (3) The CLI (dense f32 weights, --dtype
    float32) twice on the card with --prompt-cache: the first saves, the second restores (the
    file is not written again) and prints what the CPU prints restoring
    the card's file with --prompt-cache-ro."""
    import io

    import torch

    from tpullama_torch.runtime import Context, ContextParams
    from tpullama_torch.runtime.state import seq_load, seq_save
    from tpullama_torch.server.http import serve
    from tpullama_torch.tools.cli import main as cli_main

    t0 = time.perf_counter()
    rec = {"phase": phase, "card": card, "layers": gpu.hparams.n_layer}

    def greedy(ctx, tok, n, lane):
        out = []
        for _ in range(n):
            tok = int(np.argmax(ctx.decode(np.asarray([tok], np.int32), seq_id=lane)[-1]))
            out.append(tok)
        return out

    for kv in (torch.float32, torch.int8):
        name = str(kv).split(".")[-1]
        cp = ContextParams(n_ctx=256, n_seqs=2, kv_dtype=kv)
        g = Context(gpu, cp)
        g.decode(prompt, seq_id=0)
        part = greedy(g, int(prompt[-1]), 4, 0)
        f = os.path.join(tmp, f"lane_{name}.bin")
        t1 = time.perf_counter()
        seq_save(g, 0, f, tokens=list(map(int, prompt)) + part)
        save_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        toks = seq_load(g, 1, f)
        load_ms = (time.perf_counter() - t1) * 1e3
        check(toks == list(map(int, prompt)) + part, f"{name}: the file's tokens differ")
        cache = [t for c in (g.kv_k, g.kv_v) for t in (c if isinstance(c, tuple) else (c,))]
        check(all(torch.equal(t[:, 0], t[:, 1]) for t in cache) and g.n_past[0] == g.n_past[1],
              f"{name}: the loaded lane differs from the saved one")
        a, b = greedy(g, part[-1], 8, 0), greedy(g, part[-1], 8, 1)
        check(a == b, f"{name}: the loaded lane continues with {b}, the saved one with {a}")
        # the CPU port restores the card's file into its lane 1 and goes on
        # beside a card lane restored the same way (an int8 cache: over the
        # card's new rows, card_rows)
        c = Context(cpu, cp)
        seq_load(c, 1, f)
        seq_load(g, 1, f)
        if kv == torch.int8:
            got, ref = greedy_pair(g, c, part[-1], 8, lane=1)
        else:
            got = a
            logits = c.decode(np.asarray([part[-1]], np.int32), seq_id=1)[-1]
            ref = {"tokens": [], "gaps": [], "tol": 1e-3 * float(np.abs(logits).max()) + 1e-4}
            for _ in range(8):
                top2 = np.partition(logits, -2)[-2:]
                ref["gaps"].append(float(top2[1] - top2[0]))
                ref["tokens"].append(int(np.argmax(logits)))
                logits = c.decode(np.asarray(ref["tokens"][-1:], np.int32), seq_id=1)[-1]
        check(got == a, f"{name}: a lane restored twice continues with {got}, not {a}")
        n_cmp = same_under_tie_rule(a, ref, f"{name}: the CPU restoring the card's file")
        rec[name] = {"file_bytes": os.path.getsize(f), "save_ms": save_ms, "load_ms": load_ms,
                     "tokens": a, "cpu_compared": n_cmp}
        del g, c
    # (2) slot save / erase / restore over HTTP
    slots = os.path.join(tmp, "slots")
    os.makedirs(slots, exist_ok=True)
    httpd = serve(gpu, port=free_port(), n_slots=2, n_ctx=512, block=False,
                  slot_save_path=slots)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        text = word_prompt(np.random.default_rng(9), 200)
        body = {"prompt": text, "n_predict": 16, "temperature": 0}
        first = http_call(base, "/completion", body)[2]
        saved = http_call(base, "/slots/0?action=save", {"filename": "slot0.bin"})[2]
        erased = http_call(base, "/slots/0?action=erase", {})[2]
        restored = http_call(base, "/slots/0?action=restore", {"filename": "slot0.bin"})[2]
        again = http_call(base, "/completion", body)[2]
    finally:
        httpd.shutdown()
        httpd.engine.stop()
        httpd.server_close()
    check(saved["n_saved"] > 0 and erased["n_erased"] == saved["n_saved"]
          and restored["n_restored"] == saved["n_saved"],
          f"slot save {saved}, erase {erased}, restore {restored}")
    check(again["content"] == first["content"] and first["content"],
          f"the completion after a restore differs: {first['content']!r} vs {again['content']!r}")
    rec["http"] = {"n_saved": saved["n_saved"], "n_restored": restored["n_restored"],
                   "save_ms": saved["timings"]["save_ms"],
                   "restore_ms": restored["timings"]["restore_ms"],
                   "file_bytes": os.path.getsize(os.path.join(slots, "slot0.bin")),
                   "text": first["content"][:60]}
    # (3) the CLI's --prompt-cache
    cache = os.path.join(tmp, "prompt.cache")
    text = word_prompt(np.random.default_rng(5), 120)
    argv = ["-m", path, "-p", text, "-n", "16", "--temp", "0", "--dtype", "float32",
            "--prompt-cache", cache]
    outs, stamps = [], []
    for extra in ([], [], ["--device", "cpu", "--prompt-cache-ro"]):
        if extra[:2] != ["--device", "cpu"]:
            extra = extra + ([] if device == "cuda" else ["--device", device])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv + extra)
        check(rc == 0, f"the CLI exited {rc} with {extra}")
        outs.append(buf.getvalue())
        stamps.append(os.stat(cache).st_mtime_ns)
    check(stamps[0] == stamps[1] == stamps[2], "a restoring CLI run wrote the prompt cache again")
    check(outs[1] == outs[2] and outs[1].startswith(text),
          f"the restoring CLI runs differ: card {outs[1][len(text):]!r}, "
          f"cpu {outs[2][len(text):]!r}")
    rec["cli"] = {"first": outs[0][len(text):][:60], "restored": outs[1][len(text):][:60],
                  "cache_bytes": os.path.getsize(cache)}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)


# (name, source, TPU kernel it replaces, the kernels-phase case whose
# numbers the kernels line carries: the served path's shape)
KERNELS = (
    ("qmm_gemv", "tpullama_torch/csrc/qmm.cu", "tpullama/ops/pallas/qmm.py:296",
     dict(T=4, N=14336, K=4096, x="bfloat16", type="Q4_K")),
    ("qmm_tiled", "tpullama_torch/csrc/qmm.cu", "tpullama/ops/pallas/qmm.py:296",
     dict(T=1024, N=14336, K=4096, x="bfloat16", type="Q4_K")),
    ("flash_attention", "tpullama_torch/csrc/flash_attention.cu",
     "tpullama/ops/pallas/flash_attention.py:40", dict(B=4, Tq=256, D=128, extras=[])),
    ("flash_decode", "tpullama_torch/csrc/flash_decode.cu",
     "tpullama/ops/pallas/flash_decode.py:60", dict(B=1, D=128, extras=[])),
    ("flash_decode_batched", "tpullama_torch/csrc/flash_decode.cu",
     "tpullama/ops/pallas/flash_decode.py:141", dict(B=4, S=4224, D=128, extras=[])),
    ("qmm_gathered", "tpullama_torch/csrc/qmm_gathered.cu", "tpullama/ops/pallas/qmm.py:655",
     dict(slots=2048, N=28672, K=4096, scales="bfloat16", type="Q4_K")),
    ("qmm_gathered_t", "tpullama_torch/csrc/qmm_gathered.cu", "tpullama/ops/pallas/qmm.py:771",
     dict(slots=2048, N=4096, K=14336, scales="bfloat16", type="Q4_K")),
    ("qmm_ktiled", "tpullama_torch/csrc/qmm_ktiled.cu", "tpullama/ops/pallas/qmm.py:450",
     dict(T=1, N=4608, K=4096, nk=4, type="Q4_K")),
    ("fused_postattn", "tpullama_torch/csrc/fused_layer.cu",
     "tpullama/ops/pallas/fused_layer.py:112", dict(E=4096, Dq=4096, Fd=13696)),
    # the int8 cache's routes of kernels 5-7 (their has_kv_scale branches)
    ("flash_attention_int8", "tpullama_torch/csrc/flash_attention.cu",
     "tpullama/ops/pallas/flash_attention.py:40", dict(B=4, Tq=256, D=128, dtype="bfloat16")),
    ("flash_decode_int8", "tpullama_torch/csrc/flash_decode.cu",
     "tpullama/ops/pallas/flash_decode.py:60", dict(B=1, D=128, dtype="bfloat16")),
    ("flash_decode_batched_int8", "tpullama_torch/csrc/flash_decode.cu",
     "tpullama/ops/pallas/flash_decode.py:141", dict(B=4, S=4224, D=128, dtype="bfloat16")),
    # the ALiBi branches of kernels 5-7 at BLOOM-7b1's shapes
    ("flash_attention_alibi", "tpullama_torch/csrc/flash_attention.cu",
     "tpullama/ops/pallas/flash_attention.py:92", dict(B=4, Tq=256, Hq=32, D=128)),
    ("flash_decode_alibi", "tpullama_torch/csrc/flash_decode.cu",
     "tpullama/ops/pallas/flash_decode.py:104", dict(B=1, Hq=32, D=128)),
    ("flash_decode_batched_alibi", "tpullama_torch/csrc/flash_decode.cu",
     "tpullama/ops/pallas/flash_decode.py:186", dict(B=4, Hq=32, D=128)),
)


# the main path's runs, and the kernels each must launch: the B = 1
# Context.generate of each cross-check, the served B = 4 engines and the
# served one-slot ChatGLM engine (B = 1)
_DENSE_CROSS = ("qmm_gemv", "qmm_tiled", "flash_attention", "flash_decode")
_DENSE_SERVE = ("qmm_gemv", "qmm_tiled", "flash_attention", "flash_decode_batched")
_GATHERED = ("qmm_gathered", "qmm_gathered_t")
_GLM = ("qmm_ktiled", "fused_postattn") + _DENSE_CROSS
PATH_KERNELS = {
    "crosscheck": _DENSE_CROSS,
    "serve": _DENSE_SERVE,
    "moe_crosscheck": _DENSE_CROSS + _GATHERED,
    "moe_serve": _DENSE_SERVE + _GATHERED,
    "glm_crosscheck": _GLM,
    "glm_serve": _GLM,
    "qwen_crosscheck": _DENSE_CROSS,
    # dense Q8_0 at K = 3200 and 8640 (no Q4_K width): the loader keeps
    # every matrix dense, so attention alone runs kernels
    "openllama_crosscheck": ("flash_attention", "flash_decode"),
    "http": _DENSE_SERVE,
    # drafts are one-lane steps (flash_decode), verify a one-lane prefill
    "spec": _DENSE_CROSS,
    # the CLI loads dense weights (the JAX package's default)
    "cli": ("flash_attention", "flash_decode"),
    # the Q5_K matrices through qmm_gemv and qmm_tiled (q5km_serve_profile
    # counts them per step and chunk)
    "q5km_crosscheck": _DENSE_CROSS,
    "q5km_serve": _DENSE_SERVE,
    # Q3_K / Q4_K / Q5_K, Q2_K / Q3_K, Q5_0 / Q5_1 and Q4_0 packed; IQ4_XS
    # dense
    "quant_crosscheck": _DENSE_CROSS,
    # an int8 and a bf16 cache served at 8192 cells (4 lanes)
    "int8kv": ("qmm_gemv", "qmm_tiled", "flash_attention_int8", "flash_decode_batched_int8",
               "flash_attention", "flash_decode_batched"),
    "int8kv_crosscheck": ("qmm_gemv", "qmm_tiled", "flash_attention_int8", "flash_decode_int8"),
    # Q2_K [gate | up] and Q3_K down experts, row-major (the q1/q2 sets of
    # qmm_gathered); Qwen2-57B-A14B's Q5_1 experts; granite's Q4_K experts
    # at K = 1536 and 512, whose scale planes are no multiple of 128, so
    # stored transposed
    "qwen3moe_crosscheck": _DENSE_CROSS + ("qmm_gathered",),
    "qwen3moe_serve": _DENSE_SERVE + ("qmm_gathered",),
    "qwen2moe_crosscheck": _DENSE_CROSS + ("qmm_gathered",),
    "granitemoe_crosscheck": _DENSE_CROSS + ("qmm_gathered_t",),
    # MXFP4 experts of Qwen3-30B-A3B, transposed (64 and 24 scale columns),
    # beside Q8_0 attention and lm_head; one Mixtral-8x7B layer all MXFP4:
    # attention and lm_head (LUT or A/r planes; with qmm_tile_k=4 through
    # qmm_ktiled), [gate | up] row-major, down transposed
    "qwen3mxfp4_crosscheck": _DENSE_CROSS + ("qmm_gathered_t",),
    "qwen3mxfp4_serve": _DENSE_SERVE + ("qmm_gathered_t",),
    "mxfp4_crosscheck": _DENSE_CROSS + _GATHERED + ("qmm_ktiled",),
    # GLM-4.5-Air's heterogeneous stack: every layer dense in both loaders,
    # so the packed Q6_K lm_head (qmm_gemv; qmm_tiled on the cross-check's
    # 32 prompt logits) and attention at G = 12 run kernels; the served
    # chunks read one logit row a lane
    "glm4moe_crosscheck": _DENSE_CROSS,
    "glm4moe_serve": ("qmm_gemv", "flash_attention", "flash_decode_batched"),
    # gpt-oss-20b: attn_output (K = 4096) alone packs (qmm_gemv at decode,
    # qmm_tiled on the prompt chunks); attention with sinks over both
    # stacks of the two-stack cache; the experts and the lm_head are dense
    "gptoss_crosscheck": _DENSE_CROSS,
    "gptoss_serve": _DENSE_SERVE,
    # gemma-3-12b: every layer matrix Q4_K (K = 3840, 4096, 15360); D = 256
    # attention over both stacks; the tied lm_head is the dense token
    # table. command-r7b: every layer matrix Q4_K, NoPE full layers
    "gemma3_crosscheck": _DENSE_CROSS,
    "gemma3_serve": _DENSE_SERVE,
    "cohere2_crosscheck": _DENSE_CROSS,
    # Qwen3-8B: every layer matrix Q4_K (K = 4096 and 12288), the Q6_K
    # lm_head (N = 151936), per-head q/k norms; attention at G = 4, D = 128
    "qwen3_crosscheck": _DENSE_CROSS,
    "qwen3_serve": _DENSE_SERVE,
    # Llama-4-Scout: Q4_K attention and shared expert, the Q6_K lm_head;
    # [gate | up] experts transposed (K = 5120), down row-major (K = 8192);
    # attention at G = 5 over the full stack and the chunked ring
    "llama4_crosscheck": _DENSE_CROSS + _GATHERED,
    "llama4_ring": _DENSE_CROSS + _GATHERED,
    "llama4_serve": _DENSE_SERVE + _GATHERED,
    # phi-2 at 8 of 32 layers: every layer matrix Q4_K (attn_qkv 7680 rows,
    # K = 2560 and 10240), the biased Q6_K lm_head; attention at D = 80, G
    # = 1. bigcode/starcoder: Q4_K layers (K = 6144 and 24576), the dense
    # tied lm_head; attention at G = 48 over one KV head
    "phi2_crosscheck": _DENSE_CROSS,
    "phi2_serve": _DENSE_SERVE,
    "starcoder_crosscheck": _DENSE_CROSS,
    # BLOOM-7b1: every layer matrix Q4_K (attn_qkv 12288 rows, K = 4096 and
    # 16384), the dense tied lm_head; attention at G = 1, D = 128 through
    # the kernels' ALiBi branch (each launch with slopes counts apart)
    "bloom_crosscheck": ("qmm_gemv", "qmm_tiled", "flash_attention_alibi", "flash_decode_alibi"),
    "bloom_serve": ("qmm_gemv", "qmm_tiled", "flash_attention_alibi",
                    "flash_decode_batched_alibi"),
    # OLMo-2-1124-7B: every layer matrix Q4_K (K = 4096 and 11008), the
    # Q6_K lm_head (N = 100352); attention at G = 1, D = 128
    "olmo2_crosscheck": _DENSE_CROSS,
    "olmo2_serve": _DENSE_SERVE,
    # lanes saved and loaded (f32 and int8 caches), the HTTP engine, the CLI
    "state": ("qmm_gemv", "qmm_tiled", "flash_attention", "flash_decode", "flash_decode_batched",
              "flash_attention_int8", "flash_decode_int8"),
}
# each path's model: (phase prefix, widths, cross-check layers, served
# slots, the two opt-ins)
PATHS = (("", LLAMA3_8B, 2, 4, {}),
         ("moe_", MIXTRAL_8X7B, 1, 4, {}),
         ("glm_", CHATGLM3_6B, 1, 1, GLM_OPTS),
         ("qwen_", QWEN2_1_5B, 2, 0, {}),  # the cross-check alone
         ("openllama_", OPENLLAMA_3B, 2, 0, {}),
         ("q5km_", LLAMA3_8B_Q5KM, 1, 4, {}),
         ("qwen3moe_", QWEN3_30B_A3B, 1, 4, {}),
         ("qwen2moe_", QWEN2_57B_A14B, 1, 0, {}),
         ("granitemoe_", GRANITE_3B_A800M, 2, 0, {}),
         ("qwen3mxfp4_", QWEN3_30B_A3B_MXFP4, 1, 4, {}),
         ("glm4moe_", GLM_4_5_AIR, 2, 4, {}),
         ("gptoss_", GPT_OSS_20B, 2, 4, {}),
         ("gemma3_", GEMMA3_12B, 6, 4, {}),  # the cross-check reads the model's file
         ("cohere2_", COHERE2_7B, 4, 0, {}),  # the cross-check alone
         ("qwen3_", QWEN3_8B, 2, 4, {}),
         ("llama4_", LLAMA4_SCOUT, 4, 4, {}),  # the cross-check and ring read the model's file
         ("phi2_", PHI_2, 2, 4, {}),
         ("starcoder_", STARCODER, 1, 0, {}),  # the cross-check alone
         ("bloom_", BLOOM_7B1, 2, 4, {}),
         ("olmo2_", OLMO2_7B, 2, 4, {}))
# the cross-checks on the two-stack cache, with their options: gpt-oss's
# 600-token prompt wraps its 385-cell ring; gemma-3-12b's 1400 tokens its
# 1281-cell ring, then its first 2 layers (SWA layers only) run on one
# windowed stack, 8 greedy tokens each (a CPU step reads the 4 GB f32 tied
# table; the tokens echo the prompt's last, ROADMAP.md Queue 3);
# command-r7b's ring of 4096 + 256 + 1 cells stands beside the full stack
# only from n_ctx 8192 (its prompt does not wrap it)
SWA_CROSS = {"gptoss_": {},
             "gemma3_": dict(n_prompt=1400, n_ctx=2048, single_stack_layers=2, n_greedy=8),
             "cohere2_": dict(n_prompt=64, n_ctx=8192),
             # Llama-4-Scout's ring stands from n_ctx 8450; the chunk of 8192
             # is crossed by llama4_ring on the card alone (a CPU prefill of
             # 8600 tokens through 4 layers of 16 experts would take minutes)
             "llama4_": dict(n_prompt=200, n_ctx=8704, n_greedy=8, served=True)}
# the served engines' options where not phase_serve's defaults: Scout at
# n_ctx 16384, one request past its ring of 8449 cells and its chunk start
SERVE_OPTS = {"llama4_": dict(n_ctx=16384, lengths=(300, 550, 780, 8600), plain_greedy=True),
              # phi-2's 2048 positions
              "phi2_": dict(n_ctx=2048, plain_greedy=True),
              # BLOOM-7b1 at n_ctx 4096, one request of ~3000 tokens: head
              # 0's slope (2^-0.25) shuts its far cells out, head 31's
              # (2^-8) leaves them a bias of about -11.7
              # the profile's chunks and steps after them (~1300 tokens)
              "bloom_": dict(n_ctx=4608, lengths=(300, 550, 780, 3000), plain_greedy=True)}
# the attention launches a served step and a prefill chunk must make once
# per layer: BLOOM's through the kernels' ALiBi branch, OLMo-2's plain
PROFILE_ATTENTION = {"bloom_": (("flash_decode_batched_alibi",), ("flash_attention_alibi",)),
                     "olmo2_": (("flash_decode_batched",), ("flash_attention",))}
# the cross-checks of a model with a learned position table: a prompt past
# position 4096 (phase_positions_crosscheck)
POSITIONS_CROSS = ("starcoder_",)
# the gathered kernels whose one-row and 8-row routes a served MoE step and
# chunk must launch (phase_serve_profile's gathered_routes)
GATHERED_ROUTES = {"qwen3mxfp4_": ("qmm_gathered_t",), "llama4_": _GATHERED}
# the cross-checks' prompt tokens where not 32: Qwen2-57B-A14B's CPU steps
# dequantize its 20480-wide shared expert and 151936-row output per call
CROSS_PROMPT = {"qwen2moe_": 16}


def path_launches(path: str, run) -> tuple[dict, object]:
    """Run one path of the main path with every launch count at 0 just
    before it; print its own counts and return them with run()'s result.
    Fails if the path launched none of a kernel it must run."""
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = run()
    counts = launch_counts()
    emit({"phase": f"{path}_launches", "launches": counts})
    for name in PATH_KERNELS[path]:
        check(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
    return counts, out


def kernels_line(records: list, launches: dict) -> dict:
    """Every kernel with its launches on each path that ran (and their sum)
    and its numbers at the served shape from the kernels phase; qmm_gemv,
    qmm_tiled and qmm_gathered also at that shape for every other field set
    (`by_type`: Q6_K, and the q1/q2 sets of csrc/qmm_lowbit.cu and
    csrc/qmm_gathered_lowbit.cu); every labelled record of a kernel
    (`cases`: gpt-oss's attention over both stacks and its attn_output)
    with its shape and numbers."""
    rows = []
    nums = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, src, replaces, key in KERNELS:
        rec = next((r for r in records if r["kernel"] == name
                    and all(r.get(k) == v for k, v in key.items())), {})
        by_path = {p: c[name] for p, c in launches.items()}
        row = {"name": name, "route": "cuda", "body": rec.get("route"), "source": src,
               "replaces": replaces, "launches": sum(by_path.values()) if by_path else None,
               "launches_by_path": by_path, **{k: rec.get(k) for k in nums}}
        if name.endswith(("_int8", "_alibi")):
            row["library_call"] = rec.get("library_call")
        if "type" in key:
            row["by_type"] = {r["type"]: {k: r[k] for k in nums} for r in records
                              if r["kernel"] == name and r["type"] != key["type"]
                              and r.get("case") is None
                              and all(r.get(k) == v for k, v in key.items() if k != "type")}
        shape = ("B", "Tq", "S", "Hq", "Hkv", "D", "kv", "T", "N", "K", "type")
        row["cases"] = {r["case"]: {**{k: r[k] for k in shape if k in r},
                                    **{k: r[k] for k in nums}}
                        for r in records if r["kernel"] == name and r.get("case")}
        rows.append(row)
    return {"kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        check(p in ALL_PHASES, f"unknown phase {p!r}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card",
              file=sys.stderr)
        return 1
    from tpullama_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    device = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    _log.append(open(LOG_PATH, "w"))
    say(smi)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_count": torch.cuda.device_count(),
          "host_cpus": os.cpu_count(), "torch_threads": torch.get_num_threads()})

    if "build" in phases or "kernels" in phases:
        t0 = time.perf_counter()
        build.library()
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "ptxas.txt"), "w") as f:
            for src, log in build.ptxas_report.items():
                f.write(f"==== {src}\n{log}\n")
        emit({"phase": "build", "nvcc_s": build.build_seconds,
              "nvcc_s_by_source": build.source_seconds,
              "seconds": time.perf_counter() - t0,
              "spills": sorted({ln.strip() for log in build.ptxas_report.values()
                                for ln in log.splitlines()
                                if "spill" in ln and not ln.strip().startswith("0 bytes")})})

    records: list = []
    if "kernels" in phases:
        t0 = time.perf_counter()
        timer = Timer(device)
        gen = torch.Generator(device=device).manual_seed(0)
        by_builder: dict = {}

        def run_cases(label, cases, *args, **kw):
            t1, parts = time.perf_counter(), dict(timer.split)
            cases(timer, gen, device, records, *args, **kw)
            row = by_builder.setdefault(label, {})
            row["seconds"] = row.get("seconds", 0.0) + time.perf_counter() - t1
            for part, sec in timer.split.items():
                row[part] = row.get(part, 0.0) + sec - parts.get(part, 0.0)

        run_cases("qmm", qmm_cases)
        run_cases("ktiled", ktiled_cases)
        run_cases("fused", fused_cases)
        run_cases("gathered", gathered_cases)
        run_cases("attention", attention_cases)
        # gpt-oss-20b's (64/8 heads, D = 64, sinks; ring 385 cells) and
        # gemma-3-12b's (16/8 heads, D = 256; ring 1281 cells, window 1024)
        run_cases("iswa", iswa_attention_cases, GPT_OSS_20B, "gptoss", sinks=True,
                  int8=(False, True))
        run_cases("iswa", iswa_attention_cases, GEMMA3_12B, "gemma3")
        # Llama-4-Scout's (40/8 heads, D = 128; full stack 16512 cells, the
        # chunked ring 8449)
        run_cases("chunked", chunked_attention_cases)
        # phi-2's (32 heads of 80, G = 1) and bigcode/starcoder's (48 heads
        # of 128 over one KV head)
        run_cases("nongated", nongated_attention_cases)
        # BLOOM-7b1's (32 heads of 128) through the ALiBi branch
        run_cases("alibi", alibi_attention_cases)
        split = dict(timer.split)
        del timer
        torch.cuda.empty_cache()
        # the phase's host seconds by case builder, and by part: the
        # kernels' and library calls' timings and the plain versions' one
        # call each, in all and within each builder
        emit({"phase": "kernels", "cases": len(records), "seconds": time.perf_counter() - t0,
              "seconds_by_builder": by_builder, "seconds_by_part": split})

    launches: dict = {}
    # the Llama path (and its HTTP server), the Mixtral path, the ChatGLM
    # path, then the cross-checks alone, the Q5_K_M Llama path, the Qwen3
    # MoE path, the other MoE archs' cross-checks and the MXFP4 Qwen3 path
    for pre, widths, cross_layers, n_slots, opts in PATHS:
        run = [p for p in ("model", "crosscheck", "ring", "serve", "graphs", "http", "spec",
                           "int8kv", "int8kv_crosscheck", "state") if pre + p in phases]
        if not run:
            continue
        fused = bool(opts.get("fused_layer"))
        with tempfile.TemporaryDirectory() as tmp:
            model = model_path = None
            # a cross-check on the served model's weights (no file of its own)
            swa_cross = dict(SWA_CROSS.get(pre, {}))
            served = swa_cross.pop("served", False) and "crosscheck" in run
            if {"model", "serve", "graphs", "http", "spec", "int8kv"} & set(run) or served:
                # one file for the model and a cross-check of all its layers
                keep = "crosscheck" in run and cross_layers == widths.n_layer and not served
                model = phase_model(tmp, widths, phase=pre + "model", fused_layer=fused,
                                    keep_file=keep)
                if keep:
                    model_path = os.path.join(tmp, f"{pre}model.gguf")
                if served:
                    swa_cross["served"] = model
            gpu32 = None
            if "crosscheck" in run and pre in SWA_CROSS:
                launches[pre + "crosscheck"], gpu32 = path_launches(
                    pre + "crosscheck", lambda: phase_swa_crosscheck(
                        tmp, smi, widths=widths, n_layer=cross_layers, phase=pre + "crosscheck",
                        path=model_path, **swa_cross))
            elif "crosscheck" in run and pre in POSITIONS_CROSS:
                launches[pre + "crosscheck"], _ = path_launches(
                    pre + "crosscheck", lambda: phase_positions_crosscheck(
                        tmp, smi, widths=widths, n_layer=cross_layers, phase=pre + "crosscheck"))
            elif "crosscheck" in run:
                launches[pre + "crosscheck"], _ = path_launches(
                    pre + "crosscheck", lambda: phase_crosscheck(
                        tmp, widths, n_layer=cross_layers, phase=pre + "crosscheck",
                        runtime_ops=not pre, compare_native=pre == "q5km_",
                        n_prompt=CROSS_PROMPT.get(pre, 32), **opts))
            if "ring" in run:
                # the cross-check's f32 card model (all of the model's layers)
                check(gpu32 is not None and gpu32.hparams.n_layer == widths.n_layer,
                      f"{pre}ring runs after {pre}crosscheck on all {widths.n_layer} layers")
                launches[pre + "ring"], _ = path_launches(
                    pre + "ring", lambda: phase_chunk_ring(gpu32, smi, phase=pre + "ring"))
            del gpu32
            torch.cuda.empty_cache()
            serve_tokens = None
            if "serve" in run:
                # dense projections (a heterogeneous stack's are all dense; a
                # tied lm_head, the dense token table)
                layers = model.params.get("layers", {})
                dense = "layer_list" in model.params or "output" not in model.params or [
                    k for k in _LAYER_ROLES if k in layers and not isinstance(layers[k], dict)]
                launches[pre + "serve"], (eng, prompt, serve_tokens) = path_launches(
                    pre + "serve", lambda: phase_serve(model, smi, phase=pre + "serve",
                                                       n_slots=n_slots, rerun_all=bool(dense),
                                                       **SERVE_OPTS.get(pre, {}), **opts))
                # a packed model without experts: every packed matrix once
                # per step / chunk, the output by qmm_gemv in both
                qmm_counts = None
                if not (widths.n_expert or fused):
                    lm = model.quant_meta["layers"]
                    qmm_counts = (len(lm) * widths.n_layer + ("output" in model.quant_meta),
                                  len(lm) * widths.n_layer)
                if isinstance(eng.ctx.kv_k, dict):
                    swa_memory(model, eng, smi, pre + "serve_memory")
                step_attn, chunk_attn = PROFILE_ATTENTION.get(pre, ((), ()))
                phase_serve_profile(eng, prompt, smi, phase=pre + "serve_profile",
                                    step_kernels=("qmm_ktiled", "fused_postattn") if fused
                                    else step_attn, qmm_counts=qmm_counts,
                                    gathered_routes=GATHERED_ROUTES.get(pre, ()),
                                    chunk_kernels=chunk_attn,
                                    idle_kernels=() if fused else ("fused_postattn",))
                del eng
                torch.cuda.empty_cache()
            if "graphs" in run:
                phase_graphs(model, smi, phase=pre + "graphs", n_slots=n_slots, **opts)
                torch.cuda.empty_cache()
            if "http" in run:
                launches["http"], _ = path_launches("http", lambda: phase_http(model, smi))
            if "spec" in run:
                launches["spec"], _ = path_launches("spec", lambda: phase_spec(
                    model, tmp, smi, serve_tokens))
            if "int8kv" in run:
                launches["int8kv"], _ = path_launches("int8kv", lambda: phase_int8kv(model, smi))
            del model
            torch.cuda.empty_cache()
            if {"int8kv_crosscheck", "state"} & set(run):
                # one 2-layer cut for both: written and loaded once
                cut_path, gpu, cpu, prompt = load_cut(tmp, widths, cross_layers)
                if "int8kv_crosscheck" in run:
                    launches["int8kv_crosscheck"], _ = path_launches(
                        "int8kv_crosscheck",
                        lambda: phase_int8kv_crosscheck(gpu, cpu, prompt, smi))
                if "state" in run:
                    launches["state"], _ = path_launches("state", lambda: phase_state(
                        cut_path, gpu, cpu, prompt, smi, tmp))
                del gpu, cpu
                os.remove(cut_path)
        torch.cuda.empty_cache()
    if "mxfp4_crosscheck" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            launches["mxfp4_crosscheck"], _ = path_launches(
                "mxfp4_crosscheck", lambda: phase_mxfp4_crosscheck(tmp, smi))
        torch.cuda.empty_cache()
    if "cli" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            launches["cli"] = phase_cli(tmp, smi)
        torch.cuda.empty_cache()
    if "quant_crosscheck" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            launches["quant_crosscheck"], _ = path_launches(
                "quant_crosscheck", lambda: phase_quant_crosscheck(tmp, smi))
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    say(smi)
    say(json.dumps(kernels_line(records, launches)))
    _log.pop().close()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
