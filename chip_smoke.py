#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpullama_torch) end to end on one CUDA card.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases card,build,kernels

Phases, each printing one JSON line with its seconds:
  card      nvidia-smi's name and power limit of the card
  build     nvcc builds the kernels from tpullama_torch/csrc
  kernels   every kernel against its plain PyTorch version on the card, at
            the serving path's shapes, with kernel, plain and library
            times and the bound from the card's data-sheet rates
  model     a synthetic Llama-3-8B-shaped GGUF (Q4_K layers, Q6_K output,
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
            Context into host wall time and the card's busy time by kernel
  moe_model, moe_crosscheck, moe_serve
            the same three on a Mixtral-8x7B-shaped MoE llama (8 experts,
            2 per token; 8 of its 32 layers, 1 in the cross-check), whose
            expert FFNs run through the gathered qmm kernels
  glm_model, glm_crosscheck, glm_serve
            the same three on a ChatGLM3-6B-shaped model (28 layers; 1 in
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
The crosscheck and serve paths of the three models each run with every
launch count set to 0 just before and read just after, and fail unless
each kernel that path must run was launched. Then one JSON line lists every
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
from dataclasses import dataclass, replace

import numpy as np

# H100 SXM data-sheet rates (dense): memory bandwidth, bf16 tensor-core
# and f32 (non-tensor-core) peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
FLUSH_BYTES = 512 << 20  # written between timed launches: evicts the 50 MB L2
NEG_HIDDEN = -5e29  # additive mask values at or below this hide a cell

ALL_PHASES = ("card", "build", "kernels", "model", "crosscheck", "serve", "moe_model",
              "moe_crosscheck", "moe_serve", "glm_model", "glm_crosscheck", "glm_serve",
              "qwen_crosscheck")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# ---------------------------------------------------------------- model


@dataclass(frozen=True)
class Widths:
    """A llama-family configuration (n_expert > 0: a Mixtral-style MoE,
    whose n_ff is each expert's; arch "chatglm": fused biased [Q|K|V],
    fused [gate|up], n_rot rotated dims). LLAMA3_8B holds the published
    widths of meta-llama/Meta-Llama-3-8B (config.json); MIXTRAL_8X7B those
    of mistralai/Mixtral-8x7B-v0.1 (config.json; sliding window null), cut
    to 8 of its 32 layers: every layer has the same shapes and launches;
    CHATGLM3_6B those of THUDM/chatglm3-6b (config.json: hidden 4096, 28
    layers, 32 heads, multi_query_group_num 2, ffn 13696,
    padded_vocab_size 65024, seq_length 8192; rope over half of each
    head, chatglm.rope.dimension_count 64); QWEN2_1_5B those of
    Qwen/Qwen2-1.5B (config.json: hidden 1536, 28 layers, 12 heads, 2 KV
    heads, intermediate 8960, vocab 151936, rope_theta 1e6, rms_norm_eps
    1e-6; q/k/v biases), written with an untied output matrix and used at
    2 layers in the cross-check alone."""

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


LLAMA3_8B = Widths()
MIXTRAL_8X7B = Widths(n_layer=8, n_vocab=32000, rope_theta=1e6, n_ctx_train=32768,
                      n_expert=8, n_expert_used=2)
CHATGLM3_6B = Widths(n_layer=28, n_head_kv=2, n_ff=13696, n_vocab=65024, rope_theta=10000.0,
                     arch="chatglm", n_rot=64)
# the ChatGLM path's two opt-ins, the JAX package's TPULLAMA_FUSED_LAYER and
# TPULLAMA_QMM_TILE_K
GLM_OPTS = dict(fused_layer=True, qmm_tile_k=4)
QWEN2_1_5B = Widths(n_embd=1536, n_layer=28, n_head=12, n_head_kv=2, n_ff=8960,
                    n_vocab=151936, rope_theta=1e6, rms_eps=1e-6, n_ctx_train=32768,
                    arch="qwen2")


def _fp16_bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.astype(np.float16)).view(np.uint8).reshape(*a.shape, 2)


def q4k_blocks(rng: np.random.Generator, n_blocks: int) -> np.ndarray:
    """Random Q4_K blocks (ggml block_q4_K: fp16 d, fp16 dmin, 12 bytes of
    6-bit scales and mins, 128 bytes of nibbles) whose dequantized values
    d*sc*q - dmin*m have mean near 0 and std near 0.02: sc = m in [24, 40],
    dmin = 7.5 d, so each 32-value sub-block is d*sc*(q - 7.5)."""
    b = np.frombuffer(rng.bytes(n_blocks * 144), np.uint8).reshape(n_blocks, 144).copy()
    d = (1.4e-4 * rng.uniform(0.8, 1.2, n_blocks)).astype(np.float32)
    b[:, 0:2] = _fp16_bytes(d)
    b[:, 2:4] = _fp16_bytes(7.5 * d)
    sc = rng.integers(24, 41, (n_blocks, 8), dtype=np.uint8)
    m = sc
    # ggml get_scale_min_k4 packing
    b[:, 4:8] = sc[:, :4] | ((sc[:, 4:] >> 4) << 6)
    b[:, 8:12] = m[:, :4] | ((m[:, 4:] >> 4) << 6)
    b[:, 12:16] = (sc[:, 4:] & 0xF) | ((m[:, 4:] & 0xF) << 4)
    return b


def q6k_blocks(rng: np.random.Generator, n_blocks: int) -> np.ndarray:
    """Random Q6_K blocks (ql[128], qh[64], int8 scales[16], fp16 d):
    value d*sc*(q - 32), q uniform in 0..63, sc in [4, 12], so the std is
    near 0.02."""
    b = np.frombuffer(rng.bytes(n_blocks * 210), np.uint8).reshape(n_blocks, 210).copy()
    b[:, 192:208] = rng.integers(4, 13, (n_blocks, 16), dtype=np.uint8)
    d = (1.35e-4 * rng.uniform(0.8, 1.2, n_blocks)).astype(np.float32)
    b[:, 208:210] = _fp16_bytes(d)
    return b


def q8_0_blocks(rng: np.random.Generator, n_blocks: int) -> np.ndarray:
    """Random Q8_0 blocks (fp16 d, 32 int8 quants): value d*q, q uniform
    in -128..127, d near 2.7e-4, so the std is near 0.02."""
    b = np.frombuffer(rng.bytes(n_blocks * 34), np.uint8).reshape(n_blocks, 34).copy()
    b[:, 0:2] = _fp16_bytes((2.7e-4 * rng.uniform(0.8, 1.2, n_blocks)).astype(np.float32))
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
    stacks included) and token_embd Q4_K, output Q6_K, norms, biases and
    the router F32 (as llama.cpp's quantizer leaves them), random block
    bytes from `seed`. chatglm's ffn_down rows hold n_ff = 13696 values,
    not a multiple of Q4_K's 256, so they are Q8_0, as llama.cpp's
    quantizer falls back for such rows."""
    from tpullama_torch.gguf import GGMLType, GGUFWriter

    rng = np.random.default_rng(seed)
    g = GGUFWriter()
    a = w.arch
    g.add_str("general.architecture", a)
    g.add_str("general.name", "synthetic-chatglm3-6b-shape" if a == "chatglm" else
              "synthetic-qwen2-1.5b-shape" if a == "qwen2" else
              "synthetic-mixtral-8x7b-shape" if w.n_expert else "synthetic-llama3-8b-shape")
    g.add_u32(f"{a}.context_length", w.n_ctx_train)
    g.add_u32(f"{a}.embedding_length", w.n_embd)
    g.add_u32(f"{a}.block_count", w.n_layer)
    g.add_u32(f"{a}.feed_forward_length", w.n_ff)
    g.add_u32(f"{a}.attention.head_count", w.n_head)
    g.add_u32(f"{a}.attention.head_count_kv", w.n_head_kv)
    g.add_u32(f"{a}.rope.dimension_count", w.n_rot or w.n_embd // w.n_head)
    g.add_f32(f"{a}.attention.layer_norm_rms_epsilon", w.rms_eps)
    g.add_f32(f"{a}.rope.freq_base", w.rope_theta)
    g.add_u32(f"{a}.vocab_size", w.n_vocab)
    if w.n_expert:
        g.add_u32(f"{a}.expert_count", w.n_expert)
        g.add_u32(f"{a}.expert_used_count", w.n_expert_used)
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
        if qtype == GGMLType.Q8_0:
            blocks = q8_0_blocks(rng, math.prod(shape) // 32)
        else:
            blocks = (q4k_blocks if qtype == GGMLType.Q4_K else q6k_blocks)(
                rng, math.prod(shape) // 256)
        g.add_tensor(name, shape, qtype, raw=blocks)

    def norm(name, n):
        g.add_tensor(name, (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32),
                     GGMLType.F32)

    E, F, kv = w.n_embd, w.n_ff, (w.n_embd // w.n_head) * w.n_head_kv
    Q4 = GGMLType.Q4_K
    quant("token_embd.weight", (w.n_vocab, E), Q4)
    norm("output_norm.weight", E)
    quant("output.weight", (w.n_vocab, E), GGMLType.Q6_K)
    # the router's logits have std ~1.3 on unit-scale inputs: varied routing
    n_x = w.n_expert
    for il in range(w.n_layer):
        p = f"blk.{il}."
        norm(p + "attn_norm.weight", E)
        if a == "chatglm":
            quant(p + "attn_qkv.weight", (E + 2 * kv, E), Q4)
            g.add_tensor(p + "attn_qkv.bias",
                         (0.1 * rng.standard_normal(E + 2 * kv)).astype(np.float32),
                         GGMLType.F32)
        else:
            quant(p + "attn_q.weight", (E, E), Q4)
            quant(p + "attn_k.weight", (kv, E), Q4)
            quant(p + "attn_v.weight", (kv, E), Q4)
            if a == "qwen2":
                for nm, n in (("attn_q", E), ("attn_k", kv), ("attn_v", kv)):
                    g.add_tensor(p + nm + ".bias",
                                 (0.1 * rng.standard_normal(n)).astype(np.float32),
                                 GGMLType.F32)
        quant(p + "attn_output.weight", (E, E), Q4)
        norm(p + "ffn_norm.weight", E)
        if a == "chatglm":
            quant(p + "ffn_up.weight", (2 * F, E), Q4)
            quant(p + "ffn_down.weight", (E, F), GGMLType.Q8_0)
        elif n_x:
            g.add_tensor(p + "ffn_gate_inp.weight",
                         (0.02 * rng.standard_normal((n_x, E))).astype(np.float32),
                         GGMLType.F32)
            quant(p + "ffn_gate_exps.weight", (n_x, F, E), Q4)
            quant(p + "ffn_up_exps.weight", (n_x, F, E), Q4)
            quant(p + "ffn_down_exps.weight", (n_x, E, F), Q4)
        else:
            quant(p + "ffn_gate.weight", (F, E), Q4)
            quant(p + "ffn_up.weight", (F, E), Q4)
            quant(p + "ffn_down.weight", (E, F), Q4)
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

    def flush_l2(self) -> None:
        self.flush.zero_()

    def ms(self, fn, iters: int) -> float:
        torch = self.torch
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


def random_planes(ggml_type, N: int, K: int, scale_dtype, gen, device) -> dict:
    """Random planar fields of one packed matrix, made on the card:
    uniform stripe bytes and per-group scales so values have std ~0.02."""
    import torch

    from tpullama_torch.gguf import GGMLType

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=device)

    def scales(G, base):
        return base * (0.8 + 0.4 * torch.rand((N, G), generator=gen, device=device))

    if ggml_type == GGMLType.Q6_K:
        s = scales(K // 16, 1.1e-3)
        return {"q4": u8(N, K // 2), "q2": u8(N, K // 4), "scale": s.to(scale_dtype),
                "minv": (32.0 * s).to(scale_dtype)}
    if ggml_type == GGMLType.Q8_0:
        return {"q8": u8(N, K), "scale": scales(K // 32, 2.7e-4).to(scale_dtype)}
    s = scales(K // 32, 4.4e-3)
    return {"q4": u8(N, K // 2), "scale": s.to(scale_dtype),
            "minv": (7.5 * s).to(scale_dtype)}


def qmm_cases(timer, gen, device, out: list) -> None:
    import torch

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm

    Q4, Q6, Q8 = GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0
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
             (Q8, 1024, 512, f32, bf16, (1, 256))]
    group = {Q4: 32, Q6: 16, Q8: 32}
    for qt, N, K, xdt, sdt, Ts in cases:
        fields = random_planes(qt, N, K, sdt, gen, device)
        g = group[qt]
        w_lib = None
        for T in Ts:
            x = torch.randn((T, K), generator=gen, device=device).to(xdt)
            got = qmm.quantized_matmul(x, fields, qt, g, N, K)
            want = qmm.quantized_matmul_plain(x, fields, qt, g, N, K)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            # f32 sums in another order: 1e-4 of the output's scale is far
            # above that and far below any layout or decode fault
            tol = 1e-4 * float(want.abs().max()) + 1e-5
            check(bool(torch.isfinite(got).all()) and err <= tol,
                  f"qmm {qt.name} N={N} K={K} T={T}: err {err} > tol {tol}")
            ms = timer.ms(lambda: qmm.quantized_matmul(x, fields, qt, g, N, K), 20)
            plain_ms = timer.ms(lambda: qmm.quantized_matmul_plain(x, fields, qt, g, N, K), 3)
            if w_lib is None:
                # the yardstick: a cuBLAS product with the weight dequantized
                # to the activation type ahead of time, in natural order
                w = qmm.dequant_stored(fields, qt, g)
                w_lib = w.reshape(N, g, K // g).transpose(1, 2).reshape(N, K)
                del w
            wl = w_lib.to(xdt)
            lib_ms = timer.ms(lambda: torch.matmul(x, wl.T), 20)
            del wl
            n_bytes = sum(nbytes(a) for a in fields.values()) + nbytes(x) + T * N * 4
            b_ms, b_by = bound_ms(n_bytes, 2.0 * T * N * K, "bf16" if xdt == bf16 else "f32")
            name = "qmm_gemv" if T <= qmm.GEMV_MAX_T else "qmm_tiled"
            rec = {"phase": "kernels", "kernel": name, "route": qmm.route(name, T),
                   "type": qt.name, "N": N, "K": K,
                   "T": T, "x": str(xdt).split(".")[-1], "scales": str(sdt).split(".")[-1],
                   "max_abs_err": err, "tol": tol,
                   "max_rel_err": err / max(float(want.abs().max()), 1e-30),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(rec)
            out.append(rec)
        del w_lib, fields
        torch.cuda.empty_cache()


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
    planes."""
    import torch

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm

    Q4, bf16, K = GGMLType.Q4_K, torch.bfloat16, 4096
    cases = [(4608, ((1, 2), (1, 4), (1, 8), (4, 4), (256, 4))), (4096, ((1, 4),)),
             (14336, ((1, 4),))]
    for N, runs in cases:
        fields = random_planes(Q4, N, K, bf16, gen, device)
        w_lib = natural_bf16(fields, Q4, N, K, 32)
        gemv_done = False
        for T, nk in runs:
            x = torch.randn((T, K), generator=gen, device=device).to(bf16)
            todo = [("qmm_ktiled", nk)]
            if T == 1 and not gemv_done:
                todo.append(("qmm_gemv", None))
                gemv_done = True
            for name, tile_k in todo:
                def kern():
                    return qmm.quantized_matmul(x, fields, Q4, 32, N, K, tile_k=tile_k)

                def plain():
                    if tile_k is None:
                        return qmm.quantized_matmul_plain(x, fields, Q4, 32, N, K)
                    return qmm.quantized_matmul_ktiled_plain(x, fields, Q4, 32, N, K, tile_k)

                before = dict(qmm.LAUNCHES)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                check(qmm.LAUNCHES[name] == before[name] + 1, f"{name} was not the route")
                err = float((got - want).abs().max())
                tol = 1e-4 * float(want.abs().max()) + 1e-5
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"{name} N={N} K={K} T={T} nk={tile_k}: err {err} > tol {tol}")
                ms = timer.ms(kern, 20)
                plain_ms = timer.ms(plain, 3)
                lib_ms = timer.ms(lambda: torch.matmul(x, w_lib.T), 20)
                n_bytes = sum(nbytes(a) for a in fields.values()) + nbytes(x) + T * N * 4
                b_ms, b_by = bound_ms(n_bytes, 2.0 * T * N * K, "bf16")
                rec = {"phase": "kernels", "kernel": name, "route": qmm.route(name, T),
                       "type": "Q4_K", "N": N, "K": K, "T": T, "nk": tile_k, "x": "bfloat16", "scales": "bfloat16", "max_abs_err": err,
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
    against its plain version; beside it the port's own unfused chain
    (qmm_gemv o-projection, residual, rms_norm, qmm_gemv [gate|up],
    silu * up) and that chain on pre-dequantized bf16 weights through
    torch.matmul (the library time)."""
    import torch
    import torch.nn.functional as F

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import fused_layer, qmm
    from tpullama_torch.ops.norms import rms_norm

    Q4, bf16 = GGMLType.Q4_K, torch.bfloat16
    E = Dq = 4096
    Fd, eps = 13696, 1e-5
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
    (act, r1), (want_act, want_r1) = kern(), plain()
    torch.cuda.synchronize()
    check(fused_layer.LAUNCHES["fused_postattn"] == before + 1, "fused_postattn did not launch")
    errs, tols = [], []
    for got, want in ((act, want_act), (r1, want_r1)):
        errs.append(float((got - want).abs().max()))
        # f32 sums in another order (both sides dequantize bit-equal weights)
        tols.append(1e-4 * float(want.abs().max()) + 1e-5)
        check(bool(torch.isfinite(got).all()) and errs[-1] <= tols[-1],
              f"fused_postattn: err {errs[-1]} > tol {tols[-1]}")
    ms = timer.ms(kern, 20)
    plain_ms = timer.ms(plain, 3)
    unfused_ms = timer.ms(unfused, 20)
    lib_ms = timer.ms(library, 20)
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
    the dispatch) each expert is read about twice."""
    import torch
    import torch.nn.functional as F

    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm, qmm_gathered
    from tpullama_torch.ops.moe import moe_dispatch

    Q4, Q6, Q8 = GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0
    bf16, f32 = torch.bfloat16, torch.float32
    E = 8
    served, small = ((8, 1), (2048, 8)), ((8, 1), (512, 8))
    # (transposed, type, n_out per expert, K, scale dtypes, (slots, tile_t)
    # routings): Mixtral's [gate | up] (row-major) and down (transposed)
    # stacks, then the other field sets and padded rows (320 of 384)
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
    group = {Q4: 32, Q6: 16, Q8: 32}
    for planes_t, qt, N, K, sdts, routings in cases:
        g = group[qt]
        R = -(-N // 128) * 128
        name = "qmm_gathered_t" if planes_t else "qmm_gathered"
        # the library's weights: every expert dequantized to bf16 in natural order
        rows = random_planes(qt, E * R, K, f32, gen, device)
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
                else:  # top-2 of 8 distinct experts per token
                    sel = torch.rand((S // 2, E), generator=gen, device=device).argsort(-1)[:, :2]
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

                got, want = kern(), plain()
                torch.cuda.synchronize()
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
                plain_ms = timer.ms(plain, 3)
                xb = x_slots.to(bf16)
                if tt == 1 and S <= 8:
                    lib = "torch.bmm on the gathered bf16 expert weights"
                    w_sel = w_lib[sel.long()].transpose(1, 2)
                    lib_ms = timer.ms(lambda: torch.bmm(xb[:, None, :], w_sel), 20)
                    del w_sel
                else:
                    lib = "torch.matmul per expert on its rows, summed"
                    lib_ms = 0.0
                    for e in range(E):
                        xe, we = xb[sel == e], w_lib[e]
                        lib_ms += timer.ms(lambda: torch.matmul(xe, we.T), 10)
                distinct = int(torch.unique(sel).numel())
                n_bytes = distinct * per_expert + nbytes(x_slots) + S * N * 4
                b_ms, b_by = bound_ms(n_bytes, 2.0 * S * N * K, "bf16")
                rec = {"phase": "kernels", "kernel": name,
                       "route": qmm_gathered.route(tt, planes_t), "type": qt.name, "N": N, "K": K,
                       "experts": E, "slots": S, "tile_t": tt, "rows": int(x.shape[0]),
                       "distinct_experts": distinct, "x": "float32",
                       "scales": str(sdt).split(".")[-1], "max_abs_err": err, "tol": tol,
                       "max_rel_err": err / max(float(want.abs().max()), 1e-30),
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library": lib,
                       "bound_ms": b_ms, "bound_by": b_by}
                emit(rec)
                out.append(rec)
            del fields
        del rows, w_lib
        torch.cuda.empty_cache()


def attn_inputs(B, Tq, Hq, Hkv, D, S, dtype, gen, device, kv_pos, q_pos):
    """Random q/k/v at head-major cache layout and the Context's additive
    mask: visible iff the cell holds a position at or before the query's."""
    import torch

    q = torch.randn((B, Tq, Hq, D), generator=gen, device=device).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=device).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=device).to(dtype)
    kp = torch.as_tensor(kv_pos, device=device)[:, None, :]
    qp = torch.as_tensor(q_pos, device=device)[:, :, None]
    vis = (kp >= 0) & (kp <= qp)
    mask = torch.where(vis, 0.0, -1e30).to(torch.float32)[:, None]
    return q, k, v, mask


def attn_case(timer, name, fn, q, k, v, mask, out, **kw):
    import torch
    import torch.nn.functional as F

    from tpullama_torch.ops.cuda.common import flash_plain, route

    B, Tq, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    got = fn(q, k, v, mask, scale, **kw)
    want = flash_plain(q, k, v, mask, scale, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    # both sides compute in f32; a bf16 output may round one step apart
    tol = (2.0 ** -7 if q.dtype == torch.bfloat16 else 1e-5) * float(want.float().abs().max()) + 1e-6
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"{name} B={B} Tq={Tq} S={S}: err {err} > tol {tol}")
    ms = timer.ms(lambda: fn(q, k, v, mask, scale, **kw), 20)
    plain_ms = timer.ms(lambda: flash_plain(q, k, v, mask, scale, **kw), 3)
    lib_ms = None
    if not kw:
        m_lib = mask.to(q.dtype)
        qt = q.transpose(1, 2)
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=m_lib, scale=scale, enable_gqa=True), 20)
    vis = mask[:, 0] > NEG_HIDDEN  # (B, Tq, S)
    n_pairs = int(vis.sum())
    n_cells = int(vis.any(dim=1).sum())  # cache rows some query needs
    elt = k.element_size()
    n_bytes = (nbytes(q) + 2 * n_cells * Hkv * D * elt + nbytes(mask) + nbytes(q))
    flops = 4.0 * n_pairs * Hq * D
    b_ms, b_by = bound_ms(n_bytes, flops, "bf16" if q.dtype == torch.bfloat16 else "f32")
    rec = {"phase": "kernels", "kernel": name, "route": route(q, k), "B": B, "Tq": Tq,
           "Hq": Hq, "Hkv": Hkv, "D": D, "S": S, "dtype": str(q.dtype).split(".")[-1],
           "extras": sorted(kw), "visible_pairs": n_pairs,
           "tflop_s": flops / ms / 1e9, "gb_s": n_bytes / ms / 1e6,
           "max_abs_err": err, "tol": tol,
           "max_rel_err": err / max(float(want.float().abs().max()), 1e-30),
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    out.append(rec)


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

    # the options the kernels take beyond the llama path, in f32 and bf16
    extras = dict(softcap=30.0,
                  sinks=torch.randn((Hq,), generator=gen, device=device),
                  alibi_slopes=torch.rand((Hq,), generator=gen, device=device))
    for dt in (torch.float32, bf16):
        kv, qp = decode_pos([500, 77], 512)
        q, k, v, mask = attn_inputs(2, 1, Hq, Hkv, D, 512, dt, gen, device, kv, qp)
        attn_case(timer, "flash_decode_batched", flash_decode, q, k, v, mask, out, **extras)
        kv = np.tile(np.arange(512, dtype=np.int32), (2, 1))
        qp = np.tile(np.arange(448, 512, dtype=np.int32), (2, 1))
        q, k, v, mask = attn_inputs(2, 64, Hq, Hkv, D, 512, dt, gen, device, kv, qp)
        attn_case(timer, "flash_attention", flash_attention, q, k, v, mask, out, **extras)


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
                phase: str = "model", fused_layer: bool = False):
    import torch

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
    os.remove(path)
    lm = (model.quant_meta or {}).get("layers", {})
    attn = {"attn_q", "attn_k", "attn_v", "attn_output"}
    if widths.n_expert:
        check(set(lm) == attn | {"ffn_gateup_exps", "ffn_down_exps"},
              f"every layer matrix and expert stack is packed: {sorted(lm)}")
        # gate|up (K = 4096: every plane width a multiple of 128) row-major,
        # down (K = 14336: 448 scale groups) transposed
        check(not lm["ffn_gateup_exps"].planes_t and lm["ffn_down_exps"].planes_t,
              "ffn_gateup_exps row-major and ffn_down_exps transposed")
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
    emit({"phase": phase, "layers": model.hparams.n_layer, "n_embd": model.hparams.n_embd,
          "n_vocab": model.hparams.n_vocab, "experts": model.hparams.n_expert,
          "planes_t": {k: m.planes_t for k, m in lm.items() if k.endswith("_exps")},
          "orders": {k: m.order for k, m in lm.items()},
          "write_s": t_write, "load_s": t_load, "device_bytes": model.nbytes(),
          "seconds": time.perf_counter() - t0})
    return model


def phase_crosscheck(tmp: str, widths: Widths = LLAMA3_8B, device: str = "cuda",
                     n_layer: int = 2, phase: str = "crosscheck", fused_layer: bool = False,
                     qmm_tile_k: int | None = None) -> None:
    """A model at the same widths cut to n_layer layers, f32 activations and
    cache on both sides: `device` (the card) runs the kernels, the CPU the
    plain versions, both with the fused layer and K-chunks as given. With
    the fused layer on, the card's greedy run with both off, on the same
    fourblock planes, must give the same tokens too."""
    import torch

    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams

    t0 = time.perf_counter()
    path = os.path.join(tmp, f"{phase}.gguf")
    write_llama_gguf(path, replace(widths, n_layer=n_layer), seed=1)
    gpu = load_model(path, dtype=torch.float32, device=device, packed=True,
                     fused_layer=fused_layer)
    cpu = load_model(path, dtype=torch.float32, device="cpu", packed=True,
                     fused_layer=fused_layer)
    os.remove(path)
    opts = dict(fused_layer=fused_layer, qmm_tile_k=qmm_tile_k)
    prompt = gpu.vocab.tokenize(word_prompt(np.random.default_rng(2), 40), add_special=True)
    prompt = np.asarray(prompt[:32], np.int32)
    check(len(prompt) == 32, f"prompt has {len(prompt)} tokens")
    cp = ContextParams(n_ctx=256)
    lg = Context(gpu, cp, **opts).decode(prompt, n_logits=32)
    lc = Context(cpu, cp, **opts).decode(prompt, n_logits=32)
    err = float(np.abs(lg - lc).max())
    # f32 end to end; sums run in another order on the card
    tol = 1e-3 * float(np.abs(lc).max()) + 1e-4
    check(np.isfinite(lg).all() and err <= tol, f"prefill logits err {err} > tol {tol}")
    check(int(lg[-1].argmax()) == int(lc[-1].argmax()), "prefill argmax differs")
    out_g = Context(gpu, cp, **opts).generate(prompt, n_predict=8)
    out_c = Context(cpu, cp, **opts).generate(prompt, n_predict=8)
    check(out_g == out_c, f"greedy tokens differ: card {out_g} cpu {out_c}")
    rec = {"phase": phase, "layers": n_layer, "prompt_tokens": len(prompt),
           "prefill_max_abs_err": err, "tol": tol, "argmax": int(lc[-1].argmax()),
           "greedy_tokens": out_g, **opts}
    if fused_layer:
        # nk = 1: no valid K-chunks, the untiled qmm kernels
        out_u = Context(gpu, cp, fused_layer=False, qmm_tile_k=1).generate(prompt, n_predict=8)
        check(out_u == out_g, f"fused/K-chunked {out_g} and unfused {out_u} card runs differ")
        rec["unfused_greedy_tokens"] = out_u
    emit({**rec, "seconds": time.perf_counter() - t0})


def phase_serve(model, card: str, phase: str = "serve", n_slots: int = 4, **engine_kw):
    """4 greedy requests submitted together (concurrent on 4 slots, in turn
    on 1), then one seeded sampled request alone, then the first greedy
    request again on erased slots. Rates come from the Context's counters
    over each window: host clock around work that ends in a device-to-host
    copy of logits or ids. `engine_kw` goes to ServerEngine. Returns the
    engine and one prompt, for phase_serve_profile."""
    import torch

    from tpullama_torch.runtime.sampling import SamplerChain
    from tpullama_torch.server import ServerEngine, Task

    def window(perf, before):
        now = (perf.n_prefill, perf.t_prefill_ms, perf.n_decode, perf.t_decode_ms)
        d = [a - b for a, b in zip(now, before)]
        return now, {"prefill_tokens": d[0], "prefill_tok_s": d[0] / d[1] * 1e3 if d[1] else None,
                     "decode_tokens": d[2], "decode_tok_s": d[2] / d[3] * 1e3 if d[3] else None}

    t0 = time.perf_counter()
    eng = ServerEngine(model, n_slots=n_slots, n_ctx=4096, dtype=torch.bfloat16, **engine_kw)
    perf = eng.ctx.perf
    mark = (0, 0.0, 0, 0.0)
    rng = np.random.default_rng(3)
    prompts = [word_prompt(rng, n) for n in (300, 550, 780, 1000)]
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
    again = eng.complete(prompts[0], n_predict=32)
    check(again.out_tokens == tasks[0].out_tokens,
          "a greedy request run again gave other tokens")
    n_out = sum(len(t.out_tokens) for t in tasks)
    emit({"phase": phase, "card": card, "requests": len(tasks) + 2, "n_slots": n_slots,
          **engine_kw, "prompt_tokens": [len(t.prompt_tokens) for t in tasks],
          "completion_tokens": [len(t.out_tokens) for t in tasks + [sampled, again]],
          "greedy4": {**concurrent, "wall_s": wall, "output_tok_s": n_out / wall,
                      "ttft_ms": [t.ttft_ms for t in tasks]},
          "sampled_alone": {**alone, "ttft_ms": sampled.ttft_ms},
          "sampled_text": sampled.out_text[:80], "seconds": time.perf_counter() - t0})
    return eng, prompts[3]


def phase_serve_profile(eng, prompt: str, card: str, phase: str = "serve_profile",
                        step_kernels: tuple = ()) -> None:
    """torch.profiler over the served engine's Context, whose lanes still
    hold the requests: one packed B x 256 prefill chunk and one decode
    step of all B lanes. Then one more decode step with every launch count
    at 0: each kernel of `step_kernels` must have launched once per layer."""
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts

    ctx = eng.ctx
    B = ctx.p.n_seqs
    chunk = eng.vocab.tokenize(prompt, add_special=False)[:256]

    def decode():
        return ctx.decode_batch(np.full(B, 100, np.int32), np.ones(B, bool))

    rec = {"phase": phase, "card": card,
           f"prefill_chunk_{B}x{len(chunk)}": profile_step(
               ctx, lambda: ctx.decode_multi([(s, chunk) for s in range(B)]), B * len(chunk), 2),
           f"decode_batch_b{B}": profile_step(ctx, decode, B, 8)}
    reset_launch_counts()
    decode()
    rec["decode_step_launches"] = counts = launch_counts()
    emit(rec)
    n_layer = ctx.hp.n_layer
    for name in step_kernels:
        check(counts[name] == n_layer,
              f"a decode step launched {name} {counts[name]} times, not once per layer")


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


def step_bound(ctx, rows: int, kv_cells: int, routing: list, n_steps: int) -> tuple[float, str]:
    """Least card time of one forward step over `rows` new tokens of a
    Context on a packed model: every packed weight plane, every dense layer
    matrix and each of the kv_cells K/V rows the cache holds read once, and
    2 * rows * N * K operations over the layer matrices plus 2 * N * K per
    lane for the lm_head, at the bf16 peak. An MoE layer counts only the experts its
    routing selected (`routing`: the (B, T, k) expert ids the router chose
    over n_steps steps, layer after layer), each expert's planes once, and
    its experts' operations over rows * k. Norms, rope, the router and
    attention's own operations are left out, so this is a lower bound."""
    model = ctx.model
    hp = model.hparams
    p, lm = model.params, model.quant_meta["layers"]
    n_bytes = sum(nbytes(a) for a in p["output"].values())
    n_bytes += kv_cells * 2 * nbytes(ctx.kv_k[:, 0, :, 0])
    flops = 2.0 * ctx.p.n_seqs * model.quant_meta["output"].n_out * model.quant_meta["output"].n_in
    for key, w in p["layers"].items():
        if not isinstance(w, dict):
            if w.dim() == 3:  # a dense (L, n_out, n_in) matrix stack
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
    if hp.n_expert:  # gate, up (F x D) and down (D x F) per selected expert
        F, D = lm["ffn_down_exps"].n_in, hp.n_embd
        flops += 2.0 * rows * hp.n_expert_used * hp.n_layer * 3 * F * D
    return bound_ms(n_bytes, flops, "bf16")


def profile_step(ctx, step, rows: int, n_steps: int) -> dict:
    """Where one kind of Context step spends its time: host wall per step
    (synchronised, without the profiler), then a second run of n_steps
    under torch.profiler: its wall, the card's busy time (the sum of the
    kernels the profiler saw) and idle share in that same window, the
    kernels that take the most, and the step's bound. The idle share
    comes from the profiled window alone because each step grows the
    cache, so the two windows do not do the same work."""
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
    with recorded_routing([]) as routing, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    b_ms, b_by = step_bound(ctx, rows, kv_cells, routing, n_steps)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / n_steps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return {"rows": rows, "steps": n_steps, "wall_ms": wall_ms,
            "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / prof_wall_ms, "bound_ms": b_ms, "bound_by": b_by,
            "device_launches": sum(e.count for e in dev) / n_steps,
            "top": [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3 / n_steps,
                     "launches": e.count / n_steps} for e in top]}


# (name, source, TPU kernel it replaces, the kernels-phase case whose
# numbers the kernels line carries: the served path's shape)
KERNELS = (
    ("qmm_gemv", "tpullama_torch/csrc/qmm.cu", "tpullama/ops/pallas/qmm.py:296",
     dict(T=4, N=14336, K=4096, x="bfloat16")),
    ("qmm_tiled", "tpullama_torch/csrc/qmm.cu", "tpullama/ops/pallas/qmm.py:296",
     dict(T=1024, N=14336, K=4096, x="bfloat16")),
    ("flash_attention", "tpullama_torch/csrc/flash_attention.cu",
     "tpullama/ops/pallas/flash_attention.py:40", dict(B=4, Tq=256, extras=[])),
    ("flash_decode", "tpullama_torch/csrc/flash_decode.cu",
     "tpullama/ops/pallas/flash_decode.py:60", dict(B=1, extras=[])),
    ("flash_decode_batched", "tpullama_torch/csrc/flash_decode.cu",
     "tpullama/ops/pallas/flash_decode.py:141", dict(B=4, extras=[])),
    ("qmm_gathered", "tpullama_torch/csrc/qmm_gathered.cu", "tpullama/ops/pallas/qmm.py:655",
     dict(slots=2048, N=28672, K=4096, scales="bfloat16")),
    ("qmm_gathered_t", "tpullama_torch/csrc/qmm_gathered.cu", "tpullama/ops/pallas/qmm.py:771",
     dict(slots=2048, N=4096, K=14336, scales="bfloat16")),
    ("qmm_ktiled", "tpullama_torch/csrc/qmm_ktiled.cu", "tpullama/ops/pallas/qmm.py:450",
     dict(T=1, N=4608, K=4096, nk=4)),
    ("fused_postattn", "tpullama_torch/csrc/fused_layer.cu",
     "tpullama/ops/pallas/fused_layer.py:112", dict(E=4096, Fd=13696)),
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
}
# each path's model: (phase prefix, widths, cross-check layers, served
# slots, the two opt-ins)
PATHS = (("", LLAMA3_8B, 2, 4, {}),
         ("moe_", MIXTRAL_8X7B, 1, 4, {}),
         ("glm_", CHATGLM3_6B, 1, 1, GLM_OPTS),
         ("qwen_", QWEN2_1_5B, 2, 0, {}))  # the cross-check alone


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
    and its numbers at the served shape from the kernels phase."""
    rows = []
    for name, src, replaces, key in KERNELS:
        rec = next((r for r in records if r["kernel"] == name
                    and all(r.get(k) == v for k, v in key.items())), {})
        by_path = {p: c[name] for p, c in launches.items()}
        rows.append({"name": name, "route": "cuda", "body": rec.get("route"), "source": src,
                     "replaces": replaces,
                     "launches": sum(by_path.values()) if by_path else None,
                     "launches_by_path": by_path, "max_abs_err": rec.get("max_abs_err"),
                     "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
                     "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
                     "library_ms": rec.get("library_ms")})
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
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_count": torch.cuda.device_count()})

    if "build" in phases or "kernels" in phases:
        t0 = time.perf_counter()
        build.library()
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "ptxas.txt"), "w") as f:
            for src, log in build.ptxas_report.items():
                f.write(f"==== {src}\n{log}\n")
        emit({"phase": "build", "nvcc_s": build.build_seconds,
              "seconds": time.perf_counter() - t0,
              "spills": sorted({ln.strip() for log in build.ptxas_report.values()
                                for ln in log.splitlines()
                                if "spill" in ln and not ln.strip().startswith("0 bytes")})})

    records: list = []
    if "kernels" in phases:
        t0 = time.perf_counter()
        timer = Timer(device)
        gen = torch.Generator(device=device).manual_seed(0)
        qmm_cases(timer, gen, device, records)
        ktiled_cases(timer, gen, device, records)
        fused_cases(timer, gen, device, records)
        gathered_cases(timer, gen, device, records)
        attention_cases(timer, gen, device, records)
        del timer
        torch.cuda.empty_cache()
        emit({"phase": "kernels", "cases": len(records), "seconds": time.perf_counter() - t0})

    launches: dict = {}
    # the Llama path, the Mixtral path, the ChatGLM path
    for pre, widths, cross_layers, n_slots, opts in PATHS:
        run = [p for p in ("model", "crosscheck", "serve") if pre + p in phases]
        if not run:
            continue
        fused = bool(opts.get("fused_layer"))
        with tempfile.TemporaryDirectory() as tmp:
            model = None
            if "model" in run or "serve" in run:
                model = phase_model(tmp, widths, phase=pre + "model", fused_layer=fused)
            if "crosscheck" in run:
                launches[pre + "crosscheck"], _ = path_launches(
                    pre + "crosscheck", lambda: phase_crosscheck(
                        tmp, widths, n_layer=cross_layers, phase=pre + "crosscheck", **opts))
            if "serve" in run:
                launches[pre + "serve"], (eng, prompt) = path_launches(
                    pre + "serve", lambda: phase_serve(model, smi, phase=pre + "serve",
                                                       n_slots=n_slots, **opts))
                phase_serve_profile(eng, prompt, smi, phase=pre + "serve_profile",
                                    step_kernels=("qmm_ktiled", "fused_postattn") if fused
                                    else ())
                del eng
            del model
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    print(json.dumps(kernels_line(records, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
