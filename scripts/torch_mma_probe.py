#!/usr/bin/env python3
"""Where the time of the port's qmm and attention bodies goes, on one CUDA card.

    python3 scripts/torch_mma_probe.py [--body all|mma|group|attention|gemv|fused|gathered_t|ktiled]
                                       [--qtype Q4_K|MXFP4|MXFP4_AR]

Builds copies of qmm.cu, qmm_gathered.cu and qmm_ktiled.cu (or of
flash_attention.cu and flash_decode.cu, or fused_layer.cu) from
tpullama_torch/csrc in which phases of a body's loop are removed, and
times each copy at the served shapes of chip_smoke.py's kernels phase.
`--qtype` picks the planes the qmm bodies (mma, group, gemv, gathered_t,
ktiled) read at those shapes: Q4_K (the default), MXFP4's LUT planes
{q4_lut, scale} or its A/r re-code {q4a, q1r, scale} (MXFP4_AR; not for
ktiled, whose reference never chunks the A/r planes), all with bf16
scales.

Body "mma" (qmm_mma.cuh, `mma_tile`): qmm_gathered over Mixtral's
[gate | up] (28672 x 4096 x 8 experts, bf16 scales) at 2048 and 512 slots
and over 320-row experts at 512 slots, and qmm_ktiled over ChatGLM3-6B's
attn_qkv (4608 x 4096, T = 256, nk = 4). Variants:
  full      the kernels as they are
  nomma     without the products (copies and dequantization)
  nosplit   without the dequantization (copies and products)
  nocopy    without the loop's copies (dequantization and products)
  mma_only  products only
  empty     the loop's barriers alone

Body "group" (qmm_group_mma.cuh, `group_tile`): qmm_tiled over
Llama-3-8B's ffn_up (Q4_K 14336 x 4096, bf16 x and scales, T = 1024, the
packed 4 x 256 chunk) and qmm_gathered_t over Mixtral's down (4096 x
14336 x 8 experts, bf16 scales, f32 x) at 2048 and 512 slots. Variants:
  full       the kernels as they are
  nocopy     without the loop's copies and their waits (the ring keeps its
             first slices)
  nox        without the tensor copies of x (and their waits)
  noweights  without the row-major planes' tensor copies (bytes, scales,
             mins) and their waits
  noscales   without the cp.async copies: xgsum (transposed planes: and
             their bytes, scales and mins)
  noconv     without the integer unpacking (raw words as fragments)
  nomma      the products replaced by one integer op each (the unpacking
             and the fragment loads stay live)
  nofold     without the per-column epilogue (products summed straight
             into the accumulators, no scale)
  nomin      without the min term's products
  mma_only   products only (no copies, unpacking, epilogue or min term)
  empty      the loop's barriers alone
Body "attention" (flash_attention.cu, `fa_kernel`, the tensor-core
route over a bf16 cache and over an int8 one, "int8" in the case's name):
Llama-3-8B's packed 4 x 256 prefill chunk and the 1 x 256 chunk over a
4224-cell cache (chip_smoke.py's lanes), and flash_decode at B = 1 and
B = 4 (its achieved GB/s, the bytes of chip_smoke.py's bound over the
median time). Variants:
  full       the kernel as it is
  nocopy     without the K/V tile copies (int8: the raw bytes' staging;
             the mask rows still staged)
  noconvert  int8 only: without converting the staged bytes to bf16 tiles
  nomask     without the mask: no staged mask rows, no masking of scores
  nosoftmax  without the online softmax, V's int8 scales and the
             rescaling of o
  mma_only   products only (the up-front mask scan and the tile list stay)
  empty      the loop's barriers, the scan and the list alone
and flash_decode.cu (`fd_kernel`, timed at B = 1 and B = 4 only):
  fd_nocopy    without the chunk's K/V copies (int8: their staging)
  fd_noconvert int8 only: without converting the staged bytes
  fd_nocombine without the merge of the block's four warps
  fd_nomerge   without the last block's merge of the chunks (no output)
Body "gemv" (qmm_gemv.cuh, `qmm_gemv_kernel`, the decode route): qmm_gemv
over Llama-3-8B's ffn_up (Q4_K 14336 x 4096, bf16 x and scales) at T = 4
(the server's B = 4 step) and T = 1, and over its ffn_down (4096 x 14336)
at T = 4, each with its achieved GB/s, timed twice: after chip_smoke.py's
flush, which writes 512 MiB and so leaves L2 full of dirty lines (a call's
misses then also write them back), and after a flush that reads the
buffer ("readflush": clean lines, as a decode step leaves L2, its
weights read and its outputs small). Variants:
  full      the kernel as it is
  nostage   without staging x (and its column sums) into shared memory
  nounpack  without the byte permutes and the 2^23 bias: raw words as
            values
  nofma     without the FMAs and x reads of x rows past the first
  noxread   without the x reads from shared memory (an FADD per value
            and x row instead of the FMA)
  loads     the weight and scale copies and the fold alone (nostage,
            nounpack, nofma, noxread: one FADD per value)
  bothstages both ring stages' copies started at the block's start
Body "fused" (fused_layer.cu, `fused_postattn_kernel` on the decode body
of qmm_gemv.cuh): fused_postattn at ChatGLM3-6B's shape (E = Dq = 4096,
2Fd = 27392, Q4_K fourblock planes, bf16 inputs and scales), with its
achieved GB/s, after chip_smoke.py's flush and after a reading flush.
Variants:
  full      the kernel as it is
  phase_a   the o-projection alone (no [gate | up] tiles)
  phase_b   the norm and [gate | up] alone (no o-projection tiles)
  nobarrier without the grid barrier between the two
  loads     the weight and scale copies, the fold, the norm and the
            barrier alone (no staging, unpacking, FMAs or x reads, as the
            gemv body's `loads`)
  threads288 blocks of 288 threads (36-row tiles: 761 [gate | up] tiles,
            under 3 rounds of the 264 resident blocks, against 856 tiles
            in 3.2 rounds at 256); the outputs stay right
Body "gathered_t" (qmm_gathered_t.cuh, `gt_body`, the transposed one-row
decode route): qmm_gathered_t over Mixtral's down (4096 x 14336 x 8
experts, Q4_K, bf16 scales, f32 x) at 8 one-row tiles over 8, 6 and 2
experts (chip_smoke.decode_sel), with its achieved GB/s (the distinct
experts' bytes), after the writing flush and after a reading flush.
Variants:
  full      the kernel as it is
  loads     the weight copies, the scale loads, the fold and the parts'
            sums alone (no x staging, no byte permutes, an FADD per value
            instead of x reads and FMAs)
  bothstages both ring stages' copies started at the block's start
  cols16    column splits of 16 scale columns (twice the blocks; the
            wrapper's workspace follows, T_SPLIT_COLS)
Body "ktiled" (qmm_ktiled.cu, `qmm_ktiled_gemv_kernel` on the decode body):
qmm_ktiled over ChatGLM3-6B's attn_qkv (4608 x 4096, Q4_K, bf16 x and
scales) at T = 1 (nk = 2, 4, 8) and T = 4 (nk = 4), with GB/s, after both
flushes. Variants:
  full      the kernel as it is: chunk k is byte rows [kJ/nk, (k+1)J/nk) of
            every scale column (the reference's chunk), min term in chunk 0
  loads     as the gemv body's `loads` (no staging, unpacking, FMAs or x
            reads)
  classes   chunk k as classes [kC/nk, (k+1)C/nk) of 4 columns (C classes
            a row) over all byte rows, each chunk with its own min terms:
            the alternative split (its sum order differs from the plain
            version's chunks; the outputs stay within tolerance)
  bothstages both ring stages' copies started at the block's start
  nosum     without the second launch that sums the chunks' parts (no
            output)
  widering  the ring at its whole-row pitch (16 byte rows a row) instead
            of the chunk's rows alone
  lb4       launch bounds of 4 blocks an SM at T <= 2 (at most 64
            registers)
  t128      blocks of 128 threads (16 rows) instead of gemv_threads(N)
  stagefit  x staged only up to the row's last class (no zero columns
            past it)
A variant's outputs are wrong by construction; only its time means
anything. Each copy's `-Xptxas -v` report (registers, spills) goes to
chiprun_out/probe_ptxas_<body>.txt. Prints the card's name and power limit (nvidia-smi) and one
line per (variant, shape) with three timed rounds and their median (ms,
CUDA events, L2 flushed before each launch).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MMA1 = "    mma_steps<KIND, XLO, ST, BN, 0, 2>(smem, sl & 1, sl % MMA_XBUF, j0, j1, acc);\n"
MMA2 = "    mma_steps<KIND, XLO, ST, BN, 2, MMA_BK / 16>(smem, sl & 1, sl % MMA_XBUF, j0, j1, acc);\n"
SPLIT = ("    if (wt && sl + 1 < n) split_w(sl + 1);\n", "")
COPY_W = ("    copy_w(sl + 3);  // GW, into the stage just consumed\n", "    cp_async_commit();\n")
COPY_X = ("    copy_x(sl + 2);  // GX\n", "    cp_async_commit();\n")
# group body (qmm_group_mma.cuh)
G_COPY = [("    copy(sl + S - 1);  // into the stage slice sl - 1 held\n", "    cp_async_commit();\n"),
          ("    gm_bar_wait(bars + 8 * s, (phases >> s) & 1);  // and its x\n", ""),
          ("    if (!TRANS && sl % GG::WSL == 0) {  // and its weight buffer\n", "    if (false) {\n")]
G_CONV = ("      for (int ks = 0; ks < GG::KS; ++ks) frag_a(wd, cc, ks, tig, a[ks]);\n",
          "      for (int ks = 0; ks < GG::KS; ++ks) for (int mi = 0; mi < 2; ++mi)"
          " for (int i = 0; i < 4; ++i) a[ks][mi][i] = wd(i, 2 * mi + (i & 1));\n")
G_MMA_CALL = """                  if (ks == 0 && p == 0)  // the column's first products
                    gm_mma_first(ca[mi][j], a[ks][mi], b[j / 2][2 * (j % 2)],
                                 b[j / 2][2 * (j % 2) + 1]);
                  else
                    mma_bf16(ca[mi][j], a[ks][mi], b[j / 2][2 * (j % 2)],
                             b[j / 2][2 * (j % 2) + 1]);
"""
G_MMA = (G_MMA_CALL, "                  ca[mi][j][0] = __uint_as_float(a[ks][mi][0] ^ b[j / 2][2 * (j % 2)]);\n")
G_FOLD_EXPR = "fmaf(sv[cc][2 * mi + (e >> 1)], ca[mi][j][e], acc[mi][h0 + j][e]);"
G_FOLD = [(G_MMA_CALL, G_MMA_CALL.replace("ca[mi][j]", "acc[mi][h0 + j]").replace(
               "gm_mma_first", "mma_bf16")),
          (G_FOLD_EXPR, "acc[mi][h0 + j][e];")]
G_NOX = [("        group_copy_x<KIND, XLO, ST, BN, TRANS>((unsigned)__cvta_generic_to_shared(st),\n"
          "                                               bars + 8 * (sl % S), gx, "
          "sl * GM_CS * GG::GROUP);\n", ""),
         ("    gm_bar_wait(bars + 8 * s, (phases >> s) & 1);  // and its x\n", "")]
G_NOW = [("        if (!TRANS && sl % GG::WSL == 0) {\n", "        if (false) {\n"),
         ("    if (!TRANS && sl % GG::WSL == 0) {  // and its weight buffer\n", "    if (false) {\n")]
G_NOSMALL = [("      group_copy<KIND, XLO, ST, BN, TRANS>(st, w, xg, xg_rows, xrow, K, sl * GM_CS, "
              "threadIdx.x,\n", "      if (false) group_copy<KIND, XLO, ST, BN, TRANS>(st, w, xg, "
              "xg_rows, xrow, K, sl * GM_CS, threadIdx.x,\n")]
G_MIN = ("    if constexpr (GG::MIN) GroupWarp::template min_slice<ALL>(st, wb, cg, ja, jb, acc);\n",
         "")
# attention (flash_attention.cu)
A_COPY = ("      copy_kv<MMA, D, KVT>(kv_s + (2 * buf) * TILE, kv_s + (2 * buf + 1) * TILE, kh, vh,\n"
          "                           CELLS * t, S, Dr);\n", "      ;\n")
A_COPY8 = ("      stage_kv_i8<D>(raw + (2 * buf) * CELLS * D, raw + (2 * buf + 1) * CELLS * D,\n"
           "                     reinterpret_cast<const int8_t*>(kh), "
           "reinterpret_cast<const int8_t*>(vh),\n"
           "                     CELLS * t, S, Dr);\n", "      ;\n")
A_CONV = ("      convert_i8<D>(kv_s, raw + (2 * buf) * CELLS * D);\n"
          "      convert_i8<D>(kv_s + TILE, raw + (2 * buf + 1) * CELLS * D);\n", "")
A_STAGE = ("        cp_async_cg(mb + i, mask_p + (size_t)pr * S + (ok ? cell : 0), ok);\n", "")
A_MASK = ("    mask_scores<NT>(s, mr, sb, S - CELLS * t, rw, tig, scale, softcap, slopes != nullptr);\n",
          "")
A_SOFTMAX = ("    softmax_run<NT>(s, m, l, alpha);\n"
             "    if constexpr (SC) scale_probs<NT>(s, sb + CELLS, S - CELLS * t, tig);\n"
             "    rescale<D>(o, alpha);\n", "")
A_QK = ("    if constexpr (MMA) qk_mma<D, NT>(s, afrag, ks, 0, lane);\n",
        "    if constexpr (MMA) { for (int j = 0; j < NT; ++j) for (int e = 0; e < 4; ++e)"
        " s[j][e] = 0.f; }\n")
A_PV = ("    if constexpr (MMA) pv_mma<D, NT>(o, s, vs, 0, lane);\n",
        "    if constexpr (MMA) o[0][0] += s[0][0];\n")
# flash_decode.cu, as (file, old, new)
FD = "flash_decode.cu"
D_COPY = (FD, "      copy_kv<MMA, D, KVT>(ks, vs, k + (size_t)bh * S * Dr, v + (size_t)bh * S * Dr, "
          "s0, S, Dr);\n", "")
D_COPY8 = (FD, "      stage_kv_i8<D>(raw, raw + CELLS * D, reinterpret_cast<const int8_t*>(k) + "
           "(size_t)bh * S * Dr,\n                     reinterpret_cast<const int8_t*>(v) + "
           "(size_t)bh * S * Dr, s0, S, Dr);\n", "")
D_CONV = (FD, "      convert_i8<D>(reinterpret_cast<__nv_bfloat16*>(ks), raw);\n"
          "      convert_i8<D>(reinterpret_cast<__nv_bfloat16*>(vs), raw + CELLS * D);\n", "")
D_COMBINE = (FD, "    for (int i = tid; i < nr * D; i += THREADS) {\n",
             "    for (int i = tid; i < 0; i += THREADS) {\n")
D_MERGE = (FD, "  for (int w0 = 0; w0 < NC; w0 += W) {\n", "  for (int w0 = 0; w0 < 0; w0 += W) {\n")
# decode body (qmm_gemv.cuh)
V_STAGE = ("        gv_stage<KIND, TT>(x, x_bf16, xs, xsum, T, K, G, cs);\n", "")
V_UNPACK = ("  for (int b = 0; b < 4; ++b) q[b] = gv_magic(v, b) - bias;\n",
            "  for (int b = 0; b < 4; ++b) q[b] = __uint_as_float(v);\n")
V_FMA = ("  for (int t = 0; t < TT; ++t) {\n    const float4 u",
         "  for (int t = 0; t < 1; ++t) {\n    const float4 u")
V_XREAD = ("      for (int c = 0; c < GV_CW; ++c) acc[r][c][t] = fmaf(q[r][c], xv[c], acc[r][c][t]);\n",
           "      for (int c = 0; c < GV_CW; ++c) acc[r][c][t] += q[r][c];\n")
# fused post-attention step (fused_layer.cu), as (file, old, new)
FL = "fused_layer.cu"
F_NOA = (FL, "for (int nb = blockIdx.x * ROWS; nb < E;", "for (int nb = blockIdx.x * ROWS; nb < 0;")
F_NOB = (FL, "for (int j0 = blockIdx.x * (ROWS / 2); j0 < Fd;",
         "for (int j0 = blockIdx.x * (ROWS / 2); j0 < 0;")
F_SYNC = (FL, "  grid.sync();\n", "")
F_NOSTAGE = (FL, "    if (cs == staged) return;\n", "    return;\n")
F_T288 = (FL, "constexpr int THREADS = 256;", "constexpr int THREADS = 288;")
GEMV_H = "qmm_gemv.cuh"
# transposed one-row body (qmm_gathered_t.cuh)
T_STAGE = ("  for (int i = tid; i < TT * GT_COLS * 8; i += GT_THREADS) {\n",
           "  for (int i = tid; i < 0; i += GT_THREADS) {\n")
T_FMA = ("            for (int r = 0; r < GT_TR; ++r) acc[r][t] = fmaf(q[r / 4][r % 4], xa, acc[r][t]);\n",
         "            for (int r = 0; r < GT_TR; ++r) acc[r][t] += q[r / 4][r % 4];\n")
T_PRE = [("  copy(0);  // in flight while the block stages x\n",
          "  copy(0);  // in flight while the block stages x\n  copy(1);\n"),
         ("    copy(s + 1);\n", "    if (s > 0) copy(s + 1);\n")]
T_COLS16 = ("constexpr int GT_COLS = 32; ", "constexpr int GT_COLS = 16; ")
# decode body: both ring stages' copies started at the block's start
V_PRE = [(GEMV_H, "  copy(0);          // in flight while the block stages x\n",
          "  copy(0);          // in flight while the block stages x\n  copy(1);\n"),
         (GEMV_H, "        copy(s + 1);\n", "        if (s > 0) copy(s + 1);\n")]
# qmm_ktiled.cu at T <= 8, as (file, old, new)
KT = "qmm_ktiled.cu"
K_LB4 = (KT, "__launch_bounds__(256, TT <= 4 ? 2 : 1) qmm_ktiled_gemv_kernel(",
         "__launch_bounds__(256, TT <= 2 ? 4 : (TT <= 4 ? 2 : 1)) qmm_ktiled_gemv_kernel(")
K_T128 = (KT, "const int threads = gemv_threads(N), rows = threads / GV_L * GV_RT;",
          "const int threads = 128, rows = threads / GV_L * GV_RT;")
V_FIT = (GEMV_H, "    const int t = i / SW, cl = i - t * SW, c = cs + cl;\n",
         "    const int t = i / SW, cl = i - t * SW, c = cs + cl;\n"
         "    if (c >= (G + GV_CW - 1) / GV_CW * GV_CW) continue;\n")
K_CLASSES = [
    (KT, "gv_smem, part, GvRows{J * k / nk, J * (k + 1) / nk, k == 0});",
     "gv_smem, part, GvRows{0, J, true, (G + 3) / 4 * k / nk, (G + 3) / 4 * (k + 1) / nk});"),
    (KT, "gv_smem_bytes<KIND, TT>(threads, GvGeo<KIND>::JROWS / nk);",
     "gv_smem_bytes<KIND, TT>(threads);"),  # whole byte rows: the whole ring
    (GEMV_H, "  int j0, j1;\n  bool mins;\n};", "  int j0, j1;\n  bool mins;\n  int k0 = 0, k1 = 1 << 30;\n};"),
    (GEMV_H, "const int c0 = GV_L * (s / NR), h = h0 + s % NR;",
     "const int c0 = rows.k0 + GV_L * (s / NR), h = h0 + s % NR;"),
    (GEMV_H, "    if (c0 < NC) {\n", "    if (c0 < min(NC, rows.k1)) {\n"),
    (GEMV_H, "  for (int c0 = 0; c0 < NC; c0 += SC) {\n    const int nsc = min(SC, NC - c0);",
     "  for (int c0 = rows.k0; c0 < min(NC, rows.k1); c0 += SC) {\n"
     "    const int nsc = min(SC, min(NC, rows.k1) - c0);"),
    (GEMV_H, "      const bool on = k < NC;", "      const bool on = k < min(NC, rows.k1);"),
]
# (header, patches) per variant of each body
VARIANTS = {
    "mma": {
        "full": [],
        "nomma": [(MMA1, ""), (MMA2, "")],
        "nosplit": [SPLIT],
        "nocopy": [COPY_W, COPY_X],
        "mma_only": [SPLIT, COPY_W, COPY_X],
        "empty": [(MMA1, ""), (MMA2, ""), SPLIT, COPY_W, COPY_X],
    },
    "group": {
        "full": [],
        "nocopy": G_COPY,
        "nox": G_NOX,
        "noweights": G_NOW,
        "noscales": G_NOSMALL,
        "noconv": [G_CONV],
        "nomma": [G_MMA],
        "nofold": G_FOLD,
        "nomin": [G_MIN],
        "mma_only": [*G_COPY, G_CONV, *G_FOLD, G_MIN],
        "empty": [*G_COPY, G_CONV, (G_MMA_CALL, ""), (G_FOLD_EXPR, "acc[mi][h0 + j][e];"), G_MIN],
    },
    "attention": {
        "full": [],
        "nocopy": [A_COPY, A_COPY8],
        "noconvert": [A_CONV],
        "nomask": [A_STAGE, A_MASK],
        "nosoftmax": [A_SOFTMAX],
        "mma_only": [A_COPY, A_COPY8, A_CONV, A_STAGE, A_MASK, A_SOFTMAX],
        "empty": [A_COPY, A_COPY8, A_CONV, A_STAGE, A_MASK, A_SOFTMAX, A_QK, A_PV],
        "fd_nocopy": [D_COPY, D_COPY8],
        "fd_noconvert": [D_CONV],
        "fd_nocombine": [D_COMBINE],
        "fd_nomerge": [D_MERGE],
    },
    "gemv": {
        "full": [],
        "nostage": [V_STAGE],
        "nounpack": [V_UNPACK],
        "nofma": [V_FMA],
        "noxread": [V_XREAD],
        "loads": [V_STAGE, V_UNPACK, V_FMA, V_XREAD],
        "bothstages": V_PRE,
    },
    "fused": {
        "full": [],
        "phase_a": [F_NOB],
        "phase_b": [F_NOA],
        "nobarrier": [F_SYNC],
        "loads": [F_NOSTAGE, *((GEMV_H, *v) for v in (V_UNPACK, V_FMA, V_XREAD))],
        "threads288": [F_T288],
    },
    "gathered_t": {
        "full": [],
        "loads": [T_STAGE, T_FMA, (GEMV_H, *V_UNPACK)],
        "bothstages": T_PRE,
        "cols16": [T_COLS16],
    },
    "ktiled": {
        "full": [],
        "loads": [(KT, *V_STAGE), *((GEMV_H, *v) for v in (V_UNPACK, V_FMA, V_XREAD))],
        "classes": K_CLASSES,
        "bothstages": V_PRE,
        "nosum": [(KT, "  return (int)gv_sum_parts(ws, y, T * N, nk, st);", "  return 0;")],
        "lb4": [K_LB4],
        "t128": [K_T128],
        "stagefit": [V_FIT],
        "widering": [(GEMV_H, "  const int pitch = gv_pitch<KIND>(rows.j1 - rows.j0);",
                      "  const int pitch = gv_pitch<KIND>(16);"),
                     (KT, "gv_smem_bytes<KIND, TT>(threads, GvGeo<KIND>::JROWS / nk);",
                      "gv_smem_bytes<KIND, TT>(threads);")],
    },
}
# the file each body's patches edit, and the sources each copy builds
HEADER = {"mma": "qmm_mma.cuh", "group": "qmm_group_mma.cuh", "attention": "flash_attention.cu",
          "gemv": "qmm_gemv.cuh", "fused": FL, "gathered_t": "qmm_gathered_t.cuh", "ktiled": KT}
# qmm.cu links with qmm_lowbit.cu and qmm_mxfp4.cu, qmm_gathered.cu with
# qmm_gathered_lowbit.cu and qmm_gathered_mxfp4.cu (their entry points
# dispatch the q1/q2 and MXFP4 sets there)
QMM = ("qmm.cu", "qmm_lowbit.cu", "qmm_mxfp4.cu")
GATHERED = ("qmm_gathered.cu", "qmm_gathered_lowbit.cu", "qmm_gathered_mxfp4.cu")
QMM_SOURCES = (*QMM, *GATHERED, "qmm_ktiled.cu")
SOURCES = {"mma": QMM_SOURCES, "group": QMM_SOURCES,
           "attention": ("flash_attention.cu", "flash_attention_int8.cu", "flash_decode.cu",
                         "flash_decode_int8.cu", *QMM), "gemv": QMM,
           "fused": ("fused_layer.cu", *QMM), "gathered_t": (*QMM, *GATHERED),
           "ktiled": (*QMM, "qmm_ktiled.cu")}
# bodies timed after both flushes, with GB/s
READ_FLUSH = ("gemv", "fused", "gathered_t", "ktiled")
# wrapper constants a variant changes with its kernel: (module, name, value)
VARIANT_PY = {("gathered_t", "cols16"): ("qmm_gathered", "T_SPLIT_COLS", 16)}


def start_build(body: str, name: str, patches: list, root: str):
    """Patch a copy of the sources and start its nvcc processes."""
    from tpullama_torch.ops.cuda import build

    d = os.path.join(root, f"{body}-{name}")
    os.makedirs(d)
    for f in os.listdir(build.CSRC):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(build.CSRC / f, d)
    for patch in patches:  # (old, new) in the body's file, or (file, old, new)
        fname, old, new = patch if len(patch) == 3 else (HEADER[body], *patch)
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"{body} {name}: {fname} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return d, [[build._nvcc(), *build.NVCC_FLAGS, "-c", os.path.join(d, s), "-o",
                os.path.join(d, s + ".o")] for s in SOURCES[body]]


def load(d: str, body: str) -> ctypes.CDLL:
    from tpullama_torch.ops.cuda import build

    so = os.path.join(d, "lib.so")
    subprocess.run([build._nvcc(), "-shared", "-o", so,
                    *[os.path.join(d, s + ".o") for s in SOURCES[body]]], check=True)
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {
        "tpl_flash_attention": [i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, f, p],
        "tpl_flash_decode": [i, i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, f,
                             p],
        "tpl_qmm_ktiled": [i, i, i, p, p, p, p, p, p, i, i, i, i, p],
        "tpl_qmm_gathered": [i, i, i, i, p, p, p, p, p, p, p, i, i, i, i, i, p],
        "tpl_qmm_tiled": [i, i, i, p, p, p, p, p, p, p, i, i, i, p],
        "tpl_qmm_gemv": [i, i, i, p, p, p, p, p, p, i, i, i, p],
        "tpl_qmm_gathered_t": [i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p],
        "tpl_fused_postattn": [i, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, f, p],
        "tpl_error_string": [i],
    }
    for name, types in argtypes.items():
        if hasattr(lib, name):  # the symbols of this body's sources
            getattr(lib, name).argtypes = types
    lib.tpl_error_string.restype = ctypes.c_char_p
    return lib


def read_flush_timer(device):
    """chip_smoke's Timer whose flush reads its buffer instead of writing
    it, so L2 holds clean lines when the timed call starts."""
    import torch

    import chip_smoke as cs

    class ReadFlushTimer(cs.Timer):
        def __init__(self, dev):
            super().__init__(dev)
            self.sink = torch.empty((), device=dev)

        def flush_l2(self) -> None:
            torch.sum(self.flush, dim=0, out=self.sink)

    return ReadFlushTimer(device)


# --qtype: (the GGML type the qmm bodies' planes are, the A/r re-code)
QTYPES = {"Q4_K": ("Q4_K", False), "MXFP4": ("MXFP4", False), "MXFP4_AR": ("MXFP4", True)}


def shapes(device, body: str, qtype: str = "Q4_K"):
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm, qmm_gathered
    from tpullama_torch.ops.moe import moe_dispatch

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, E = torch.bfloat16, 8
    Q4 = GGMLType[QTYPES[qtype][0]]  # the qmm bodies' type (fused: always Q4_K)
    ar = QTYPES[qtype][1]

    def planes(N, K):
        return cs.random_planes(Q4, N, K, bf16, gen, device, ar=ar)

    def experts(N, K, planes_t):
        R = -(-N // 128) * 128
        f = cs.random_planes(Q4, E * R, K, bf16, gen, device, ar=ar)
        f = {k: v.reshape(E, R, -1) for k, v in f.items()}
        if planes_t:  # (E, kcols, R); group rows padded to 16
            f = {k: v.transpose(1, 2).contiguous() for k, v in f.items()}
            f = {k: (F.pad(v, (0, 0, 0, -v.shape[1] % 16)) if k in ("scale", "minv") else v)
                 for k, v in f.items()}
        return f

    def routed(S, K):
        sel = torch.rand((S // 2, E), generator=gen, device=device).argsort(-1)[:, :2]
        perm, tiles, _, _ = moe_dispatch(sel.reshape(S).int(), E, 8)
        xs = torch.randn((S, K), generator=gen, device=device)
        return torch.cat([xs, xs.new_zeros((1, K))])[perm], tiles

    out = []
    if body == "attention":
        return attention_shapes(device, gen)
    if body == "fused":
        from tpullama_torch.ops.cuda import fused_layer

        E, Fd, Q4 = 4096, 13696, GGMLType.Q4_K
        o = cs.random_planes(Q4, E, E, bf16, gen, device)
        gu = cs.random_planes(Q4, 2 * Fd, E, bf16, gen, device)
        att, x = (torch.randn((1, E), generator=gen, device=device).to(bf16) for _ in range(2))
        w = (1.0 + 0.1 * torch.randn((E,), generator=gen, device=device)).to(bf16)
        n_bytes = (sum(cs.nbytes(a) for a in (*o.values(), *gu.values(), att, x, w))
                   + 4 * (Fd + E))
        return [(f"fused_postattn E={E} Fd={Fd}",
                 lambda: fused_layer.fused_postattn(att, x, o, w, gu, group=32, eps=1e-5),
                 n_bytes)]
    if body == "gathered_t":
        N, K = 4096, 14336
        f = experts(N, K, True)
        per_expert = sum(cs.nbytes(a) for a in f.values()) / E
        for distinct in (8, 6, 2):
            sel = cs.decode_sel(4, E, distinct, gen, device)
            x = torch.randn((8, K), generator=gen, device=device)
            n_bytes = distinct * per_expert + cs.nbytes(x) + 8 * N * 4
            out.append((f"qmm_gathered_t N={N} 8 tiles / {distinct} experts",
                        lambda x=x, f=f, sel=sel, N=N, K=K:
                        qmm_gathered.quantized_matmul_gathered(x, f, sel, Q4, 32, N, K,
                                                               planes_t=True), n_bytes))
        return out
    if body == "ktiled":
        N, K = 4608, 4096
        f = planes(N, K)
        for T, nk in ((1, 2), (1, 4), (1, 8), (4, 4)):
            x = torch.randn((T, K), generator=gen, device=device).to(bf16)
            n_bytes = sum(cs.nbytes(a) for a in f.values()) + cs.nbytes(x) + T * N * 4
            out.append((f"qmm_ktiled N={N} K={K} T={T} nk={nk}",
                        lambda x=x, f=f, nk=nk: qmm.quantized_matmul(x, f, Q4, 32, N, K,
                                                                     tile_k=nk), n_bytes))
        return out
    if body == "gemv":
        for N, K, T in ((14336, 4096, 4), (14336, 4096, 1), (4096, 14336, 4)):
            f = planes(N, K)
            x = torch.randn((T, K), generator=gen, device=device).to(bf16)
            n_bytes = sum(cs.nbytes(a) for a in f.values()) + cs.nbytes(x) + T * N * 4
            out.append((f"qmm_gemv N={N} K={K} T={T}",
                        lambda x=x, f=f, N=N, K=K: qmm.quantized_matmul(x, f, Q4, 32, N, K),
                        n_bytes))
        return out
    if body == "mma":
        K = 4096
        for N, S in ((2 * 14336, 2048), (2 * 14336, 512), (320, 512)):
            f = experts(N, K, False)
            x, tiles = routed(S, K)
            out.append((f"qmm_gathered N={N} slots={S}",
                        lambda x=x, f=f, t=tiles, N=N, K=K:
                        qmm_gathered.quantized_matmul_gathered(x, f, t, Q4, 32, N, K, tile_t=8)))
        if not ar:  # the A/r planes are never K-chunked
            f = planes(4608, K)
            x = torch.randn((256, K), generator=gen, device=device).to(bf16)
            out.append(("qmm_ktiled N=4608 T=256 nk=4",
                        lambda x=x, f=f, K=K: qmm.quantized_matmul(x, f, Q4, 32, 4608, K,
                                                                   tile_k=4)))
    else:
        N, K = 14336, 4096
        f = planes(N, K)
        x = torch.randn((1024, K), generator=gen, device=device).to(bf16)
        out.append((f"qmm_tiled N={N} T=1024",
                    lambda x=x, f=f, N=N, K=K: qmm.quantized_matmul(x, f, Q4, 32, N, K)))
        N, K = 4096, 14336
        f = experts(N, K, True)
        for S in (2048, 512):
            x, tiles = routed(S, K)
            out.append((f"qmm_gathered_t N={N} slots={S}",
                        lambda x=x, f=f, t=tiles, N=N, K=K:
                        qmm_gathered.quantized_matmul_gathered(x, f, t, Q4, 32, N, K, tile_t=8,
                                                               planes_t=True)))
    return out


def attention_shapes(device, gen):
    """chip_smoke.py's served attention shapes: (name, call, bytes of its
    bound) for the packed 4 x 256 and the 1 x 256 prefill chunks and the
    B = 1 and B = 4 decode steps over a 4224-cell cache, 32/8 heads, D 128,
    each over a bf16 cache and an int8 one (rows quantized as the model
    writes them, chip_smoke.int8_cache; its bound counts the int8 rows and
    their f32 scales)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode

    Hq, Hkv, D, S, Tq = 32, 8, 128, 4224, 256
    out = []

    def both(name, fn, q, k, v, mask, n_rows):
        """The bf16 case, then the int8 one; n_rows: the K/V rows a call reads
        (None: no bound)."""
        kq, vq, (ks, vs) = cs.int8_cache(k, v)
        for kv, args, kw, elt in (("", (k, v), {}, D * k.element_size()),
                                  (" int8", (kq, vq), dict(k_scale=ks, v_scale=vs), D + 4)):
            n_bytes = None if n_rows is None else (
                2 * cs.nbytes(q) + cs.nbytes(mask) + 2 * n_rows * Hkv * elt)
            out.append((name + kv, lambda q=q, a=args, m=mask, kw=kw: fn(
                q, *a, m, D ** -0.5, **kw), n_bytes))

    for lanes in ([(0, 256), (700, 216), (1800, 100), (3500, 0)], [(700, 216)]):
        kv = np.full((len(lanes), S), -1, np.int32)
        qp = np.full((len(lanes), Tq), -1, np.int32)
        for b, (n_past, n_new) in enumerate(lanes):
            kv[b, :n_past + n_new] = np.arange(n_past + n_new)
            qp[b, :n_new] = np.arange(n_past, n_past + n_new)
        q, k, v, mask = cs.attn_inputs(len(lanes), Tq, Hq, Hkv, D, S, torch.bfloat16, gen,
                                       device, kv, qp)
        both(f"flash_attention B={len(lanes)}", flash_attention, q, k, v, mask, None)
    for lengths in ([4000], [4000, 3000, 1000, 300]):
        B = len(lengths)
        kv = np.full((B, S), -1, np.int32)
        for b, n in enumerate(lengths):
            kv[b, :n] = np.arange(n)
        qp = np.asarray(lengths, np.int32)[:, None] - 1
        q, k, v, mask = cs.attn_inputs(B, 1, Hq, Hkv, D, S, torch.bfloat16, gen, device, kv, qp)
        both(f"flash_decode B={B}", flash_decode, q, k, v, mask, sum(lengths))
    return out


def main() -> int:
    import argparse

    import torch

    import chip_smoke as cs
    from tpullama_torch.ops import cuda as cuda_ops
    from tpullama_torch.ops.cuda import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--body", choices=("all", *VARIANTS), default="all")
    ap.add_argument("--qtype", choices=tuple(QTYPES), default="Q4_K",
                    help="the planes of the qmm bodies' shapes (fused and attention ignore it)")
    args = ap.parse_args()
    bodies = tuple(VARIANTS) if args.body == "all" else (args.body,)
    if args.qtype == "MXFP4_AR" and "ktiled" in bodies:
        print("torch_mma_probe: the A/r planes are never K-chunked (--body ktiled)",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_mma_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        built = {(b, n): start_build(b, n, p, root) for b in bodies for n, p in VARIANTS[b].items()}
        cmds = [c for _d, cs_ in built.values() for c in cs_]
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        # each copy's -Xptxas -v report (registers, spills), one file per body
        reports = {b: open(os.path.join(ROOT, "chiprun_out", f"probe_ptxas_{b}.txt"), "w")
                   for b in bodies}
        for i in range(0, len(cmds), 12):  # at most 12 nvcc processes at a time
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds[i:i + 12]]
            for c, proc in zip(cmds[i:i + 12], procs):
                log, _ = proc.communicate()
                if proc.returncode:
                    print(f"{c[-1]}: nvcc failed\n{log}", file=sys.stderr)
                    return 1
                copy = os.path.basename(os.path.dirname(c[-1]))  # <body>-<variant>
                src = os.path.basename(c[-3])
                reports[copy.split("-")[0]].write(f"==== {copy} {src}\n{log}\n")
        for f in reports.values():
            f.close()
        timer = cs.Timer(device)
        read_timer = read_flush_timer(device) if set(READ_FLUSH) & set(bodies) else None
        cases = {b: shapes(device, b, args.qtype) for b in bodies}
        libs = {k: load(d, k[0]) for k, (d, _c) in built.items()}
        times: dict = {}
        for _round in range(3):
            for (b, n), lib in libs.items():
                build.library = lambda lib=lib: lib  # the wrappers launch this copy
                py = VARIANT_PY.get((b, n))
                if py:
                    mod = getattr(cuda_ops, py[0])
                    kept = getattr(mod, py[1])
                    setattr(mod, py[1], py[2])
                for name, fn, *_ in cases[b]:
                    is_fd = name.startswith("flash_decode")
                    if b == "attention" and n != "full" and (
                            is_fd != n.startswith("fd_")
                            or "convert" in n and "int8" not in name):
                        continue  # each kernel under its own variants
                    times.setdefault((b, n, name), []).append(timer.ms(fn, 10))
                    if b in READ_FLUSH:
                        times.setdefault((b, n, name + " readflush"), []).append(
                            read_timer.ms(fn, 10))
                if py:
                    setattr(mod, py[1], kept)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    n_bytes = {name: nb[0] for b in bodies for name, _fn, *nb in cases[b] if nb and nb[0]}
    n_bytes.update({name + " readflush": nb for name, nb in list(n_bytes.items())})
    for (b, n, name), t in times.items():
        med = sorted(t)[1]
        rate = f"  {n_bytes[name] / med / 1e6:.1f} GB/s" if name in n_bytes else ""
        print(f"{b:9s} {n:9s} {name:42s} " + " ".join(f"{v:.4f}" for v in t)
              + f"  median {med:.4f}{rate}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
