// Fused dequantize x matmul over planar packed weights, y = x @ W^T.
//
// Replaces the Pallas kernel `kernel` of quantized_matmul
// (tpullama/ops/pallas/qmm.py:296, launched by _call_qmm_kernel :848).
// W stays packed in device memory exactly as tpullama/ops/qweights.py
// stores it: "global stripe" nibble/crumb planes in group-transposed order
// plus per-group scale (and min) planes, f32 or bf16. A stored position p
// of a row holds natural element (p % G) * g + p / G (G = K / g), and its
// scale/min sit at column p % G of the scale planes.
//
// What bounds it on an H100, and the two routes:
//   - decode (T <= 8), qmm_gemv: bytes. One decode step reads every packed
//     weight once (~0.6 B/weight for Q4_K with bf16 scales) and does 2*T
//     flops per weight, far below the card's 295 flop/byte ridge. It runs
//     the decode body of qmm_gemv.cuh: a block stages x (column order, read
//     in place) into shared memory, each thread walks classes of 4 scale
//     columns down 2 rows with 4-byte loads, unpacks by byte permutes into
//     exact f32, sums per column and scales each column once.
//   - prefill (T > 8), qmm_tiled: operations (120 GFLOP at 14336 x 4096 and
//     a packed 1024-token chunk, 0.12 ms at the bf16 peak). It runs the
//     group-scaled tensor-core body of qmm_group_mma.cuh: the raw integers
//     of each scale column times bf16 x (or f32 x split into bf16 hi/lo),
//     one f32 scale per column, the min term as its own small product. It
//     replaced an f32 FMA tile (64 x 64 outputs per block, every weight
//     dequantized once per 64 tokens; 4.97 ms at that shape on an NVIDIA
//     H100 80GB HBM3, 700.00 W). The wrapper passes x in column order:
//     natural order for stripe planes, whole 32-value blocks permuted by
//     fourblock_scale_perm for fourblock planes.
//
// Field sets covered (the wrapper raises on the rest; qmm_dequant.cuh):
//   KIND_Q4: {q4, scale, minv}      g=32  (Q4_0, Q4_1, Q4_K)
//   KIND_Q6: {q4, q2, scale, minv}  g=16  (Q6_K: value = q4 | q2 << 4)
//   KIND_Q8: {q8, scale}            g=32  (Q8_0, signed bytes)
//   KIND_Q5: {q4, q1, scale, minv}  g=32  (Q5_0, Q5_1, Q5_K: q4 | q1 << 4)
//   KIND_Q3: {q2, q1, scale, minv}  g=16  (Q3_K: q2 | q1 << 2)
//   KIND_Q2: {q2, scale, minv}      g=16  (Q2_K)
//   KIND_MXFP4: {q4_lut, scale}     g=32  (MXFP4: value LUT[idx])
//   KIND_MXFP4_AR: {q4a, q1r, scale} g=32 (MXFP4 re-coded: 2 (a - 8) + r)
// The kernels live in qmm_launch.cuh; this file instantiates the first
// three sets, qmm_lowbit.cu the q1/q2 sets and qmm_mxfp4.cu MXFP4's, which
// build side by side.

#include "qmm_launch.cuh"

using namespace tpl;

// x: (T, K) in column order (x_col[t, c*g + a] = x[t, nu(c)*g + a], natural
// order for stripe planes), f32 or bf16, 16-byte aligned; qa: the low
// plane (q4, q8, q2 for Q3_K/Q2_K, q4_lut or q4a for MXFP4), (N,
// K*bits/8); qb: the high plane (q2 of Q6_K, q1 of Q5/Q3_K, q1r of MXFP4's
// A/r) or null; s, m: (N, K/g) f32 or bf16 (m null for Q8 and MXFP4); y:
// (T, N) f32; T <= 8. K % 32 for Q4, Q8 and MXFP4's LUT set (K/g need not
// be a multiple of 8: a row's last column class is then ragged), K % 256
// for the other sets. Returns cudaGetLastError().
extern "C" int tpl_qmm_gemv(int kind, int x_bf16, int s_bf16, const void* x,
                            const void* qa, const void* qb, const void* s,
                            const void* m, float* y, int T, int N, int K,
                            void* stream) {
  if (K % 32 || T > 8) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_Q4) return launch_gemv<KIND_Q4>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (kind == KIND_Q6) return launch_gemv<KIND_Q6>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (kind == KIND_Q8) return launch_gemv<KIND_Q8>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (kind == KIND_MXFP4 || kind == KIND_MXFP4_AR)
    return qmm_gemv_mxfp4(kind, x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (K % 256) return (int)cudaErrorInvalidValue;
  return qmm_gemv_lowbit(kind, x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
}

// x: (T, K) in column order (x_col[t, c*g + a] = x[t, nu(c)*g + a]), f32 or
// bf16; f32 x is overwritten with its bf16 hi/lo split. xg: (2, T, K/g)
// bf16 scratch for xgsum's hi and lo planes (unused for Q8 and MXFP4). The other
// arguments as tpl_qmm_gemv's. K % 256, every K the loader packs: a row's
// scales are whole 16-byte runs for the tensor copies, its byte runs at
// g = 32 (Q4, Q5 and Q8) start on 8-byte boundaries (by tensor copies
// where they start on 16-byte ones, else by cp.async), and those at g = 16
// (Q6_K, Q3_K, Q2_K) on 16-byte ones. The last 16-column weight buffer of a
// row may be partial: its columns past K/g are never used.
extern "C" int tpl_qmm_tiled(int kind, int x_bf16, int s_bf16, void* x, const void* qa,
                             const void* qb, const void* s, const void* m, void* xg, float* y,
                             int T, int N, int K, void* stream) {
  TiledFn fn;
  if (K % 256) return (int)cudaErrorInvalidValue;
  if (kind == KIND_Q4) fn = pick_tiled<KIND_Q4>(x_bf16, s_bf16);
  else if (kind == KIND_Q6) fn = pick_tiled<KIND_Q6>(x_bf16, s_bf16);
  else if (kind == KIND_Q8) fn = pick_tiled<KIND_Q8>(x_bf16, s_bf16);
  else if (kind == KIND_MXFP4 || kind == KIND_MXFP4_AR)
    return qmm_tiled_mxfp4(kind, x_bf16, s_bf16, x, qa, qb, s, m, xg, y, T, N, K,
                           static_cast<cudaStream_t>(stream));
  else
    return qmm_tiled_lowbit(kind, x_bf16, s_bf16, x, qa, qb, s, m, xg, y, T, N, K,
                            static_cast<cudaStream_t>(stream));
  return fn(x, xg, qa, qb, s, m, y, T, N, K, static_cast<cudaStream_t>(stream));
}

// Message for a code returned by any tpl_* entry point.
extern "C" const char* tpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
