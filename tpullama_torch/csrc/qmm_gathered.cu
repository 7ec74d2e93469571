// Gathered dequantize x matmul for MoE experts kept packed on the card:
// y[t*tt : (t+1)*tt] = x[t*tt : (t+1)*tt] @ W[sel[t]]^T for every tile t of
// tt rows (the ggml_mul_mat_id analog). sel holds one expert per tile and
// stays on the card: no launch reads it back to the host.
//
// Replaces two Pallas kernels of tpullama/ops/pallas/qmm.py:
//   - qmm_gathered: `kernel` of quantized_matmul_gathered (:655, wrapper
//     :525) on row-major expert planes (M, R, kcols);
//   - qmm_gathered_t: `kernel` of _qmm_gathered_t (:771, wrapper :704) on
//     transposed planes (M, kcols, R) whose scale/minv planes hold Gp >= G
//     group rows (zero-padded to 16), with the min term hoisted out of the
//     weights as the TPU kernel does: y = x . (q * scale) - xgsum . minv,
//     xgsum being x's per-group sums, which the kernels compute from x, so
//     every output row depends on its own x row alone, whatever the tile
//     holds.
// R is the stored rows per expert (rows padded to 128 by the loader), N <= R
// the rows computed. qmm_gathered's one-row tiles take x f32 or bf16 in
// natural order, read in place (for stripe planes the decode body's column
// order is natural order); its tiles of more than one row take f32 x in
// stored (group-permuted) order, as in qmm.cu. qmm_gathered_t takes f32 x
// in natural order, in which scale column c holds natural elements c*32 ..
// c*32 + 31.
//
// What bounds it on an H100:
//   - decode (tt = 1, one tile per (token, k) slot): bytes. A step reads
//     only the selected experts' packed planes. qmm_gathered runs the
//     decode body of qmm_gemv.cuh (gv_tile) over runs of tiles that share
//     an expert: a block of tile t goes on only if t starts a run (its rank
//     among the tiles of its expert, in tile order, is a multiple of
//     GATHER_RUN = 4), gathers the run's tiles from sel on the card, and
//     reads its rows of the expert once for all of them, the run's x rows
//     being the body's T. A row's output does not depend on T, so a tile's
//     output is bit-identical whoever else picked its expert.
//     qmm_gathered_t runs the same runs (find_run) on its own thread
//     mapping for R-contiguous planes, with the decode body's unpacking and
//     fold (qmm_gathered_t_gemv_kernel): a thread holds 8 neighbouring rows
//     of one scale column, and a block's rows cover 32 columns of K, so
//     the card holds ~2,000 blocks at Mixtral's decode step.
//   - prefill (tt = 8 rows per tile, slots sorted by expert): operations.
//     qmm_gathered routes tiles of more than one row to
//     qmm_gathered_mma_kernel, the tensor-core tile body of qmm_mma.cuh
//     (exact f32 weights split into bf16 hi/lo), and qmm_gathered_t to
//     qmm_gathered_t_mma_kernel, the group-scaled body of
//     qmm_group_mma.cuh (the raw integers of each scale column on the
//     tensor cores, one f32 scale per column, the min term as its own
//     product). Both run 128 rows of one expert against a block of tiles,
//     so each weight is read once per block instead of once per tile.
//
// Field sets: qmm_gathered covers every set of qmm_dequant.cuh on both
// routes, KIND_Q4, KIND_Q6 and KIND_Q8 here, the q1/q2 sets KIND_Q5,
// KIND_Q3 and KIND_Q2 in qmm_gathered_lowbit.cu and MXFP4's KIND_MXFP4 and
// KIND_MXFP4_AR in qmm_gathered_mxfp4.cu (the row-major kernels are
// templates in qmm_gathered.cuh); qmm_gathered_t covers KIND_Q4 and KIND_Q8
// here and the two MXFP4 sets in qmm_gathered_mxfp4.cu, every set the
// loader stores transposed (its kernels are templates in
// qmm_gathered_t.cuh). The wrappers raise on the rest.

#include "qmm_gathered_t.cuh"

using namespace tpl;

// Row-major. sel: (n_tiles,) int32 expert per tile, on the card; qa: the
// low planes (M, R, K*bits/8): q4, q8, q2 (Q3, Q2), q4_lut or q4a (MXFP4);
// qb: the high planes, q2 (Q6), q1 (Q5, Q3) or q1r (MXFP4's A/r), or null;
// s, m: (M, R, K/g) f32 or bf16 (s_bf16; m null for Q8 and MXFP4); y:
// (n_tiles * tt, N) f32. tt = 1 runs the decode body over runs of at most
// GATHER_RUN (4) tiles of one expert: x (n_tiles, K) f32 or bf16 (x_bf16)
// in natural order, 16-byte aligned, read in place; K % 32 (the sets with
// a high or q2 plane % 256); n_tiles <= 65535.
// tt in 2..8 runs the tensor-core route: x (n_tiles * tt, K) f32 in stored
// order, which it overwrites with its bf16 hi/lo split (the wrapper passes
// its own permuted copy); K % 256 (whole 16-byte scale runs).
// Returns a CUDA error code (cudaGetLastError() after the launches).
extern "C" int tpl_qmm_gathered(int kind, int x_bf16, int s_bf16, void* x,
                                const int* sel, const void* qa, const void* qb, const void* s,
                                const void* m, float* y, int n_tiles, int tt, int N, int R,
                                int K, void* stream) {
  if (tt < 1 || tt > 8 || K % 32 || (tt > 1 && K % 256) || (tt == 1 && n_tiles > 65535))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_Q4)
    return launch_gathered<KIND_Q4>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N, R,
                                    K, st);
  if (kind == KIND_Q6)
    return launch_gathered<KIND_Q6>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N, R,
                                    K, st);
  if (kind == KIND_Q8)
    return launch_gathered<KIND_Q8>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N, R,
                                    K, st);
  if (kind == KIND_MXFP4 || kind == KIND_MXFP4_AR)
    return qmm_gathered_mxfp4(kind, x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N, R,
                              K, st);
  return qmm_gathered_lowbit(kind, x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N, R, K,
                             st);
}

// Transposed. x: (n_tiles * tt, K) f32 in natural order, 16-byte aligned;
// sel as above; q: q4, q8, q4_lut or q4a planes (M, K*bits/8, R); qh: the
// A/r set's q1r planes (M, K/8, R), else null; s, m: (M, Gp, R) f32 or
// bf16 (m null for Q8 and MXFP4), 16-byte aligned; y: (n_tiles * tt, N)
// f32.
// R % 128 == 0, tt <= 8, K % 32, Gp >= K/32 rounded up to 4. tt = 1 runs
// the transposed decode body over runs of at most GATHER_RUN (4) tiles of
// one expert (n_tiles <= 65535), and xg is its f32 workspace of
// (ceil(K/32 / 32), n_tiles, N) column-split parts. tt > 1 runs the
// tensor-core route, which overwrites x with its bf16 hi/lo split (the
// wrapper passes its own copy), and xg is (2, n_tiles * tt, K/32) bf16
// scratch for xgsum's hi and lo planes (Q4; K/32 rounded up to a multiple
// of 4 columns, group_xg_cols). K % 256 for the A/r set.
extern "C" int tpl_qmm_gathered_t(int kind, int s_bf16, float* x, void* xg, const int* sel,
                                  const void* q, const void* qh, const void* s, const void* m,
                                  float* y, int n_tiles, int tt, int N, int R, int K, int Gp,
                                  void* stream) {
  if (tt < 1 || tt > 8 || R % GT_ROWS || K % 32 || Gp < group_xg_cols(K / 32) ||
      (tt == 1 && n_tiles > 65535))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_Q4)
    return launch_gathered_t<KIND_Q4>(s_bf16, x, xg, sel, q, qh, s, m, y, n_tiles, tt, N, R, K,
                                      Gp, st);
  if (kind == KIND_Q8)
    return launch_gathered_t<KIND_Q8>(s_bf16, x, xg, sel, q, qh, s, m, y, n_tiles, tt, N, R, K,
                                      Gp, st);
  return qmm_gathered_t_mxfp4(kind, s_bf16, x, xg, sel, q, qh, s, m, y, n_tiles, tt, N, R, K, Gp,
                              st);
}
