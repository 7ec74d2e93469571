// qmm_gemv and qmm_tiled for the K-quant field sets with a q1 plane or a
// q2 low plane (qmm_dequant.cuh Planes):
//   KIND_Q5: {q4, q1, scale, minv}  g=32  (Q5_0, Q5_1, Q5_K: q4 | q1 << 4)
//   KIND_Q3: {q2, q1, scale, minv}  g=16  (Q3_K: q2 | q1 << 2)
//   KIND_Q2: {q2, scale, minv}      g=16  (Q2_K)
// The same two kernels as qmm.cu's (qmm_launch.cuh), which replace the
// Pallas kernel `kernel` of quantized_matmul (tpullama/ops/pallas/qmm.py:296,
// whose body unpacks these planes in _unpack_stripes :55-76): the decode
// body (T <= 8, bound by bytes: 0.75 B/weight for Q5, 0.625 for Q3_K, 0.5
// for Q2_K with bf16 scales) and the group body (T > 8, bound by
// operations). Only how a weight's integer is assembled differs from Q4:
// the decode body takes every set through one unpacking step
// (gv_low_high), the group body through frag_a. In a file of its own so
// that its instances build beside qmm.cu's instead of after them.
// tpl_qmm_gemv and tpl_qmm_tiled (qmm.cu) dispatch here; K % 256.

#include "qmm_launch.cuh"

namespace tpl {

int qmm_gemv_lowbit(int kind, int x_bf16, int s_bf16, const void* x, const void* qa,
                    const void* qb, const void* s, const void* m, float* y, int T, int N, int K,
                    cudaStream_t st) {
  if (kind == KIND_Q5) return launch_gemv<KIND_Q5>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (kind == KIND_Q3) return launch_gemv<KIND_Q3>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (kind == KIND_Q2) return launch_gemv<KIND_Q2>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  return (int)cudaErrorInvalidValue;
}

int qmm_tiled_lowbit(int kind, int x_bf16, int s_bf16, void* x, const void* qa, const void* qb,
                     const void* s, const void* m, void* xg, float* y, int T, int N, int K,
                     cudaStream_t st) {
  TiledFn fn;
  if (kind == KIND_Q5) fn = pick_tiled<KIND_Q5>(x_bf16, s_bf16);
  else if (kind == KIND_Q3) fn = pick_tiled<KIND_Q3>(x_bf16, s_bf16);
  else if (kind == KIND_Q2) fn = pick_tiled<KIND_Q2>(x_bf16, s_bf16);
  else return (int)cudaErrorInvalidValue;
  return fn(x, xg, qa, qb, s, m, y, T, N, K, st);
}

}  // namespace tpl
