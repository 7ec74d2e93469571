// qmm_gathered for the K-quant field sets with a q1 plane or a q2 low
// plane (qmm_dequant.cuh Planes):
//   KIND_Q5: {q4, q1, scale, minv}  g=32  (Q5_0, Q5_1, Q5_K: q4 | q1 << 4)
//   KIND_Q3: {q2, q1, scale, minv}  g=16  (Q3_K: q2 | q1 << 2)
//   KIND_Q2: {q2, scale, minv}      g=16  (Q2_K)
// The row-major kernel of qmm_gathered.cu (qmm_gathered.cuh), which replaces
// the Pallas kernel `kernel` of quantized_matmul_gathered
// (tpullama/ops/pallas/qmm.py:655, whose `bits` table takes these sets as
// q1/q2): one-row tiles on the decode body (gv_low_high assembles each
// value), tiles of 2..8 rows on the tensor-core body (decode_vals). Only
// how a weight's integer is assembled differs from Q4. In a file of its
// own so that its instances build beside qmm_gathered.cu's instead of
// after them. tpl_qmm_gathered (qmm_gathered.cu) dispatches here; K % 256.
// The transposed kernel does not take these sets: the loader never stores
// them transposed.

#include "qmm_gathered.cuh"

namespace tpl {

int qmm_gathered_lowbit(int kind, int x_bf16, int s_bf16, void* x, const int* sel,
                        const void* qa, const void* qb, const void* s, const void* m, float* y,
                        int n_tiles, int tt, int N, int R, int K, cudaStream_t st) {
  if (K % 256) return (int)cudaErrorInvalidValue;
  if (kind == KIND_Q5)
    return launch_gathered<KIND_Q5>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N, R,
                                    K, st);
  if (kind == KIND_Q3)
    return launch_gathered<KIND_Q3>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N, R,
                                    K, st);
  if (kind == KIND_Q2)
    return launch_gathered<KIND_Q2>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N, R,
                                    K, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tpl
