// qmm_gathered and qmm_gathered_t for MXFP4's field sets (qmm_dequant.cuh):
//   KIND_MXFP4:    {q4_lut, scale}     g=32  (value LUT[idx], laid out as Q4)
//   KIND_MXFP4_AR: {q4a, q1r, scale}   g=32  (value 2 (a - 8) + r, laid out as Q5)
// The kernels of qmm_gathered.cu, which replace the Pallas kernels `kernel`
// of quantized_matmul_gathered (tpullama/ops/pallas/qmm.py:655, whose
// `bits` table takes q4_lut and q4a/q1r) and of _qmm_gathered_t (:771, its
// A/r and q4_lut branches :801-825): row-major one-row tiles on the decode
// body (gv_value makes each value), tiles of 2..8 rows on the tensor-core
// body (decode_vals); transposed one-row tiles on gt_body, tiles of 2..8
// rows on the group body (frag_a). Neither set has a min term. Only how a
// weight's integer is made differs from Q4 and Q5. In a file of its own so
// that its instances build beside qmm_gathered.cu's instead of after them.
// tpl_qmm_gathered and tpl_qmm_gathered_t (qmm_gathered.cu) dispatch here;
// K % 256 for the A/r set.

#include "qmm_gathered_t.cuh"

namespace tpl {

int qmm_gathered_mxfp4(int kind, int x_bf16, int s_bf16, void* x, const int* sel,
                       const void* qa, const void* qb, const void* s, const void* m, float* y,
                       int n_tiles, int tt, int N, int R, int K, cudaStream_t st) {
  if (kind == KIND_MXFP4)
    return launch_gathered<KIND_MXFP4>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt, N,
                                       R, K, st);
  if (kind == KIND_MXFP4_AR && K % 256 == 0)
    return launch_gathered<KIND_MXFP4_AR>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, tt,
                                          N, R, K, st);
  return (int)cudaErrorInvalidValue;
}

int qmm_gathered_t_mxfp4(int kind, int s_bf16, float* x, void* xg, const int* sel,
                         const void* q, const void* qh, const void* s, const void* m, float* y,
                         int n_tiles, int tt, int N, int R, int K, int Gp, cudaStream_t st) {
  if (kind == KIND_MXFP4)
    return launch_gathered_t<KIND_MXFP4>(s_bf16, x, xg, sel, q, qh, s, m, y, n_tiles, tt, N, R,
                                         K, Gp, st);
  if (kind == KIND_MXFP4_AR && K % 256 == 0)
    return launch_gathered_t<KIND_MXFP4_AR>(s_bf16, x, xg, sel, q, qh, s, m, y, n_tiles, tt, N,
                                            R, K, Gp, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tpl
