// qmm_gemv and qmm_tiled for MXFP4's field sets (qmm_dequant.cuh):
//   KIND_MXFP4:    {q4_lut, scale}     g=32  (value LUT[idx], laid out as Q4)
//   KIND_MXFP4_AR: {q4a, q1r, scale}   g=32  (value 2 (a - 8) + r, laid out as Q5)
// The same two kernels as qmm.cu's (qmm_launch.cuh), which replace the
// Pallas kernel `kernel` of quantized_matmul (tpullama/ops/pallas/qmm.py:296,
// whose body unpacks these planes in _unpack_stripes :77-92): the decode
// body (T <= 8, bound by bytes: 0.5625 B/weight for the LUT set, 0.6875
// for A/r with bf16 scales) and the group body (T > 8, bound by
// operations). Neither set has a min term; only how a weight's integer is
// made differs from Q4 and Q5 (the decode body's gv_value, the group
// body's frag_a). In a file of its own so that its instances build beside
// qmm.cu's instead of after them. tpl_qmm_gemv and tpl_qmm_tiled (qmm.cu)
// dispatch here; K % 32 for the LUT set on the decode body, else K % 256.

#include "qmm_launch.cuh"

namespace tpl {

int qmm_gemv_mxfp4(int kind, int x_bf16, int s_bf16, const void* x, const void* qa,
                   const void* qb, const void* s, const void* m, float* y, int T, int N, int K,
                   cudaStream_t st) {
  if (kind == KIND_MXFP4)
    return launch_gemv<KIND_MXFP4>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (kind == KIND_MXFP4_AR && K % 256 == 0)
    return launch_gemv<KIND_MXFP4_AR>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  return (int)cudaErrorInvalidValue;
}

int qmm_tiled_mxfp4(int kind, int x_bf16, int s_bf16, void* x, const void* qa, const void* qb,
                    const void* s, const void* m, void* xg, float* y, int T, int N, int K,
                    cudaStream_t st) {
  TiledFn fn;
  if (kind == KIND_MXFP4) fn = pick_tiled<KIND_MXFP4>(x_bf16, s_bf16);
  else if (kind == KIND_MXFP4_AR) fn = pick_tiled<KIND_MXFP4_AR>(x_bf16, s_bf16);
  else return (int)cudaErrorInvalidValue;
  return fn(x, xg, qa, qb, s, m, y, T, N, K, st);
}

}  // namespace tpl
