// K-chunked (split-K) fused dequantize x matmul, y = x @ W^T.
//
// Replaces the Pallas kernel `kernel` of _qmm_ktiled
// (tpullama/ops/pallas/qmm.py:450, called from quantized_matmul :258 when
// nk > 1 K-chunks are asked for and valid). The planes are the stripe-order
// planar fields of qmm.cu, and the wrapper (tpullama_torch/ops/cuda/qmm.py)
// permutes x into stored order the same way.
//
// What the TPU kernel does: a grid (T tiles, N tiles, nk chunks) whose
// innermost axis revisits one output tile and accumulates into it. Chunk k
// covers stored elements [k*ce, (k+1)*ce) of each stripe (ce = K/stripes/nk):
// a contiguous byte range [k*ce, (k+1)*ce) of the q4 (or q8) plane. Blocks
// on Hopper run in no order, so nothing carries across them: here
//   - qmm_ktiled_kernel, grid (N/4 row blocks, nk chunks, ceil(T/TT) row
//     tiles), gives each warp one output row over one chunk's byte range
//     (warp_row_sums restricted to the chunk) for TT activation rows, and
//     writes the partial into an (nk, T, N) f32 workspace;
//   - qmm_ksum_kernel sums the partials of each output in chunk order.
// No float atomics: a request's tokens must not depend on which block
// finished first.
//
// The reference hoists the asymmetric-min term (xgsum @ minv^T) and folds
// it into chunk 0. Here every weight is dequantized in registers as
// q * scale - minv (qmm_dequant.cuh, bit-equal to the plain version), so
// each chunk carries its own min terms and there is nothing to fold.
//
// What bounds it on an H100: bytes at decode (T <= 8: every packed weight
// read once, 2*T flops per weight); the split raises the number of warps
// in flight (nk x the rows) for the narrow projections (N <= 4608) where
// one warp per row leaves the card underfilled. At prefill (T > 8) each
// row tile re-reads the chunk's weights (from L2 for the 4608 x 4096
// attn_qkv), with f32 FMAs: far from the tensor-core rate, as qmm_gemv.
//
// Field sets covered (the wrapper raises on the rest; the reference's
// _kchunks_valid admits only single-stripe-width sets):
//   KIND_Q4: {q4, scale, minv}  g=32  (Q4_0, Q4_1, Q4_K)
//   KIND_Q8: {q8, scale}        g=32  (Q8_0, signed bytes)

#include "qmm_dequant.cuh"

namespace {

using namespace tpl;

template <int KIND, typename XT, typename ST, int TT>
__global__ void __launch_bounds__(128) qmm_ktiled_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ qa,
    const ST* __restrict__ scale, const ST* __restrict__ minv,
    float* __restrict__ ws, int T, int N, int K, int nk) {
  const int n = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (n >= N) return;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.y;
  const int t0 = blockIdx.z * TT;
  const int rows = min(TT, T - t0);
  const int per = K / 32 / nk;  // 32-position chunks of one K-chunk
  float acc[TT];
  warp_row_sums<KIND, XT, ST, TT>(x + (size_t)t0 * K, qa, nullptr, scale, minv, n, rows, K,
                                  k * per, (k + 1) * per, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < TT; ++r)
      if (r < rows) ws[((size_t)k * T + t0 + r) * N + n] = acc[r];
  }
}

// y[i] = ws[0][i] + ws[1][i] + ... in chunk order (i over T * N outputs).
__global__ void __launch_bounds__(256) qmm_ksum_kernel(const float* __restrict__ ws,
                                                       float* __restrict__ y, int TN,
                                                       int nk) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= TN) return;
  float acc = ws[i];
  for (int k = 1; k < nk; ++k) acc += ws[(size_t)k * TN + i];
  y[i] = acc;
}

template <int KIND, typename XT, typename ST, int TT>
void launch_tt(const void* x, const void* qa, const void* s, const void* m, float* ws,
               int T, int N, int K, int nk, cudaStream_t st) {
  dim3 grid((N + 3) / 4, nk, (T + TT - 1) / TT), block(128);
  qmm_ktiled_kernel<KIND, XT, ST, TT><<<grid, block, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(qa),
      static_cast<const ST*>(s), static_cast<const ST*>(m), ws, T, N, K, nk);
}

template <int KIND, typename XT, typename ST>
void launch(const void* x, const void* qa, const void* s, const void* m, float* ws,
            int T, int N, int K, int nk, cudaStream_t st) {
  if (T <= 1) launch_tt<KIND, XT, ST, 1>(x, qa, s, m, ws, T, N, K, nk, st);
  else if (T <= 2) launch_tt<KIND, XT, ST, 2>(x, qa, s, m, ws, T, N, K, nk, st);
  else if (T <= 4) launch_tt<KIND, XT, ST, 4>(x, qa, s, m, ws, T, N, K, nk, st);
  else launch_tt<KIND, XT, ST, 8>(x, qa, s, m, ws, T, N, K, nk, st);
}

using LaunchFn = void (*)(const void*, const void*, const void*, const void*, float*, int,
                          int, int, int, cudaStream_t);

template <int KIND>
LaunchFn pick_dtypes(int x_bf16, int s_bf16) {
  using bf = __nv_bfloat16;
  if (x_bf16) return s_bf16 ? launch<KIND, bf, bf> : launch<KIND, bf, float>;
  return s_bf16 ? launch<KIND, float, bf> : launch<KIND, float, float>;
}

}  // namespace

// x: (T, K) in stored (group-permuted) order, f32 or bf16; qa: q4 or q8
// plane (N, K*bits/8); s, m: (N, K/g) f32 or bf16 (m null for Q8); ws:
// (nk, T, N) f32 scratch; y: (T, N) f32. nk must divide K/32 (the wrapper
// checks the reference's _kchunks_valid). Returns cudaGetLastError().
extern "C" int tpl_qmm_ktiled(int kind, int x_bf16, int s_bf16, const void* x,
                              const void* qa, const void* s, const void* m, float* ws,
                              float* y, int T, int N, int K, int nk, void* stream) {
  LaunchFn fn;
  if (kind == KIND_Q4) fn = pick_dtypes<KIND_Q4>(x_bf16, s_bf16);
  else if (kind == KIND_Q8) fn = pick_dtypes<KIND_Q8>(x_bf16, s_bf16);
  else return (int)cudaErrorInvalidValue;
  if (nk < 2 || (K / 32) % nk) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  fn(x, qa, s, m, ws, T, N, K, nk, st);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int TN = T * N;
  qmm_ksum_kernel<<<(TN + 255) / 256, 256, 0, st>>>(ws, y, TN, nk);
  return (int)cudaGetLastError();
}
