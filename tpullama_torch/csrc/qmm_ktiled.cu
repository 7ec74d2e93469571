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
//   - T <= 8: qmm_ktiled_kernel, grid (N/4 row blocks, nk chunks), gives
//     each warp one output row over one chunk's byte range (warp_row_sums
//     restricted to the chunk) for the T activation rows, and writes the
//     partial into an (nk, T, N) f32 workspace;
//   - T > 8: qmm_ktiled_mma_kernel, grid (N/128 row blocks, T/BN token
//     blocks, nk chunks), writes the same partials from the tensor cores
//     (f32 x split into bf16 hi/lo once, in place, first);
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
// one warp per row leaves the card underfilled. At prefill (T > 8):
// operations (9.7 GFLOP at ChatGLM3-6B's 4608 x 4096 attn_qkv and a
// 256-token chunk, 0.0098 ms at the bf16 peak). The warp-per-row body
// dequantized every weight once per 8-row tile and summed in f32 FMAs
// (9.7 TFLOP/s); qmm_ktiled_mma_kernel instead runs the tensor-core tile
// body of qmm_mma.cuh over 128 rows x 128 tokens (64 where the layout
// needs the room) x one chunk per block, so each weight is dequantized once
// per 128 tokens, and its products run on
// the tensor cores (two bf16 passes for bf16 x, three for f32).
//
// Field sets covered (the wrapper raises on the rest; the reference's
// _kchunks_valid admits only single-stripe-width sets):
//   KIND_Q4: {q4, scale, minv}  g=32  (Q4_0, Q4_1, Q4_K)
//   KIND_Q8: {q8, scale}        g=32  (Q8_0, signed bytes)

#include "qmm_mma.cuh"

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

// T > 8: grid (128-row blocks, BN-token blocks, nk chunks); each block
// writes its chunk's partial products of its tile into the workspace. x is
// bf16 rows of K, or (XLO) f32 rows split in place by mma_split_x. BN is
// 128 where the layout fits (bf16 scales), else 64.
template <int KIND, bool XLO, typename ST, int K_BN>
__global__ void __launch_bounds__(MMA_THREADS, 1) qmm_ktiled_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qa,
    const ST* __restrict__ scale, const ST* __restrict__ minv,
    float* __restrict__ ws, int T, int N, int K, int nk) {
  extern __shared__ __align__(16) char smem[];
  constexpr int NG = K_BN / 32;
  __shared__ int xrow[K_BN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * MMA_BM;
  const int t0 = blockIdx.y * K_BN;
  const int k = blockIdx.z;
  if (tid < K_BN) xrow[tid] = t0 + tid < T ? t0 + tid : -1;
  float acc[2][NG][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;
  const int per = K / 32 / nk;  // 32-position chunks of one K-chunk
  const int G = K / Geo<KIND>::GROUP;
  const size_t q_row = KIND == KIND_Q8 ? K : K / 2;
  mma_tile<KIND, XLO, ST, K_BN>(smem, x, xrow, qa + n0 * q_row, nullptr, scale + (size_t)n0 * G,
                                KIND == KIND_Q8 ? nullptr : minv + (size_t)n0 * G,
                                min(MMA_BM, N - n0), K, k * per, (k + 1) * per, 0, K_BN / 8,
                                acc);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + 32 * wm + 16 * mi + g + 8 * (i >> 1);
        const int t = t0 + 8 * (NG * wn + j) + 2 * tig + (i & 1);
        if (n < N && t < T) ws[((size_t)k * T + t) * N + n] = acc[mi][j][i];
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
int launch_mma(void* x, const void* qa, const void* s, const void* m, float* ws, int T, int N,
               int K, int nk, cudaStream_t st) {
  constexpr bool XLO = sizeof(XT) == 4;
  constexpr int K_BN = mma_bn<KIND, XLO, ST>();
  constexpr int smem = MmaGeo<KIND, XLO, ST, K_BN>::BYTES;
  auto kern = qmm_ktiled_mma_kernel<KIND, XLO, ST, K_BN>;
  // allowed once per process, not once per launch (a driver call)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  if constexpr (XLO) {
    const cudaError_t err = mma_split_x_launch(static_cast<float*>(x), (size_t)T * K, st);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + MMA_BM - 1) / MMA_BM, (T + K_BN - 1) / K_BN, nk);
  kern<<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qa),
      static_cast<const ST*>(s), static_cast<const ST*>(m), ws, T, N, K, nk);
  return (int)cudaGetLastError();
}

template <int KIND, typename XT, typename ST>
int launch(void* x, const void* qa, const void* s, const void* m, float* ws, int T, int N,
           int K, int nk, cudaStream_t st) {
  if (T > 8) return launch_mma<KIND, XT, ST>(x, qa, s, m, ws, T, N, K, nk, st);
  if (T <= 1) launch_tt<KIND, XT, ST, 1>(x, qa, s, m, ws, T, N, K, nk, st);
  else if (T <= 2) launch_tt<KIND, XT, ST, 2>(x, qa, s, m, ws, T, N, K, nk, st);
  else if (T <= 4) launch_tt<KIND, XT, ST, 4>(x, qa, s, m, ws, T, N, K, nk, st);
  else launch_tt<KIND, XT, ST, 8>(x, qa, s, m, ws, T, N, K, nk, st);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(void*, const void*, const void*, const void*, float*, int, int, int,
                         int, cudaStream_t);

template <int KIND>
LaunchFn pick_dtypes(int x_bf16, int s_bf16) {
  using bf = __nv_bfloat16;
  if (x_bf16) return s_bf16 ? launch<KIND, bf, bf> : launch<KIND, bf, float>;
  return s_bf16 ? launch<KIND, float, bf> : launch<KIND, float, float>;
}

}  // namespace

// x: (T, K) in stored (group-permuted) order, f32 or bf16; qa: q4 or q8
// plane (N, K*bits/8); s, m: (N, K/g) f32 or bf16 (m null for Q8); ws:
// (nk, T, N) f32 scratch; y: (T, N) f32. nk must divide K/32 into chunk
// ranges of an even length (the wrapper checks the reference's
// _kchunks_valid, which implies both). T <= 8 runs one warp per (row,
// chunk), T > 8 the tensor-core route, which overwrites f32 x with its
// bf16 hi/lo split (the wrapper passes its own permuted copy). Returns a
// CUDA error code.
extern "C" int tpl_qmm_ktiled(int kind, int x_bf16, int s_bf16, void* x,
                              const void* qa, const void* s, const void* m, float* ws,
                              float* y, int T, int N, int K, int nk, void* stream) {
  LaunchFn fn;
  if (kind == KIND_Q4) fn = pick_dtypes<KIND_Q4>(x_bf16, s_bf16);
  else if (kind == KIND_Q8) fn = pick_dtypes<KIND_Q8>(x_bf16, s_bf16);
  else return (int)cudaErrorInvalidValue;
  if (nk < 2 || K % 32 || (K / 32) % nk || (K / 32 / nk) % MMA_NCH)
    return (int)cudaErrorInvalidValue;
  if (T > 8 && K % 256) return (int)cudaErrorInvalidValue;  // whole 16-byte scale runs
  auto st = static_cast<cudaStream_t>(stream);
  const int err = fn(x, qa, s, m, ws, T, N, K, nk, st);
  if (err) return err;
  const int TN = T * N;
  qmm_ksum_kernel<<<(TN + 255) / 256, 256, 0, st>>>(ws, y, TN, nk);
  return (int)cudaGetLastError();
}
