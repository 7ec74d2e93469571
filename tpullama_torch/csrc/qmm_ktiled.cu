// K-chunked (split-K) fused dequantize x matmul, y = x @ W^T.
//
// Replaces the Pallas kernel `kernel` of _qmm_ktiled
// (tpullama/ops/pallas/qmm.py:450, called from quantized_matmul :258 when
// nk > 1 K-chunks are asked for and valid). The planes are the stripe-order
// planar fields of qmm.cu.
//
// What the TPU kernel does: a grid (T tiles, N tiles, nk chunks) whose
// innermost axis revisits one output tile and accumulates into it. Chunk k
// covers stored elements [k*ce, (k+1)*ce) of each stripe (ce = K/stripes/nk):
// a contiguous byte range [k*ce, (k+1)*ce) of the q4 (or q8) plane, which
// _kchunks_valid makes whole byte rows j*G + c of every scale column c,
// j in [k*J/nk, (k+1)*J/nk) (J = 16 for q4, 32 for q8). Blocks on Hopper
// run in no order, so nothing carries across them: here
//   - T <= 8: qmm_ktiled_gemv_kernel, grid (row blocks, nk chunks), runs
//     the decode body of qmm_gemv.cuh (gv_tile) over one chunk's byte rows
//     of its block's rows, x read in place in column order (natural order
//     for stripe planes), and writes the partial into an (nk, T, N) f32
//     workspace;
//   - T > 8: qmm_ktiled_mma_kernel, grid (N/128 row blocks, T/BN token
//     blocks, nk chunks), writes the same partials from the tensor cores
//     (f32 x in stored order split into bf16 hi/lo once, in place, first);
//   - gv_sum_parts (qmm_gemv.cuh) sums the partials of each output in
//     chunk order.
// No float atomics: a request's tokens must not depend on which block
// finished first.
//
// The reference hoists the asymmetric-min term (xgsum @ minv^T) and folds
// it into chunk 0. The decode body does the same: each block folds its
// chunk's column sums once per scale column (scale * sum q*x), and chunk
// 0's blocks alone also fold minv * (the column's whole x sum). The
// tensor-core route dequantizes every weight as q * scale - minv
// (qmm_dequant.cuh), so each of its chunks carries its own min terms.
//
// What bounds it on an H100: bytes at decode (T <= 8: every packed weight
// read once, 2*T flops per weight); the split multiplies the blocks in
// flight by nk for the narrow projections (N <= 4608) where one block per
// row tile leaves the card underfilled. At prefill (T > 8): operations
// (9.7 GFLOP at ChatGLM3-6B's 4608 x 4096 attn_qkv and a 256-token chunk,
// 0.0098 ms at the bf16 peak). A warp per row dequantized every weight once
// per 8-row tile and summed in f32 FMAs (9.7 TFLOP/s);
// qmm_ktiled_mma_kernel instead runs the tensor-core tile body of
// qmm_mma.cuh over 128 rows x 128 tokens (64 where the layout needs the
// room) x one chunk per block, so each weight is dequantized once per 128
// tokens, and its products run on the tensor cores (two bf16 passes for
// bf16 x, three for f32).
//
// Field sets covered (the wrapper raises on the rest; the reference's
// _kchunks_valid admits only single-stripe-width sets):
//   KIND_Q4: {q4, scale, minv}     g=32  (Q4_0, Q4_1, Q4_K)
//   KIND_Q8: {q8, scale}           g=32  (Q8_0, signed bytes)
//   KIND_MXFP4: {q4_lut, scale}    g=32  (MXFP4: Q4's layout, value LUT[idx],
//                                         no min term; the TPU kernel's
//                                         q4_lut branch, qmm.py:476-485)

#include "qmm_gemv.cuh"
#include "qmm_mma.cuh"

namespace {

using namespace tpl;

// T <= 8: block (b, k) computes chunk k's partial of rows [b * rows_blk,
// (b + 1) * rows_blk) through gv_tile over the chunk's byte rows, min term
// in chunk 0 alone.
template <int KIND, int TT>
__global__ void __launch_bounds__(256, TT <= 4 ? 2 : 1) qmm_ktiled_gemv_kernel(
    const void* __restrict__ x, const uint8_t* __restrict__ qa, const void* __restrict__ scale,
    const void* __restrict__ minv, float* __restrict__ ws, int x_bf16, int s_bf16, int T, int N,
    int K, int nk) {
  extern __shared__ __align__(16) float gv_smem[];
  constexpr int J = GvGeo<KIND>::JROWS;
  const int G = K / GvGeo<KIND>::GROUP, k = blockIdx.y;
  const int nb = blockIdx.x * (blockDim.x / GV_L * GV_RT);  // the block's first row
  const int n0 = nb + threadIdx.x / GV_L * GV_RT;
  float part[GV_RT][TT];
  gv_tile<KIND, TT>(
      qa, nullptr, scale, minv, s_bf16, K, [&](int rr) { return (size_t)min(nb + rr, N - 1); },
      [&](float* xs, float* xsum, int cs) {
        gv_stage<KIND, TT>(x, x_bf16, xs, xsum, T, K, G, cs);
      },
      gv_smem, part, GvRows{J * k / nk, J * (k + 1) / nk, k == 0});
  if ((threadIdx.x & (GV_L - 1)) == 0)
#pragma unroll
    for (int r = 0; r < GV_RT; ++r)
#pragma unroll
      for (int t = 0; t < TT; ++t)
        if (t < T && n0 + r < N) ws[((size_t)k * T + t) * N + n0 + r] = part[r][t];
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
                                has_min<KIND>() ? minv + (size_t)n0 * G : nullptr,
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

template <int KIND, int TT>
int launch_gemv_tt(int x_bf16, int s_bf16, const void* x, const void* qa, const void* s,
                   const void* m, float* ws, int T, int N, int K, int nk, cudaStream_t st) {
  auto kern = qmm_ktiled_gemv_kernel<KIND, TT>;
  // set once per instance: the attribute call is slow, a launch is not
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, gv_smem_bytes<KIND, TT>(256));
  if (attr != cudaSuccess) return (int)attr;
  const int threads = gemv_threads(N), rows = threads / GV_L * GV_RT;
  dim3 grid((N + rows - 1) / rows, nk);
  // the ring holds a chunk's byte rows alone, so more blocks fit an SM
  const int smem = gv_smem_bytes<KIND, TT>(threads, GvGeo<KIND>::JROWS / nk);
  kern<<<grid, threads, smem, st>>>(
      x, static_cast<const uint8_t*>(qa), s, m, ws, x_bf16, s_bf16, T, N, K, nk);
  return (int)cudaGetLastError();
}

// the x and scale types are flags of one instance per (KIND, TT bucket)
template <int KIND>
int launch_gemv(int x_bf16, int s_bf16, const void* x, const void* qa, const void* s,
                const void* m, float* ws, int T, int N, int K, int nk, cudaStream_t st) {
  if (T <= 1) return launch_gemv_tt<KIND, 1>(x_bf16, s_bf16, x, qa, s, m, ws, T, N, K, nk, st);
  if (T <= 2) return launch_gemv_tt<KIND, 2>(x_bf16, s_bf16, x, qa, s, m, ws, T, N, K, nk, st);
  if (T <= 4) return launch_gemv_tt<KIND, 4>(x_bf16, s_bf16, x, qa, s, m, ws, T, N, K, nk, st);
  return launch_gemv_tt<KIND, 8>(x_bf16, s_bf16, x, qa, s, m, ws, T, N, K, nk, st);
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

using MmaFn = int (*)(void*, const void*, const void*, const void*, float*, int, int, int,
                      int, cudaStream_t);

template <int KIND>
MmaFn pick_mma(int x_bf16, int s_bf16) {
  using bf = __nv_bfloat16;
  if (x_bf16) return s_bf16 ? launch_mma<KIND, bf, bf> : launch_mma<KIND, bf, float>;
  return s_bf16 ? launch_mma<KIND, float, bf> : launch_mma<KIND, float, float>;
}

}  // namespace

// x: (T, K) f32 or bf16: T <= 8 in column order (natural order for stripe
// planes), 16-byte aligned, read in place; T > 8 in stored (group-permuted)
// order, f32 x overwritten with its bf16 hi/lo split (the wrapper passes
// its own permuted copy). qa: q4, q4_lut or q8 plane (N, K*bits/8); s, m:
// (N, K/g) f32 or bf16 (m null for Q8 and MXFP4); ws: (nk, T, N) f32
// scratch; y: (T, N) f32. nk must divide the plane's byte rows per column
// (16 for q4 and q4_lut, 32 for q8)
// and K/32 into chunk ranges of an even length (the wrapper checks the
// reference's _kchunks_valid, which implies both). Returns a CUDA error
// code.
extern "C" int tpl_qmm_ktiled(int kind, int x_bf16, int s_bf16, void* x,
                              const void* qa, const void* s, const void* m, float* ws,
                              float* y, int T, int N, int K, int nk, void* stream) {
  if (kind != KIND_Q4 && kind != KIND_Q8 && kind != KIND_MXFP4) return (int)cudaErrorInvalidValue;
  if (nk < 2 || K % 32 || (K / 32) % nk || (K / 32 / nk) % MMA_NCH ||
      (kind == KIND_Q8 ? 32 : 16) % nk)
    return (int)cudaErrorInvalidValue;
  if (T > 8 && K % 256) return (int)cudaErrorInvalidValue;  // whole 16-byte scale runs
  auto st = static_cast<cudaStream_t>(stream);
  int err;
  if (T <= 8)
    err = (kind == KIND_Q4 ? &launch_gemv<KIND_Q4>
           : kind == KIND_Q8 ? &launch_gemv<KIND_Q8>
                             : &launch_gemv<KIND_MXFP4>)(x_bf16, s_bf16, x, qa, s, m, ws, T, N,
                                                         K, nk, st);
  else
    err = (kind == KIND_Q4 ? pick_mma<KIND_Q4>(x_bf16, s_bf16)
           : kind == KIND_Q8 ? pick_mma<KIND_Q8>(x_bf16, s_bf16)
                             : pick_mma<KIND_MXFP4>(x_bf16, s_bf16))(x, qa, s, m, ws, T, N, K,
                                                                     nk, st);
  if (err) return err;
  return (int)gv_sum_parts(ws, y, T * N, nk, st);  // the chunks' partials in chunk order
}
