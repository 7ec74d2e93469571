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
// Field sets covered (the wrapper raises on the rest):
//   KIND_Q4: {q4, scale, minv}      g=32  (Q4_0, Q4_1, Q4_K)
//   KIND_Q6: {q4, q2, scale, minv}  g=16  (Q6_K: value = q4 | q2 << 4)
//   KIND_Q8: {q8, scale}            g=32  (Q8_0, signed bytes)

#include "qmm_gemv.cuh"
#include "qmm_group_mma.cuh"

namespace {

using namespace tpl;

// Prefill T > 8: the group-scaled tensor-core tile body (qmm_group_mma.cuh)
// over 128 weight rows x BN tokens per block, grid (row blocks, token
// blocks). x (column-order bf16 rows, or f32 rows split in place by
// group_prep, which also writes xgsum, xg) comes through the tensor map
// tmx, the packed planes through maps (group_w_maps).
template <int KIND, bool XLO, typename ST, int BN>
__global__ void __launch_bounds__(GM_THREADS, 1) qmm_tiled_group_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ GroupMaps maps,
    const uint8_t* __restrict__ qa, const __nv_bfloat16* __restrict__ xg, float* __restrict__ y,
    int T, int N, int K) {
  extern __shared__ __align__(16) char smem[];
  using GG = GroupGeo<KIND, XLO, ST, BN, false>;
  constexpr int NG = GG::NG;
  __shared__ int xrow[BN];
  __shared__ uint64_t xbar[GM_BARS];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * GM_BM;
  const int t0 = blockIdx.y * BN;
  if (tid < BN) xrow[tid] = t0 + tid < T ? t0 + tid : -1;
  if (tid == 0) group_bars_init(xbar);
  float acc[2][NG][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const GroupW<ST> w{qa, nullptr, nullptr, KIND == KIND_Q8 ? K : K / 2, maps.m, n0, N};
  const GroupX gx{&tmx, t0, 0, BN, 1};
  unsigned phases = 0;
  group_tile<KIND, XLO, ST, BN, false>(smem, gx, xrow, xg, T, w, K, 0, 2 * NG,
                                       (unsigned)__cvta_generic_to_shared(xbar), phases, acc);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 32 * wm + GG::row(mi, e >> 1, g);
        const int t = t0 + 8 * (NG * wn + j) + 2 * tig + (e & 1);
        if (n < N && t < T) y[(size_t)t * N + n] = acc[mi][j][e];
      }
}

template <int KIND, int TT>
int launch_gemv_tt(int x_bf16, int s_bf16, const void* x, const void* qa, const void* qb,
                   const void* s, const void* m, float* y, int T, int N, int K, cudaStream_t st) {
  auto kern = qmm_gemv_kernel<KIND, TT>;
  // set once per instance: the attribute call is slow, a launch is not
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, gv_smem_bytes<KIND, TT>(256));
  if (attr != cudaSuccess) return (int)attr;
  const int threads = gemv_threads(N), rows = threads / GV_L * GV_RT;
  kern<<<(N + rows - 1) / rows, threads, gv_smem_bytes<KIND, TT>(threads), st>>>(
      x, static_cast<const uint8_t*>(qa), static_cast<const uint8_t*>(qb), s, m, y, x_bf16,
      s_bf16, T, N, K);
  return (int)cudaGetLastError();
}

// the x and scale types are flags of one instance per (KIND, TT): they
// change only the staging and the once-per-class scale loads
template <int KIND>
int launch_gemv(int x_bf16, int s_bf16, const void* x, const void* qa, const void* qb,
                const void* s, const void* m, float* y, int T, int N, int K, cudaStream_t st) {
  if (T <= 1) return launch_gemv_tt<KIND, 1>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (T <= 2) return launch_gemv_tt<KIND, 2>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (T <= 4) return launch_gemv_tt<KIND, 4>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  return launch_gemv_tt<KIND, 8>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
}

template <int KIND, typename XT, typename ST>
int launch_tiled(void* x, void* xg, const void* qa, const void* qb, const void* s,
                 const void* m, float* y, int T, int N, int K, cudaStream_t st) {
  constexpr bool XLO = sizeof(XT) == 4;
  constexpr int BN = group_bn<KIND, XLO, ST, false>();
  constexpr int smem = GroupGeo<KIND, XLO, ST, BN, false>::BYTES;
  auto kern = qmm_tiled_group_kernel<KIND, XLO, ST, BN>;
  // set once per process: the attribute call is slow, a launch is not
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tmx;
  GroupMaps maps;
  int mapped = group_x_map(&tmx, x, XLO ? 2 * K : K, T, BN);
  if (!mapped) mapped = group_w_maps<KIND, ST>(maps.m, qa, qb, s, m, N, K);
  if (mapped) return mapped;
  auto xgp = static_cast<__nv_bfloat16*>(xg);
  const cudaError_t err = group_prep_launch<KIND, XT>(static_cast<XT*>(x), xgp, T, K, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + GM_BM - 1) / GM_BM, (T + BN - 1) / BN);
  kern<<<grid, GM_THREADS, smem, st>>>(
      tmx, maps, static_cast<const uint8_t*>(qa), xgp, y, T, N, K);
  return (int)cudaGetLastError();
}

using TiledFn = int (*)(void*, void*, const void*, const void*, const void*, const void*,
                        float*, int, int, int, cudaStream_t);

template <int KIND>
TiledFn pick_tiled(int x_bf16, int s_bf16) {
  using bf = __nv_bfloat16;
  if (x_bf16) return s_bf16 ? launch_tiled<KIND, bf, bf> : launch_tiled<KIND, bf, float>;
  return s_bf16 ? launch_tiled<KIND, float, bf> : launch_tiled<KIND, float, float>;
}

}  // namespace

// x: (T, K) in column order (x_col[t, c*g + a] = x[t, nu(c)*g + a], natural
// order for stripe planes), f32 or bf16, 16-byte aligned; qa: q4 or q8
// plane (N, K*bits/8); qb: q2 plane (Q6) or null; s, m: (N, K/g) f32 or
// bf16 (m null for Q8); y: (T, N) f32; T <= 8. K % 32 (K/g need not be a
// multiple of 8: a row's last column class is then ragged). Returns
// cudaGetLastError().
extern "C" int tpl_qmm_gemv(int kind, int x_bf16, int s_bf16, const void* x,
                            const void* qa, const void* qb, const void* s,
                            const void* m, float* y, int T, int N, int K,
                            void* stream) {
  if (K % 32 || T > 8) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_Q4) return launch_gemv<KIND_Q4>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (kind == KIND_Q6) return launch_gemv<KIND_Q6>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  if (kind == KIND_Q8) return launch_gemv<KIND_Q8>(x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, st);
  return (int)cudaErrorInvalidValue;
}

// x: (T, K) in column order (x_col[t, c*g + a] = x[t, nu(c)*g + a]), f32 or
// bf16; f32 x is overwritten with its bf16 hi/lo split. xg: (2, T, K/g)
// bf16 scratch for xgsum's hi and lo planes (unused for Q8). The other
// arguments as tpl_qmm_gemv's. K % 256, every K the loader packs: a row's
// scales are whole 16-byte runs for the tensor copies, its Q4/Q8 byte runs
// start on 8-byte boundaries (by tensor copies where they start on 16-byte
// ones), and Q6's on 16-byte ones. The last 16-column weight buffer of a
// row may be partial: its columns past K/g are never used.
extern "C" int tpl_qmm_tiled(int kind, int x_bf16, int s_bf16, void* x, const void* qa,
                             const void* qb, const void* s, const void* m, void* xg, float* y,
                             int T, int N, int K, void* stream) {
  TiledFn fn;
  if (K % 256) return (int)cudaErrorInvalidValue;
  if (kind == KIND_Q4) fn = pick_tiled<KIND_Q4>(x_bf16, s_bf16);
  else if (kind == KIND_Q6) fn = pick_tiled<KIND_Q6>(x_bf16, s_bf16);
  else if (kind == KIND_Q8) fn = pick_tiled<KIND_Q8>(x_bf16, s_bf16);
  else return (int)cudaErrorInvalidValue;
  return fn(x, xg, qa, qb, s, m, y, T, N, K, static_cast<cudaStream_t>(stream));
}

// Message for a code returned by any tpl_* entry point.
extern "C" const char* tpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
