// The launches of qmm.cu's two kernels, qmm_gemv (T <= 8, the decode body
// of qmm_gemv.cuh) and qmm_tiled (T > 8, the group body of
// qmm_group_mma.cuh), as templates over the field set (KIND). qmm.cu
// instantiates KIND_Q4, KIND_Q6 and KIND_Q8, qmm_lowbit.cu KIND_Q5,
// KIND_Q3 and KIND_Q2 and qmm_mxfp4.cu KIND_MXFP4 and KIND_MXFP4_AR, so
// the sources build side by side
// (ops/cuda/build.py starts one nvcc per source). qmm.cu's entry points
// dispatch on the kind; see qmm.cu for what each kernel replaces, what
// bounds it and the arguments.

#pragma once

#include "qmm_gemv.cuh"
#include "qmm_group_mma.cuh"

namespace tpl {

// Prefill T > 8: the group-scaled tensor-core tile body (qmm_group_mma.cuh)
// over 128 weight rows x BN tokens per block, grid (row blocks, token
// blocks). x (column-order bf16 rows, or f32 rows split in place by
// group_prep, which also writes xgsum, xg) comes through the tensor map
// tmx, the packed planes through maps (group_w_maps), or, for runs the
// tensor copies cannot start, from qa and qb by cp.async.
template <int KIND, bool XLO, typename ST, int BN>
__global__ void __launch_bounds__(GM_THREADS, 1) qmm_tiled_group_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ GroupMaps maps,
    const uint8_t* __restrict__ qa, const uint8_t* __restrict__ qb,
    const __nv_bfloat16* __restrict__ xg, float* __restrict__ y, int T, int N, int K) {
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
  using P = Planes<KIND>;
  const GroupW<ST> w{qa, nullptr, nullptr, K / 8 * P::BL, maps.m, n0, N, qb, K / 8 * P::BH};
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
      tmx, maps, static_cast<const uint8_t*>(qa), static_cast<const uint8_t*>(qb), xgp, y, T,
      N, K);
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


// qmm_lowbit.cu: the same launches for KIND_Q5, KIND_Q3 and KIND_Q2
// (cudaErrorInvalidValue for another kind)
int qmm_gemv_lowbit(int kind, int x_bf16, int s_bf16, const void* x, const void* qa,
                    const void* qb, const void* s, const void* m, float* y, int T, int N, int K,
                    cudaStream_t st);
int qmm_tiled_lowbit(int kind, int x_bf16, int s_bf16, void* x, const void* qa, const void* qb,
                     const void* s, const void* m, void* xg, float* y, int T, int N, int K,
                     cudaStream_t st);

// qmm_mxfp4.cu: the same launches for KIND_MXFP4 and KIND_MXFP4_AR
// (cudaErrorInvalidValue for another kind)
int qmm_gemv_mxfp4(int kind, int x_bf16, int s_bf16, const void* x, const void* qa,
                   const void* qb, const void* s, const void* m, float* y, int T, int N, int K,
                   cudaStream_t st);
int qmm_tiled_mxfp4(int kind, int x_bf16, int s_bf16, void* x, const void* qa, const void* qb,
                    const void* s, const void* m, void* xg, float* y, int T, int N, int K,
                    cudaStream_t st);

}  // namespace tpl
