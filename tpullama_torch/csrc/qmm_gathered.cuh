// The row-major gathered kernel (qmm_gathered: the Pallas kernel `kernel`
// of quantized_matmul_gathered, tpullama/ops/pallas/qmm.py:655) as
// templates over the field set (KIND), and the runs of one-row tiles that
// both gathered kernels compute (find_run). qmm_gathered.cu instantiates
// KIND_Q4, KIND_Q6 and KIND_Q8, qmm_gathered_lowbit.cu the q1/q2 sets
// KIND_Q5, KIND_Q3 and KIND_Q2 and qmm_gathered_mxfp4.cu MXFP4's
// KIND_MXFP4 and KIND_MXFP4_AR, so the sources build side by side
// (ops/cuda/build.py starts one nvcc per source). See qmm_gathered.cu for
// what bounds the kernel, its design and its arguments.

#pragma once

#include <type_traits>

#include "qmm_gemv.cuh"
#include "qmm_mma.cuh"

namespace tpl {

// One-row tiles of both layouts run in runs: a block of tile t goes on
// only if t starts a run, i.e. among the tiles whose expert is e = sel[t],
// in tile order, t's rank is a multiple of GATHER_RUN. The run is the next
// (at most GATHER_RUN) tiles of e from t on, and the block reads its part
// of expert e once for all of them, the run's x rows being the body's T.
// Runs of 4 keep the row-major body at 2 blocks per SM: an 8-row run
// measured slower at 62 slots, its x slice taking twice the shared memory.
constexpr int GATHER_RUN = 4;

struct GatherRun {
  int tile[GATHER_RUN];  // the run's tiles, in tile order
  int len;               // 0: the block's tile lies inside another tile's run
};

// The run that tile `tile` starts, found by warp 0 with ballots over sel (32
// tiles a step), so any sel, sorted or not, is right; into shared `run`,
// read after a barrier. Both one-row kernels find their runs here
// (ops/cuda/qmm_gathered.run_plan mirrors it).
__device__ __forceinline__ void find_run(const int* __restrict__ sel, int tile, int n_tiles,
                                         GatherRun& run) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, e = sel[tile];
  int rank = 0, len = 0;
  for (int b = 0; b < tile; b += 32)
    rank += __popc(__ballot_sync(0xffffffffu, b + lane < tile && sel[b + lane] == e));
  if (rank % GATHER_RUN == 0) {
    for (int b = tile; b < n_tiles && len < GATHER_RUN; b += 32) {
      unsigned m = __ballot_sync(0xffffffffu, b + lane < n_tiles && sel[b + lane] == e);
      for (; m && len < GATHER_RUN; m &= m - 1, ++len)
        if (lane == 0) run.tile[len] = b + __ffs(m) - 1;
    }
  }
  if (lane == 0) run.len = len;
}

// Row-major, one-row tiles: grid (row blocks of the body, tiles). Block
// (b, t) of a tile t that starts a run reads rows [b * rows_blk, (b + 1) *
// rows_blk) of expert e once for the run's tiles through the decode body
// (gv_tile). The body instance follows the run's length (1, 2 or 4 x
// rows), so a lone tile costs what a T = 1 gemv does. A row's output does
// not depend on T, so a tile's output is bit-identical whoever else picked
// its expert.
template <int KIND>
__global__ void __launch_bounds__(256, 2) qmm_gathered_gemv_kernel(
    const void* __restrict__ x, const int* __restrict__ sel, const uint8_t* __restrict__ qa,
    const uint8_t* __restrict__ qb, const void* __restrict__ scale,
    const void* __restrict__ minv, float* __restrict__ y, int x_bf16, int s_bf16, int n_tiles,
    int N, int R, int K) {
  extern __shared__ __align__(16) float gv_smem[];
  __shared__ GatherRun run;
  const int tile = blockIdx.y;
  const int e = sel[tile];
  find_run(sel, tile, n_tiles, run);
  __syncthreads();
  const int T = run.len;
  if (T == 0) return;  // tile t is inside another tile's run
  constexpr int g = GvGeo<KIND>::GROUP;
  const int G = K / g;
  const int nb = blockIdx.x * (blockDim.x / GV_L * GV_RT);
  const int n0 = nb + threadIdx.x / GV_L * GV_RT;
  const size_t row0 = (size_t)e * R;
  auto row_of = [&](int rr) { return row0 + min(nb + rr, N - 1); };
  auto body = [&](auto tt) {
    constexpr int TT = decltype(tt)::value;
    float part[GV_RT][TT];
    gv_tile<KIND, TT>(
        qa, qb, scale, minv, s_bf16, K, row_of,
        [&](float* xs, float* xsum, int cs) {
          gv_stage_with<KIND, TT>(
              [&](int t, int c, float (&v)[g]) {
                const size_t at = (size_t)run.tile[t] * K + (size_t)c * g;
                if (x_bf16) load_f<__nv_bfloat16, g>(static_cast<const __nv_bfloat16*>(x) + at, v);
                else load_f<float, g>(static_cast<const float*>(x) + at, v);
              },
              xs, xsum, T, G, cs);
        },
        gv_smem, part);
    if ((threadIdx.x & (GV_L - 1)) == 0)
#pragma unroll
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int r = 0; r < GV_RT; ++r)
          if (t < T && n0 + r < N) y[(size_t)run.tile[t] * N + n0 + r] = part[r][t];
  };
  if (T == 1) body(std::integral_constant<int, 1>{});
  else if (T == 2) body(std::integral_constant<int, 2>{});
  else body(std::integral_constant<int, GATHER_RUN>{});
}

// Row-major, tiles of 2..8 rows: the tensor-core route. Replaces the warp
// per output row of an 8-row tile (the same Pallas kernel, qmm.py:655),
// which dequantized every weight once per tile (~33 times per expert at
// 2048 slots), re-read the tile's x per warp through L1 and summed in f32
// FMAs (3.9 TFLOP/s on the H100).
//
// What bounds it on an H100: operations. At Mixtral's prefill (28672 x
// 4096 [gate | up] rows per expert, 2048 slots over 8 experts) the product
// is 481 GFLOP, three bf16 passes of it for f32 x; its planes (73 MB per
// expert) do not fit in the 50 MB L2.
//
// What the design does about it: one block computes 128 stored rows of
// one expert against NT = BN / 8 consecutive tiles, each tile one n8
// column group of the mma (tile rows past tt are zero columns), so a
// block dequantizes its rows once per NT tiles (16, 128 slots, with bf16
// scales; 8 where the layout or the registers need it, mma_bn) instead of
// once per tile, and the products run on the tensor cores (qmm_mma.cuh).
// x is split into bf16 hi/lo once per call, in place, before the tile
// kernel runs. The block reads its tiles' experts on the card and runs the
// K loop once per
// run of consecutive tiles with one expert, issuing mma only for that
// run's column groups: moe_dispatch sorts the slots by expert, so a block
// usually holds one run and at most two or three; any sel, sorted or not,
// is right. The grid runs the slot-blocks fastest, so the few blocks that
// read one (expert, row block) run together and share it through L2.
template <int KIND, typename ST, int BN>
__global__ void __launch_bounds__(MMA_THREADS, 1) qmm_gathered_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ sel,
    const uint8_t* __restrict__ qa, const uint8_t* __restrict__ qb,
    const ST* __restrict__ scale, const ST* __restrict__ minv,
    float* __restrict__ y, int n_tiles, int tt, int N, int R, int K) {
  extern __shared__ __align__(16) char smem[];
  constexpr int NT = BN / 8;
  constexpr int NG = BN / 32;
  __shared__ int xrow[BN];
  __shared__ int tsel[NT];
  const int tid = threadIdx.x;
  const int tile0 = blockIdx.x * NT;
  const int n0 = blockIdx.y * MMA_BM;
  const int nt = min(NT, n_tiles - tile0);
  const int rows = min(MMA_BM, N - n0);
  if (tid < BN) {
    const int j = tid / 8, r = tid % 8;
    xrow[tid] = j < nt && r < tt ? (tile0 + j) * tt + r : -1;
  }
  if (tid < NT) tsel[tid] = tid < nt ? sel[tile0 + tid] : -1;
  float acc[2][NG][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;
  __syncthreads();
  const int G = K / Geo<KIND>::GROUP;
  using P = Planes<KIND>;
  const size_t q_row = (size_t)K / 8 * P::BL, h_row = (size_t)K / 8 * P::BH;
  for (int j0 = 0; j0 < nt;) {
    const int e = tsel[j0];
    int j1 = j0 + 1;
    while (j1 < nt && tsel[j1] == e) ++j1;
    const size_t row0 = (size_t)e * R + n0;
    mma_tile<KIND, true, ST, BN>(smem, x, xrow, qa + row0 * q_row,
                                 P::BH ? qb + row0 * h_row : nullptr,
                                 scale + row0 * G, has_min<KIND>() ? minv + row0 * G : nullptr,
                                 rows, K, 0, K / 32, j0, j1, acc);
    j0 = j1;
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int jb = NG * wn + j;
      if (jb >= nt) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + 32 * wm + 16 * mi + g + 8 * (i >> 1);
        const int r = 2 * tig + (i & 1);
        if (n < N && r < tt) y[((size_t)(tile0 + jb) * tt + r) * N + n] = acc[mi][j][i];
      }
    }
}

// one-row tiles (decode): the decode body over runs of at most GATHER_RUN
// tiles
template <int KIND>
int launch_gathered_gemv(int x_bf16, int s_bf16, const void* x, const int* sel,
                         const void* qa, const void* qb, const void* s, const void* m, float* y,
                         int n_tiles, int N, int R, int K, cudaStream_t st) {
  auto kern = qmm_gathered_gemv_kernel<KIND>;
  // set once per instance: the attribute call is slow, a launch is not
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, gv_smem_bytes<KIND, GATHER_RUN>(256));
  if (attr != cudaSuccess) return (int)attr;
  const int threads = gemv_threads(N), rows = threads / GV_L * GV_RT;
  dim3 grid((N + rows - 1) / rows, n_tiles);
  kern<<<grid, threads, gv_smem_bytes<KIND, GATHER_RUN>(threads), st>>>(
      x, sel, static_cast<const uint8_t*>(qa), static_cast<const uint8_t*>(qb), s, m, y, x_bf16,
      s_bf16, n_tiles, N, R, K);
  return (int)cudaGetLastError();
}

// tiles of 2..8 rows (prefill): x is split in place, then the tile body
template <int KIND, typename ST>
int launch_gathered_mma(float* x, const int* sel, const void* qa, const void* qb,
                        const void* s, const void* m, float* y, int n_tiles, int tt, int N,
                        int R, int K, cudaStream_t st) {
  constexpr int BN = mma_bn<KIND, true, ST>();
  constexpr int smem = MmaGeo<KIND, true, ST, BN>::BYTES;
  auto kern = qmm_gathered_mma_kernel<KIND, ST, BN>;
  // set once per process: the attribute call is slow, a launch is not
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const cudaError_t err = mma_split_x_launch(x, (size_t)n_tiles * tt * K, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_tiles + BN / 8 - 1) / (BN / 8), (N + MMA_BM - 1) / MMA_BM);
  kern<<<grid, MMA_THREADS, smem, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), sel, static_cast<const uint8_t*>(qa),
      static_cast<const uint8_t*>(qb), static_cast<const ST*>(s), static_cast<const ST*>(m), y,
      n_tiles, tt, N, R, K);
  return (int)cudaGetLastError();
}

// qmm_gathered's two routes for one field set: one-row tiles (tt = 1) on the
// decode body, tiles of 2..8 rows on the tensor-core body, with the scale
// type a template argument there and a runtime flag on the decode body
template <int KIND>
int launch_gathered(int x_bf16, int s_bf16, void* x, const int* sel, const void* qa,
                    const void* qb, const void* s, const void* m, float* y, int n_tiles, int tt,
                    int N, int R, int K, cudaStream_t st) {
  if (tt == 1)
    return launch_gathered_gemv<KIND>(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, N, R,
                                      K, st);
  auto fn = s_bf16 ? &launch_gathered_mma<KIND, __nv_bfloat16> : &launch_gathered_mma<KIND, float>;
  return fn(static_cast<float*>(x), sel, qa, qb, s, m, y, n_tiles, tt, N, R, K, st);
}

// qmm_gathered_lowbit.cu: launch_gathered for KIND_Q5, KIND_Q3 and KIND_Q2
// (cudaErrorInvalidValue for another kind)
int qmm_gathered_lowbit(int kind, int x_bf16, int s_bf16, void* x, const int* sel,
                        const void* qa, const void* qb, const void* s, const void* m, float* y,
                        int n_tiles, int tt, int N, int R, int K, cudaStream_t st);

// qmm_gathered_mxfp4.cu: launch_gathered (row-major) and launch_gathered_t
// (transposed, qmm_gathered_t.cuh) for KIND_MXFP4 and KIND_MXFP4_AR
// (cudaErrorInvalidValue for another kind)
int qmm_gathered_mxfp4(int kind, int x_bf16, int s_bf16, void* x, const int* sel,
                       const void* qa, const void* qb, const void* s, const void* m, float* y,
                       int n_tiles, int tt, int N, int R, int K, cudaStream_t st);
int qmm_gathered_t_mxfp4(int kind, int s_bf16, float* x, void* xg, const int* sel,
                         const void* q, const void* qh, const void* s, const void* m, float* y,
                         int n_tiles, int tt, int N, int R, int K, int Gp, cudaStream_t st);

}  // namespace tpl
