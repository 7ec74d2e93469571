// Gathered dequantize x matmul for MoE experts kept packed on the card:
// y[t*tt : (t+1)*tt] = x[t*tt : (t+1)*tt] @ W[sel[t]]^T for every tile t of
// tt rows (the ggml_mul_mat_id analog). sel holds one expert per tile and
// stays on the card: no launch reads it back to the host.
//
// Replaces two Pallas kernels of tpullama/ops/pallas/qmm.py:
//   - qmm_gathered: `kernel` of quantized_matmul_gathered (:655, wrapper
//     :525) on row-major expert planes (M, R, kcols);
//   - qmm_gathered_t: `kernel` of _qmm_gathered_t (:771, wrapper :704) on
//     transposed planes (M, kcols, R) whose scale/minv planes hold Gp >= G
//     group rows (zero-padded to 16), with the min term hoisted out of the
//     weights as the TPU kernel does: y = x . (q * scale) - xgsum . minv,
//     xgsum being x's per-group sums. The kernel sums each group of x as it
//     walks that group's stored positions, so every output row depends on
//     its own x row alone, whatever the tile holds.
// R is the stored rows per expert (rows padded to 128 by the loader), N <= R
// the rows computed. qmm_gathered's one-row tiles take x f32 or bf16 in
// natural order, read in place (for stripe planes the decode body's column
// order is natural order); its tiles of more than one row take f32 x in
// stored (group-permuted) order, as in qmm.cu. qmm_gathered_t takes f32 x
// in natural order, whose walk over one scale group's stored positions
// meets that group's 32 natural elements in order; its one-row body uses
// qmm.cu's dequantization helpers (qmm_dequant.cuh), so its weights equal
// the plain version's bit for bit.
//
// What bounds it on an H100:
//   - decode (tt = 1, one tile per (token, k) slot): bytes. A step reads
//     only the selected experts' packed planes. qmm_gathered runs the
//     decode body of qmm_gemv.cuh (gv_tile) over runs of tiles that share
//     an expert: a block of tile t goes on only if t starts a run (its rank
//     among the tiles of its expert, in tile order, is a multiple of
//     GATHER_RUN = 4), gathers the run's tiles from sel on the card, and
//     reads its rows of the expert once for all of them, the run's x rows
//     being the body's T. A row's output does not depend on T, so a tile's
//     output is bit-identical whoever else picked its expert.
//     qmm_gathered_t gives each lane 4 neighbouring rows (4-byte loads,
//     128 bytes per warp) and splits the groups of K over 8 warps so that
//     ~2000 warps are in flight.
//   - prefill (tt = 8 rows per tile, slots sorted by expert): operations.
//     qmm_gathered routes tiles of more than one row to
//     qmm_gathered_mma_kernel, the tensor-core tile body of qmm_mma.cuh
//     (exact f32 weights split into bf16 hi/lo), and qmm_gathered_t to
//     qmm_gathered_t_mma_kernel, the group-scaled body of
//     qmm_group_mma.cuh (the raw integers of each scale column on the
//     tensor cores, one f32 scale per column, the min term as its own
//     product). Both run 128 rows of one expert against a block of tiles,
//     so each weight is read once per block instead of once per tile.
//
// Field sets: qmm_gathered covers KIND_Q4, KIND_Q6 and KIND_Q8 on both
// routes; qmm_gathered_t covers KIND_Q4 and KIND_Q8 (the loader stores no
// other field set transposed). The wrappers raise on the rest.

#include <type_traits>

#include "qmm_gemv.cuh"
#include "qmm_group_mma.cuh"

namespace {

using namespace tpl;

// Row-major, one-row tiles: grid (row blocks of the body, tiles). Block
// (b, t) runs only if tile t starts a run: among the tiles whose expert is
// e = sel[t], in tile order, t's rank is a multiple of GATHER_RUN. The run
// is the next (at most GATHER_RUN) tiles of e from t on; the block reads
// rows [b * rows_blk, (b + 1) * rows_blk) of expert e once for all of
// them. Warp 0 finds the run with ballots over sel (32 tiles a step), so
// any sel, sorted or not, is right. The body instance follows the run's length (1,
// 2 or 4 x rows), so a lone tile costs what a T = 1 gemv does. Runs of 4
// keep the body at 2 blocks per SM: an 8-row run measured slower at 62
// slots, its x slice taking twice the shared memory.
constexpr int GATHER_RUN = 4;

template <int KIND>
__global__ void __launch_bounds__(256, 2) qmm_gathered_gemv_kernel(
    const void* __restrict__ x, const int* __restrict__ sel, const uint8_t* __restrict__ qa,
    const uint8_t* __restrict__ qb, const void* __restrict__ scale,
    const void* __restrict__ minv, float* __restrict__ y, int x_bf16, int s_bf16, int n_tiles,
    int N, int R, int K) {
  extern __shared__ __align__(16) float gv_smem[];
  __shared__ int run[GATHER_RUN];
  __shared__ int run_len;
  const int tile = blockIdx.y;
  const int e = sel[tile];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int rank = 0, len = 0;
    for (int b = 0; b < tile; b += 32)
      rank += __popc(__ballot_sync(0xffffffffu, b + lane < tile && sel[b + lane] == e));
    if (rank % GATHER_RUN == 0) {
      for (int b = tile; b < n_tiles && len < GATHER_RUN; b += 32) {
        unsigned m = __ballot_sync(0xffffffffu, b + lane < n_tiles && sel[b + lane] == e);
        for (; m && len < GATHER_RUN; m &= m - 1, ++len)
          if (lane == 0) run[len] = b + __ffs(m) - 1;
      }
    }
    if (lane == 0) run_len = len;
  }
  __syncthreads();
  const int T = run_len;
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
                const size_t at = (size_t)run[t] * K + (size_t)c * g;
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
          if (t < T && n0 + r < N) y[(size_t)run[t] * N + n0 + r] = part[r][t];
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
  const size_t q_row = KIND == KIND_Q8 ? K : K / 2;
  for (int j0 = 0; j0 < nt;) {
    const int e = tsel[j0];
    int j1 = j0 + 1;
    while (j1 < nt && tsel[j1] == e) ++j1;
    const size_t row0 = (size_t)e * R + n0;
    mma_tile<KIND, true, ST, BN>(smem, x, xrow, qa + row0 * q_row,
                                 KIND == KIND_Q6 ? qb + row0 * (K / 4) : nullptr,
                                 scale + row0 * G, KIND == KIND_Q8 ? nullptr : minv + row0 * G,
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

// Transposed, tiles of 2..8 rows: the group-scaled tensor-core route
// (qmm_group_mma.cuh) on the (kcols, R) planes, in qmm_gathered_mma_kernel's
// scheme: one block computes 128 stored rows of one expert against NT = BN
// / 8 consecutive tiles, each tile one n8 column group (tile rows past tt
// are zero columns); the block reads its tiles' experts on the card and
// runs the K loop once per run of consecutive tiles with one expert,
// issuing mma only for that run's column groups; slot-blocks run fastest
// in the grid. It replaced the f32 FMA body below for tiles of more
// than one row (14.90 ms at Mixtral's down 4096 x 14336 x 8 experts and
// 2048 slots, NVIDIA H100 80GB HBM3, 700.00 W), which dequantized each
// expert's planes again for every one of its ~32 tiles. x is f32 in natural
// order, split into bf16 hi/lo in place by group_prep, which also writes
// xgsum (xg), and read through the tensor map tmx.
template <int KIND, typename ST, int BN>
__global__ void __launch_bounds__(GM_THREADS, 1) qmm_gathered_t_mma_kernel(
    const __grid_constant__ CUtensorMap tmx, const __nv_bfloat16* __restrict__ xg,
    const int* __restrict__ sel, const uint8_t* __restrict__ q, const ST* __restrict__ scale,
    const ST* __restrict__ minv, float* __restrict__ y, int n_tiles, int tt, int N, int R,
    int K, int Gp) {
  extern __shared__ __align__(16) char smem[];
  using GG = GroupGeo<KIND, true, ST, BN, true>;
  constexpr int NT = BN / 8;
  constexpr int NG = GG::NG;
  __shared__ int xrow[BN];
  __shared__ int tsel[NT];
  __shared__ uint64_t xbar[GM_BARS];
  const int tid = threadIdx.x;
  const int tile0 = blockIdx.x * NT;
  const int n0 = blockIdx.y * GM_BM;
  const int nt = min(NT, n_tiles - tile0);
  if (tid < BN) {
    const int j = tid / 8, r = tid % 8;
    xrow[tid] = j < nt && r < tt ? (tile0 + j) * tt + r : -1;
  }
  if (tid < NT) tsel[tid] = tid < nt ? sel[tile0 + tid] : -1;
  if (tid == 0) group_bars_init(xbar);
  float acc[2][NG][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  __syncthreads();
  const size_t q_rows = KIND == KIND_Q8 ? K : K / 2;
  // 8-row tiles are BN consecutive rows: one box; else one box per tile
  const GroupX gx = tt == 8 ? GroupX{&tmx, tile0 * 8, 0, BN, 1} : GroupX{&tmx, tile0 * tt, tt, tt, nt};
  unsigned phases = 0;
  for (int j0 = 0; j0 < nt;) {
    const int e = tsel[j0];
    int j1 = j0 + 1;
    while (j1 < nt && tsel[j1] == e) ++j1;
    const GroupW<ST> w{q + (size_t)e * q_rows * R + n0, scale + (size_t)e * Gp * R + n0,
                       GG::MIN ? minv + (size_t)e * Gp * R + n0 : nullptr, R, nullptr, 0};
    group_tile<KIND, true, ST, BN, true>(smem, gx, xrow, xg, n_tiles * tt, w, K, j0, j1,
                                         (unsigned)__cvta_generic_to_shared(xbar), phases, acc);
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
        const int n = n0 + 32 * wm + GG::row(mi, i >> 1, g);
        const int r = 2 * tig + (i & 1);
        if (n < N && r < tt) y[((size_t)(tile0 + jb) * tt + r) * N + n] = acc[mi][j][i];
      }
    }
}

constexpr int T_ROWS = 4;    // output rows per lane
constexpr int T_WARPS = 8;   // warps splitting the groups of K
constexpr int T_BLOCK_N = 32 * T_ROWS;

// Transposed, one-row tiles (decode, TT = 1): grid (tile, block of 128
// rows), 8 warps. Lane l holds rows
// n0..n0+3 (n0 = 4 l); warp w takes the groups gi = w, w + 8, ... For
// group gi it stages the tile's x over natural elements gi*32 .. gi*32+31
// in shared memory (one 128-byte load per row), loads the 4 rows' scales
// once, then walks the stored positions p = gi + j G whose scale that is:
// for Q4 the byte rows p < K/2 (low nibble: stored position p, natural
// element gi*32 + j; high nibble: p + K/2, element gi*32 + 16 + j), for Q8
// the rows p < K (element gi*32 + j). The group's x sum for the min term
// accumulates on the way. The 8 warps' partial sums meet in shared memory.
template <int KIND, typename ST, int TT>
__global__ void __launch_bounds__(T_WARPS * 32) qmm_gathered_t_kernel(
    const float* __restrict__ x, const int* __restrict__ sel, const uint8_t* __restrict__ q,
    const ST* __restrict__ scale, const ST* __restrict__ minv,
    float* __restrict__ y, int tt, int N, int R, int K, int Gp) {
  __shared__ float part[T_WARPS][TT][T_BLOCK_N];
  __shared__ float xg[T_WARPS][TT][32];  // each warp's group of x
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int nb = blockIdx.y * T_BLOCK_N;
  const int n0 = nb + lane * T_ROWS;
  const int e = sel[tile];
  const int G = K / 32;
  const int q_rows = KIND == KIND_Q8 ? K : K / 2;
  const float* xt = x + (size_t)tile * tt * K;
  const uint8_t* qe = q + (size_t)e * q_rows * R + n0;
  const ST* se = scale + (size_t)e * Gp * R + n0;
  const ST* me = KIND == KIND_Q8 ? nullptr : minv + (size_t)e * Gp * R + n0;
  float acc[TT][T_ROWS];
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int i = 0; i < T_ROWS; ++i) acc[r][i] = 0.f;

  for (int gi = warp; gi < G; gi += T_WARPS) {
#pragma unroll
    for (int r = 0; r < TT; ++r)
      xg[warp][r][lane] = r < tt ? xt[(size_t)r * K + gi * 32 + lane] : 0.f;
    __syncwarp();
    float s[T_ROWS];
    load_f<ST, T_ROWS>(se + (size_t)gi * R, s);
    float xs[TT];  // natural group gi's x sum per row
#pragma unroll
    for (int r = 0; r < TT; ++r) xs[r] = 0.f;
    if constexpr (KIND == KIND_Q4) {
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int c = gi + j * G;
        const uint32_t qv = *reinterpret_cast<const uint32_t*>(qe + (size_t)c * R);
        float wl[T_ROWS], wh[T_ROWS];
#pragma unroll
        for (int i = 0; i < T_ROWS; ++i) {
          const int b = (qv >> (8 * i)) & 0xff;
          wl[i] = __fmul_rn((float)(b & 15), s[i]);
          wh[i] = __fmul_rn((float)(b >> 4), s[i]);
        }
#pragma unroll
        for (int r = 0; r < TT; ++r) {
          if (r < tt) {
            const float xl = xg[warp][r][j];
            const float xh = xg[warp][r][16 + j];
            xs[r] += xl;
            xs[r] += xh;
#pragma unroll
            for (int i = 0; i < T_ROWS; ++i) {
              acc[r][i] = fmaf(xl, wl[i], acc[r][i]);
              acc[r][i] = fmaf(xh, wh[i], acc[r][i]);
            }
          }
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const int c = gi + j * G;
        const uint32_t qv = *reinterpret_cast<const uint32_t*>(qe + (size_t)c * R);
        float w[T_ROWS];
#pragma unroll
        for (int i = 0; i < T_ROWS; ++i)
          w[i] = __fmul_rn((float)(int8_t)((qv >> (8 * i)) & 0xff), s[i]);
#pragma unroll
        for (int r = 0; r < TT; ++r) {
          if (r < tt) {
            const float xv = xg[warp][r][j];
#pragma unroll
            for (int i = 0; i < T_ROWS; ++i) acc[r][i] = fmaf(xv, w[i], acc[r][i]);
          }
        }
      }
    }
    if constexpr (KIND != KIND_Q8) {
      float m[T_ROWS];
      load_f<ST, T_ROWS>(me + (size_t)gi * R, m);
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int i = 0; i < T_ROWS; ++i) acc[r][i] = fmaf(-xs[r], m[i], acc[r][i]);
    }
    __syncwarp();  // every lane has read xg before the next group overwrites it
  }
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int i = 0; i < T_ROWS; ++i) part[warp][r][lane * T_ROWS + i] = acc[r][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < tt * T_BLOCK_N; idx += T_WARPS * 32) {
    const int r = idx / T_BLOCK_N, nl = idx % T_BLOCK_N;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < T_WARPS; ++w) v += part[w][r][nl];
    const int n = nb + nl;
    if (n < N) y[((size_t)tile * tt + r) * N + n] = v;
  }
}

using RmFn = int (*)(float*, const int*, const void*, const void*, const void*,
                    const void*, float*, int, int, int, int, int, cudaStream_t);
using TFn = int (*)(float*, void*, const int*, const void*, const void*, const void*,
                    float*, int, int, int, int, int, int, cudaStream_t);

// one-row tiles (decode): the decode body over runs of at most GATHER_RUN
// tiles
template <int KIND>
int launch_gemv(int x_bf16, int s_bf16, const void* x, const int* sel, const void* qa,
                const void* qb, const void* s, const void* m, float* y, int n_tiles, int N,
                int R, int K, cudaStream_t st) {
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
int launch_mma(float* x, const int* sel, const void* qa, const void* qb, const void* s,
               const void* m, float* y, int n_tiles, int tt, int N, int R, int K,
               cudaStream_t st) {
  constexpr int BN = mma_bn<KIND, true, ST>();
  constexpr int smem = MmaGeo<KIND, true, ST, BN>::BYTES;
  auto kern = qmm_gathered_mma_kernel<KIND, ST, BN>;
  // allowed once per process, not once per launch (a driver call)
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

// one-row tiles (decode): the f32 FMA body
template <int KIND, typename ST>
int launch_t(float* x, void*, const int* sel, const void* q, const void* s, const void* m,
             float* y, int n_tiles, int tt, int N, int R, int K, int Gp, cudaStream_t st) {
  dim3 grid(n_tiles, (N + T_BLOCK_N - 1) / T_BLOCK_N), block(T_WARPS * 32);
  qmm_gathered_t_kernel<KIND, ST, 1><<<grid, block, 0, st>>>(
      x, sel, static_cast<const uint8_t*>(q), static_cast<const ST*>(s),
      static_cast<const ST*>(m), y, tt, N, R, K, Gp);
  return (int)cudaGetLastError();
}

// tiles of 2..8 rows (prefill): group_prep, then the group-scaled tile body
template <int KIND, typename ST>
int launch_t_mma(float* x, void* xg, const int* sel, const void* q, const void* s,
                 const void* m, float* y, int n_tiles, int tt, int N, int R, int K, int Gp,
                 cudaStream_t st) {
  constexpr int BN = group_bn<KIND, true, ST, true>();
  constexpr int smem = GroupGeo<KIND, true, ST, BN, true>::BYTES;
  auto kern = qmm_gathered_t_mma_kernel<KIND, ST, BN>;
  // set once per process: the attribute call is slow, a launch is not
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tmx;
  const int mapped = group_x_map(&tmx, x, 2 * K, n_tiles * tt, tt == 8 ? BN : tt);
  if (mapped) return mapped;
  auto xgp = static_cast<__nv_bfloat16*>(xg);
  const cudaError_t err = group_prep_launch<KIND, float>(x, xgp, n_tiles * tt, K, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_tiles + BN / 8 - 1) / (BN / 8), (N + GM_BM - 1) / GM_BM);
  kern<<<grid, GM_THREADS, smem, st>>>(
      tmx, xgp, sel, static_cast<const uint8_t*>(q),
      static_cast<const ST*>(s), static_cast<const ST*>(m), y, n_tiles, tt, N, R, K, Gp);
  return (int)cudaGetLastError();
}

template <int KIND, typename ST>
TFn pick_t(int tt) {
  return tt == 1 ? &launch_t<KIND, ST> : &launch_t_mma<KIND, ST>;
}

}  // namespace

// Row-major. sel: (n_tiles,) int32 expert per tile, on the card; qa: q4
// or q8 planes (M, R, K*bits/8); qb: q2 planes (Q6) or null; s, m: (M, R,
// K/g) f32 or bf16 (s_bf16; m null for Q8); y: (n_tiles * tt, N) f32.
// tt = 1 runs the decode body over runs of at most GATHER_RUN (4) tiles
// of one expert: x (n_tiles, K) f32 or bf16 (x_bf16) in natural order,
// 16-byte aligned, read in place; K % 32 (Q6_K % 256); n_tiles <= 65535.
// tt in 2..8 runs the tensor-core route: x (n_tiles * tt, K) f32 in stored
// order, which it overwrites with its bf16 hi/lo split (the wrapper passes
// its own permuted copy); K % 256 (whole 16-byte scale runs).
// Returns a CUDA error code (cudaGetLastError() after the launches).
extern "C" int tpl_qmm_gathered(int kind, int x_bf16, int s_bf16, void* x,
                                const int* sel, const void* qa, const void* qb, const void* s,
                                const void* m, float* y, int n_tiles, int tt, int N, int R,
                                int K, void* stream) {
  using bf = __nv_bfloat16;
  if (tt < 1 || tt > 8 || K % 32 || (tt > 1 && K % 256) || (tt == 1 && n_tiles > 65535))
    return (int)cudaErrorInvalidValue;
  if (kind != KIND_Q4 && kind != KIND_Q6 && kind != KIND_Q8) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (tt == 1) {
    auto fn = kind == KIND_Q4 ? &launch_gemv<KIND_Q4>
              : kind == KIND_Q6 ? &launch_gemv<KIND_Q6>
                                : &launch_gemv<KIND_Q8>;
    return fn(x_bf16, s_bf16, x, sel, qa, qb, s, m, y, n_tiles, N, R, K, st);
  }
  RmFn fn;
  if (kind == KIND_Q4) fn = s_bf16 ? &launch_mma<KIND_Q4, bf> : &launch_mma<KIND_Q4, float>;
  else if (kind == KIND_Q6) fn = s_bf16 ? &launch_mma<KIND_Q6, bf> : &launch_mma<KIND_Q6, float>;
  else fn = s_bf16 ? &launch_mma<KIND_Q8, bf> : &launch_mma<KIND_Q8, float>;
  return fn(static_cast<float*>(x), sel, qa, qb, s, m, y, n_tiles, tt, N, R, K, st);
}

// Transposed. x: (n_tiles * tt, K) f32 in natural order; sel as above; q:
// q4 or q8 planes (M, K*bits/8, R); s, m: (M, Gp, R) f32 or bf16 (m null
// for Q8); xg: (2, n_tiles * tt, K/32) bf16 scratch for xgsum's hi and lo
// planes (tt > 1, Q4; K/32 rounded up to a multiple of 4 columns,
// group_xg_cols); y: (n_tiles * tt, N) f32. R % 128 == 0, tt <= 8, K % 32,
// Gp >= K/32 rounded up to 4. tt = 1 runs the f32 FMA body; tt > 1 the
// tensor-core route, which overwrites x with its bf16 hi/lo split (the
// wrapper passes its own copy).
extern "C" int tpl_qmm_gathered_t(int kind, int s_bf16, float* x, void* xg, const int* sel,
                                  const void* q, const void* s, const void* m, float* y,
                                  int n_tiles, int tt, int N, int R, int K, int Gp,
                                  void* stream) {
  using bf = __nv_bfloat16;
  if (tt < 1 || tt > 8 || R % T_BLOCK_N || K % 32 || Gp < group_xg_cols(K / 32))
    return (int)cudaErrorInvalidValue;
  TFn fn;
  if (kind == KIND_Q4) fn = s_bf16 ? pick_t<KIND_Q4, bf>(tt) : pick_t<KIND_Q4, float>(tt);
  else if (kind == KIND_Q8) fn = s_bf16 ? pick_t<KIND_Q8, bf>(tt) : pick_t<KIND_Q8, float>(tt);
  else return (int)cudaErrorInvalidValue;
  return fn(x, xg, sel, q, s, m, y, n_tiles, tt, N, R, K, Gp, static_cast<cudaStream_t>(stream));
}
