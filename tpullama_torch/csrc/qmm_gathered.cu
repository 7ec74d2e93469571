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
//     xgsum being x's per-group sums, which the kernels compute from x, so
//     every output row depends on its own x row alone, whatever the tile
//     holds.
// R is the stored rows per expert (rows padded to 128 by the loader), N <= R
// the rows computed. qmm_gathered's one-row tiles take x f32 or bf16 in
// natural order, read in place (for stripe planes the decode body's column
// order is natural order); its tiles of more than one row take f32 x in
// stored (group-permuted) order, as in qmm.cu. qmm_gathered_t takes f32 x
// in natural order, in which scale column c holds natural elements c*32 ..
// c*32 + 31.
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
//     qmm_gathered_t runs the same runs (find_run) on its own thread
//     mapping for R-contiguous planes, with the decode body's unpacking and
//     fold (qmm_gathered_t_gemv_kernel): a thread holds 8 neighbouring rows
//     of one scale column, and a block's rows cover 32 columns of K, so
//     the card holds ~2,000 blocks at Mixtral's decode step.
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
// in the grid. It replaced an f32 FMA body (a lane per 4 rows) for tiles
// of more than one row (14.90 ms at Mixtral's down 4096 x 14336 x 8
// experts and 2048 slots, NVIDIA H100 80GB HBM3, 700.00 W), which
// dequantized each expert's planes again for every one of its ~32 tiles. x is f32 in natural
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

// Transposed, one-row tiles (decode): the decode body's arithmetic on
// (kcols, R) planes, whose contiguous axis is the rows. Byte row j*G + c of
// an expert's q plane holds position j of scale column c for every row
// (Q4: low nibble a = j, high a = j + 16; Q8_0: a = j), so a 4-byte word
// is 4 neighbouring rows at one position, and one x value, the same for
// every row, is a broadcast.
//   - Grid (row blocks of GT_ROWS, column splits of GT_COLS scale columns,
//     tiles). A block of a tile that starts a run (find_run) reads its rows
//     of the split's columns once for the run's tiles.
//   - GT_STREAMS column streams of GT_LANES threads; a thread holds 2
//     words, 8 rows, and its stream takes the split's columns c = stream,
//     stream + GT_STREAMS, ... in order. One 16-byte read of staged x (4
//     positions) feeds 8 rows x 4 positions of FMAs per x row.
//   - Each step's tile (GT_STREAMS columns x 16 byte rows x GT_ROWS bytes:
//     every cp.async a whole 16 bytes of 16 neighbouring rows, every
//     GT_ROWS-byte run coalesced) comes through a 2-stage shared-memory
//     ring while the threads sum the step before; Q8_0 takes 2 steps (2
//     rounds of 16 byte rows) a column.
//   - Values by byte permute into 2^23 and one FADD (qmm_gemv.cuh's
//     gv_vals); each (row, x row, column) sum in f32 over a = j, j + 16 (Q4)
//     or a in order (Q8_0), folded once: part += scale * sum - minv * (the
//     column's x sum), the reference's hoisted min term. A row's 8 scales
//     (and mins) are one or two 16-byte loads a column.
//   - The streams' parts meet in shared memory in stream order, the
//     splits' in a workspace summed in split order (gv_sum_parts). No order
//     depends on T, so a tile's output is bit-identical whoever else picked
//     its expert.
constexpr int GT_ROWS = 128;                  // rows of a block
constexpr int GT_TR = 8;                      // rows of a thread: 2 words
constexpr int GT_LANES = GT_ROWS / GT_TR;     // threads of a column stream
constexpr int GT_STREAMS = 8;                 // column streams of a block
constexpr int GT_THREADS = GT_LANES * GT_STREAMS;
constexpr int GT_COLS = 32;                   // scale columns of a split
constexpr int GT_XP = 36;                     // staged x floats a column: 32 and a bank pad
constexpr int GT_STAGE = GT_STREAMS * 16 * GT_ROWS;  // bytes of a ring stage

// the x slice and its column sums, then the ring (which the streams' parts
// reuse at the end)
constexpr int gt_smem_bytes(int tt) { return tt * GT_COLS * (GT_XP + 1) * 4 + 2 * GT_STAGE; }
static_assert(GT_STREAMS * GATHER_RUN * GT_ROWS * 4 <= 2 * GT_STAGE, "parts fit the ring");

template <int KIND, int TT>
__device__ __forceinline__ void gt_body(const float* __restrict__ x, const GatherRun& run,
                                        const uint8_t* __restrict__ qe,
                                        const void* __restrict__ se, const void* __restrict__ me,
                                        bool s_bf16, float* __restrict__ ws, float* smem, int T,
                                        int n_tiles, int N, int R, int K) {
  constexpr int ROUNDS = KIND == KIND_Q8 ? 2 : 1;
  constexpr uint32_t NIB = 0x0F0F0F0Fu;
  constexpr float MAGIC = 8388608.f;  // 2^23
  const int G = K / 32, tid = threadIdx.x;
  const int li = tid % GT_LANES, sm = tid / GT_LANES;
  const int nb = blockIdx.x * GT_ROWS, c0 = blockIdx.y * GT_COLS, nc = min(GT_COLS, G - c0);
  const int nsteps = (nc + GT_STREAMS - 1) / GT_STREAMS * ROUNDS;
  float* xs = smem;                       // [t][column][GT_XP]
  float* xsum = smem + TT * GT_COLS * GT_XP;  // [t][column]
  uint8_t* ring = reinterpret_cast<uint8_t*>(xsum + TT * GT_COLS);
  // step s's tile into stage s % 2, one cp.async group (empty past the steps)
  auto copy = [&](int s) {
    if (s < nsteps) {
      const int cs = s / ROUNDS * GT_STREAMS, h = s % ROUNDS;
      uint8_t* st = ring + (s & 1) * GT_STAGE;
      constexpr int P = GT_ROWS / 16;  // 16-byte pieces of a byte row's run
      for (int i = tid; i < GT_STREAMS * 16 * P; i += GT_THREADS) {
        const int p = i % P, j = i / P % 16, m = i / (16 * P), c = cs + m;
        if (c >= nc) continue;
        const uint8_t* src = qe + ((size_t)(16 * h + j) * G + c0 + c) * R + 16 * p;
        const unsigned d =
            (unsigned)__cvta_generic_to_shared(st + (m * 16 + j) * GT_ROWS + 16 * p);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  copy(0);  // in flight while the block stages x
  // x: the run's rows over the split's columns, zero past T and the columns
  for (int i = tid; i < TT * GT_COLS * 8; i += GT_THREADS) {
    const int t = i / (GT_COLS * 8), cl = i / 8 % GT_COLS, v = i % 8;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T && cl < nc)
      u = *reinterpret_cast<const float4*>(x + (size_t)run.tile[t] * K + (c0 + cl) * 32 + 4 * v);
    *reinterpret_cast<float4*>(xs + (t * GT_COLS + cl) * GT_XP + 4 * v) = u;
  }
  __syncthreads();
  for (int i = tid; i < TT * GT_COLS; i += GT_THREADS) {
    const float* xc = xs + i * GT_XP;
    float sum = 0.f;
#pragma unroll
    for (int a = 0; a < 32; ++a) sum += xc[a];
    xsum[i] = sum;
  }
  float part[GT_TR][TT], acc[GT_TR][TT], sc[GT_TR], mn[GT_TR];
#pragma unroll
  for (int r = 0; r < GT_TR; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) part[r][t] = 0.f;
  for (int s = 0; s < nsteps; ++s) {
    const int h = s % ROUNDS, cl = s / ROUNDS * GT_STREAMS + sm;
    const bool on = cl < nc;
    if (h == 0 && on) {  // the column's scales, used at its fold
      const size_t at = ((size_t)c0 + cl) * R + 8 * li;
      if (s_bf16) load_f<__nv_bfloat16, GT_TR>(static_cast<const __nv_bfloat16*>(se) + at, sc);
      else load_f<float, GT_TR>(static_cast<const float*>(se) + at, sc);
      if constexpr (KIND != KIND_Q8) {
        if (s_bf16) load_f<__nv_bfloat16, GT_TR>(static_cast<const __nv_bfloat16*>(me) + at, mn);
        else load_f<float, GT_TR>(static_cast<const float*>(me) + at, mn);
      }
#pragma unroll
      for (int r = 0; r < GT_TR; ++r)
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[r][t] = 0.f;
    }
    __syncthreads();  // step s - 1's stage is free; (first step) x is staged
    copy(s + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // step s's tile has landed for every thread
    if (!on) continue;
    const uint8_t* wv = ring + (s & 1) * GT_STAGE + sm * 16 * GT_ROWS + 8 * li;
    const float* xc = xs + cl * GT_XP + 16 * h;
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 4) {
      float4 xl[TT], xh[TT];  // positions a = j0 .. j0 + 3 (Q4: and a + 16)
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        xl[t] = *reinterpret_cast<const float4*>(xc + t * GT_COLS * GT_XP + j0);
        if constexpr (KIND == KIND_Q4)
          xh[t] = *reinterpret_cast<const float4*>(xc + t * GT_COLS * GT_XP + 16 + j0);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint2 w = *reinterpret_cast<const uint2*>(wv + (j0 + jj) * GT_ROWS);
        float q[2][4];
        auto fma_rows = [&](const float4 (&xv)[TT]) {
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const float xa = jj == 0 ? xv[t].x : jj == 1 ? xv[t].y : jj == 2 ? xv[t].z : xv[t].w;
#pragma unroll
            for (int r = 0; r < GT_TR; ++r) acc[r][t] = fmaf(q[r / 4][r % 4], xa, acc[r][t]);
          }
        };
        if constexpr (KIND == KIND_Q4) {
          gv_vals(w.x & NIB, MAGIC, q[0]);
          gv_vals(w.y & NIB, MAGIC, q[1]);
          fma_rows(xl);
          gv_vals((w.x >> 4) & NIB, MAGIC, q[0]);
          gv_vals((w.y >> 4) & NIB, MAGIC, q[1]);
          fma_rows(xh);
        } else {
          // signed bytes b as b + 128, so the bias is 2^23 + 128
          gv_vals(w.x ^ 0x80808080u, MAGIC + 128.f, q[0]);
          gv_vals(w.y ^ 0x80808080u, MAGIC + 128.f, q[1]);
          fma_rows(xl);
        }
      }
    }
    if (h == ROUNDS - 1) {  // fold the column once
#pragma unroll
      for (int r = 0; r < GT_TR; ++r)
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          part[r][t] = fmaf(sc[r], acc[r][t], part[r][t]);
          if constexpr (KIND != KIND_Q8)
            part[r][t] = fmaf(-mn[r], xsum[t * GT_COLS + cl], part[r][t]);
        }
    }
  }
  // the streams' parts meet in stream order, in the ring's memory
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [stream][t][row]
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int r = 0; r < GT_TR; ++r) red[(sm * TT + t) * GT_ROWS + GT_TR * li + r] = part[r][t];
  __syncthreads();
  for (int i = tid; i < T * GT_ROWS; i += GT_THREADS) {
    const int t = i / GT_ROWS, rr = i % GT_ROWS;
    float v = red[t * GT_ROWS + rr];
    for (int m = 1; m < GT_STREAMS; ++m) v += red[(m * TT + t) * GT_ROWS + rr];
    if (nb + rr < N) ws[((size_t)blockIdx.y * n_tiles + run.tile[t]) * N + nb + rr] = v;
  }
}

// ws: (column splits, n_tiles, N) f32, each split's part of every output
template <int KIND>
__global__ void __launch_bounds__(GT_THREADS, 3) qmm_gathered_t_gemv_kernel(
    const float* __restrict__ x, const int* __restrict__ sel, const uint8_t* __restrict__ q,
    const void* __restrict__ scale, const void* __restrict__ minv, float* __restrict__ ws,
    int s_bf16, int n_tiles, int N, int R, int K, int Gp) {
  extern __shared__ __align__(16) float gt_smem[];
  __shared__ GatherRun run;
  const int tile = blockIdx.z;
  find_run(sel, tile, n_tiles, run);
  __syncthreads();
  const int T = run.len;
  if (T == 0) return;  // tile t is inside another tile's run
  const int e = sel[tile];
  const size_t kcols = KIND == KIND_Q8 ? K : K / 2, rb = blockIdx.x * GT_ROWS;
  const uint8_t* qe = q + (size_t)e * kcols * R + rb;
  const size_t so = (size_t)e * Gp * R + rb;  // the expert's scale rows, from the block's row
  const int sz = s_bf16 ? 2 : 4;
  const void* se = static_cast<const char*>(scale) + so * sz;
  const void* me = KIND == KIND_Q8 ? nullptr : static_cast<const char*>(minv) + so * sz;
  if (T == 1)
    gt_body<KIND, 1>(x, run, qe, se, me, s_bf16, ws, gt_smem, T, n_tiles, N, R, K);
  else if (T == 2)
    gt_body<KIND, 2>(x, run, qe, se, me, s_bf16, ws, gt_smem, T, n_tiles, N, R, K);
  else
    gt_body<KIND, GATHER_RUN>(x, run, qe, se, me, s_bf16, ws, gt_smem, T, n_tiles, N, R, K);
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

// one-row tiles (decode): the transposed body over runs of at most
// GATHER_RUN tiles and splits of GT_COLS columns, then the splits' sum
template <int KIND>
int launch_t_gemv(int s_bf16, const float* x, float* ws, const int* sel, const void* q,
                  const void* s, const void* m, float* y, int n_tiles, int N, int R, int K,
                  int Gp, cudaStream_t st) {
  auto kern = qmm_gathered_t_gemv_kernel<KIND>;
  constexpr int smem = gt_smem_bytes(GATHER_RUN);
  // set once per instance: the attribute call is slow, a launch is not
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int splits = (K / 32 + GT_COLS - 1) / GT_COLS;
  dim3 grid((N + GT_ROWS - 1) / GT_ROWS, splits, n_tiles);
  kern<<<grid, GT_THREADS, smem, st>>>(x, sel, static_cast<const uint8_t*>(q), s, m, ws, s_bf16,
                                       n_tiles, N, R, K, Gp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gv_sum_parts(ws, y, n_tiles * N, splits, st);
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

// Transposed. x: (n_tiles * tt, K) f32 in natural order, 16-byte aligned;
// sel as above; q: q4 or q8 planes (M, K*bits/8, R); s, m: (M, Gp, R) f32
// or bf16 (m null for Q8), 16-byte aligned; y: (n_tiles * tt, N) f32.
// R % 128 == 0, tt <= 8, K % 32, Gp >= K/32 rounded up to 4. tt = 1 runs
// the transposed decode body over runs of at most GATHER_RUN (4) tiles of
// one expert (n_tiles <= 65535), and xg is its f32 workspace of
// (ceil(K/32 / 32), n_tiles, N) column-split parts. tt > 1 runs the
// tensor-core route, which overwrites x with its bf16 hi/lo split (the
// wrapper passes its own copy), and xg is (2, n_tiles * tt, K/32) bf16
// scratch for xgsum's hi and lo planes (Q4; K/32 rounded up to a multiple
// of 4 columns, group_xg_cols).
extern "C" int tpl_qmm_gathered_t(int kind, int s_bf16, float* x, void* xg, const int* sel,
                                  const void* q, const void* s, const void* m, float* y,
                                  int n_tiles, int tt, int N, int R, int K, int Gp,
                                  void* stream) {
  using bf = __nv_bfloat16;
  if (tt < 1 || tt > 8 || R % GT_ROWS || K % 32 || Gp < group_xg_cols(K / 32) ||
      (tt == 1 && n_tiles > 65535))
    return (int)cudaErrorInvalidValue;
  if (kind != KIND_Q4 && kind != KIND_Q8) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (tt == 1) {
    auto fn = kind == KIND_Q4 ? &launch_t_gemv<KIND_Q4> : &launch_t_gemv<KIND_Q8>;
    return fn(s_bf16, x, static_cast<float*>(xg), sel, q, s, m, y, n_tiles, N, R, K, Gp, st);
  }
  TFn fn;
  if (kind == KIND_Q4) fn = s_bf16 ? &launch_t_mma<KIND_Q4, bf> : &launch_t_mma<KIND_Q4, float>;
  else fn = s_bf16 ? &launch_t_mma<KIND_Q8, bf> : &launch_t_mma<KIND_Q8, float>;
  return fn(x, xg, sel, q, s, m, y, n_tiles, tt, N, R, K, Gp, st);
}
