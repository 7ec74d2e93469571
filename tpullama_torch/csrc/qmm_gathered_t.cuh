// The transposed gathered kernel (qmm_gathered_t: the Pallas kernel
// `kernel` of _qmm_gathered_t, tpullama/ops/pallas/qmm.py:771) as templates
// over the field set (KIND): one-row tiles on the transposed decode body
// (gt_body), tiles of 2..8 rows on the group body (qmm_group_mma.cuh).
// qmm_gathered.cu instantiates KIND_Q4 and KIND_Q8 and
// qmm_gathered_mxfp4.cu MXFP4's KIND_MXFP4 and KIND_MXFP4_AR, the field
// sets the loader stores transposed, so the sources build side by side.
// See qmm_gathered.cu for what bounds the kernel and its arguments.

#pragma once

#include "qmm_gathered.cuh"
#include "qmm_group_mma.cuh"

namespace tpl {

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
    const int* __restrict__ sel, const uint8_t* __restrict__ q, const uint8_t* __restrict__ qh,
    const ST* __restrict__ scale, const ST* __restrict__ minv, float* __restrict__ y,
    int n_tiles, int tt, int N, int R, int K, int Gp) {
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
  using P = Planes<KIND>;
  const size_t q_rows = (size_t)K / 8 * P::BL, h_rows = (size_t)K / 8 * P::BH;
  // 8-row tiles are BN consecutive rows: one box; else one box per tile
  const GroupX gx = tt == 8 ? GroupX{&tmx, tile0 * 8, 0, BN, 1} : GroupX{&tmx, tile0 * tt, tt, tt, nt};
  unsigned phases = 0;
  for (int j0 = 0; j0 < nt;) {
    const int e = tsel[j0];
    int j1 = j0 + 1;
    while (j1 < nt && tsel[j1] == e) ++j1;
    const GroupW<ST> w{q + (size_t)e * q_rows * R + n0, scale + (size_t)e * Gp * R + n0,
                       GG::MIN ? minv + (size_t)e * Gp * R + n0 : nullptr, R, nullptr, 0, 0,
                       P::BH ? qh + (size_t)e * h_rows * R + n0 : nullptr, R};
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
// an expert's low plane holds position j of scale column c for every row
// (Q4 and MXFP4's sets: low nibble a = j, high a = j + 16; Q8_0: a = j),
// and byte row (j % 4)*G + c of the A/r set's q1r plane bit j / 4 of a = j
// and bit j / 4 + 4 of a = j + 16, so a 4-byte word is 4 neighbouring rows
// at one position, and one x value, the same for every row, is a
// broadcast.
//   - Grid (row blocks of GT_ROWS, column splits of GT_COLS scale columns,
//     tiles). A block of a tile that starts a run (find_run) reads its rows
//     of the split's columns once for the run's tiles.
//   - GT_STREAMS column streams of GT_LANES threads; a thread holds 2
//     words, 8 rows, and its stream takes the split's columns c = stream,
//     stream + GT_STREAMS, ... in order. One 16-byte read of staged x (4
//     positions) feeds 8 rows x 4 positions of FMAs per x row.
//   - Each step's tile (GT_STREAMS columns x 16 byte rows x GT_ROWS bytes,
//     and the A/r set's 4 q1r byte rows: every cp.async a whole 16 bytes of
//     16 neighbouring rows, every GT_ROWS-byte run coalesced) comes through
//     a 2-stage shared-memory ring while the threads sum the step before;
//     Q8_0 takes 2 steps (2 rounds of 16 byte rows) a column.
//   - Values by byte permute into 2^23 and one FADD (qmm_gemv.cuh's
//     gv_vals; MXFP4's through gv_value); each (row, x row, column) sum in
//     f32 over a = j, j + 16 (Q4, MXFP4) or a in order (Q8_0), folded
//     once: part += scale * sum - minv * (the column's x sum), the
//     reference's hoisted min term (none for Q8_0 and MXFP4). A row's 8
//     scales (and mins) are one or two 16-byte loads a column.
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

// byte rows of a column in a step's tile: 16 of the low plane, and the A/r
// set's 4 q1r rows
template <int KIND>
__host__ __device__ constexpr int gt_jrows() { return 16 + Planes<KIND>::JH; }
// bytes of a ring stage
template <int KIND>
__host__ __device__ constexpr int gt_stage() { return GT_STREAMS * gt_jrows<KIND>() * GT_ROWS; }
// the x slice and its column sums, then the ring (which the streams' parts
// reuse at the end)
template <int KIND>
__host__ __device__ constexpr int gt_smem_bytes(int tt) {
  return tt * GT_COLS * (GT_XP + 1) * 4 + 2 * gt_stage<KIND>();
}
static_assert(GT_STREAMS * GATHER_RUN * GT_ROWS * 4 <= 2 * GT_STREAMS * 16 * GT_ROWS,
              "parts fit the ring");

template <int KIND, int TT>
__device__ __forceinline__ void gt_body(const float* __restrict__ x, const GatherRun& run,
                                        const uint8_t* __restrict__ qe,
                                        const uint8_t* __restrict__ he,
                                        const void* __restrict__ se, const void* __restrict__ me,
                                        bool s_bf16, float* __restrict__ ws, float* smem, int T,
                                        int n_tiles, int N, int R, int K) {
  constexpr int ROUNDS = KIND == KIND_Q8 ? 2 : 1;
  constexpr int JR = gt_jrows<KIND>(), GT_STAGE = gt_stage<KIND>();
  constexpr bool LOW4 = KIND != KIND_Q8;  // nibbles: a = j and j + 16
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
      for (int i = tid; i < GT_STREAMS * JR * P; i += GT_THREADS) {
        const int p = i % P, j = i / P % JR, m = i / (JR * P), c = cs + m;
        if (c >= nc) continue;
        // byte rows 16.. of a column's tile: the q1r plane's (j - 16)G + c
        const uint8_t* src = j < 16 ? qe + ((size_t)(16 * h + j) * G + c0 + c) * R + 16 * p
                                    : he + ((size_t)(j - 16) * G + c0 + c) * R + 16 * p;
        const unsigned d =
            (unsigned)__cvta_generic_to_shared(st + (m * JR + j) * GT_ROWS + 16 * p);
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
      if constexpr (has_min<KIND>()) {
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
    const uint8_t* wv = ring + (s & 1) * GT_STAGE + sm * JR * GT_ROWS + 8 * li;
    const float* xc = xs + cl * GT_XP + 16 * h;
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 4) {
      float4 xl[TT], xh[TT];  // positions a = j0 .. j0 + 3 (nibbles: and a + 16)
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        xl[t] = *reinterpret_cast<const float4*>(xc + t * GT_COLS * GT_XP + j0);
        if constexpr (LOW4)
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
        if constexpr (LOW4) {
          // the A/r set's bits r of a = j (bit j / 4) and a = j + 16 (bit
          // j / 4 + 4) over the fields a | r << 4 (gv_value)
          uint2 hr = make_uint2(0u, 0u);
          if constexpr (KIND == KIND_MXFP4_AR)
            hr = *reinterpret_cast<const uint2*>(wv + (16 + (j0 + jj) % 4) * GT_ROWS);
          constexpr float B = MAGIC + GvGeo<KIND>::BIAS;
          const int hs = (j0 + jj) / 4;
          auto lo = [&](uint32_t v, uint32_t r) {
            return gv_value<KIND>((v & NIB) | (((r >> hs) & 0x01010101u) << 4));
          };
          auto hi = [&](uint32_t v, uint32_t r) {
            return gv_value<KIND>(((v >> 4) & NIB) | (((r >> (hs + 4)) & 0x01010101u) << 4));
          };
          gv_vals(lo(w.x, hr.x), B, q[0]);
          gv_vals(lo(w.y, hr.y), B, q[1]);
          fma_rows(xl);
          gv_vals(hi(w.x, hr.x), B, q[0]);
          gv_vals(hi(w.y, hr.y), B, q[1]);
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
          if constexpr (has_min<KIND>())
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
    const uint8_t* __restrict__ qh, const void* __restrict__ scale,
    const void* __restrict__ minv, float* __restrict__ ws, int s_bf16, int n_tiles, int N,
    int R, int K, int Gp) {
  extern __shared__ __align__(16) float gt_smem[];
  __shared__ GatherRun run;
  const int tile = blockIdx.z;
  find_run(sel, tile, n_tiles, run);
  __syncthreads();
  const int T = run.len;
  if (T == 0) return;  // tile t is inside another tile's run
  const int e = sel[tile];
  const size_t kcols = (size_t)K / 8 * Planes<KIND>::BL, rb = blockIdx.x * GT_ROWS;
  const uint8_t* qe = q + (size_t)e * kcols * R + rb;
  const uint8_t* he = Planes<KIND>::BH ? qh + (size_t)e * (K / 8) * R + rb : nullptr;
  const size_t so = (size_t)e * Gp * R + rb;  // the expert's scale rows, from the block's row
  const int sz = s_bf16 ? 2 : 4;
  const void* se = static_cast<const char*>(scale) + so * sz;
  const void* me = has_min<KIND>() ? static_cast<const char*>(minv) + so * sz : nullptr;
  if (T == 1)
    gt_body<KIND, 1>(x, run, qe, he, se, me, s_bf16, ws, gt_smem, T, n_tiles, N, R, K);
  else if (T == 2)
    gt_body<KIND, 2>(x, run, qe, he, se, me, s_bf16, ws, gt_smem, T, n_tiles, N, R, K);
  else
    gt_body<KIND, GATHER_RUN>(x, run, qe, he, se, me, s_bf16, ws, gt_smem, T, n_tiles, N, R,
                              K);
}


// one-row tiles (decode): the transposed body over runs of at most
// GATHER_RUN tiles and splits of GT_COLS columns, then the splits' sum
template <int KIND>
int launch_t_gemv(int s_bf16, const float* x, float* ws, const int* sel, const void* q,
                  const void* qh, const void* s, const void* m, float* y, int n_tiles, int N,
                  int R, int K, int Gp, cudaStream_t st) {
  auto kern = qmm_gathered_t_gemv_kernel<KIND>;
  constexpr int smem = gt_smem_bytes<KIND>(GATHER_RUN);
  // set once per instance: the attribute call is slow, a launch is not
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int splits = (K / 32 + GT_COLS - 1) / GT_COLS;
  dim3 grid((N + GT_ROWS - 1) / GT_ROWS, splits, n_tiles);
  kern<<<grid, GT_THREADS, smem, st>>>(x, sel, static_cast<const uint8_t*>(q),
                                       static_cast<const uint8_t*>(qh), s, m, ws, s_bf16,
                                       n_tiles, N, R, K, Gp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gv_sum_parts(ws, y, n_tiles * N, splits, st);
}

// tiles of 2..8 rows (prefill): group_prep, then the group-scaled tile body
template <int KIND, typename ST>
int launch_t_mma(float* x, void* xg, const int* sel, const void* q, const void* qh,
                 const void* s, const void* m, float* y, int n_tiles, int tt, int N, int R,
                 int K, int Gp, cudaStream_t st) {
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
      tmx, xgp, sel, static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(qh),
      static_cast<const ST*>(s), static_cast<const ST*>(m), y, n_tiles, tt, N, R, K, Gp);
  return (int)cudaGetLastError();
}

// qmm_gathered_t's two routes for one field set: one-row tiles (tt = 1) on
// the transposed decode body, tiles of 2..8 rows on the group body, with
// the scale type a template argument there and a runtime flag on the decode
// body (see tpl_qmm_gathered_t in qmm_gathered.cu for the arguments)
template <int KIND>
int launch_gathered_t(int s_bf16, float* x, void* xg, const int* sel, const void* q,
                      const void* qh, const void* s, const void* m, float* y, int n_tiles,
                      int tt, int N, int R, int K, int Gp, cudaStream_t st) {
  if (tt == 1)
    return launch_t_gemv<KIND>(s_bf16, x, static_cast<float*>(xg), sel, q, qh, s, m, y,
                               n_tiles, N, R, K, Gp, st);
  auto fn = s_bf16 ? &launch_t_mma<KIND, __nv_bfloat16> : &launch_t_mma<KIND, float>;
  return fn(x, xg, sel, q, qh, s, m, y, n_tiles, tt, N, R, K, Gp, st);
}

}  // namespace tpl
