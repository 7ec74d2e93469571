// The decode body (T <= 8 x rows): y = x @ W^T over planar packed
// weights, designed for the H100's memory. gv_tile runs it over one
// block's tile of rows; four kernels call it:
//   - qmm_gemv (qmm.cu), the T <= 8 use of the Pallas kernel `kernel` of
//     quantized_matmul (tpullama/ops/pallas/qmm.py:296);
//   - qmm_ktiled at T <= 8 (qmm_ktiled.cu), one K-chunk per block: the
//     chunk's a-rows of every scale column (GvRows);
//   - fused_postattn (fused_layer.cu), both of its matvecs, x made in the
//     kernel (gv_stage_with);
//   - one-row qmm_gathered tiles (qmm_gathered.cu), x the rows of the
//     tiles that share an expert, each expert's rows read once per run.
// (One-row qmm_gathered_t tiles, on transposed planes, run their own
// thread mapping in qmm_gathered.cu with this file's unpacking.)
// What bounds it: bytes. A decode step reads every packed weight once
// (~0.6 B/weight for Q4_K with bf16 scales) and does 2*T flops per
// weight. A warp per row, dequantizing each weight as q * scale - minv,
// ran about 13 thread-instructions per weight at T = 4 (a slow
// int->float conversion, the scale and min, a bf16 -> f32 conversion of
// x per weight). This body:
//
//   - Scale columns held, not reloaded. Stored position p = a*G + c of a
//     row (G = K/g) sits in scale column c. A thread owns classes of 4
//     consecutive columns and walks each class down its g positions a (one
//     4-byte word per a-row of a plane), so a class's scales (and mins) are
//     read once. It sums q * x per (column, x row) in f32 registers, in a
//     fixed order of a, and folds each column once: part += scale * sum,
//     then part -= minv * sum_a x (the group body's arithmetic,
//     qmm_group_mma.cuh).
//   - No int -> float conversion per weight: a byte permute places each
//     value in the mantissa of 2^23 and one FADD of -2^23 makes it exact
//     (Q8_0's signed bytes biased by 128 first).
//   - x read in place and reused: the wrapper passes x in column order
//     (x_col[t, c*g + a], natural order for stripe planes); the block
//     stages a slice of its columns into shared memory as f32 in stored
//     order [t][a][column] with each column's sum. Shared memory delivers
//     at most 128 bytes a clock to an SM, broadcast or not, so x read per
//     FMA would bound the call at ~4x the FMA rate: each thread takes 2
//     rows, and one 16-byte read of x feeds 8 FMAs. Slices of 256 / T
//     columns (64 at T = 8) keep any T <= 8 and K in the budget.
//   - Bytes in flight: the block copies each step's weight tile (its rows
//     x 16 classes) by 16-byte cp.async from all threads into a 2-stage
//     shared-memory ring while it sums the step before, so they cost no
//     registers (held in registers, a class's words and their addresses
//     took 128-187 registers and spilled).
//   - 16 lanes per row group take classes lane, lane + 16, ...; their
//     partial sums meet in a butterfly.
//     None of this depends on T, so a row's output is bit-identical at
//     every T <= 8. Blocks of 64 to 256 threads: the smallest count that
//     still gives 132 blocks, so a narrow N (1024, K/V projections) fills
//     the card.
//
// Field sets: KIND_Q4 {q4, scale, minv} g=32 (byte jG + c: a = j low
// nibble, a = j + 16 high); KIND_Q6 {q4, q2, scale, minv} g=16 (q4 byte
// jG + c, j < 8: a = j, j + 8; q2 byte jG + c, j < 4: crumb i is a = j +
// 4i; value q4 | q2 << 4); KIND_Q8 {q8, scale} g=32 (signed byte aG + c).
// Any K % 32 (Q6_K: % 256): where G % 4 != 0 a row's last class is ragged
// and its bytes and scales are read one by one, past-the-row columns zero.

#pragma once

#include "qmm_dequant.cuh"

namespace tpl {

constexpr int GV_CW = 4;             // scale columns per class: a 4-byte word per a-row
constexpr int GV_RT = 2;             // rows per thread: each x value feeds both
constexpr int GV_L = 16;             // lanes per row group: classes per step
constexpr int GV_MIN_BLOCKS = 132;   // blocks wanted before threads are halved

// Columns of x a slice stages: T * columns fixed (33.8 KB for g = 32 at
// T <= 4), and a compile-time pitch, so every read of x is at an immediate
// offset. A slice holds whole steps of 16 classes.
template <int TT>
struct GvSlice {
  static constexpr int COLS = TT < 4 ? 256 / TT : 64;
};

template <int KIND>
struct GvGeo {
  static constexpr int GROUP = KIND == KIND_Q6 ? 16 : 32;
  // a-rows of a step's tile (Q4 16; Q6_K 8 of q4 and 4 of q2; Q8_0 16 of
  // its 32, two rounds a class) and the tile's row pitch in words (a pad
  // of 8 puts a warp's two row groups on different banks)
  static constexpr int AROWS = KIND == KIND_Q6 ? 12 : 16;
  static constexpr int ROUNDS = KIND == KIND_Q8 ? 2 : 1;
  static constexpr int PITCH = AROWS * GV_L + 8;
  // byte rows per scale column of the q4 (Q4) or q8 (Q8_0) plane
  static constexpr int JROWS = 16 * ROUNDS;
};

// The part of each row gv_tile sums: byte rows [j0, j1) of every scale
// column of the q4 plane (a = j and j + 16) or the q8 plane (a = j), the
// stored elements [j0 * G, j1 * G) of each stripe, which is one K-chunk of
// the reference's _qmm_ktiled; and whether each column's min term is
// folded (the reference folds it into chunk 0 alone). Q6_K takes whole
// rows.
struct GvRows {
  int j0, j1;
  bool mins;
};

template <int KIND>
__device__ __forceinline__ constexpr GvRows gv_whole() {
  return GvRows{0, GvGeo<KIND>::JROWS, true};
}

// A row's words in a ring stage for a range of jn byte rows: the rows of
// one round (at most 16) and a pad of 8, which puts a warp's two row
// groups on different banks; GvGeo::PITCH for whole rows (and Q6_K).
template <int KIND>
__host__ __device__ __forceinline__ constexpr int gv_pitch(int jn) {
  return KIND == KIND_Q6 ? GvGeo<KIND>::PITCH : (jn < 16 ? jn : 16) * GV_L + 8;
}

// (2^23 + byte b of w) as f32, exact
__device__ __forceinline__ float gv_magic(uint32_t w, int b) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + b));
}

// cb (16, 8 or 4) bytes of a plane at p into shared memory, of which the
// first `valid` are copied and the rest zero: cp.async where p is cb-aligned,
// else (G % 4 != 0: cb is 4) byte by byte.
__device__ __forceinline__ void gv_copy(void* dst, const uint8_t* __restrict__ p, int cb,
                                        bool async, int valid) {
  valid = max(0, min(cb, valid));
  if (async) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (cb == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(p),
                   "r"(valid) : "memory");
    else if (cb == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(p),
                   "r"(valid) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(p),
                   "r"(valid) : "memory");
    return;
  }
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < valid) v |= (uint32_t)p[b] << (8 * b);
  *static_cast<uint32_t*>(dst) = v;
}

// 4 scale (or min) values of a class from element i of a plane of T, f32;
// past-the-row columns 0
template <typename T>
__device__ __forceinline__ void gv_scales_t(const void* plane, size_t i, bool aligned, int valid,
                                            float (&out)[GV_CW]) {
  const T* p = static_cast<const T*>(plane) + i;
  if (aligned) {
    load_f<T, GV_CW>(p, out);
    return;
  }
#pragma unroll
  for (int b = 0; b < GV_CW; ++b) out[b] = b < valid ? to_f(p[b]) : 0.f;
}

__device__ __forceinline__ void gv_scales(const void* plane, size_t i, bool bf16, bool aligned,
                                          int valid, float (&out)[GV_CW]) {
  if (bf16) gv_scales_t<__nv_bfloat16>(plane, i, aligned, valid, out);
  else gv_scales_t<float>(plane, i, aligned, valid, out);
}

// The 4 values of one position a as f32 from the word holding them, each
// byte already its integer (+ bias).
__device__ __forceinline__ void gv_vals(uint32_t v, float bias, float (&q)[GV_CW]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) q[b] = gv_magic(v, b) - bias;
}

// acc[r][c][t] += q[r][c] * x[t][a][c] for the class whose staged x starts
// at xk (the slice is [t][a][column], SW columns): one 16-byte read per x
// row feeds both rows' 4 values, and the 32 lanes of a row read 512
// contiguous bytes.
template <int TT, int GROUP, int SW>
__device__ __forceinline__ void gv_fma(const float (&q)[GV_RT][GV_CW], const float* xk, int a,
                                       float (&acc)[GV_RT][GV_CW][TT]) {
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    const float4 u = *reinterpret_cast<const float4*>(xk + (size_t)(t * GROUP + a) * SW);
    const float xv[GV_CW] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int r = 0; r < GV_RT; ++r)
#pragma unroll
      for (int c = 0; c < GV_CW; ++c) acc[r][c][t] = fmaf(q[r][c], xv[c], acc[r][c][t]);
  }
}

// Stage columns [cs, cs + SW) of x (rows t < T, zeros for t >= T and
// columns >= G) into xs[t][a][c - cs] as f32, and each column's sum over a
// (in order) into xsum[t][c - cs]. load(t, c, v) fills v with the g values
// of x row t in scale column c (x_col[t, c*g .. c*g + g)), so x may come
// from global memory in column order or be made by the caller.
template <int KIND, int TT, class Load>
__device__ __forceinline__ void gv_stage_with(Load load, float* xs, float* xsum, int T, int G,
                                              int cs) {
  constexpr int g = GvGeo<KIND>::GROUP, SW = GvSlice<TT>::COLS;
  for (int i = threadIdx.x; i < TT * SW; i += blockDim.x) {
    const int t = i / SW, cl = i - t * SW, c = cs + cl;
    float v[g];
    if (t < T && c < G) {
      load(t, c, v);
    } else {
#pragma unroll
      for (int a = 0; a < g; ++a) v[a] = 0.f;
    }
    float sum = 0.f;
#pragma unroll
    for (int a = 0; a < g; ++a) {
      sum += v[a];
      xs[(size_t)(t * g + a) * SW + cl] = v[a];
    }
    xsum[t * SW + cl] = sum;
  }
}

// x rows in column order in global memory, (T, K) at x, f32 or bf16
template <int KIND, int TT>
__device__ __forceinline__ void gv_stage(const void* x, bool x_bf16, float* xs, float* xsum,
                                         int T, int K, int G, int cs) {
  constexpr int g = GvGeo<KIND>::GROUP;
  gv_stage_with<KIND, TT>(
      [&](int t, int c, float (&v)[g]) {
        const size_t at = (size_t)t * K + (size_t)c * g;
        if (x_bf16) load_f<__nv_bfloat16, g>(static_cast<const __nv_bfloat16*>(x) + at, v);
        else load_f<float, g>(static_cast<const float*>(x) + at, v);
      },
      xs, xsum, T, G, cs);
}

// The body: part[r][t] = x[t] . W[row_of(rg * GV_RT + r)] over the whole
// row (K), for the block's rows_blk = blockDim.x / 16 * GV_RT tile rows and
// x rows t < TT, every lane of a 16-lane row group holding the totals.
// Block: blockDim.x / 16 groups of 16 lanes, each group GV_RT rows; lane li
// takes classes li, li + 16, ... of its rows, in that order whatever the
// slices (GvSlice columns each) cut. row_of(rr) is the plane row of tile
// row rr, always a row of the planes (callers clamp). stage(xs, xsum, cs)
// fills the x slice of columns [cs, cs + SW) (gv_stage, gv_stage_with); it
// is called after a barrier, once per slice. smem: gv_smem_bytes<KIND, TT>
// bytes (dynamic shared memory).
//
// The block runs in steps: step s is class group s / NR (16 classes),
// round h0 + s % NR of the rounds [h0, h0 + NR) that hold the byte rows of
// `rows` (all ROUNDS for whole rows). Its tile (every row of the block,
// the round's byte rows in `rows`, 64 bytes of each) comes into a 2-stage
// ring by 16-byte cp.async from all threads while the threads sum step
// s - 1 out of the other stage; each thread then reads its own 4-byte
// words at immediate offsets. Steps of a thread over whole rows: Q4 16, a
// = j and j + 16; Q6_K 8, a = j and j + 8; Q8_0 2 x 16. A byte row range
// skips the other rows' copies and sums and keeps the order of the rest.
template <int KIND, int TT, class RowOf, class Stage>
__device__ __forceinline__ void gv_tile(const uint8_t* __restrict__ qa,
                                        const uint8_t* __restrict__ qb,
                                        const void* __restrict__ scale,
                                        const void* __restrict__ minv, bool s_bf16, int K,
                                        RowOf row_of, Stage stage, float* smem,
                                        float (&part)[GV_RT][TT],
                                        GvRows rows = gv_whole<KIND>()) {
  using GE = GvGeo<KIND>;
  constexpr int g = GE::GROUP, RT = GV_RT, L = GV_L, SW = GvSlice<TT>::COLS, SC = SW / GV_CW;
  constexpr int A = GE::AROWS, ROUNDS = GE::ROUNDS;
  constexpr uint32_t NIB = 0x0F0F0F0Fu;
  constexpr float MAGIC = 8388608.f;  // 2^23
  const int G = K / g, NC = (G + GV_CW - 1) / GV_CW;
  const bool aligned = G % GV_CW == 0;
  const int cb = G % 16 == 0 ? 16 : (G % 8 == 0 ? 8 : 4);  // copy chunk bytes
  const int rows_blk = blockDim.x / L * RT;
  // the rounds that hold byte rows [j0, j1), and the rows of round h
  const int h0 = KIND == KIND_Q6 ? 0 : rows.j0 / 16;
  const int NR = KIND == KIND_Q6 ? 1 : (rows.j1 + 15) / 16 - h0;
  auto j_lo = [&](int h) { return KIND == KIND_Q6 ? 0 : max(rows.j0 - 16 * h, 0); };
  auto j_hi = [&](int h) { return KIND == KIND_Q6 ? A : min(rows.j1 - 16 * h, 16); };
  // a row's words in a stage: the range's byte rows of a round, packed
  // (GvGeo::PITCH for whole rows)
  const int pitch = gv_pitch<KIND>(rows.j1 - rows.j0);
  float* xs = smem;
  float* xsum = smem + TT * g * SW;
  uint32_t* ring = reinterpret_cast<uint32_t*>(xsum + TT * SW);
  const int ring_stage = rows_blk * pitch;  // words
  const int li = threadIdx.x & (L - 1), rg = threadIdx.x / L;
  // this thread's words: row rg * RT + r, byte row j of round h at
  // + r * pitch + (j - j_lo(h)) * L
  const uint32_t* mine = ring + rg * RT * pitch + li;
  // step s's tile into stage s % 2, one cp.async group (empty past the rows)
  auto copy = [&](int s) {
    const int c0 = GV_L * (s / NR), h = h0 + s % NR;
    uint32_t* st = ring + (s & 1) * ring_stage;
    if (c0 < NC) {
      const int ja = j_lo(h);
      const int per_row = (j_hi(h) - ja) * (64 / cb);  // chunks of one row's tile
      for (int i = threadIdx.x; i < rows_blk * per_row; i += blockDim.x) {
        const int rr = i / per_row, e = i - rr * per_row, j = ja + e / (64 / cb);
        const int at = (e - (j - ja) * (64 / cb)) * cb;  // byte in the a-row's 64
        const size_t n = row_of(rr);
        const uint8_t* src;
        if (KIND == KIND_Q6 && j >= 8)
          src = qb + n * (K / 4) + (size_t)(j - 8) * G;
        else
          src = qa + n * (KIND == KIND_Q8 ? K : K / 2) + (size_t)(16 * h + j) * G;
        const int col = GV_CW * c0 + at;  // byte of the a-row
        gv_copy(reinterpret_cast<char*>(st + rr * pitch + (j - ja) * L) + at, src + col, cb,
                aligned, G - col);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) part[r][t] = 0.f;
  int s = 0;
  __syncthreads();  // a block that runs several tiles: the last one's ring readers are done
  copy(0);          // in flight while the block stages x
  for (int c0 = 0; c0 < NC; c0 += SC) {
    const int nsc = min(SC, NC - c0);
    __syncthreads();  // the last slice's readers are done
    stage(xs, xsum, GV_CW * c0);
    for (int cg = c0; cg < c0 + nsc; cg += L) {
      const int k = cg + li;  // this thread's class
      const bool on = k < NC;
      const int cv = min(GV_CW, G - GV_CW * k);
      // used at the fold: their latency hides behind the sums
      float sc[RT][GV_CW], mn[RT][GV_CW];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const size_t at = row_of(rg * RT + r) * G + GV_CW * (on ? k : 0);
        gv_scales(scale, at, s_bf16, aligned, cv, sc[r]);
        if constexpr (KIND != KIND_Q8)
          if (rows.mins) gv_scales(minv, at, s_bf16, aligned, cv, mn[r]);
      }
      const float* xk = xs + GV_CW * (k - c0);
      float acc[RT][GV_CW][TT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < GV_CW; ++c)
#pragma unroll
          for (int t = 0; t < TT; ++t) acc[r][c][t] = 0.f;
      float q[RT][GV_CW];
#pragma unroll
      for (int hh = 0; hh < ROUNDS; ++hh) {
        if (hh == NR) break;
        const int h = h0 + hh, jl = j_lo(h), jh = j_hi(h);
        __syncthreads();  // step s - 1's stage is free; (first step) x is staged
        copy(s + 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();  // step s's tile has landed for every thread
        const uint32_t* wv = mine + (s++ & 1) * ring_stage;
        if (!on) continue;
        if constexpr (KIND == KIND_Q4) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < jl || j >= jh) continue;
            uint32_t wr[RT];
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              wr[r] = wv[r * pitch + (j - jl) * L];
              gv_vals(wr[r] & NIB, MAGIC, q[r]);
            }
            gv_fma<TT, g, SW>(q, xk, j, acc);
#pragma unroll
            for (int r = 0; r < RT; ++r) gv_vals((wr[r] >> 4) & NIB, MAGIC, q[r]);
            gv_fma<TT, g, SW>(q, xk, j + 16, acc);
          }
        } else if constexpr (KIND == KIND_Q6) {
          // value = nibble | crumb << 4: q4 word j holds a = j (low) and
          // j + 8 (high), q2 word j % 4 crumbs j / 4 and j / 4 + 2 for them
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c2 = j / 4;
            uint32_t lo[RT], cr[RT];
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              lo[r] = wv[r * pitch + j * L];
              cr[r] = wv[r * pitch + (8 + j % 4) * L];
              gv_vals((lo[r] & NIB) | ((cr[r] << (4 - 2 * c2)) & 0x30303030u), MAGIC, q[r]);
            }
            gv_fma<TT, g, SW>(q, xk, j, acc);
#pragma unroll
            for (int r = 0; r < RT; ++r)
              gv_vals(((lo[r] >> 4) & NIB) | ((cr[r] >> (2 * c2)) & 0x30303030u), MAGIC, q[r]);
            gv_fma<TT, g, SW>(q, xk, j + 8, acc);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < jl || j >= jh) continue;
            // signed bytes b as b + 128, so the bias is 2^23 + 128
#pragma unroll
            for (int r = 0; r < RT; ++r)
              gv_vals(wv[r * pitch + (j - jl) * L] ^ 0x80808080u, MAGIC + 128.f, q[r]);
            gv_fma<TT, g, SW>(q, xk, 16 * h + j, acc);
          }
        }
      }
      if (!on) continue;
      // fold each column once, in column order
      const float* xsk = xsum + GV_CW * (k - c0);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < GV_CW; ++c)
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            part[r][t] = fmaf(sc[r][c], acc[r][c][t], part[r][t]);
            if constexpr (KIND != KIND_Q8)
              if (rows.mins) part[r][t] = fmaf(-mn[r][c], xsk[t * SW + c], part[r][t]);
          }
    }
  }
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int t = 0; t < TT; ++t) part[r][t] += __shfl_xor_sync(0xffffffffu, part[r][t], o);
}

// y[t, n] = sum over K of x[t] . W[n] for t < T <= TT, x in column order:
// block b computes rows [b * rows_blk, (b + 1) * rows_blk) through gv_tile.
template <int KIND, int TT>
__global__ void __launch_bounds__(256, TT <= 4 ? 2 : 1) qmm_gemv_kernel(
    const void* __restrict__ x, const uint8_t* __restrict__ qa, const uint8_t* __restrict__ qb,
    const void* __restrict__ scale, const void* __restrict__ minv, float* __restrict__ y,
    int x_bf16, int s_bf16, int T, int N, int K) {
  extern __shared__ __align__(16) float gv_smem[];
  const int G = K / GvGeo<KIND>::GROUP;
  const int nb = blockIdx.x * (blockDim.x / GV_L * GV_RT);  // the block's first row
  const int n0 = nb + threadIdx.x / GV_L * GV_RT;
  float part[GV_RT][TT];
  gv_tile<KIND, TT>(
      qa, qb, scale, minv, s_bf16, K, [&](int rr) { return (size_t)min(nb + rr, N - 1); },
      [&](float* xs, float* xsum, int cs) {
        gv_stage<KIND, TT>(x, x_bf16, xs, xsum, T, K, G, cs);
      },
      gv_smem, part);
  if ((threadIdx.x & (GV_L - 1)) == 0)
#pragma unroll
    for (int r = 0; r < GV_RT; ++r)
#pragma unroll
      for (int t = 0; t < TT; ++t)
        if (t < T && n0 + r < N) y[(size_t)t * N + n0 + r] = part[r][t];
}

// Threads per block: 256, halved (to 64) while the grid would have fewer
// than 132 blocks, so a narrow N (1024, K/V projections) fills the card.
inline int gemv_threads(int N) {
  int threads = 256;
  while (threads > 64 && threads / GV_L * GV_RT * GV_MIN_BLOCKS > N) threads /= 2;
  return threads;
}

// the x slice and its column sums, then the two stages of the ring (for
// ranges of jn byte rows; whole rows by default)
template <int KIND, int TT>
constexpr int gv_smem_bytes(int threads, int jn = GvGeo<KIND>::JROWS) {
  return TT * (GvGeo<KIND>::GROUP + 1) * GvSlice<TT>::COLS * 4 +
         2 * (threads / GV_L * GV_RT) * gv_pitch<KIND>(jn) * 4;
}

// y[i] = ws[0][i] + ws[1][i] + ... + ws[nk - 1][i] in that order, i over
// n outputs: the partials of calls split over K (qmm_ktiled's chunks,
// qmm_gathered_t's column splits) meet in a fixed order, never by float
// atomics, so an output does not depend on which block finished first.
static __global__ void __launch_bounds__(256) gv_sum_parts_kernel(const float* __restrict__ ws,
                                                                 float* __restrict__ y, int n,
                                                                 int nk) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float acc = ws[i];
  for (int k = 1; k < nk; ++k) acc += ws[(size_t)k * n + i];
  y[i] = acc;
}

static inline cudaError_t gv_sum_parts(const float* ws, float* y, int n, int nk,
                                       cudaStream_t st) {
  gv_sum_parts_kernel<<<(n + 255) / 256, 256, 0, st>>>(ws, y, n, nk);
  return cudaGetLastError();
}

}  // namespace tpl
