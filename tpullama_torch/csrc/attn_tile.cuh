// Warp-level pieces shared by the two attention kernels (flash_attention.cu,
// flash_decode.cu): one warp owns 16 query rows (an m16 tile of mma.sync)
// against a run of 8 * NT key cells, and every thread keeps its values in
// the mma accumulator layout: lane = 4 g + tig holds, for n8 tile j, the
// scores of rows g and g + 8 (h = 0, 1) at cells 8 j + 2 tig and
// 8 j + 2 tig + 1 (s[j][2 h + c]), and the outputs of those two rows at
// columns 8 dn + 2 tig + c (o[dn][2 h + c]).
//
// Query rows: a kv head's G query heads and Tq positions are one row space
// in (position, head) order, row r = position * G + head. Row tiles cut
// that space freely, so one tile may span heads and positions and a group
// larger than a tile spans several tiles; each row reads the mask row of
// its own position.
//
// Two routes, chosen by dtype:
//   MMA (bf16 q, k, v): S = Q K^T by mma.sync m16n8k16 (bf16 operands, f32
//     accumulators; the products of bf16 values are exact, only the order
//     of the sums differs from the plain version); K fragments by ldmatrix
//     from rows of D values whose 16-byte pieces are XOR-swizzled by the
//     row (piece c of row r at c ^ (r % 8): conflict-free, no padding). O
//     += P V with V by ldmatrix.trans and P split into bf16 hi + lo, two
//     passes, so P keeps ~16 bits (the plain version is f32; one bf16 pass
//     would keep 8).
//   FMA (any f32 operand): the same layout computed by f32 FMAs from f32
//     tiles in shared memory, P through a per-warp shared buffer.
// An int8 cache (the JAX package's kv_dtype=int8) runs either route: bf16
// q takes MMA, its K/V bytes staged raw by cp.async and converted once per
// tile into the bf16 tile (stage_kv_i8, convert_i8; int8 values are exact
// in bf16), f32 q takes FMA, whose plain loads convert them to f32. Its
// per-(head, token) f32 scales apply as the TPU kernels apply them: K's
// multiplies a score after the scale and before softcap, mask and ALiBi
// (mask_scores), V's multiplies a probability after the row sum took it
// (scale_probs), before P V.
// Scale, logit softcap, mask, ALiBi and the online softmax stay in
// registers (quad shuffles for the row max; each thread keeps a partial
// row sum, reduced once at the end). The softmax runs in base 2: logits are
// scaled by log2(e) once, so each probability is one exp2f; row maxima
// (m) are kept in that base.
//
// Head dims: an instance is built for a padded width D (64, 128 or 256, a
// multiple of the m16n8k16 k-step) and takes any runtime head dim Dr <= D.
// Global rows are Dr values apart; the tiles, q fragments and outputs keep
// D columns, those at or past Dr loaded as zeros, so they add nothing to
// q . k, and nothing past Dr is written.

#pragma once

#include <cstdint>
#include <type_traits>

#include "qmm_mma.cuh"

namespace tpl_attn {

using tpl::cp_async_commit;
using tpl::cp_async_wait;
using tpl::ldsm_x4;
using tpl::mma_bf16;
using tpl::split2;

constexpr float NEG_INF = -1e30f;
constexpr float NEG_HALF = -5e29f;  // a mask value at or below it hides its cell
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;        // 4 warps
constexpr int CELLS = 64;           // key cells per tile (prefill) or chunk (decode)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// two neighbouring outputs
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16(a); }

// outputs d and d + 1 (d even) of a row of Dr values: one paired store
// where the row keeps pairs aligned (Dr even), else one by one; nothing at
// or past Dr
template <typename T>
__device__ __forceinline__ void store2_row(T* row, int d, float a, float b, int Dr) {
  if (d + 1 < Dr && (Dr & 1) == 0) {
    store2(row + d, a, b);
    return;
  }
  if (d < Dr) store1(row + d, a);
  if (d + 1 < Dr) store1(row + d + 1, b);
}

// A (CELLS x D) K or V tile in shared memory: bf16 rows of D values with
// swizzled 16-byte pieces (MMA, `piece`) or f32 rows of D + 4 (FMA); both
// keep ldmatrix and the float4 reads conflict-free.
template <bool MMA, int D>
struct Tile {
  using E = typename std::conditional<MMA, __nv_bfloat16, float>::type;
  static constexpr int LD = MMA ? D : D + 4;
  static constexpr int BYTES = CELLS * LD * (int)sizeof(E);
};

// MMA tiles: element offset of 16-byte piece c (8 values) of row r
template <int D>
__device__ __forceinline__ int piece(int r, int c) {
  return r * D + 8 * (c ^ (r & 7));
}

// 16 bytes, zeros where !valid, bypassing L1 (.cg): L1 keeps the mask rows
__device__ __forceinline__ void cp_async_cg(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes, zeros where !valid (cp.async.ca: mask values and bf16 pairs of
// rows that are no whole 16-byte pieces)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

// Four transposed 8x8 bf16 matrices (ldmatrix .trans), one row address per lane
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// 8 bytes, zeros where !valid (bf16 rows of whole 4-value runs)
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0) : "memory");
}

// MMA: cells [s0, s0 + CELLS) of one kv head's bf16 K or V rows (src: the
// head's first row, rows of Dr values) into tile dst by the block's
// threads, V values a copy (8: 16-byte cp.async, 4: 8-byte, 2: 4-byte,
// 1: through registers); cells at or past S and columns at or past Dr
// come as zeros. Not inlined: only head dims that do not fill the
// instance take it, and inlined it cost the served widths registers.
template <int V, int D>
__device__ __noinline__ void copy_rows_mma(__nv_bfloat16* dst, const __nv_bfloat16* src, int s0,
                                           int S, int Dr) {
  constexpr int PER = D / V;  // copies per tile row
  for (int i = threadIdx.x; i < CELLS * PER; i += THREADS) {
    const int cell = i / PER, d = V * (i % PER);
    const bool ok = s0 + cell < S && d < Dr;
    const __nv_bfloat16* from = src + (ok ? (size_t)(s0 + cell) * Dr + d : 0);
    __nv_bfloat16* to = dst + piece<D>(cell, d / 8) + d % 8;
    if constexpr (V == 8) cp_async_cg(to, from, ok);
    else if constexpr (V == 4) cp_async8(to, from, ok);
    else if constexpr (V == 2) cp_async4(to, from, ok);
    else *to = ok ? *from : __float2bfloat16(0.f);
  }
}

// Cells [s0, s0 + CELLS) of one kv head's K or V rows (src: the head's
// first row, rows of Dr values) into tile dst by the block's threads;
// cells at or past S and columns at or past Dr come as zeros. MMA:
// cp.async (committed by the caller) of the widest run a row keeps
// aligned (copy_rows_mma); FMA: plain loads converted to f32.
template <bool MMA, int D, typename KVT>
__device__ __forceinline__ void copy_rows(typename Tile<MMA, D>::E* dst,
                                          const KVT* __restrict__ src, int s0, int S, int Dr) {
  using TL = Tile<MMA, D>;
  if constexpr (MMA) {
    if (Dr % 8 == 0) copy_rows_mma<8, D>(dst, src, s0, S, Dr);
    else if (Dr % 4 == 0) copy_rows_mma<4, D>(dst, src, s0, S, Dr);
    else if (Dr % 2 == 0) copy_rows_mma<2, D>(dst, src, s0, S, Dr);
    else copy_rows_mma<1, D>(dst, src, s0, S, Dr);
  } else {
    for (int i = threadIdx.x; i < CELLS * D; i += THREADS) {
      const int cell = i / D, d = i % D;
      const bool ok = s0 + cell < S && d < Dr;
      dst[cell * TL::LD + d] = ok ? to_f(src[(size_t)(s0 + cell) * Dr + d]) : 0.f;
    }
  }
}

// Cells [s0, s0 + CELLS) of one kv head's K and V rows (kh, vh: the
// head's first rows) into tiles ks, vs. A head dim that fills the
// instance (Dr == D, the served widths) takes one loop over both tensors
// with the row pitch known at compile time; any other goes through
// copy_rows.
template <bool MMA, int D, typename KVT>
__device__ __forceinline__ void copy_kv(typename Tile<MMA, D>::E* ks, typename Tile<MMA, D>::E* vs,
                                        const KVT* __restrict__ kh, const KVT* __restrict__ vh,
                                        int s0, int S, int Dr) {
  using TL = Tile<MMA, D>;
  if (Dr != D) {
    copy_rows<MMA, D, KVT>(ks, kh, s0, S, Dr);
    copy_rows<MMA, D, KVT>(vs, vh, s0, S, Dr);
    return;
  }
  if constexpr (MMA) {
    constexpr int PER = D / 8;  // 16-byte pieces per row
    for (int i = threadIdx.x; i < CELLS * PER; i += THREADS) {
      const int cell = i / PER, p = i % PER;
      const bool ok = s0 + cell < S;
      const size_t src = (size_t)(ok ? s0 + cell : 0) * D + 8 * p;
      cp_async_cg(ks + piece<D>(cell, p), kh + src, ok);
      cp_async_cg(vs + piece<D>(cell, p), vh + src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < CELLS * D; i += THREADS) {
      const int cell = i / D, d = i % D;
      const bool ok = s0 + cell < S;
      ks[cell * TL::LD + d] = ok ? to_f(kh[(size_t)(s0 + cell) * D + d]) : 0.f;
      vs[cell * TL::LD + d] = ok ? to_f(vh[(size_t)(s0 + cell) * D + d]) : 0.f;
    }
  }
}

// MMA route over an int8 cache: cells [s0, s0 + CELLS) of one kv head's
// int8 rows (src: the head's first row, rows of Dr bytes) into raw rows of
// D bytes (dst) by the block's threads, V bytes a copy: 16 (16-byte
// cp.async: rows of whole 16-byte pieces from a 16-byte aligned head), 4
// (4-byte cp.async) or 1 (plain loads, for a head dim no multiple of 4);
// cells at or past S and columns at or past Dr come as zeros. Committed
// by the caller.
template <int V, int D>
__device__ __noinline__ void stage_i8_rows(int8_t* dst, const int8_t* src, int s0, int S,
                                           int Dr) {
  constexpr int PER = D / V;  // copies per raw row
  for (int i = threadIdx.x; i < CELLS * PER; i += THREADS) {
    const int cell = i / PER, d = V * (i % PER);
    const bool ok = s0 + cell < S && d < Dr;
    const int8_t* from = src + (ok ? (size_t)(s0 + cell) * Dr + d : 0);
    int8_t* to = dst + cell * D + d;
    if constexpr (V == 16) cp_async_cg(to, from, ok);
    else if constexpr (V == 4) cp_async4(to, from, ok);
    else *to = ok ? *from : (int8_t)0;
  }
}

// The int8 K and V rows of cells [s0, s0 + CELLS) (kh, vh: the head's
// first rows) into raw rows rk, rv: a head dim that fills the instance
// from 16-byte aligned heads (the served widths) in one loop of 16-byte
// copies over both tensors, any other through stage_i8_rows at the widest
// copy its rows and heads keep aligned.
template <int D>
__device__ __forceinline__ void stage_kv_i8(int8_t* rk, int8_t* rv, const int8_t* kh,
                                            const int8_t* vh, int s0, int S, int Dr) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(kh) | reinterpret_cast<uintptr_t>(vh);
  if (Dr == D && a % 16 == 0) {
    constexpr int PER = D / 16;
    for (int i = threadIdx.x; i < CELLS * PER; i += THREADS) {
      const int cell = i / PER, d = 16 * (i % PER);
      const bool ok = s0 + cell < S;
      const size_t src = (size_t)(ok ? s0 + cell : 0) * D + d;
      cp_async_cg(rk + cell * D + d, kh + src, ok);
      cp_async_cg(rv + cell * D + d, vh + src, ok);
    }
    return;
  }
  if (Dr % 16 == 0 && a % 16 == 0) {
    stage_i8_rows<16, D>(rk, kh, s0, S, Dr);
    stage_i8_rows<16, D>(rv, vh, s0, S, Dr);
  } else if (Dr % 4 == 0 && a % 4 == 0) {
    stage_i8_rows<4, D>(rk, kh, s0, S, Dr);
    stage_i8_rows<4, D>(rv, vh, s0, S, Dr);
  } else {
    stage_i8_rows<1, D>(rk, kh, s0, S, Dr);
    stage_i8_rows<1, D>(rv, vh, s0, S, Dr);
  }
}

// two neighbouring int8 values (bytes sh / 8 and sh / 8 + 1 of w) as a bf16
// pair, low half the first: exact
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, int sh) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)(int8_t)(w >> sh),
                                                 (float)(int8_t)(w >> (sh + 8)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The raw int8 rows of a tile (rows of D bytes) into the MMA route's bf16
// tile (swizzled 16-byte pieces) by the block's threads: 8 values a piece.
template <int D>
__device__ __forceinline__ void convert_i8(__nv_bfloat16* dst, const int8_t* raw) {
  constexpr int PER = D / 8;
  for (int i = threadIdx.x; i < CELLS * PER; i += THREADS) {
    const int cell = i / PER, c = i % PER;
    const uint2 w = *reinterpret_cast<const uint2*>(raw + cell * D + 8 * c);
    const uint4 o = make_uint4(i8_pair(w.x, 0), i8_pair(w.x, 16), i8_pair(w.y, 0),
                               i8_pair(w.y, 16));
    *reinterpret_cast<uint4*>(dst + piece<D>(cell, c)) = o;
  }
}

// This thread's two query rows (h = 0: g, h = 1: g + 8 of the m16 tile).
struct Rows {
  int pos[2];  // query position, -1 past the last row
  int hq[2];   // query head
  float slope[2];

  // rows r0 + g and r0 + g + 8 of the (position, head) row space of kv
  // head h, R = Tq * G rows
  __device__ void init(int r0, int g, int G, int R, int h, const float* __restrict__ slopes) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      pos[i] = r < R ? r / G : -1;
      hq[i] = h * G + (r < R ? r % G : 0);
      slope[i] = slopes && r < R ? slopes[hq[i]] : 0.f;
    }
  }
};

// Does any of this thread's cells c0 + 8 j + 2 tig + c (j < NT) show a
// visible mask value on its rows? mask_b: the batch row's (Tq, S) mask.
template <int NT>
__device__ __forceinline__ bool any_visible(const float* __restrict__ mask_b, int S,
                                            const Rows& rw, int c0, int tig) {
  bool vis = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rw.pos[i] < 0) continue;
    const float* mr = mask_b + (size_t)rw.pos[i] * S;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cell = c0 + 8 * j + 2 * tig + c;
        if (cell < S) vis |= __ldg(mr + cell) > NEG_HALF;
      }
  }
  return vis;
}

// Raw scores -> logits in base 2: scale, K's int8 scale (ksc: the run's
// first cell's, null for a float cache), softcap, then the mask value
// (times the row's ALiBi slope) where visible, all times log2(e); NEG_INF
// where hidden. mr[i]: row i's
// mask values from this run's first cell (shared or global memory), null
// past the last row; n: the run's cells before the cache ends.
template <int NT>
__device__ __forceinline__ void mask_scores(float (&s)[NT][4], const float* const (&mr)[2],
                                            const float* ksc, int n, const Rows& rw, int tig,
                                            float scale, float softcap, bool alibi) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, cell = 8 * j + 2 * tig + (e & 1);
      const float mk = mr[i] && cell < n ? mr[i][cell] : NEG_INF;
      float v = s[j][e] * scale;
      if (ksc && cell < n) v *= ksc[cell];
      if (softcap > 0.f) v = softcap * tanhf(v / softcap);
      s[j][e] = mk > NEG_HALF ? (v + (alibi ? mk * rw.slope[i] : mk)) * LOG2E : NEG_INF;
    }
}

// Online softmax over one run of cells: updates the row max m and this
// thread's partial row sum l, turns s into probabilities (0 where hidden)
// and returns the factor alpha by which earlier outputs are rescaled.
template <int NT>
__device__ __forceinline__ void softmax_run(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = s[j][2 * i + c];
        v = v > NEG_HALF ? exp2f(v - m_new) : 0.f;
        sum += v;
      }
    l[i] = l[i] * alpha[i] + sum;
  }
}

// int8 cache: V's scales into the probabilities of this run (vsc: the
// run's first cell's scale, n: its cells before the cache ends), after
// softmax_run's row sums took them unscaled
template <int NT>
__device__ __forceinline__ void scale_probs(float (&p)[NT][4], const float* vsc, int n,
                                            int tig) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cell = 8 * j + 2 * tig + (e & 1);
      if (cell < n) p[j][e] *= vsc[cell];
    }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 8][4], const float (&alpha)[2]) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e >> 1];
}

// values d and d + 1 (d even) of a bf16 row of Dr values as one register
// (low half d), zeros past Dr or for a null row; one 4-byte load where the
// row keeps pairs aligned (Dr even)
__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* row, int d, int Dr) {
  if (!row || d >= Dr) return 0u;
  if ((Dr & 1) == 0) return *reinterpret_cast<const uint32_t*>(row + d);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
  return (uint32_t)h[d] | (d + 1 < Dr ? (uint32_t)h[d + 1] << 16 : 0u);
}

// bf16 A fragments of this thread's two rows of q (row pointers, null past
// the last row), for the MMA route's S = Q K^T.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 16][4],
                                             const __nv_bfloat16* q0, const __nv_bfloat16* q1,
                                             int tig, int Dr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int d = 16 * ks + 8 * kh + 2 * tig;
      qa[ks][2 * kh] = bf16_pair(q0, d, Dr);
      qa[ks][2 * kh + 1] = bf16_pair(q1, d, Dr);
    }
}

// The A fragments of a warp's 16 rows of q at k-step kk from a bf16 tile
// of rows of D values (piece-swizzled like K; qw: the warp's first row):
// matrix i of the ldmatrix is rows 8 (i % 2) .. + 7, k half i / 2, the
// register order of load_q_frags.
template <int D>
__device__ __forceinline__ void q_frag_smem(uint32_t (&a)[4], const __nv_bfloat16* qw, int kk,
                                            int lane) {
  ldsm_x4(a, qw + piece<D>((lane & 7) + 8 * ((lane >> 3) & 1), 2 * kk + (lane >> 4)));
}

// MMA: s = Q K^T over cells c0 .. c0 + 8 NT - 1 (c0 % 16 == 0) of tile ks;
// afrag(kk, a) fills the A fragments of q at k-step kk (from registers,
// load_q_frags, or shared memory, q_frag_smem)
template <int D, int NT, class AFrag>
__device__ __forceinline__ void qk_mma(float (&s)[NT][4], AFrag afrag,
                                       const __nv_bfloat16* ks, int c0, int lane) {
  const int i = lane >> 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // matrix i of a pair: n8 tile 2 jp + i / 2, k half i % 2
  const int r = c0 + 8 * (i >> 1) + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    afrag(kk, a);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, ks + piece<D>(r + 16 * jp, 2 * kk + (i & 1)));
      mma_bf16(s[2 * jp], a, b[0], b[1]);
      mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// MMA: o += P V over cells c0 .. c0 + 8 NT - 1 of tile vs, P (the
// probabilities in s) split into bf16 hi + lo: for each 16 cells and output
// group, hi then lo, always in that order.
template <int D, int NT>
__device__ __forceinline__ void pv_mma(float (&o)[D / 8][4], const float (&p)[NT][4],
                                       const __nv_bfloat16* vs, int c0, int lane) {
  const int i = lane >> 3;
  // matrix i of a pair: k half i % 2, output group 2 dp + i / 2
  const int r = c0 + 8 * (i & 1) + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t ah[4], al[4];
    split2(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
    split2(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
    split2(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
    split2(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + piece<D>(r + 16 * kk, 2 * dp + (i >> 1)));
      mma_bf16(o[2 * dp], ah, b[0], b[1]);
      mma_bf16(o[2 * dp], al, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], ah, b[2], b[3]);
      mma_bf16(o[2 * dp + 1], al, b[2], b[3]);
    }
  }
}

// FMA: s = Q K^T in the mma layout; qs: this warp's 16 f32 q rows (D + 4 apart)
template <int D, int NT>
__device__ __forceinline__ void qk_fma(float (&s)[NT][4], const float* qs, const float* ks,
                                       int c0, int g, int tig) {
  constexpr int LD = Tile<false, D>::LD;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const float* q0 = qs + g * LD;
  const float* q1 = qs + (g + 8) * LD;
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
    const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(ks + (c0 + 8 * j + 2 * tig + c) * LD + d);
        float& s0 = s[j][c];
        float& s1 = s[j][2 + c];
        s0 = fmaf(a0.x, b.x, s0); s0 = fmaf(a0.y, b.y, s0);
        s0 = fmaf(a0.z, b.z, s0); s0 = fmaf(a0.w, b.w, s0);
        s1 = fmaf(a1.x, b.x, s1); s1 = fmaf(a1.y, b.y, s1);
        s1 = fmaf(a1.z, b.z, s1); s1 = fmaf(a1.w, b.w, s1);
      }
  }
}

// FMA: o += P V; ps: this warp's (16 x 8 NT + 4) f32 buffer for P
template <int D, int NT>
__device__ __forceinline__ void pv_fma(float (&o)[D / 8][4], const float (&p)[NT][4], float* ps,
                                       const float* vs, int c0, int g, int tig) {
  constexpr int LD = Tile<false, D>::LD;
  constexpr int PLD = 8 * NT + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(ps + g * PLD + 8 * j + 2 * tig, p[j][0], p[j][1]);
    store2(ps + (g + 8) * PLD + 8 * j + 2 * tig, p[j][2], p[j][3]);
  }
  __syncwarp();
  for (int cell = 0; cell < 8 * NT; ++cell) {
    const float p0 = ps[g * PLD + cell], p1 = ps[(g + 8) * PLD + cell];
    const float* vr = vs + (c0 + cell) * LD + 2 * tig;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float2 v = *reinterpret_cast<const float2*>(vr + 8 * dn);
      o[dn][0] = fmaf(p0, v.x, o[dn][0]);
      o[dn][1] = fmaf(p0, v.y, o[dn][1]);
      o[dn][2] = fmaf(p1, v.x, o[dn][2]);
      o[dn][3] = fmaf(p1, v.y, o[dn][3]);
    }
  }
  __syncwarp();
}

// Finish a row (m in base 2): the sink logit (if any) joins the
// normalisation; rows whose mask hid every key (l = 0, no sink) come out as
// zeros. Returns the factor for the row's outputs.
__device__ __forceinline__ float finish_row(float m, float l, const float* __restrict__ sinks,
                                            int hq) {
  float corr = 1.f;
  if (sinks) {
    const float sk = sinks[hq] * LOG2E;
    const float mf = fmaxf(m, sk);
    corr = exp2f(m - mf);
    l = l * corr + exp2f(sk - mf);
  }
  return corr / fmaxf(l, 1e-30f);
}

}  // namespace tpl_attn
