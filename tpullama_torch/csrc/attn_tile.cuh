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
// Scale, logit softcap, mask, ALiBi and the online softmax stay in
// registers (quad shuffles for the row max; each thread keeps a partial
// row sum, reduced once at the end). The softmax runs in base 2: logits are
// scaled by log2(e) once, so each probability is one exp2f; row maxima
// (m) are kept in that base.

#pragma once

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

// two neighbouring outputs
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// Four transposed 8x8 bf16 matrices (ldmatrix .trans), one row address per lane
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Cells [s0, s0 + CELLS) of one kv head's K and V rows (kh, vh: the head's
// first row) into tiles ks, vs by the block's threads; cells at or past S
// come as zeros. MMA: 16-byte cp.async (committed by the caller); FMA:
// plain loads converted to f32.
template <bool MMA, int D, typename KVT>
__device__ __forceinline__ void copy_kv(typename Tile<MMA, D>::E* ks, typename Tile<MMA, D>::E* vs,
                                        const KVT* __restrict__ kh, const KVT* __restrict__ vh,
                                        int s0, int S) {
  using TL = Tile<MMA, D>;
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

// Raw scores -> logits in base 2: scale, softcap, then the mask value
// (times the row's ALiBi slope) where visible, all times log2(e); NEG_INF
// where hidden. mr[i]: row i's
// mask values from this run's first cell (shared or global memory), null
// past the last row; n: the run's cells before the cache ends.
template <int NT>
__device__ __forceinline__ void mask_scores(float (&s)[NT][4], const float* const (&mr)[2],
                                            int n, const Rows& rw, int tig, float scale,
                                            float softcap, bool alibi) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, cell = 8 * j + 2 * tig + (e & 1);
      const float mk = mr[i] && cell < n ? mr[i][cell] : NEG_INF;
      float v = s[j][e] * scale;
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

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 8][4], const float (&alpha)[2]) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e >> 1];
}

// bf16 A fragments of this thread's two rows of q (row pointers, null past
// the last row), for the MMA route's S = Q K^T.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 16][4],
                                             const __nv_bfloat16* q0, const __nv_bfloat16* q1,
                                             int tig) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int d = 16 * ks + 8 * kh + 2 * tig;
      qa[ks][2 * kh] = q0 ? *reinterpret_cast<const uint32_t*>(q0 + d) : 0u;
      qa[ks][2 * kh + 1] = q1 ? *reinterpret_cast<const uint32_t*>(q1 + d) : 0u;
    }
}

// MMA: s = Q K^T over cells c0 .. c0 + 8 NT - 1 (c0 % 16 == 0) of tile ks
template <int D, int NT>
__device__ __forceinline__ void qk_mma(float (&s)[NT][4], const uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* ks, int c0, int lane) {
  const int i = lane >> 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // matrix i of a pair: n8 tile 2 jp + i / 2, k half i % 2
  const int r = c0 + 8 * (i >> 1) + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, ks + piece<D>(r + 16 * jp, 2 * kk + (i & 1)));
      mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
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
