// Dequantization helpers of the planar qmm kernels: load_f and to_f (every
// body), and decode_raw with decode_vals (the tensor-core tile body
// qmm_mma.cuh, and through it qmm_ktiled.cu and qmm_gathered.cu). The
// decode body (qmm_gemv.cuh: qmm_gemv, qmm_ktiled at T <= 8,
// fused_postattn and one-row qmm_gathered tiles) and one-row
// qmm_gathered_t tiles take the field sets below but unpack their own way.
//
// The planes are tpullama/ops/qweights.py's: "global stripe" nibble/crumb
// planes in group-transposed stored order plus per-group scale (and min)
// planes, f32 or bf16. In stripe order a stored position p of a row holds
// natural element (p % G) * g + p / G (G = K / g); in fourblock order
// (the ChatGLM path's attn_output and ffn_up) another element, but in both its scale/min sit at
// column p % G, so these helpers serve both orders.
// Every weight is q * scale - minv in f32 with two roundings and no
// contraction, the plain versions' arithmetic, so a kernel's weights equal
// its plain version's bit for bit.
//
// Field sets (Planes below: a low plane, an optional high plane; value =
// low | high << bits of the low plane):
//   KIND_Q4: {q4, scale, minv}      g=32  (Q4_0, Q4_1, Q4_K)
//   KIND_Q6: {q4, q2, scale, minv}  g=16  (Q6_K: value = q4 | q2 << 4)
//   KIND_Q8: {q8, scale}            g=32  (Q8_0, signed bytes)
//   KIND_Q5: {q4, q1, scale, minv}  g=32  (Q5_0, Q5_1, Q5_K: q4 | q1 << 4)
//   KIND_Q3: {q2, q1, scale, minv}  g=16  (Q3_K: q2 | q1 << 2)
//   KIND_Q2: {q2, scale, minv}      g=16  (Q2_K)
//   KIND_MXFP4: {q4_lut, scale}     g=32  (MXFP4: value = LUT[idx], the
//                                          e2m1 table, laid out as Q4)
//   KIND_MXFP4_AR: {q4a, q1r, scale} g=32 (MXFP4 re-coded by
//                                          qweights.mxfp4_to_ar: value =
//                                          2 (a - 8) + r, laid out as Q5)
// The MXFP4 sets have no min plane: a weight is value * scale, one
// rounding, as Q8_0's. Every body takes every set: the tile body of
// qmm_mma.cuh through decode_vals, the decode body and the group body their
// own way.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpl {

constexpr int KIND_Q4 = 0;
constexpr int KIND_Q6 = 1;
constexpr int KIND_Q8 = 2;
constexpr int KIND_Q5 = 3;
constexpr int KIND_Q3 = 4;
constexpr int KIND_Q2 = 5;
constexpr int KIND_MXFP4 = 6;
constexpr int KIND_MXFP4_AR = 7;

// The set whose planes and byte geometry a set shares (every address a
// body computes follows it): MXFP4's LUT set is laid out as Q4's {q4}, its
// A/r set as Q5's {q4, q1}. Only how a value is made differs.
template <int KIND>
__host__ __device__ constexpr int layout_of() {
  return KIND == KIND_MXFP4 ? KIND_Q4 : KIND == KIND_MXFP4_AR ? KIND_Q5 : KIND;
}

// Whether a set has a min plane (q * scale - minv); Q8_0 and MXFP4's sets
// have none (q * scale).
template <int KIND>
__host__ __device__ constexpr bool has_min() {
  return KIND != KIND_Q8 && KIND != KIND_MXFP4 && KIND != KIND_MXFP4_AR;
}

// Four e2m1 indices (one per byte, each 0..15) -> 12 + their values
// LUT[idx] (0..24, one per byte; the table of tpullama/ops/pallas/qmm.py
// :45-47,77-83): the magnitudes {0, 1, 2, 3, 4, 6, 8, 12} by a byte permute
// over idx & 7, the positive (12 + mag) or negative (12 - mag) table
// picked by bit 3.
__device__ __forceinline__ uint32_t mxfp4_biased(uint32_t idx) {
  const uint32_t s = idx & 0x07070707u;
  uint32_t sel = s | (s >> 4);
  sel = (sel & 0xFFu) | ((sel >> 8) & 0xFF00u);  // byte i's index in nibble i
  const uint32_t pos = __byte_perm(0x0F0E0D0Cu, 0x18141210u, sel);  // 12 + {0,1,2,3,4,6,8,12}
  const uint32_t neg = __byte_perm(0x090A0B0Cu, 0x00040608u, sel);  // 12 - the same
  const uint32_t m = ((idx >> 3) & 0x01010101u) * 0xFFu;
  return (pos & ~m) | (neg & m);
}

// A set's planes. Stored position p = a*G + c of a row (element a of
// scale column c, G = K/g) sits in byte (a % JL)*G + c of the low plane,
// field a / JL (BL bits each), and in byte (a % JH)*G + c of the high
// plane, field a / JH (BH bits each): qweights._stripe_pack's global
// stripes. A plane's rows are K * bits / 8 bytes.
template <int KIND>
struct Planes {
  static constexpr int L = layout_of<KIND>();
  static constexpr int GROUP = L == KIND_Q6 || L == KIND_Q3 || L == KIND_Q2 ? 16 : 32;
  static constexpr int BL = L == KIND_Q8 ? 8 : L == KIND_Q3 || L == KIND_Q2 ? 2 : 4;
  static constexpr int BH = L == KIND_Q6 ? 2 : L == KIND_Q5 || L == KIND_Q3 ? 1 : 0;
  static constexpr int JL = GROUP * BL / 8;  // low-plane byte runs per scale column
  static constexpr int JH = GROUP * BH / 8;  // high-plane byte runs
  static_assert(JL % (JH ? JH : 1) == 0, "a high byte run serves whole low runs");
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// N contiguous elements of T starting at a 16-byte (or, for 8-byte
// totals, 8-byte) aligned address -> f32.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  static_assert(BYTES % 8 == 0, "vector load width");
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) out[i * PER + j] = to_f(e[j]);
    }
  } else {
    constexpr int PER = 8 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i) {
      uint2 u = reinterpret_cast<const uint2*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) out[i * PER + j] = to_f(e[j]);
    }
  }
}

__device__ __forceinline__ float deq(float q, float s, float m) {
  // two roundings, no contraction: the same arithmetic as the plain
  // version (q * scale, then - minv)
  return __fsub_rn(__fmul_rn(q, s), m);
}

// A chunk is 32 stored positions of a row: NSEG segments of SEG positions
// each, segment j of chunk c starting at seg_start(c, j). The g = 32 sets
// with a q4 low plane (Q4, Q5) take 2 segments, byte t of the chunk's q4
// run holding segment 0's offset t (low nibble) and segment 1's (high);
// the g = 16 sets (Q6, Q3, Q2) take 4, the field or crumb j of a byte
// holding segment j's. Each segment's scale (and min) columns are the same
// SEG consecutive columns (mod G).
template <int KIND>
struct Geo {
  // quant group size, x segments per 32-position chunk, segment length
  static constexpr int L = layout_of<KIND>();
  static constexpr int GROUP = Planes<KIND>::GROUP;
  static constexpr int NSEG = L == KIND_Q8 ? 1 : GROUP == 32 ? 2 : 4;
  static constexpr int SEG = 32 / NSEG;
  // stored position of segment j of chunk c
  __device__ __forceinline__ static int seg_start(int c, int j, int K) {
    return j * (K / NSEG) + SEG * c;
  }
  // the shift of chunk c's fields in the q1 plane (Q5 and MXFP4's A/r:
  // chunk c's segment j sits in bit 4 j + hs of its bytes; Q3: segment j
  // in bit 2 j + hs), for K % 256; 0 for the other sets
  __device__ __forceinline__ static int high_shift(int c, int K) {
    if constexpr (L == KIND_Q5) return 128 * c / K;
    else if constexpr (L == KIND_Q3) return 64 * c / K;
    else return 0;
  }
  // byte offset in a q1 row of chunk c's run of SEG bytes (K % 256)
  __device__ __forceinline__ static int high_byte(int c, int K) { return SEG * c % (K / 8); }
};

// Dequantize one chunk (32 stored positions) from its packed bytes and its
// SEG scale (and min) values s, m into w, in chunk-local order u = segment
// * SEG + offset. q: Q4 and Q5 the chunk's 16 q4 bytes; Q6 its 8 bytes of
// the low q4 half (q), of the high half (qh) and of the q2 plane (q2); Q3
// and Q2 its 8 q2 bytes; Q8 its 32 q8 bytes. Q5 and Q3 also take the
// chunk's SEG q1 bytes (qh) and their shift hs (Geo::high_shift). MXFP4's
// sets as Q4 and Q5 (the LUT set its 16 q4_lut bytes; the A/r set its 16
// q4a bytes and SEG q1r bytes), each weight value * scale. Reads global or
// shared memory alike.
template <int KIND>
__device__ __forceinline__ void decode_vals(const uint8_t* __restrict__ q,
                                            const uint8_t* __restrict__ qh,
                                            const uint8_t* __restrict__ q2,
                                            const float (&s)[Geo<KIND>::SEG],
                                            const float (&m)[Geo<KIND>::SEG], float (&w)[32],
                                            int hs = 0) {
  if constexpr (KIND == KIND_MXFP4) {
    uint4 qv = *reinterpret_cast<const uint4*>(q);
    const uint32_t words[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = mxfp4_biased(words[i] & 0x0F0F0F0Fu);
      const uint32_t hi = mxfp4_biased((words[i] >> 4) & 0x0F0F0F0Fu);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int t = 4 * i + b;
        w[t] = __fmul_rn((float)((int)((lo >> (8 * b)) & 0xFFu) - 12), s[t]);
        w[16 + t] = __fmul_rn((float)((int)((hi >> (8 * b)) & 0xFFu) - 12), s[t]);
      }
    }
  } else if constexpr (KIND == KIND_MXFP4_AR) {
    uint4 qv = *reinterpret_cast<const uint4*>(q);
    uint4 hv = *reinterpret_cast<const uint4*>(qh);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&qv);
    const uint8_t* h = reinterpret_cast<const uint8_t*>(&hv);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int hb = h[t] >> hs;
      w[t] = __fmul_rn((float)(2 * ((b[t] & 15) - 8) + (hb & 1)), s[t]);
      w[16 + t] = __fmul_rn((float)(2 * ((b[t] >> 4) - 8) + ((hb >> 4) & 1)), s[t]);
    }
  } else if constexpr (KIND == KIND_Q5) {
    uint4 qv = *reinterpret_cast<const uint4*>(q);
    uint4 hv = *reinterpret_cast<const uint4*>(qh);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&qv);
    const uint8_t* h = reinterpret_cast<const uint8_t*>(&hv);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int hb = h[t] >> hs;
      w[t] = deq((float)((b[t] & 15) | ((hb & 1) << 4)), s[t], m[t]);
      w[16 + t] = deq((float)((b[t] >> 4) | (((hb >> 4) & 1) << 4)), s[t], m[t]);
    }
  } else if constexpr (KIND == KIND_Q3 || KIND == KIND_Q2) {
    uint2 av = *reinterpret_cast<const uint2*>(q);
    const uint8_t* A = reinterpret_cast<const uint8_t*>(&av);
    uint2 hv = make_uint2(0u, 0u);
    if constexpr (KIND == KIND_Q3) hv = *reinterpret_cast<const uint2*>(qh);
    const uint8_t* H = reinterpret_cast<const uint8_t*>(&hv);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int hb = H[t] >> hs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int v = (A[t] >> (2 * j)) & 3;
        if constexpr (KIND == KIND_Q3) v |= ((hb >> (2 * j)) & 1) << 2;
        w[8 * j + t] = deq((float)v, s[t], m[t]);
      }
    }
  } else if constexpr (KIND == KIND_Q4) {
    uint4 qv = *reinterpret_cast<const uint4*>(q);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&qv);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      w[t] = deq((float)(b[t] & 15), s[t], m[t]);
      w[16 + t] = deq((float)(b[t] >> 4), s[t], m[t]);
    }
  } else if constexpr (KIND == KIND_Q6) {
    uint2 av = *reinterpret_cast<const uint2*>(q);
    uint2 bv = *reinterpret_cast<const uint2*>(qh);
    uint2 hv = *reinterpret_cast<const uint2*>(q2);
    const uint8_t* A = reinterpret_cast<const uint8_t*>(&av);
    const uint8_t* B = reinterpret_cast<const uint8_t*>(&bv);
    const uint8_t* H = reinterpret_cast<const uint8_t*>(&hv);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int h = H[t];
      w[t] = deq((float)((A[t] & 15) | ((h & 3) << 4)), s[t], m[t]);
      w[8 + t] = deq((float)((B[t] & 15) | (((h >> 2) & 3) << 4)), s[t], m[t]);
      w[16 + t] = deq((float)((A[t] >> 4) | (((h >> 4) & 3) << 4)), s[t], m[t]);
      w[24 + t] = deq((float)((B[t] >> 4) | (((h >> 6) & 3) << 4)), s[t], m[t]);
    }
  } else {
    const uint4* qv = reinterpret_cast<const uint4*>(q);
    uint4 q0 = qv[0], q1 = qv[1];
    const int8_t* b0 = reinterpret_cast<const int8_t*>(&q0);
    const int8_t* b1 = reinterpret_cast<const int8_t*>(&q1);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      w[t] = __fmul_rn((float)b0[t], s[t]);
      w[16 + t] = __fmul_rn((float)b1[t], s[16 + t]);
    }
  }
}

// decode_vals with the chunk's SEG consecutive scale (and min) values read
// from sp, mp (16-byte aligned; mp unused for the sets without a min plane)
template <int KIND, typename ST>
__device__ __forceinline__ void decode_raw(const uint8_t* __restrict__ q,
                                           const uint8_t* __restrict__ qh,
                                           const uint8_t* __restrict__ q2,
                                           const ST* __restrict__ sp,
                                           const ST* __restrict__ mp, float (&w)[32],
                                           int hs = 0) {
  constexpr int SEG = Geo<KIND>::SEG;
  float s[SEG], m[SEG];
  load_f<ST, SEG>(sp, s);
  if constexpr (has_min<KIND>()) load_f<ST, SEG>(mp, m);
  decode_vals<KIND>(q, qh, q2, s, m, w, hs);
}

}  // namespace tpl
