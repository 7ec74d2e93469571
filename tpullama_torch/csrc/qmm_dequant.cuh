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
// Field sets:
//   KIND_Q4: {q4, scale, minv}      g=32  (Q4_0, Q4_1, Q4_K)
//   KIND_Q6: {q4, q2, scale, minv}  g=16  (Q6_K: value = q4 | q2 << 4)
//   KIND_Q8: {q8, scale}            g=32  (Q8_0, signed bytes)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpl {

constexpr int KIND_Q4 = 0;
constexpr int KIND_Q6 = 1;
constexpr int KIND_Q8 = 2;

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

template <int KIND>
struct Geo {
  // quant group size, x segments per 32-position chunk, segment length
  static constexpr int GROUP = KIND == KIND_Q6 ? 16 : 32;
  static constexpr int NSEG = KIND == KIND_Q4 ? 2 : (KIND == KIND_Q6 ? 4 : 1);
  static constexpr int SEG = 32 / NSEG;
  // stored position of segment j of chunk c
  __device__ __forceinline__ static int seg_start(int c, int j, int K) {
    if constexpr (KIND == KIND_Q4) return j * (K / 2) + 16 * c;
    else if constexpr (KIND == KIND_Q6) return j * (K / 4) + 8 * c;
    else return 32 * c;
  }
};

// Dequantize one chunk (32 stored positions) from its packed bytes and its
// SEG scale (and min) values s, m into w, in chunk-local order u = segment
// * SEG + offset. q: Q4 the chunk's 16 q4 bytes; Q6 its 8 bytes of the low
// q4 half (q), of the high half (qh) and of the q2 plane (q2); Q8 its 32
// q8 bytes. Reads global or shared memory alike.
template <int KIND>
__device__ __forceinline__ void decode_vals(const uint8_t* __restrict__ q,
                                            const uint8_t* __restrict__ qh,
                                            const uint8_t* __restrict__ q2,
                                            const float (&s)[Geo<KIND>::SEG],
                                            const float (&m)[Geo<KIND>::SEG], float (&w)[32]) {
  if constexpr (KIND == KIND_Q4) {
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
// from sp, mp (16-byte aligned; mp unused for Q8)
template <int KIND, typename ST>
__device__ __forceinline__ void decode_raw(const uint8_t* __restrict__ q,
                                           const uint8_t* __restrict__ qh,
                                           const uint8_t* __restrict__ q2,
                                           const ST* __restrict__ sp,
                                           const ST* __restrict__ mp, float (&w)[32]) {
  constexpr int SEG = Geo<KIND>::SEG;
  float s[SEG], m[SEG];
  load_f<ST, SEG>(sp, s);
  if constexpr (KIND != KIND_Q8) load_f<ST, SEG>(mp, m);
  decode_vals<KIND>(q, qh, q2, s, m, w);
}

}  // namespace tpl
