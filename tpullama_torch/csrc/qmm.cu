// Fused dequantize x matmul over planar packed weights, y = x @ W^T.
//
// Replaces the Pallas kernel `kernel` of quantized_matmul
// (tpullama/ops/pallas/qmm.py:296, launched by _call_qmm_kernel :848).
// W stays packed in device memory exactly as tpullama/ops/qweights.py
// stores it: "global stripe" nibble/crumb planes in group-transposed order
// plus per-group scale (and min) planes, f32 or bf16. A stored position p
// of a row holds natural element (p % G) * g + p / G (G = K / g), and its
// scale/min sit at column p % G of the scale planes. The wrapper
// (tpullama_torch/ops/cuda/qmm.py) permutes x into that stored order, so
// the kernel contracts stored positions with stored positions.
//
// Every weight is dequantized in registers as q * scale - minv in f32
// (the reference's exact mode) and accumulated in f32.
//
// What bounds it on an H100:
//   - decode (T <= 8): bytes. One decode step reads every packed weight
//     once (~0.6 B/weight for Q4_K with bf16 scales) and does 2*T flops
//     per weight, far below the card's 295 flop/byte ridge. qmm_gemv gives
//     each warp whole packed rows and streams them with 16-byte loads, so
//     the weight planes are read once and nothing else of size is.
//   - prefill (T > 8): operations. qmm_tiled dequantizes a 64-row x
//     32-position slab of W into shared memory once per 64 activation
//     rows and runs a plain f32 FMA tile product (4x4 per thread); it is
//     far from the tensor-core rate (no mma/wgmma yet), which is the known
//     gap this first version leaves for a later change.
//
// Field sets covered (the wrapper raises on the rest):
//   KIND_Q4: {q4, scale, minv}      g=32  (Q4_0, Q4_1, Q4_K)
//   KIND_Q6: {q4, q2, scale, minv}  g=16  (Q6_K: value = q4 | q2 << 4)
//   KIND_Q8: {q8, scale}            g=32  (Q8_0, signed bytes)

#include "qmm_dequant.cuh"

namespace {

using namespace tpl;

// Decode T <= 8: one warp per output row (warp_row_dot).
template <int KIND, typename XT, typename ST, int TT>
__global__ void __launch_bounds__(128) qmm_gemv_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ qa,
    const uint8_t* __restrict__ qb, const ST* __restrict__ scale,
    const ST* __restrict__ minv, float* __restrict__ y, int T, int N, int K) {
  const int n = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (n >= N) return;
  warp_row_dot<KIND, XT, ST, TT>(x, qa, qb, scale, minv, n, T, K, y + n, N,
                                 threadIdx.x & 31);
}

// One loader thread's share of a chunk: 8 dequantized weights of row n
// and their chunk-local positions u.
template <int KIND, typename ST>
__device__ __forceinline__ void decode_quarter(const uint8_t* __restrict__ qa,
                                               const uint8_t* __restrict__ qb,
                                               const ST* __restrict__ srow,
                                               const ST* __restrict__ mrow, int n,
                                               int c, int qq, int K, float (&w)[8],
                                               int (&u)[8]) {
  constexpr int GROUP = Geo<KIND>::GROUP;
  const int G = K / GROUP;
  if constexpr (KIND == KIND_Q4) {
    const uint32_t qv = *reinterpret_cast<const uint32_t*>(qa + (size_t)n * (K / 2) + 16 * c + 4 * qq);
    const int s0 = (16 * c) % G + 4 * qq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = (qv >> (8 * e)) & 0xff;
      const float s = to_f(srow[s0 + e]);
      const float m = to_f(mrow[s0 + e]);
      w[e] = deq((float)(b & 15), s, m);
      u[e] = 4 * qq + e;
      w[4 + e] = deq((float)(b >> 4), s, m);
      u[4 + e] = 16 + 4 * qq + e;
    }
  } else if constexpr (KIND == KIND_Q6) {
    const uint8_t* row4 = qa + (size_t)n * (K / 2);
    const uint8_t* row2 = qb + (size_t)n * (K / 4);
    const int s0 = (8 * c) % G + 2 * qq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * qq + e;
      const int A = row4[8 * c + t];
      const int B = row4[K / 4 + 8 * c + t];
      const int h = row2[8 * c + t];
      const float s = to_f(srow[s0 + e]);
      const float m = to_f(mrow[s0 + e]);
      w[e] = deq((float)((A & 15) | ((h & 3) << 4)), s, m);
      u[e] = t;
      w[2 + e] = deq((float)((B & 15) | (((h >> 2) & 3) << 4)), s, m);
      u[2 + e] = 8 + t;
      w[4 + e] = deq((float)((A >> 4) | (((h >> 4) & 3) << 4)), s, m);
      u[4 + e] = 16 + t;
      w[6 + e] = deq((float)((B >> 4) | (((h >> 6) & 3) << 4)), s, m);
      u[6 + e] = 24 + t;
    }
  } else {
    const uint2 qv = *reinterpret_cast<const uint2*>(qa + (size_t)n * K + 32 * c + 8 * qq);
    const int8_t* b = reinterpret_cast<const int8_t*>(&qv);
    const int s0 = (32 * c) % G + 8 * qq;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w[e] = __fmul_rn((float)b[e], to_f(srow[s0 + e]));
      u[e] = 8 * qq + e;
    }
  }
}

constexpr int TB = 64;   // tile rows of T and of N
constexpr int TPAD = 4;  // keeps float4 alignment of shared rows

// Prefill T > 8: 64 x 64 output tile per block, 256 threads, 4 x 4 per
// thread, one 32-position chunk of K per step.
template <int KIND, typename XT, typename ST>
__global__ void __launch_bounds__(256) qmm_tiled_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ qa,
    const uint8_t* __restrict__ qb, const ST* __restrict__ scale,
    const ST* __restrict__ minv, float* __restrict__ y, int T, int N, int K) {
  using GE = Geo<KIND>;
  __shared__ __align__(16) float Ws[32][TB + TPAD];
  __shared__ __align__(16) float Xs[32][TB + TPAD];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TB;
  const int t0 = blockIdx.y * TB;
  const int tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 2, lq = tid & 3;  // loader row / quarter
  const int G = K / GE::GROUP;
  const int wn = n0 + lr;
  const int xt = t0 + lr;
  const ST* srow = scale + (size_t)(wn < N ? wn : 0) * G;
  const ST* mrow = KIND == KIND_Q8 ? nullptr : minv + (size_t)(wn < N ? wn : 0) * G;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_chunks = K / 32;
  for (int c = 0; c < n_chunks; ++c) {
    {
      float w[8];
      int u[8];
      if (wn < N) {
        decode_quarter<KIND, ST>(qa, qb, srow, mrow, wn, c, lq, K, w, u);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          w[e] = 0.f;
          u[e] = 8 * lq + e;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) Ws[u[e]][lr] = w[e];
    }
    {
      const int u0 = 8 * lq;
      float xv[8];
      if (xt < T) {
        const int j = u0 / GE::SEG;
        const int pos = GE::seg_start(c, j, K) + (u0 % GE::SEG);
        load_f<XT, 8>(x + (size_t)xt * K + pos, xv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) Xs[u0 + e][lr] = xv[e];
    }
    __syncthreads();
#pragma unroll 8
    for (int u = 0; u < 32; ++u) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[u][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ws[u][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(size_t)t * N + n] = acc[i][j];
    }
  }
}

template <int KIND, typename XT, typename ST>
void launch_gemv(const void* x, const void* qa, const void* qb, const void* s,
                 const void* m, float* y, int T, int N, int K, cudaStream_t st) {
  dim3 grid((N + 3) / 4), block(128);
  auto xp = static_cast<const XT*>(x);
  auto ap = static_cast<const uint8_t*>(qa);
  auto bp = static_cast<const uint8_t*>(qb);
  auto sp = static_cast<const ST*>(s);
  auto mp = static_cast<const ST*>(m);
  if (T <= 1) qmm_gemv_kernel<KIND, XT, ST, 1><<<grid, block, 0, st>>>(xp, ap, bp, sp, mp, y, T, N, K);
  else if (T <= 2) qmm_gemv_kernel<KIND, XT, ST, 2><<<grid, block, 0, st>>>(xp, ap, bp, sp, mp, y, T, N, K);
  else if (T <= 4) qmm_gemv_kernel<KIND, XT, ST, 4><<<grid, block, 0, st>>>(xp, ap, bp, sp, mp, y, T, N, K);
  else qmm_gemv_kernel<KIND, XT, ST, 8><<<grid, block, 0, st>>>(xp, ap, bp, sp, mp, y, T, N, K);
}

template <int KIND, typename XT, typename ST>
void launch_tiled(const void* x, const void* qa, const void* qb, const void* s,
                  const void* m, float* y, int T, int N, int K, cudaStream_t st) {
  dim3 grid((N + TB - 1) / TB, (T + TB - 1) / TB), block(256);
  qmm_tiled_kernel<KIND, XT, ST><<<grid, block, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(qa),
      static_cast<const uint8_t*>(qb), static_cast<const ST*>(s),
      static_cast<const ST*>(m), y, T, N, K);
}

using LaunchFn = void (*)(const void*, const void*, const void*, const void*,
                          const void*, float*, int, int, int, cudaStream_t);

template <bool TILED, int KIND>
LaunchFn pick_dtypes(int x_bf16, int s_bf16) {
  using bf = __nv_bfloat16;
  if (TILED) {
    if (x_bf16) return s_bf16 ? launch_tiled<KIND, bf, bf> : launch_tiled<KIND, bf, float>;
    return s_bf16 ? launch_tiled<KIND, float, bf> : launch_tiled<KIND, float, float>;
  }
  if (x_bf16) return s_bf16 ? launch_gemv<KIND, bf, bf> : launch_gemv<KIND, bf, float>;
  return s_bf16 ? launch_gemv<KIND, float, bf> : launch_gemv<KIND, float, float>;
}

template <bool TILED>
int run(int kind, int x_bf16, int s_bf16, const void* x, const void* qa,
        const void* qb, const void* s, const void* m, float* y, int T, int N,
        int K, void* stream) {
  LaunchFn fn;
  if (kind == KIND_Q4) fn = pick_dtypes<TILED, KIND_Q4>(x_bf16, s_bf16);
  else if (kind == KIND_Q6) fn = pick_dtypes<TILED, KIND_Q6>(x_bf16, s_bf16);
  else if (kind == KIND_Q8) fn = pick_dtypes<TILED, KIND_Q8>(x_bf16, s_bf16);
  else return (int)cudaErrorInvalidValue;
  fn(x, qa, qb, s, m, y, T, N, K, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // namespace

// x: (T, K) in stored (group-permuted) order, f32 or bf16; qa: q4 or q8
// plane (N, K*bits/8); qb: q2 plane (Q6) or null; s, m: (N, K/g) f32 or
// bf16 (m null for Q8); y: (T, N) f32. Returns cudaGetLastError().
extern "C" int tpl_qmm_gemv(int kind, int x_bf16, int s_bf16, const void* x,
                            const void* qa, const void* qb, const void* s,
                            const void* m, float* y, int T, int N, int K,
                            void* stream) {
  return run<false>(kind, x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, stream);
}

extern "C" int tpl_qmm_tiled(int kind, int x_bf16, int s_bf16, const void* x,
                             const void* qa, const void* qb, const void* s,
                             const void* m, float* y, int T, int N, int K,
                             void* stream) {
  return run<true>(kind, x_bf16, s_bf16, x, qa, qb, s, m, y, T, N, K, stream);
}

// Message for a code returned by any tpl_* entry point.
extern "C" const char* tpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
