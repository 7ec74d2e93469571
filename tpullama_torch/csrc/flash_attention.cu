// Mask-driven flash attention for prefill chunks over the head-major
// (B, Hkv, S, D) KV cache.
//
// Replaces the Pallas kernel _fa_kernel of flash_attention
// (tpullama/ops/pallas/flash_attention.py:40, called at :214). As there,
// the G query heads that share a kv head are flattened with a tile of
// query positions into one block of 64 rows (G * BQ = 64), so each K/V tile
// is read once per kv head rather than once per query head; the additive
// f32 mask drives visibility, and a (query tile, key tile) pair whose mask
// is hidden everywhere is skipped without reading K/V (the causal upper
// triangle and the unwritten cache tail).
//
// The TPU kernel carries (m, l, acc) across the sequential S grid axis in
// scratch; here one block owns one (query tile, kv head, batch row) and
// loops over all key tiles itself, keeping the running max and sum in
// shared memory and the output accumulator in registers.
//
// What bounds it on an H100: operations, at prefill chunk sizes. Each K/V
// byte is reused by 64 query rows, so the arithmetic intensity is well
// above the ridge for the tensor cores; this first version computes the
// two products with f32 FMAs from shared memory (no mma/wgmma), so it runs
// far below the tensor-core rate. That is the gap a later change closes.
//
// Semantics follow the TPU kernel: scale, logit softcap, ALiBi slopes
// multiplying visible mask values, sink logits in the final normalisation,
// f32 online softmax, and finite zeros for rows the mask hides entirely
// (padded prompt tokens). Scores and both products run in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float NEG_HALF = -5e29f;
constexpr int ROWS = 64;  // G * BQ query rows per block
constexpr int BS = 64;    // key tile
constexpr int NT = 256;   // threads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <int D>
struct Smem {
  static constexpr int QLD = D + 4;  // Q rows, broadcast reads
  static constexpr int KLD = D + 1;  // K rows, column reads by 16 threads
  static constexpr int VLD = D;      // V rows, contiguous reads
  static constexpr int PLD = BS + 1;
  static constexpr size_t floats =
      (size_t)ROWS * QLD + (size_t)BS * KLD + (size_t)BS * VLD + (size_t)ROWS * PLD + 3 * ROWS;
};

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(NT) fa_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k, const KVT* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ slopes,
    const float* __restrict__ sinks, QT* __restrict__ out, int Tq, int Hq,
    int Hkv, int S, float scale, float softcap) {
  using SM = Smem<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + ROWS * SM::QLD;
  float* Vs = Ks + BS * SM::KLD;
  float* Ps = Vs + BS * SM::VLD;
  float* row_m = Ps + ROWS * SM::PLD;
  float* row_l = row_m + ROWS;
  float* row_a = row_l + ROWS;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int BQ = ROWS / G;
  const int q0 = qt * BQ;
  const float* mask_b = mask + (size_t)b * Tq * S;
  const KVT* kh = k + ((size_t)b * Hkv + h) * S * D;
  const KVT* vh = v + ((size_t)b * Hkv + h) * S * D;

  // row r <-> q head h*G + r / BQ, query position q0 + r % BQ
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D, d = i % D;
    const int tq = q0 + r % BQ;
    Qs[r * SM::QLD + d] =
        tq < Tq ? to_f(q[(((size_t)b * Tq + tq) * Hq + h * G + r / BQ) * D + d]) : 0.f;
  }
  if (tid < ROWS) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  constexpr int DPT = D / 32;  // output columns per thread
  const int warp = tid >> 5, lane = tid & 31;
  float acc[8][DPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const int nq = min(BQ, Tq - q0);
  for (int s0 = 0; s0 < S; s0 += BS) {
    const int ns = min(BS, S - s0);
    int vis = 0;
    for (int i = tid; i < nq * ns; i += NT) {
      vis |= mask_b[(size_t)(q0 + i / ns) * S + s0 + i % ns] > NEG_HALF;
    }
    if (!__syncthreads_or(vis)) continue;

    for (int i = tid; i < BS * D; i += NT) {
      const int cell = i / D, d = i % D;
      const bool in = cell < ns;
      Ks[cell * SM::KLD + d] = in ? to_f(kh[(size_t)(s0 + cell) * D + d]) : 0.f;
      Vs[cell * SM::VLD + d] = in ? to_f(vh[(size_t)(s0 + cell) * D + d]) : 0.f;
    }
    __syncthreads();

    {  // scores: rows ty*4 + i, cells tx + 16*j
      const int tx = tid & 15, ty = tid >> 4;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * SM::QLD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * SM::KLD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int tq = q0 + r % BQ;
        const float slope = slopes ? slopes[h * G + r / BQ] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cell = tx + 16 * j;
          float sv = s[i][j] * scale;
          if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
          float mk = (tq < Tq && cell < ns) ? mask_b[(size_t)tq * S + s0 + cell] : NEG_INF;
          if (slopes) mk = mk > NEG_HALF ? mk * slope : NEG_INF;
          Ps[r * SM::PLD + cell] = sv + mk;
        }
      }
    }
    __syncthreads();

    {  // online softmax: 4 threads per row, 16 cells each
      const int r = tid >> 2, part = tid & 3;
      float* pr = Ps + r * SM::PLD + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, pr[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = pr[j] > NEG_HALF ? expf(pr[j] - m_new) : 0.f;
        pr[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc rows warp*8 + i, columns lane*DPT + j
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = row_a[warp * 8 + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= a;
    }
    for (int cell = 0; cell < BS; ++cell) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[cell * SM::VLD + lane * DPT + j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = Ps[(warp * 8 + i) * SM::PLD + cell];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    const int tq = q0 + r % BQ;
    if (tq >= Tq) continue;
    const int hq = h * G + r / BQ;
    float m = row_m[r], l = row_l[r], corr = 1.f;
    if (sinks) {
      const float sk = sinks[hq];
      const float mf = fmaxf(m, sk);
      corr = expf(m - mf);
      l = l * corr + expf(sk - mf);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    QT* o = out + (((size_t)b * Tq + tq) * Hq + hq) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) from_f(acc[i][j] * corr * inv, o + lane * DPT + j);
  }
}

template <typename QT, typename KVT, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const float* slopes, const float* sinks, void* out, int B, int Tq,
           int Hq, int Hkv, int S, float scale, float softcap, cudaStream_t st) {
  const int G = Hq / Hkv;
  const int BQ = ROWS / G;
  const size_t smem = sizeof(float) * Smem<D>::floats;
  auto kern = fa_kernel<QT, KVT, D>;
  // allowed once per process, not once per launch (a driver call)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<dim3((Tq + BQ - 1) / BQ, Hkv, B), NT, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), mask, slopes, sinks, static_cast<QT*>(out),
      Tq, Hq, Hkv, S, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT>
int pick_d(int D, const void* q, const void* k, const void* v, const float* mask,
           const float* slopes, const float* sinks, void* out, int B, int Tq,
           int Hq, int Hkv, int S, float scale, float softcap, cudaStream_t st) {
  if (D == 64)
    return launch<QT, KVT, 64>(q, k, v, mask, slopes, sinks, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  if (D == 128)
    return launch<QT, KVT, 128>(q, k, v, mask, slopes, sinks, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Tq, Hq, D); k, v: (B, Hkv, S, D); mask: (B, Tq, S) f32 additive;
// slopes, sinks: (Hq,) f32 or null; out: (B, Tq, Hq, D) in q's type.
// Requires 64 % (Hq / Hkv) == 0 and D in {64, 128} (the wrapper checks).
extern "C" int tpl_flash_attention(int q_bf16, int kv_bf16, const void* q,
                                   const void* k, const void* v, const float* mask,
                                   const float* slopes, const float* sinks,
                                   void* out, int B, int Tq, int Hq, int Hkv, int S,
                                   int D, float scale, float softcap, void* stream) {
  using bf = __nv_bfloat16;
  auto st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_bf16) return pick_d<bf, bf>(D, q, k, v, mask, slopes, sinks, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
    return pick_d<bf, float>(D, q, k, v, mask, slopes, sinks, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  }
  if (kv_bf16) return pick_d<float, bf>(D, q, k, v, mask, slopes, sinks, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return pick_d<float, float>(D, q, k, v, mask, slopes, sinks, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
}
