// Split-S flash-decoding over the head-major (B, Hkv, S, D) KV cache.
//
// Replaces the Pallas kernels _fd_kernel (B = 1, grid (B, Hkv, S/bs),
// tpullama/ops/pallas/flash_decode.py:60) and _fdb_kernel (batch-major
// B > 1, grid (Hkv, S/bs), flash_decode.py:141). Both carry the flash
// (m, l, acc) recurrence across the TPU's sequential S axis in scratch
// memory; CUDA blocks run in no order and share nothing, so this version
// splits S into chunks that run independently and merges them afterwards:
//   fd_split_kernel    one block per (S chunk, kv head, batch row): the
//                      G*Tq query rows of that kv head against the chunk's
//                      keys; writes the chunk's row max m, row sum l and
//                      unnormalised p @ V.
//   fd_combine_kernel  one block per (kv head, batch row): rescales the
//                      chunk partials to the global max, applies the sink
//                      logit, divides by the sum, writes (B, Tq, Hq, D).
//
// What bounds it on an H100: bytes. Decode attention reads every visible
// K and V row once and does 4*G*Tq flops per element read (G = 4 for
// Llama-3-8B), far under the 295 flop/byte ridge. So the kernel reads each
// K/V row once per kv head (GQA rows grouped, not per q head), skips every
// chunk whose mask rows are all hidden without touching its K/V, and cuts
// S into 128-cell chunks so that even B = 1 with 8 kv heads launches
// Hkv * S/128 blocks (264 at S = 4224) and fills the 132 SMs.
//
// Semantics follow the TPU kernel: additive f32 mask (<= -1e30 hidden),
// logit softcap, ALiBi slopes multiplying the visible mask values, sink
// logits in the final normalisation, and finite zeros for rows whose mask
// hides everything. Scores, softmax and the PV sum run in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float NEG_HALF = -5e29f;
constexpr int CS = 128;  // cells per S chunk
constexpr int KT = 32;   // keys staged in shared memory at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// blockDim.x == D; dynamic shared memory: qs[R*D] | ks[KT*(D+1)] | ps[R*CS]
template <typename QT, typename KVT, int D, int RB>
__global__ void __launch_bounds__(D) fd_split_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k, const KVT* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ slopes,
    float* __restrict__ part_o, float* __restrict__ part_ml, int Tq, int Hq,
    int Hkv, int S, float scale, float softcap) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.x;
  const int tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int R = G * Tq;
  float* qs = smem;
  float* ks = qs + R * D;
  float* ps = ks + KT * (D + 1);

  const int s_begin = c * CS;
  const int n = min(S - s_begin, CS);
  const float* mask_b = mask + (size_t)b * Tq * S;
  const size_t part = ((size_t)b * Hkv + h) * NC + c;
  float* po = part_o + part * R * D;
  float* pml = part_ml + part * R * 2;

  int vis = 0;
  for (int i = tid; i < Tq * n; i += D) {
    const int tq = i / n;
    vis |= mask_b[(size_t)tq * S + s_begin + i % n] > NEG_HALF;
  }
  if (!__syncthreads_or(vis)) {
    // nothing visible: the combine step skips this chunk (l = 0) and
    // never reads its p @ V partial
    for (int r = tid; r < R; r += D) {
      pml[2 * r] = NEG_INF;
      pml[2 * r + 1] = 0.f;
    }
    return;
  }

  for (int i = tid; i < R * D; i += D) {
    const int r = i / D, d = i % D;
    const int g = r / Tq, tq = r % Tq;
    qs[i] = to_f(q[(((size_t)b * Tq + tq) * Hq + h * G + g) * D + d]);
  }
  const KVT* kh = k + ((size_t)b * Hkv + h) * S * D;
  const KVT* vh = v + ((size_t)b * Hkv + h) * S * D;
  for (int s0 = 0; s0 < n; s0 += KT) {
    const int nn = min(KT, n - s0);
    __syncthreads();
    for (int i = tid; i < nn * D; i += D) {
      const int cell = i / D, d = i % D;
      ks[cell * (D + 1) + d] = to_f(kh[(size_t)(s_begin + s0 + cell) * D + d]);
    }
    __syncthreads();
    for (int i = tid; i < R * KT; i += D) {
      const int r = i / KT, cell = i % KT;
      if (cell < nn) {
        const float* qr = qs + r * D;
        const float* kr = ks + cell * (D + 1);
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        ps[r * CS + s0 + cell] = acc;
      }
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  constexpr int NW = D / 32;
  for (int r = warp; r < R; r += NW) {
    const int tq = r % Tq;
    const float* mr = mask_b + (size_t)tq * S + s_begin;
    const float slope = slopes ? slopes[h * G + r / Tq] : 0.f;
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) {
      float sv = ps[r * CS + j] * scale;
      if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
      float mk = mr[j];
      if (slopes) mk = mk > NEG_HALF ? mk * slope : NEG_INF;
      sv += mk;
      ps[r * CS + j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float sv = ps[r * CS + j];
      const float p = sv > NEG_HALF ? expf(sv - mx) : 0.f;
      ps[r * CS + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      pml[2 * r] = mx;
      pml[2 * r + 1] = l;
    }
  }
  __syncthreads();

  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float vv = to_f(vh[(size_t)(s_begin + j) * D + tid]);
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < R) acc[r] = fmaf(ps[r * CS + j], vv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (r < R) po[(size_t)r * D + tid] = acc[r];
}

// blockDim.x == D; one block per (kv head, batch row)
template <typename QT, int D>
__global__ void __launch_bounds__(D) fd_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const float* __restrict__ sinks, QT* __restrict__ out, int NC, int Tq,
    int Hq, int Hkv) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int d = threadIdx.x;
  const int G = Hq / Hkv;
  const int R = G * Tq;
  const size_t base = ((size_t)b * Hkv + h) * NC;
  for (int r = 0; r < R; ++r) {
    float M = NEG_INF;
    for (int c = 0; c < NC; ++c) M = fmaxf(M, part_ml[((base + c) * R + r) * 2]);
    float L = 0.f, O = 0.f;
    for (int c = 0; c < NC; ++c) {
      const float* ml = part_ml + ((base + c) * R + r) * 2;
      const float l = ml[1];
      if (l > 0.f) {
        const float w = expf(ml[0] - M);
        L = fmaf(l, w, L);
        O = fmaf(part_o[((base + c) * R + r) * D + d], w, O);
      }
    }
    const int hq = h * G + r / Tq, tq = r % Tq;
    if (sinks) {
      const float sk = sinks[hq];
      const float mf = fmaxf(M, sk);
      const float corr = expf(M - mf);
      O *= corr;
      L = L * corr + expf(sk - mf);
    }
    from_f(O / fmaxf(L, 1e-30f), out + (((size_t)b * Tq + tq) * Hq + hq) * D + d);
  }
}

// dynamic shared memory of fd_split_kernel for R query rows
constexpr size_t smem_bytes(int R, int D) {
  return sizeof(float) * ((size_t)R * D + KT * (D + 1) + (size_t)R * CS);
}

template <typename QT, typename KVT, int D, int RB>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const float* slopes, const float* sinks, float* part_o,
           float* part_ml, void* out, int B, int Tq, int Hq, int Hkv, int S,
           float scale, float softcap, cudaStream_t st) {
  const int NC = (S + CS - 1) / CS;
  const int R = (Hq / Hkv) * Tq;
  auto kern = fd_split_kernel<QT, KVT, D, RB>;
  // allow this instance's largest request (R = RB rows) once per process,
  // not once per launch: the attribute is a driver call on the host's path
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(RB, D));
  if (attr != cudaSuccess) return (int)attr;
  kern<<<dim3(NC, Hkv, B), D, smem_bytes(R, D), st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), mask, slopes, part_o, part_ml, Tq, Hq, Hkv, S,
      scale, softcap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fd_combine_kernel<QT, D><<<dim3(Hkv, B), D, 0, st>>>(
      part_o, part_ml, sinks, static_cast<QT*>(out), NC, Tq, Hq, Hkv);
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT, int D>
int pick_rows(int R, const void* q, const void* k, const void* v, const float* mask,
              const float* slopes, const float* sinks, float* po, float* pml,
              void* out, int B, int Tq, int Hq, int Hkv, int S, float scale,
              float softcap, cudaStream_t st) {
  if (R <= 4)
    return launch<QT, KVT, D, 4>(q, k, v, mask, slopes, sinks, po, pml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  if (R <= 8)
    return launch<QT, KVT, D, 8>(q, k, v, mask, slopes, sinks, po, pml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  if (R <= 16)
    return launch<QT, KVT, D, 16>(q, k, v, mask, slopes, sinks, po, pml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  if (R <= 32)
    return launch<QT, KVT, D, 32>(q, k, v, mask, slopes, sinks, po, pml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

template <typename QT, typename KVT>
int pick_d(int D, int R, const void* q, const void* k, const void* v, const float* mask,
           const float* slopes, const float* sinks, float* po, float* pml, void* out,
           int B, int Tq, int Hq, int Hkv, int S, float scale, float softcap,
           cudaStream_t st) {
  if (D == 64)
    return pick_rows<QT, KVT, 64>(R, q, k, v, mask, slopes, sinks, po, pml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  if (D == 128)
    return pick_rows<QT, KVT, 128>(R, q, k, v, mask, slopes, sinks, po, pml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Tq, Hq, D); k, v: (B, Hkv, S, D); mask: (B, Tq, S) f32 additive;
// slopes, sinks: (Hq,) f32 or null; part_o: (B, Hkv, ceil(S/128), R, D) f32
// and part_ml: (B, Hkv, ceil(S/128), R, 2) f32 scratch; out: (B, Tq, Hq, D)
// in q's type. q_bf16 / kv_bf16 select bf16 (1) or f32 (0).
extern "C" int tpl_flash_decode(int q_bf16, int kv_bf16, const void* q,
                                const void* k, const void* v, const float* mask,
                                const float* slopes, const float* sinks,
                                float* part_o, float* part_ml, void* out, int B,
                                int Tq, int Hq, int Hkv, int S, int D,
                                float scale, float softcap, void* stream) {
  using bf = __nv_bfloat16;
  auto st = static_cast<cudaStream_t>(stream);
  const int R = (Hq / Hkv) * Tq;
  if (q_bf16) {
    if (kv_bf16)
      return pick_d<bf, bf>(D, R, q, k, v, mask, slopes, sinks, part_o, part_ml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
    return pick_d<bf, float>(D, R, q, k, v, mask, slopes, sinks, part_o, part_ml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  }
  if (kv_bf16)
    return pick_d<float, bf>(D, R, q, k, v, mask, slopes, sinks, part_o, part_ml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return pick_d<float, float>(D, R, q, k, v, mask, slopes, sinks, part_o, part_ml, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
}
