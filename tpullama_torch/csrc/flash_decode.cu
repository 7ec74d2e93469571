// Split-S flash-decoding over the head-major (B, Hkv, S, D) KV cache, in
// one launch.
//
// Replaces the Pallas kernels _fd_kernel (B = 1, grid (B, Hkv, S/bs),
// tpullama/ops/pallas/flash_decode.py:60) and _fdb_kernel (batch-major
// B > 1, grid (Hkv, S/bs), flash_decode.py:141). Both carry the flash
// (m, l, acc) recurrence across the TPU's sequential S axis in scratch
// memory; CUDA blocks run in no order and share nothing, so here S is cut
// into chunks of 64 cells that run independently, one block per (chunk,
// tile of 16 query rows, kv head x batch row):
//   - the block's 4 warps split the chunk's cells (16 each) against the
//     same 16 rows of the kv head's (position, head) row space (row r =
//     position * G + head, attn_tile.cuh; any G, G * Tq rows in as many
//     tiles as it takes), then merge their (m, l, o) in shared memory and
//     write the chunk's row max, row sum and unnormalised P V;
//   - a per-(row tile, kv head, batch row) ticket counts the finished
//     chunks; the block that takes the last ticket merges every chunk's
//     partials in chunk order (so the result does not depend on which
//     block finished first), applies the sink logit, writes (B, Tq, Hq, D)
//     and resets the ticket to 0 for the next call.
//
// What bounds it on an H100: bytes. Decode attention reads every visible
// K and V row once and does 4 * G * Tq flops per element read (G = 4 for
// Llama-3-8B), far under the 295 flop/byte ridge. So the kernel reads each
// K/V row once per kv head and row tile, skips every chunk whose mask rows
// are all hidden without touching its K/V (the vote comes from the mask
// values the threads need anyway), requests a chunk's K and V at once in
// 16-byte cp.async copies (32 KB a block at D = 128), and cuts S finely
// enough that B = 1 at S = 4224 with 8 kv heads launches 528 blocks, four
// or more per SM with 33 KB of shared memory each (K and V in swizzled
// rows, later the warps' partials). Scores and P V run on
// the tensor cores for bf16 (the 16 rows padded with zeros; compute is
// free here), with P split into bf16 hi + lo; any f32 operand runs the
// same layout as f32 FMAs. It replaced a split kernel of 128-cell chunks
// (128-thread blocks, K staged 32 cells at a time with 2-byte loads, serial
// 128-long dot products) followed by a second combine launch: 0.0864 ms at
// B = 1 and 0.0974 ms at B = 4 on an NVIDIA H100 80GB HBM3, 700.00 W.
//
// Head dims: one instance per padded width D in {64, 128, 256} takes any
// head dim Dr <= D (attn_tile.cuh); the chunks' partial outputs are rows
// of DP = Dr rounded up to 4 values, so the merge reads them 16 bytes at a
// time.
//
// An int8 cache (the TPU kernels' has_kv_scale branches, flash_decode.py
// :98, :116, :179, :198) takes the same two routes: MMA stages the chunk's
// raw K/V bytes by cp.async beside the tiles and converts them into the
// bf16 tiles (exact); FMA loads and converts them as it does f32 or bf16
// rows. Each warp reads its 16 cells' K and V scales from device memory
// beside their mask values. Partials, merge and tickets are unchanged.
//
// Semantics follow the TPU kernel: additive f32 mask (<= -1e30 hidden),
// logit softcap, ALiBi slopes multiplying the visible mask values, sink
// logits in the final normalisation, and finite zeros for rows whose mask
// hides everything. Scores, softmax and the sums run in f32.

#include "attn_tile.cuh"

namespace {

using namespace tpl_attn;

constexpr int NT = 2;  // n8 tiles of cells per warp: 16 of the chunk's 64

// dynamic shared memory: the chunk's K and V tiles (reused for the warps'
// partials, WO floats); FMA adds the 16 f32 q rows and each warp's P
// buffer, MMA over int8 the chunk's raw K and V bytes (RAW)
template <bool MMA, int D, bool RAW = false>
struct FdSmem {
  static constexpr int WO = 4 * 16 * D + 2 * 4 * 16;  // [warp][row][D] o, then m and l
  static constexpr int KV = 2 * Tile<MMA, D>::BYTES;
  static constexpr int BASE = KV > WO * 4 ? KV : WO * 4;
  static constexpr int BYTES =
      BASE + (MMA ? 0 : (16 * Tile<false, D>::LD + 4 * 16 * (8 * NT + 4)) * (int)sizeof(float)) +
      (RAW ? 2 * CELLS * D : 0);
};

template <bool MMA, typename QT, typename KVT, int D>
__global__ void __launch_bounds__(THREADS) fd_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k, const KVT* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ slopes,
    const float* __restrict__ sinks, const float* __restrict__ ksc,
    const float* __restrict__ vsc, float* __restrict__ part_o, float* __restrict__ part_ml,
    int* __restrict__ tickets, QT* __restrict__ out, int Tq, int Hq, int Hkv, int S,
    float scale, float softcap, int Dr) {
  constexpr bool SC = std::is_same<KVT, int8_t>::value;  // int8 cache: scales
  constexpr bool RAW = MMA && SC;  // its raw bytes staged, then converted
  using TL = Tile<MMA, D>;
  using SM = FdSmem<MMA, D, RAW>;
  using E = typename TL::E;
  extern __shared__ __align__(16) char smem[];
  E* ks = reinterpret_cast<E*>(smem);
  E* vs = ks + CELLS * TL::LD;
  float* wo = reinterpret_cast<float*>(smem);  // after the products: [warp][16][D]
  float* wm = wo + 4 * 16 * D;                 // [warp][16] row max, then [warp][16] sums
  float* qs = reinterpret_cast<float*>(smem + SM::BASE);  // FMA: [16][D + 4]
  float* ps = qs + 16 * Tile<false, D>::LD;               // FMA: [warp][16][8 NT + 4]
  int8_t* raw = reinterpret_cast<int8_t*>(smem + SM::BASE);  // RAW: [K, V][CELLS][D]
  __shared__ int last;

  const int c = blockIdx.x, rt = blockIdx.y, bh = blockIdx.z;
  const int NC = gridDim.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int G = Hq / Hkv, R = Tq * G;
  const int r0 = 16 * rt;
  const int nr = min(16, R - r0);  // valid rows of this tile
  Rows rw;
  rw.init(r0, g, G, R, h, slopes);
  const float* mask_b = mask + (size_t)b * Tq * S;
  const int s0 = c * CELLS, c0 = 16 * warp;  // the chunk's and the warp's first cell
  const size_t part = (size_t)bh * NC + c;    // partial rows at (part * R + row)
  const int DP = (Dr + 3) & ~3;               // a partial row's values
  auto q_row = [&](int i) {
    return rw.pos[i] < 0 ? nullptr : q + (((size_t)b * Tq + rw.pos[i]) * Hq + rw.hq[i]) * Dr;
  };

  // q first, so that its loads overlap the vote's
  uint32_t qa[MMA ? D / 16 : 1][4];
  if constexpr (MMA) {
    load_q_frags<D>(qa, q_row(0), q_row(1), tig, Dr);
  } else {
    for (int i = tid; i < 16 * D; i += THREADS) {
      const int r = r0 + i / D, d = i % D;
      qs[(i / D) * Tile<false, D>::LD + d] =
          r < R && d < Dr ? to_f(q[(((size_t)b * Tq + r / G) * Hq + h * G + r % G) * Dr + d])
                          : 0.f;
    }
  }
  if (__syncthreads_or(any_visible<NT>(mask_b, S, rw, s0 + c0, tig))) {
    if constexpr (RAW) {
      stage_kv_i8<D>(raw, raw + CELLS * D, reinterpret_cast<const int8_t*>(k) + (size_t)bh * S * Dr,
                     reinterpret_cast<const int8_t*>(v) + (size_t)bh * S * Dr, s0, S, Dr);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      convert_i8<D>(reinterpret_cast<__nv_bfloat16*>(ks), raw);
      convert_i8<D>(reinterpret_cast<__nv_bfloat16*>(vs), raw + CELLS * D);
    } else {
      copy_kv<MMA, D, KVT>(ks, vs, k + (size_t)bh * S * Dr, v + (size_t)bh * S * Dr, s0, S, Dr);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[NT][4], o[D / 8][4], alpha[2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    if constexpr (MMA) {
      qk_mma<D, NT>(s, [&](int kk, uint32_t (&a)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
      }, ks, c0, lane);
    } else {
      qk_fma<D, NT>(s, qs, ks, c0, g, tig);
    }
    const float* const mr[2] = {
        rw.pos[0] < 0 ? nullptr : mask_b + (size_t)rw.pos[0] * S + s0 + c0,
        rw.pos[1] < 0 ? nullptr : mask_b + (size_t)rw.pos[1] * S + s0 + c0};
    // SC: this warp's cells' K and V scales, read beside their mask values
    const size_t sc0 = (size_t)bh * S + s0 + c0;
    mask_scores<NT>(s, mr, SC ? ksc + sc0 : nullptr, S - s0 - c0, rw, tig, scale, softcap,
                    slopes != nullptr);
    softmax_run<NT>(s, m, l, alpha);
    if constexpr (SC) scale_probs<NT>(s, vsc + sc0, S - s0 - c0, tig);
    if constexpr (MMA) pv_mma<D, NT>(o, s, vs, c0, lane);
    else pv_fma<D, NT>(o, s, ps + warp * 16 * (8 * NT + 4), vs, c0, g, tig);
    __syncthreads();  // every warp is done with the K/V tiles
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = g + 8 * i;
      float* wr = wo + (warp * 16 + row) * D + 2 * tig;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) store2(wr + 8 * dn, o[dn][2 * i], o[dn][2 * i + 1]);
      if (tig == 0) {
        wm[warp * 16 + row] = m[i];
        wm[64 + warp * 16 + row] = l[i];
      }
    }
    __syncthreads();
    // the chunk's partials: the four warps' runs merged in warp order
    // (indices over the instance's D, so the divisions are by a constant;
    // columns at or past DP are skipped)
    for (int i = tid; i < nr * D; i += THREADS) {
      const int row = i / D, d = i % D;
      if (d >= DP) continue;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (wm[64 + w * 16 + row] > 0.f) M = fmaxf(M, wm[w * 16 + row]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float lw = wm[64 + w * 16 + row];
        if (lw > 0.f) {
          const float f = exp2f(wm[w * 16 + row] - M);
          L = fmaf(lw, f, L);
          O = fmaf(wo[(w * 16 + row) * D + d], f, O);
        }
      }
      part_o[(part * R + r0 + row) * DP + d] = O;
      if (d == 0) {
        part_ml[2 * (part * R + r0 + row)] = M;
        part_ml[2 * (part * R + r0 + row) + 1] = L;
      }
    }
  } else if (tid < nr) {
    // nothing visible: the merge skips this chunk (l = 0) and never reads
    // its P V partial
    part_ml[2 * (part * R + r0 + tid)] = NEG_INF;
    part_ml[2 * (part * R + r0 + tid) + 1] = 0.f;
  }

  // the last block of this (row tile, kv head, batch row) merges the chunks
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)bh * gridDim.y + rt;
  if (tid == 0) last = atomicAdd(ticket, 1) == NC - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The merge, in chunk order: the chunks' (m, l) of this tile's rows are
  // staged in shared memory (the K/V area), W chunks at a time; per window
  // each output takes the window's row max first, so its chunks' weights
  // are independent of each other, and its P V loads go MB at a time. A
  // chunk with nothing visible has l = 0 and an unwritten P V, never used.
  constexpr int W = SM::BASE / (16 * (int)sizeof(float2));
  constexpr int MB = 16;
  constexpr int IT = (16 * D / 4 + THREADS - 1) / THREADS;  // outputs (x4) per thread
  float2* mls = reinterpret_cast<float2*>(smem);            // [chunk][16 rows]
  const float2* pml = reinterpret_cast<const float2*>(part_ml) + (size_t)bh * NC * R + r0;
  const float* po = part_o + ((size_t)bh * NC * R + r0) * DP;
  float M[IT], L[IT];
  float4 O[IT];
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    M[k] = NEG_INF;
    L[k] = 0.f;
    O[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int w0 = 0; w0 < NC; w0 += W) {
    const int nw = min(W, NC - w0);
    for (int i = tid; i < nw * nr; i += THREADS)
      mls[(i / nr) * 16 + i % nr] = __ldcg(pml + (size_t)(w0 + i / nr) * R + i % nr);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const int i = tid + k * THREADS;
      if (i >= nr * (D / 4)) break;
      const int row = i / (D / 4), d = 4 * (i % (D / 4));
      if (d >= DP) continue;
      float Mw = M[k];
      for (int c2 = 0; c2 < nw; ++c2) {
        const float2 ml = mls[c2 * 16 + row];
        if (ml.y > 0.f) Mw = fmaxf(Mw, ml.x);
      }
      const float a = exp2f(M[k] - Mw);
      M[k] = Mw;
      L[k] *= a;
      O[k].x *= a;
      O[k].y *= a;
      O[k].z *= a;
      O[k].w *= a;
      for (int cb = 0; cb < nw; cb += MB) {
        float4 p[MB];
#pragma unroll
        for (int j = 0; j < MB; ++j)
          p[j] = __ldcg(reinterpret_cast<const float4*>(
              po + ((size_t)(w0 + min(cb + j, nw - 1)) * R + row) * DP + d));
#pragma unroll
        for (int j = 0; j < MB; ++j) {
          if (cb + j >= nw) break;
          const float2 ml = mls[(cb + j) * 16 + row];
          if (!(ml.y > 0.f)) continue;
          const float f = exp2f(ml.x - Mw);
          L[k] = fmaf(ml.y, f, L[k]);
          O[k].x = fmaf(p[j].x, f, O[k].x);
          O[k].y = fmaf(p[j].y, f, O[k].y);
          O[k].z = fmaf(p[j].z, f, O[k].z);
          O[k].w = fmaf(p[j].w, f, O[k].w);
        }
      }
    }
    __syncthreads();  // before the next window's (m, l)
  }
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const int i = tid + k * THREADS;
    if (i >= nr * (D / 4)) break;
    const int row = r0 + i / (D / 4), d = 4 * (i % (D / 4));
    if (d >= DP) continue;
    const int hq = h * G + row % G;
    const float fin = finish_row(M[k], L[k], sinks, hq);
    QT* orow = out + (((size_t)b * Tq + row / G) * Hq + hq) * Dr;
    store2_row(orow, d, O[k].x * fin, O[k].y * fin, Dr);
    store2_row(orow, d + 2, O[k].z * fin, O[k].w * fin, Dr);
  }
  if (tid == 0) *ticket = 0;
}

template <bool MMA, typename QT, typename KVT, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const float* slopes, const float* sinks, const float* ksc, const float* vsc,
           float* part_o, float* part_ml, int* tickets, void* out, int B, int Tq, int Hq,
           int Hkv, int S, int Dr, float scale, float softcap, cudaStream_t st) {
  constexpr int smem = FdSmem<MMA, D, MMA && std::is_same<KVT, int8_t>::value>::BYTES;
  auto kern = fd_kernel<MMA, QT, KVT, D>;
  // allowed once per process, not once per launch (a driver call)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int R = Tq * (Hq / Hkv);
  kern<<<dim3((S + CELLS - 1) / CELLS, (R + 15) / 16, B * Hkv), THREADS, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v), mask,
      slopes, sinks, ksc, vsc, part_o, part_ml, tickets, static_cast<QT*>(out), Tq, Hq, Hkv, S,
      scale, softcap, Dr);
  return (int)cudaGetLastError();
}

// the instance of the padded width that holds head dim D
template <bool MMA, typename QT, typename KVT>
int pick_d(int D, const void* q, const void* k, const void* v, const float* mask,
           const float* slopes, const float* sinks, const float* ksc, const float* vsc,
           float* po, float* pml, int* tk, void* out, int B, int Tq, int Hq, int Hkv, int S,
           float scale, float softcap, cudaStream_t st) {
  if (D >= 1 && D <= 64)
    return launch<MMA, QT, KVT, 64>(q, k, v, mask, slopes, sinks, ksc, vsc, po, pml, tk, out, B, Tq, Hq, Hkv, S, D, scale, softcap, st);
  if (D > 64 && D <= 128)
    return launch<MMA, QT, KVT, 128>(q, k, v, mask, slopes, sinks, ksc, vsc, po, pml, tk, out, B, Tq, Hq, Hkv, S, D, scale, softcap, st);
  if (D > 128 && D <= 256)
    return launch<MMA, QT, KVT, 256>(q, k, v, mask, slopes, sinks, ksc, vsc, po, pml, tk, out, B, Tq, Hq, Hkv, S, D, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The int8 cache's instances (kv_type 2) build in their own translation unit,
// flash_decode_int8.cu, which includes this file with TPL_ATTN_INT8 set, so
// that the two halves compile in parallel (build.py)
int fd_int8(int q_bf16, int D, const void* q, const void* k, const void* v, const float* mask,
            const float* slopes, const float* sinks, const float* ksc, const float* vsc,
            float* po, float* pml, int* tk, void* out, int B, int Tq, int Hq, int Hkv, int S,
            float scale, float softcap, cudaStream_t st);

#ifdef TPL_ATTN_INT8
int fd_int8(int q_bf16, int D, const void* q, const void* k, const void* v, const float* mask,
            const float* slopes, const float* sinks, const float* ksc, const float* vsc,
            float* po, float* pml, int* tk, void* out, int B, int Tq, int Hq, int Hkv, int S,
            float scale, float softcap, cudaStream_t st) {
  if (q_bf16)
    return pick_d<true, __nv_bfloat16, int8_t>(D, q, k, v, mask, slopes, sinks, ksc, vsc, po, pml, tk, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return pick_d<false, float, int8_t>(D, q, k, v, mask, slopes, sinks, ksc, vsc, po, pml, tk, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
}
#else
// q: (B, Tq, Hq, D); k, v: (B, Hkv, S, D); mask: (B, Tq, S) f32 additive;
// slopes, sinks: (Hq,) f32 or null; part_o: (B, Hkv, ceil(S/64), R, DP) f32
// (DP = D rounded up to a multiple of 4, 1 <= D <= 256)
// and part_ml: (B, Hkv, ceil(S/64), R, 2) f32 scratch (R = Tq * Hq / Hkv);
// tickets: B * Hkv * ceil(R/16) int32, all 0 (each call leaves them 0);
// ksc, vsc: an int8 cache's (B, Hkv, S) f32 scales (null for a float
// cache); out: (B, Tq, Hq, D) in q's type. q_bf16 selects bf16 (1) or f32
// (0) q, kv_type 0 f32, 1 bf16 or 2 int8 K/V: bf16 q over bf16 or int8 K/V
// runs the tensor-core route, any f32 operand the FMA route.
extern "C" int tpl_flash_decode(int q_bf16, int kv_type, const void* q,
                                const void* k, const void* v, const float* mask,
                                const float* slopes, const float* sinks,
                                const float* ksc, const float* vsc,
                                float* part_o, float* part_ml, int* tickets, void* out, int B,
                                int Tq, int Hq, int Hkv, int S, int D,
                                float scale, float softcap, void* stream) {
  using bf = __nv_bfloat16;
  auto st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv || kv_type < 0 || kv_type > 2) return (int)cudaErrorInvalidValue;
  if ((kv_type == 2) != (ksc != nullptr && vsc != nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_type == 2)
    return fd_int8(q_bf16, D, q, k, v, mask, slopes, sinks, ksc, vsc, part_o, part_ml, tickets, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  if (q_bf16) {
    if (kv_type == 1)
      return pick_d<true, bf, bf>(D, q, k, v, mask, slopes, sinks, ksc, vsc, part_o, part_ml, tickets, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
    return pick_d<false, bf, float>(D, q, k, v, mask, slopes, sinks, ksc, vsc, part_o, part_ml, tickets, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  }
  if (kv_type == 1)
    return pick_d<false, float, bf>(D, q, k, v, mask, slopes, sinks, ksc, vsc, part_o, part_ml, tickets, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return pick_d<false, float, float>(D, q, k, v, mask, slopes, sinks, ksc, vsc, part_o, part_ml, tickets, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
}
#endif
