// Mask-driven flash attention for prefill chunks over the head-major
// (B, Hkv, S, D) KV cache.
//
// Replaces the Pallas kernel _fa_kernel of flash_attention
// (tpullama/ops/pallas/flash_attention.py:40, called at :214). As there,
// the G query heads that share a kv head are flattened with the query
// positions into one row space, so each K/V tile is read once per kv head
// rather than once per query head; the additive f32 mask drives
// visibility, and a (row tile, key tile) pair whose mask is hidden
// everywhere is skipped without reading K/V (the causal upper triangle and
// the unwritten cache tail). Rows run in (position, head) order (row r =
// position * G + head, attn_tile.cuh), cut into tiles of 64 rows, so any
// group G = Hq / Hkv is taken: a tile may span heads and positions.
//
// The TPU kernel carries (m, l, acc) across the sequential S grid axis in
// scratch; here one block owns one (row tile, kv head, batch row) and loops
// over the key tiles itself, its running max, sums and outputs in
// registers.
//
// What bounds it on an H100: operations, at prefill chunk sizes (6.4 GFLOP
// of visible pairs in Llama-3-8B's packed 4 x 256 chunk over a 4224-cell
// cache; each K/V byte is reused by 64 query rows). Design, for bf16 q, k, v
// (the served dtype): 4 warps of 16 rows each; q fragments held in
// registers for the whole loop; K/V tiles of 64 cells by 16-byte cp.async,
// double-buffered, so the next visible tile's copy overlaps this tile's
// products; S = Q K^T and O += P V by mma.sync (bf16 in, f32 accumulators;
// P split into bf16 hi + lo, two passes, attn_tile.cuh); softmax in
// registers. The block first reads its positions' mask rows once, all
// threads at once, and lists the key tiles any of its rows sees; the loop
// then walks that list, each tile's mask rows staged with its K/V, so no
// global load and no vote sits between two tiles' products. It replaced a
// body of scalar f32 FMAs through shared memory (1.818 ms at that shape on
// an NVIDIA H100 80GB HBM3, 700.00 W). Any f32 operand runs the same layout
// as f32 FMAs (the FMA route of attn_tile.cuh).
//
// Head dims: one instance per padded width D in {64, 128, 256} takes any
// head dim Dr <= D (attn_tile.cuh). At D = 256 the MMA route reads q's
// fragments from a bf16 tile in shared memory at each key tile instead of
// holding them (64 registers more beside a 128-register accumulator), and
// the FMA route runs K and then V through one f32 tile, since two
// buffers of K and V tiles of 256 f32 columns would not fit shared memory.
//
// An int8 cache (the TPU kernel's has_kv_scale branches, :85-86 and
// :106-108) takes the same two routes. MMA stages each visible tile's raw
// K/V bytes by cp.async, double-buffered like the bf16 tiles, and converts
// them into one pair of bf16 tiles when the tile is due (exact); FMA loads
// and converts them as it does f32 or bf16 rows. Each tile's 64 K and 64
// V scales ride with its mask rows (16-byte copies where the scale rows
// start 16-byte aligned, else 4-byte ones).
//
// Semantics follow the TPU kernel: scale, logit softcap, ALiBi slopes
// multiplying visible mask values, sink logits in the final normalisation,
// f32 online softmax, and finite zeros for rows the mask hides entirely
// (padded prompt tokens).

#include "attn_tile.cuh"

namespace {

using namespace tpl_attn;

constexpr int ROWS = 64;  // query rows per block: 4 warps x 16
constexpr int NT = CELLS / 8;  // n8 tiles of a key tile per warp

// Mask rows one block stages per key tile: the positions its ROWS rows
// span, at most (ROWS - 1) / G + 2 of them.
inline int fa_mask_rows(int G) { return G == 1 ? ROWS : (ROWS - 1) / G + 2; }

// Dynamic shared memory: two buffers of the K/V tiles (FMA at D = 256:
// one tile, K then V; MMA over int8: one pair of tiles, then two buffers
// of the raw K and V bytes), then two buffers of the key tile's mask rows
// (mp rows of CELLS f32), an int8 cache's two buffers of its K and V
// scales (CELLS f32 each) and the visible key tiles' flags and list
// (n_tiles bytes and ints); MMA at D = 256 adds the block's bf16 q rows,
// FMA its f32 q rows and each warp's P buffer.
template <bool MMA, int D, bool RAW>
__host__ __device__ constexpr int fa_fixed_smem() {
  return (!MMA && D > 128 ? 1 : RAW ? 2 : 4) * Tile<MMA, D>::BYTES + (RAW ? 4 * CELLS * D : 0) +
         (MMA && D > 128 ? ROWS * D * 2 : 0) +
         (MMA ? 0 : (ROWS * Tile<false, D>::LD + 4 * 16 * (8 * NT + 4)) * (int)sizeof(float));
}
inline size_t fa_smem(int fixed, int mp, int n_tiles, bool scaled) {
  return (size_t)fixed + 2 * (size_t)mp * CELLS * sizeof(float) +
         (scaled ? 4 * CELLS * sizeof(float) : 0) + (size_t)n_tiles * 5 + 16;
}

template <bool MMA, typename QT, typename KVT, int D>
__global__ void __launch_bounds__(THREADS) fa_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k, const KVT* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ slopes,
    const float* __restrict__ sinks, const float* __restrict__ ksc,
    const float* __restrict__ vsc, QT* __restrict__ out, int Tq, int Hq, int Hkv, int S,
    float scale, float softcap, int mp, int Dr) {
  using TL = Tile<MMA, D>;
  using E = typename TL::E;
  constexpr int TILE = TL::BYTES / (int)sizeof(E);
  constexpr bool QS = MMA && D > 128;   // q fragments from shared memory
  constexpr bool ONE = !MMA && D > 128;  // one K-then-V tile
  constexpr bool SC = std::is_same<KVT, int8_t>::value;  // int8 cache: scales
  constexpr bool RAW = MMA && SC;  // its raw bytes staged, converted per tile
  extern __shared__ __align__(16) char smem[];
  E* kv_s = reinterpret_cast<E*>(smem);  // [buffer][K, V] tiles; ONE: one tile; RAW: [K, V]
  int8_t* raw = reinterpret_cast<int8_t*>(smem + (RAW ? 2 : 0) * TL::BYTES);  // [buffer][K, V]
  char* after = smem + (ONE ? 1 : RAW ? 2 : 4) * TL::BYTES + (RAW ? 4 * CELLS * D : 0);
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(after);  // QS: [ROWS][D], swizzled
  float* qs = reinterpret_cast<float*>(after);                  // FMA: [ROWS][D + 4]
  float* ps = qs + ROWS * Tile<false, D>::LD;                    // FMA: [warp][16][8 NT + 4]
  float* ms = reinterpret_cast<float*>(smem + fa_fixed_smem<MMA, D, RAW>());  // [buffer][mp][CELLS]
  float* scs = ms + 2 * mp * CELLS;  // SC: [buffer][K, V][CELLS]
  const int n_tiles = (S + CELLS - 1) / CELLS;
  int* list = reinterpret_cast<int*>(scs + (SC ? 4 * CELLS : 0));  // visible key tiles, in order
  unsigned char* flag = reinterpret_cast<unsigned char*>(list + n_tiles);
  __shared__ int n_vis, warp_n[4];

  const int rt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int G = Hq / Hkv, R = Tq * G;
  Rows rw;
  rw.init(ROWS * rt + 16 * warp, g, G, R, h, slopes);
  // the mask rows of the block's positions p0 .. p0 + np - 1
  const int p0 = ROWS * rt / G;
  const int np = min(Tq - 1, (ROWS * rt + ROWS - 1) / G) - p0 + 1;
  const float* mask_p = mask + ((size_t)b * Tq + p0) * S;
  const KVT* kh = k + ((size_t)b * Hkv + h) * S * Dr;
  const KVT* vh = v + ((size_t)b * Hkv + h) * S * Dr;
  // SC: the head's K and V scale rows, copied 16 bytes at a time when both
  // start 16-byte aligned (S % 4 == 0 in the Context's caches)
  const float* ksh = SC ? ksc + ((size_t)b * Hkv + h) * S : nullptr;
  const float* vsh = SC ? vsc + ((size_t)b * Hkv + h) * S : nullptr;
  const bool sc16 = SC && S % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(ksh) | reinterpret_cast<uintptr_t>(vsh)) & 15) == 0;
  auto q_row = [&](int i) {
    return rw.pos[i] < 0 ? nullptr : q + (((size_t)b * Tq + rw.pos[i]) * Hq + rw.hq[i]) * Dr;
  };
  // value d of the block's row i (zeros past the last row and past Dr)
  auto q_val = [&](int i, int d) {
    const int r = ROWS * rt + i;
    return r < R && d < Dr ? q[(((size_t)b * Tq + r / G) * Hq + h * G + r % G) * Dr + d]
                           : QT(0.f);
  };

  uint32_t qa[MMA && !QS ? D / 16 : 1][4];
  if constexpr (QS) {
    for (int i = tid; i < ROWS * D; i += THREADS)
      qb[piece<D>(i / D, i % D / 8) + i % 8] = q_val(i / D, i % D);
  } else if constexpr (MMA) {
    load_q_frags<D>(qa, q_row(0), q_row(1), tig, Dr);
  } else {
    for (int i = tid; i < ROWS * D; i += THREADS)
      qs[(i / D) * Tile<false, D>::LD + i % D] = to_f(q_val(i / D, i % D));
  }
  auto afrag = [&](int kk, uint32_t (&a)[4]) {
    if constexpr (QS) {
      q_frag_smem<D>(a, qb + 16 * warp * D, kk, lane);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qa[MMA ? kk : 0][e];
    }
  };

  // Which key tiles does any of the block's rows see? One pass over its
  // positions' mask rows by the whole block, then the visible tiles listed
  // in order (a ballot per 128 tiles); fully hidden tiles cost no K/V.
  for (int t = tid; t < n_tiles; t += THREADS) flag[t] = 0;
  __syncthreads();
  if (S % 4 == 0) {
    // rows of whole 16-byte runs: SB runs in flight per thread at a time
    constexpr int SB = 16;
    const int S4 = S / 4, n4 = np * S4;
    for (int i0 = tid; i0 < n4; i0 += SB * THREADS) {
      float4 mv[SB];
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        // the block's mask rows are consecutive: run i is at 16 i bytes
        mv[j] = __ldg(reinterpret_cast<const float4*>(mask_p) + min(i0 + j * THREADS, n4 - 1));
      }
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const int i = i0 + j * THREADS;
        if (i < n4 && fmaxf(fmaxf(mv[j].x, mv[j].y), fmaxf(mv[j].z, mv[j].w)) > NEG_HALF)
          flag[4 * (i % S4) / CELLS] = 1;
      }
    }
  } else {
    for (int i = tid; i < np * S; i += THREADS)
      if (__ldg(mask_p + i) > NEG_HALF) flag[i % S / CELLS] = 1;
  }
  if (tid == 0) n_vis = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_tiles; t0 += THREADS) {
    const bool f = t0 + tid < n_tiles && flag[t0 + tid];
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int at = n_vis;
    for (int w = 0; w < warp; ++w) at += warp_n[w];
    if (f) list[at + __popc(bal & ((1u << lane) - 1))] = t0 + tid;
    __syncthreads();
    if (tid == 0) n_vis += warp_n[0] + warp_n[1] + warp_n[2] + warp_n[3];
    __syncthreads();
  }
  const int nv = n_vis;

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // key tile t's mask rows, scales (SC) and (but ONE) K and V (RAW: their
  // raw bytes) into buffer buf
  auto copy = [&](int t, int buf) {
    if constexpr (RAW)
      stage_kv_i8<D>(raw + (2 * buf) * CELLS * D, raw + (2 * buf + 1) * CELLS * D,
                     reinterpret_cast<const int8_t*>(kh), reinterpret_cast<const int8_t*>(vh),
                     CELLS * t, S, Dr);
    else if constexpr (!ONE)
      copy_kv<MMA, D, KVT>(kv_s + (2 * buf) * TILE, kv_s + (2 * buf + 1) * TILE, kh, vh,
                           CELLS * t, S, Dr);
    if constexpr (SC) {
      float* sb = scs + buf * 2 * CELLS;
      if (sc16) {
        for (int i = 4 * tid; i < 2 * CELLS; i += 4 * THREADS) {
          const int cell = CELLS * t + i % CELLS;
          const bool ok = cell < S;
          cp_async_cg(sb + i, (i < CELLS ? ksh : vsh) + (ok ? cell : 0), ok);
        }
      } else {
        for (int i = tid; i < 2 * CELLS; i += THREADS) {
          const int cell = CELLS * t + i % CELLS;
          const bool ok = cell < S;
          cp_async4(sb + i, (i < CELLS ? ksh : vsh) + (ok ? cell : 0), ok);
        }
      }
    }
    float* mb = ms + buf * mp * CELLS;
    if (S % 4 == 0) {  // 16-byte runs
      for (int i = 4 * tid; i < np * CELLS; i += 4 * THREADS) {
        const int pr = i / CELLS, cell = CELLS * t + i % CELLS;
        const bool ok = cell < S;
        cp_async_cg(mb + i, mask_p + (size_t)pr * S + (ok ? cell : 0), ok);
      }
    } else {
      for (int i = tid; i < np * CELLS; i += THREADS) {
        const int pr = i / CELLS, cell = CELLS * t + i % CELLS;
        const bool ok = cell < S;
        cp_async4(mb + i, mask_p + (size_t)pr * S + (ok ? cell : 0), ok);
      }
    }
    cp_async_commit();
  };

  if (nv > 0) copy(list[0], 0);
  for (int it = 0, buf = 0; it < nv; ++it, buf ^= 1) {
    if (it + 1 < nv) copy(list[it + 1], buf ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();  // tile it's copies
    __syncthreads();
    if constexpr (RAW) {
      convert_i8<D>(kv_s, raw + (2 * buf) * CELLS * D);
      convert_i8<D>(kv_s + TILE, raw + (2 * buf + 1) * CELLS * D);
      __syncthreads();
    }
    const int t = list[it];
    const E* ks = kv_s + (ONE || RAW ? 0 : 2 * buf) * TILE;
    const E* vs = kv_s + (ONE ? 0 : RAW ? 1 : 2 * buf + 1) * TILE;
    const float* mb = ms + buf * mp * CELLS;
    const float* sb = SC ? scs + buf * 2 * CELLS : nullptr;  // K, then V scales
    const float* const mr[2] = {rw.pos[0] < 0 ? nullptr : mb + (rw.pos[0] - p0) * CELLS,
                                rw.pos[1] < 0 ? nullptr : mb + (rw.pos[1] - p0) * CELLS};
    float s[NT][4], alpha[2];
    if constexpr (ONE) {
      copy_rows<MMA, D, KVT>(kv_s, kh, CELLS * t, S, Dr);
      __syncthreads();
    }
    if constexpr (MMA) qk_mma<D, NT>(s, afrag, ks, 0, lane);
    else qk_fma<D, NT>(s, qs + 16 * warp * Tile<false, D>::LD, ks, 0, g, tig);
    mask_scores<NT>(s, mr, sb, S - CELLS * t, rw, tig, scale, softcap, slopes != nullptr);
    softmax_run<NT>(s, m, l, alpha);
    if constexpr (SC) scale_probs<NT>(s, sb + CELLS, S - CELLS * t, tig);
    rescale<D>(o, alpha);
    if constexpr (ONE) {
      __syncthreads();  // every warp is done with K
      copy_rows<MMA, D, KVT>(kv_s, vh, CELLS * t, S, Dr);
      __syncthreads();
    }
    if constexpr (MMA) pv_mma<D, NT>(o, s, vs, 0, lane);
    else pv_fma<D, NT>(o, s, ps + warp * 16 * (8 * NT + 4), vs, 0, g, tig);
    __syncthreads();  // the buffers are free for the copies two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rw.pos[i] < 0) continue;
    const float f = finish_row(m[i], l[i], sinks, rw.hq[i]);
    QT* orow = out + (((size_t)b * Tq + rw.pos[i]) * Hq + rw.hq[i]) * Dr;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2_row(orow, 8 * dn + 2 * tig, o[dn][2 * i] * f, o[dn][2 * i + 1] * f, Dr);
  }
}

template <bool MMA, typename QT, typename KVT, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const float* slopes, const float* sinks, const float* ksc, const float* vsc,
           void* out, int B, int Tq, int Hq, int Hkv, int S, int Dr, float scale,
           float softcap, cudaStream_t st) {
  constexpr bool SC = std::is_same<KVT, int8_t>::value;
  constexpr int fixed = fa_fixed_smem<MMA, D, MMA && SC>();
  const int G = Hq / Hkv, mp = fa_mask_rows(G), n_tiles = (S + CELLS - 1) / CELLS;
  const size_t smem = fa_smem(fixed, mp, n_tiles, SC);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;  // S too long for the tile list
  auto kern = fa_kernel<MMA, QT, KVT, D>;
  // the instance's largest request, raised (a driver call) only when a
  // launch needs more than the last
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    allowed = smem;
  }
  const int R = Tq * G;
  kern<<<dim3((R + ROWS - 1) / ROWS, Hkv, B), THREADS, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v), mask,
      slopes, sinks, ksc, vsc, static_cast<QT*>(out), Tq, Hq, Hkv, S, scale, softcap, mp, Dr);
  return (int)cudaGetLastError();
}

// the instance of the padded width that holds head dim D
template <bool MMA, typename QT, typename KVT>
int pick_d(int D, const void* q, const void* k, const void* v, const float* mask,
           const float* slopes, const float* sinks, const float* ksc, const float* vsc,
           void* out, int B, int Tq, int Hq, int Hkv, int S, float scale, float softcap,
           cudaStream_t st) {
  if (D >= 1 && D <= 64)
    return launch<MMA, QT, KVT, 64>(q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, D, scale, softcap, st);
  if (D > 64 && D <= 128)
    return launch<MMA, QT, KVT, 128>(q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, D, scale, softcap, st);
  if (D > 128 && D <= 256)
    return launch<MMA, QT, KVT, 256>(q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, D, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The int8 cache's instances (kv_type 2) build in their own translation unit,
// flash_attention_int8.cu, which includes this file with TPL_ATTN_INT8 set,
// so that the two halves compile in parallel (build.py)
int fa_int8(int q_bf16, int D, const void* q, const void* k, const void* v, const float* mask,
            const float* slopes, const float* sinks, const float* ksc, const float* vsc,
            void* out, int B, int Tq, int Hq, int Hkv, int S, float scale, float softcap,
            cudaStream_t st);

#ifdef TPL_ATTN_INT8
int fa_int8(int q_bf16, int D, const void* q, const void* k, const void* v, const float* mask,
            const float* slopes, const float* sinks, const float* ksc, const float* vsc,
            void* out, int B, int Tq, int Hq, int Hkv, int S, float scale, float softcap,
            cudaStream_t st) {
  if (q_bf16)
    return pick_d<true, __nv_bfloat16, int8_t>(D, q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return pick_d<false, float, int8_t>(D, q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
}
#else
// q: (B, Tq, Hq, D); k, v: (B, Hkv, S, D); mask: (B, Tq, S) f32 additive;
// slopes, sinks: (Hq,) f32 or null; ksc, vsc: an int8 cache's (B, Hkv, S)
// f32 scales (null for a float cache); out: (B, Tq, Hq, D) in q's type.
// Requires Hq % Hkv == 0 and 1 <= D <= 256 (the wrapper checks). kv_type:
// 0 f32, 1 bf16, 2 int8. bf16 q over bf16 or int8 K/V runs the tensor-core
// route, any f32 operand the FMA route.
extern "C" int tpl_flash_attention(int q_bf16, int kv_type, const void* q,
                                   const void* k, const void* v, const float* mask,
                                   const float* slopes, const float* sinks,
                                   const float* ksc, const float* vsc,
                                   void* out, int B, int Tq, int Hq, int Hkv, int S,
                                   int D, float scale, float softcap, void* stream) {
  using bf = __nv_bfloat16;
  auto st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv || kv_type < 0 || kv_type > 2) return (int)cudaErrorInvalidValue;
  if ((kv_type == 2) != (ksc != nullptr && vsc != nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_type == 2)
    return fa_int8(q_bf16, D, q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  if (q_bf16) {
    if (kv_type == 1) return pick_d<true, bf, bf>(D, q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
    return pick_d<false, bf, float>(D, q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  }
  if (kv_type == 1) return pick_d<false, float, bf>(D, q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
  return pick_d<false, float, float>(D, q, k, v, mask, slopes, sinks, ksc, vsc, out, B, Tq, Hq, Hkv, S, scale, softcap, st);
}
#endif
