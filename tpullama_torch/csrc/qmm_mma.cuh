// Tensor-core tile body shared by the prefill routes of the planar qmm
// kernels: qmm_gathered for tiles of more than one row (qmm_gathered.cu)
// and qmm_ktiled for T > 8 (qmm_ktiled.cu).
//
// One block of 512 threads computes a BM x BN output tile, BM = 128 weight
// rows by BN activation rows, over a range of 32-position chunks of K, in
// slices of NCH = 2 chunks (BK = 64 stored positions). Per slice:
//   (a) cp.async copies the slice's packed bytes with their scale (and
//       min) columns, and its x values, into shared memory. Each of the
//       first 256 threads copies exactly the (row, chunk) pair of weights
//       it dequantizes itself, so no barrier sits between that copy and its
//       use; x goes straight to the planes the products read;
//   (b) each of those threads dequantizes its pair with decode_raw: every
//       weight is q * scale - minv with the plain version's two roundings,
//       so the weights are bit-equal to it;
//   (c) each weight w is split into bf16 hi = bf16(w) and lo = bf16(w - hi).
//       x is bf16 (its own hi, no lo) or f32 split the same way once per
//       call by mma_split_x, into blocks of 8 hi then 8 lo values;
//   (d) mma.sync m16n8k16 (bf16 operands, f32 accumulators) adds hi*hi +
//       hi*lo + lo*hi for every 16 positions (hi*x + lo*x for bf16 x), the
//       weight rows as the A operand and the activation rows as B. The
//       dropped lo*lo term and the split's residual are ~2^-16 of each
//       product, well inside the kernels' 1e-4 tolerance; a plain bf16
//       product (~2^-9 per weight) is not.
// The copies run two slices ahead (two raw weight stages, three x planes)
// and the split weight planes are double-buffered: while slice s's products
// run, the weight threads dequantize slice s + 1, with one barrier per
// slice.
//
// Each output element depends only on its weight row, its activation row
// and the fixed order of slices, 16-position steps and passes, never on the
// other rows of its block. Rows past the valid ones (weight rows at or past
// `rows`, x rows marked -1) are copied as zeros and contribute exactly 0.
//
// Slice order: position kk = s * SV + ci * SEG + t (SV = SEG * NCH) is
// offset t of segment s of chunk c0 + ci, stored position
// Geo::seg_start(c0 + ci, s, K) + t; x is staged in this order (runs of SV
// positions per segment), and the weights land at the same kk.

#pragma once

#include "qmm_dequant.cuh"

namespace tpl {

constexpr int MMA_BM = 128;              // weight rows per block
constexpr int MMA_THREADS = 512;         // 16 warps: 4 along the rows x 4 along the columns
constexpr int MMA_NCH = 2;               // 32-position chunks per slice
constexpr int MMA_WT = MMA_BM * MMA_NCH; // weight threads: one (row, chunk) pair each
constexpr int MMA_BK = 32 * MMA_NCH;     // stored positions per slice
constexpr int MMA_LDS = MMA_BK + 8;      // bf16 row stride of the planes: conflict-free fragments
constexpr int MMA_WRAW = 2;              // raw weight stages
constexpr int MMA_XBUF = 3;              // x plane buffers
static_assert(MMA_WT <= MMA_THREADS, "every (row, chunk) pair has a thread");

// Shared-memory layout of one instance (byte offsets, all 16-aligned). The
// raw areas are private to each weight thread and laid out piece-major
// ([piece][thread] of 16 bytes, Q6's 8-byte runs [run][thread]), so that a
// warp's accesses are contiguous. XLO: x comes split into hi/lo blocks.
template <int KIND, bool XLO, typename ST, int BN>
struct MmaGeo {
  using GE = Geo<KIND>;
  static constexpr bool MIN = KIND != KIND_Q8;
  static constexpr int SV = GE::SEG * MMA_NCH;                      // x values per segment
  static constexpr int QCH = KIND == KIND_Q4 ? 16 : KIND == KIND_Q6 ? 24 : 32;  // q bytes per chunk
  static constexpr int SP = GE::SEG * (int)sizeof(ST) / 16;          // 16-byte scale pieces
  static constexpr int RQ = 0;
  static constexpr int RS = RQ + MMA_WT * QCH;
  static constexpr int RM = RS + MMA_WT * SP * 16;
  static constexpr int RAW = RM + (MIN ? MMA_WT * SP * 16 : 0);     // one raw stage
  static constexpr int WB = MMA_WRAW * RAW;
  static constexpr int WPLANE = MMA_BM * MMA_LDS * 2;                // one bf16 weight plane
  static constexpr int XB = WB + 4 * WPLANE;                         // [buffer][hi, lo]
  static constexpr int XPLANES = XLO ? 2 : 1;                        // hi (and lo) per buffer
  static constexpr int XPLANE = BN * MMA_LDS * 2;                    // one bf16 x plane
  static constexpr int BYTES = XB + MMA_XBUF * XPLANES * XPLANE;
  static constexpr int NG = BN / 32;                                 // n8 groups per warp
  static_assert(BN % 64 == 0 && SV % 8 == 0 && RAW % 16 == 0, "tile shapes");

  __device__ static __nv_bfloat16* w_plane(char* smem, int buf, int lo) {
    return reinterpret_cast<__nv_bfloat16*>(smem + WB + (2 * buf + lo) * WPLANE);
  }
  __device__ static __nv_bfloat16* x_plane(char* smem, int buf, int lo) {
    return reinterpret_cast<__nv_bfloat16*>(smem + XB + (XPLANES * buf + lo) * XPLANE);
  }
};

// 16 or 8 bytes, zeros where !valid. Both go through L1 (.ca): on the H100
// the 16-byte copies ran faster that way than bypassing it (.cg).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread but the N most recent has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give matrix i's rows): register i holds matrix i's
// fragment, (row lane / 4, columns 2 (lane % 4), 2 (lane % 4) + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(v), lo = bf16(v - hi) for two values, packed (first value low)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y)));
}

// f32 x -> bf16 hi/lo, in place: each block of 8 values becomes 8 hi then
// 8 lo values (the same 32 bytes). n8: the number of blocks.
static __global__ void __launch_bounds__(256) mma_split_x(uint4* __restrict__ x, size_t n8) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  const uint4 a = x[2 * i], b = x[2 * i + 1];
  uint4 h, l;
  split2(__uint_as_float(a.x), __uint_as_float(a.y), h.x, l.x);
  split2(__uint_as_float(a.z), __uint_as_float(a.w), h.y, l.y);
  split2(__uint_as_float(b.x), __uint_as_float(b.y), h.z, l.z);
  split2(__uint_as_float(b.z), __uint_as_float(b.w), h.w, l.w);
  x[2 * i] = h;
  x[2 * i + 1] = l;
}

// Weight thread `tid`'s raw copies of slice c0 (chunks c0, c0 + 1) into
// stage `st`: the packed bytes and scale (and min) columns of its (row,
// chunk) pair. The weight pointers are at the block's first row.
template <int KIND, bool XLO, typename ST, int BN>
__device__ __forceinline__ void mma_copy_w(char* st, const uint8_t* __restrict__ qa,
                                           const uint8_t* __restrict__ qb,
                                           const ST* __restrict__ scale,
                                           const ST* __restrict__ minv, int rows, int K,
                                           int c0) {
  using MG = MmaGeo<KIND, XLO, ST, BN>;
  using GE = Geo<KIND>;
  const int tid = threadIdx.x;
  const bool ok = tid / MMA_NCH < rows;
  const int r = ok ? tid / MMA_NCH : 0;  // rows past `rows` copy zeros from row 0's address
  const int c = c0 + tid % MMA_NCH;
  char* rq = st + MG::RQ;
  if constexpr (KIND == KIND_Q4) {
    cp_async<16>(rq + 16 * tid, qa + (size_t)r * (K / 2) + 16 * c, ok);
  } else if constexpr (KIND == KIND_Q6) {
    const uint8_t* row4 = qa + (size_t)r * (K / 2);
    cp_async<8>(rq + 8 * tid, row4 + 8 * c, ok);
    cp_async<8>(rq + 8 * (MMA_WT + tid), row4 + K / 4 + 8 * c, ok);
    cp_async<8>(rq + 8 * (2 * MMA_WT + tid), qb + (size_t)r * (K / 4) + 8 * c, ok);
  } else {
    const uint8_t* src = qa + (size_t)r * K + 32 * c;
    cp_async<16>(rq + 16 * tid, src, ok);
    cp_async<16>(rq + 16 * (MMA_WT + tid), src + 16, ok);
  }
  // the chunk's SEG scale (and min) values sit at columns (SEG * c + t) % G;
  // G is a multiple of a piece's PV values (the callers check), so each
  // 16-byte piece is one aligned run and the wrap falls between pieces
  constexpr int PV = 16 / (int)sizeof(ST);
  const int G = K / GE::GROUP;
#pragma unroll
  for (int p = 0; p < MG::SP; ++p) {
    const size_t col = (size_t)r * G + (GE::SEG * c + PV * p) % G;
    cp_async<16>(st + MG::RS + 16 * (p * MMA_WT + tid), scale + col, ok);
    if constexpr (MG::MIN)
      cp_async<16>(st + MG::RM + 16 * (p * MMA_WT + tid), minv + col, ok);
  }
}

// Slice c0's x into planes `buf`: bf16 rows (K values) or split rows (2K:
// blocks of 8 hi then 8 lo values), one 16-byte piece per copy.
template <int KIND, bool XLO, typename ST, int BN>
__device__ __forceinline__ void mma_copy_x(char* smem, int buf,
                                           const __nv_bfloat16* __restrict__ x,
                                           const int* xrow, int K, int c0) {
  using MG = MmaGeo<KIND, XLO, ST, BN>;
  using GE = Geo<KIND>;
  constexpr int PER_ROW = MMA_BK / 8 * MG::XPLANES;
#pragma unroll
  for (int i = threadIdx.x; i < BN * PER_ROW; i += MMA_THREADS) {
    const int col = i / PER_ROW, kk = 8 * (i % PER_ROW / MG::XPLANES);
    const int lo = XLO ? i % 2 : 0;
    const int xr = xrow[col];
    const int p = GE::seg_start(c0, kk / MG::SV, K) + kk % MG::SV;  // stored position
    const __nv_bfloat16* src = XLO ? x + (size_t)(xr < 0 ? 0 : xr) * 2 * K + 2 * p + 8 * lo
                                   : x + (size_t)(xr < 0 ? 0 : xr) * K + p;
    cp_async<16>(MG::x_plane(smem, buf, lo) + col * MMA_LDS + kk, src, xr >= 0);
  }
}

// Weight thread `tid`: dequantize and split its raw copies in stage `st`
// into weight planes `buf`.
template <int KIND, bool XLO, typename ST, int BN>
__device__ __forceinline__ void mma_split_w(char* smem, const char* st, int buf) {
  using MG = MmaGeo<KIND, XLO, ST, BN>;
  using GE = Geo<KIND>;
  const int tid = threadIdx.x;
  const int r = tid / MMA_NCH, ci = tid % MMA_NCH;
  const char* rq = st + MG::RQ;
  uint4 sv[MG::SP], mv[MG::SP];
#pragma unroll
  for (int p = 0; p < MG::SP; ++p) {
    sv[p] = reinterpret_cast<const uint4*>(st + MG::RS)[p * MMA_WT + tid];
    if constexpr (MG::MIN) mv[p] = reinterpret_cast<const uint4*>(st + MG::RM)[p * MMA_WT + tid];
  }
  const ST* s = reinterpret_cast<const ST*>(sv);
  const ST* m = MG::MIN ? reinterpret_cast<const ST*>(mv) : nullptr;
  float w[32];
  if constexpr (KIND == KIND_Q4) {
    const uint4 q = reinterpret_cast<const uint4*>(rq)[tid];
    decode_raw<KIND, ST>(reinterpret_cast<const uint8_t*>(&q), nullptr, nullptr, s, m, w);
  } else if constexpr (KIND == KIND_Q6) {
    const uint2 a = reinterpret_cast<const uint2*>(rq)[tid];
    const uint2 h = reinterpret_cast<const uint2*>(rq)[MMA_WT + tid];
    const uint2 q2 = reinterpret_cast<const uint2*>(rq)[2 * MMA_WT + tid];
    decode_raw<KIND, ST>(reinterpret_cast<const uint8_t*>(&a),
                         reinterpret_cast<const uint8_t*>(&h),
                         reinterpret_cast<const uint8_t*>(&q2), s, m, w);
  } else {
    uint4 q[2];
    q[0] = reinterpret_cast<const uint4*>(rq)[tid];
    q[1] = reinterpret_cast<const uint4*>(rq)[MMA_WT + tid];
    decode_raw<KIND, ST>(reinterpret_cast<const uint8_t*>(q), nullptr, nullptr, s, nullptr, w);
  }
  __nv_bfloat16* wh = MG::w_plane(smem, buf, 0) + r * MMA_LDS;
  __nv_bfloat16* wl = MG::w_plane(smem, buf, 1) + r * MMA_LDS;
#pragma unroll
  for (int sg = 0; sg < GE::NSEG; ++sg) {
#pragma unroll
    for (int t = 0; t < GE::SEG; t += 8) {
      uint4 h, l;
      const float* v = w + sg * GE::SEG + t;
      split2(v[0], v[1], h.x, l.x);
      split2(v[2], v[3], h.y, l.y);
      split2(v[4], v[5], h.z, l.z);
      split2(v[6], v[7], h.w, l.w);
      const int kk = sg * MG::SV + ci * GE::SEG + t;
      *reinterpret_cast<uint4*>(wh + kk) = h;
      *reinterpret_cast<uint4*>(wl + kk) = l;
    }
  }
}

// The widest BN (128 or 64) whose layout fits in a block's shared memory
// (227 KB, less 1 KB for the kernels' static arrays) and whose registers
// do not spill: Q6 with f32 scales spills at 128 (ptxas -v, sm_90a).
template <int KIND, bool XLO, typename ST>
constexpr int mma_bn() {
  if (KIND == KIND_Q6 && sizeof(ST) == 4) return 64;
  return MmaGeo<KIND, XLO, ST, 128>::BYTES <= 226 * 1024 ? 128 : 64;
}

// Split f32 x (n values, n % 8 == 0) in place for an XLO tile body.
inline cudaError_t mma_split_x_launch(float* x, size_t n, cudaStream_t st) {
  const size_t n8 = n / 8;
  mma_split_x<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(reinterpret_cast<uint4*>(x), n8);
  return cudaGetLastError();
}

// The products of 16-position steps [K0, K1) of weight planes `wbuf` and x
// planes `xbuf` for this warp's n8 groups [ja, jb) (ALL: every one of its
// NG groups, with no branch between the products). The loops run pass by
// pass over the warp's 2 x NG accumulators, so consecutive mma do not
// depend on each other; each accumulator still takes its passes in the
// fixed order.
template <int KIND, bool XLO, typename ST, int BN, int K0, int K1, bool ALL>
__device__ __forceinline__ void mma_steps_warp(char* smem, int wbuf, int xbuf, int ja, int jb,
                                               float (&acc)[2][BN / 32][4]) {
  using MG = MmaGeo<KIND, XLO, ST, BN>;
  constexpr int NG = MG::NG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int lr = lane & 7, li = lane >> 3;
  // A (weights, [row][k]): matrix li is rows 8 (li & 1).., k 8 (li >> 1)..
  const int a_off = (32 * wm + 8 * (li & 1) + lr) * MMA_LDS + 8 * (li >> 1);
  // B (x, [column][k]): matrix li is group li >> 1, k 8 (li & 1)..
  const int b_off = (8 * (NG * wn + (li >> 1)) + lr) * MMA_LDS + 8 * (li & 1);
  const __nv_bfloat16* wh = MG::w_plane(smem, wbuf, 0) + a_off;
  const __nv_bfloat16* wl = MG::w_plane(smem, wbuf, 1) + a_off;
  const __nv_bfloat16* xh = MG::x_plane(smem, xbuf, 0) + b_off;
  const __nv_bfloat16* xl = MG::x_plane(smem, xbuf, XLO ? 1 : 0) + b_off;
#pragma unroll
  for (int k = 16 * K0; k < 16 * K1; k += 16) {
    uint32_t ah[2][4], al[2][4], bh[NG / 2][4], bl[NG / 2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      ldsm_x4(ah[mi], wh + 16 * mi * MMA_LDS + k);
      ldsm_x4(al[mi], wl + 16 * mi * MMA_LDS + k);
    }
#pragma unroll
    for (int jp = 0; jp < NG / 2; ++jp) {
      if (!ALL && (2 * jp + 1 < ja || 2 * jp >= jb)) continue;
      ldsm_x4(bh[jp], xh + 16 * jp * MMA_LDS + k);
      if constexpr (XLO) ldsm_x4(bl[jp], xl + 16 * jp * MMA_LDS + k);
    }
    // pass 1: hi * hi (hi * x for bf16 x)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (ALL || (j >= ja && j < jb))
          mma_bf16(acc[mi][j], ah[mi], bh[j / 2][2 * (j % 2)], bh[j / 2][2 * (j % 2) + 1]);
    // pass 2 (split x): hi * lo
    if constexpr (XLO) {
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (ALL || (j >= ja && j < jb))
            mma_bf16(acc[mi][j], ah[mi], bl[j / 2][2 * (j % 2)], bl[j / 2][2 * (j % 2) + 1]);
    }
    // last pass: lo * hi (lo * x)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (ALL || (j >= ja && j < jb))
          mma_bf16(acc[mi][j], al[mi], bh[j / 2][2 * (j % 2)], bh[j / 2][2 * (j % 2) + 1]);
  }
}

// The products of steps [K0, K1) for the block's n8 column groups [j0, j1).
template <int KIND, bool XLO, typename ST, int BN, int K0, int K1>
__device__ __forceinline__ void mma_steps(char* smem, int wbuf, int xbuf, int j0, int j1,
                                          float (&acc)[2][BN / 32][4]) {
  constexpr int NG = BN / 32;
  const int wn = threadIdx.x >> 7;
  const int ja = max(j0 - NG * wn, 0), jb = min(j1 - NG * wn, NG);
  if (ja >= jb) return;  // none of this warp's groups
  if (ja == 0 && jb == NG)
    mma_steps_warp<KIND, XLO, ST, BN, K0, K1, true>(smem, wbuf, xbuf, 0, NG, acc);
  else
    mma_steps_warp<KIND, XLO, ST, BN, K0, K1, false>(smem, wbuf, xbuf, ja, jb, acc);
}

// acc += W[rows] . x[xrow] over chunks [c0, c1) (c1 - c0 even) for the
// block's n8 column groups [j0, j1); groups outside are left untouched.
// acc[mi][j][2 * h + c] is weight row 32 * wm + 16 * mi + g + 8 * h of the
// block and column 8 * (NG * wn + j) + 2 * tig + c (warp = 4 * wn + wm,
// lane = 4 * g + tig). x: bf16 rows of K, or (XLO) rows of 2K split by
// mma_split_x. Every thread of the block calls it with the same arguments;
// it begins with a barrier, so xrow may be written just before.
//
// Copy groups: slice t's x is copied in slice t - 2's step (group GX) and
// its raw weights in slice t - 3's (group GW), both issued two slices
// before their use; every thread commits every group (some empty), so
// "all but the 3 most recent groups" always names the one a step needs.
template <int KIND, bool XLO, typename ST, int BN>
__device__ __forceinline__ void mma_tile(char* smem, const __nv_bfloat16* __restrict__ x,
                                         const int* xrow, const uint8_t* __restrict__ qa,
                                         const uint8_t* __restrict__ qb,
                                         const ST* __restrict__ scale,
                                         const ST* __restrict__ minv, int rows, int K, int c0,
                                         int c1, int j0, int j1, float (&acc)[2][BN / 32][4]) {
  using MG = MmaGeo<KIND, XLO, ST, BN>;
  const int n = (c1 - c0) / MMA_NCH;
  const bool wt = threadIdx.x < MMA_WT;
  auto copy_w = [&](int sl) {
    if (wt && sl < n)
      mma_copy_w<KIND, XLO, ST, BN>(smem + (sl % MMA_WRAW) * MG::RAW, qa, qb, scale, minv, rows,
                                    K, c0 + sl * MMA_NCH);
    cp_async_commit();
  };
  auto copy_x = [&](int sl) {
    if (sl < n) mma_copy_x<KIND, XLO, ST, BN>(smem, sl % MMA_XBUF, x, xrow, K, c0 + sl * MMA_NCH);
    cp_async_commit();
  };
  auto split_w = [&](int sl) {
    mma_split_w<KIND, XLO, ST, BN>(smem, smem + (sl % MMA_WRAW) * MG::RAW, sl & 1);
  };
  __syncthreads();  // xrow written; the last run's readers are done
  copy_x(0);
  copy_w(0);
  copy_w(1);  // GW of slice -2
  copy_x(1);  // GX of slice -1
  cp_async_wait<2>();  // slice 0's x and weights
  if (wt) split_w(0);
  copy_w(2);  // GW of slice -1
  __syncthreads();
  for (int sl = 0; sl < n; ++sl) {
    copy_x(sl + 2);  // GX
    mma_steps<KIND, XLO, ST, BN, 0, 2>(smem, sl & 1, sl % MMA_XBUF, j0, j1, acc);
    cp_async_wait<3>();  // slice sl + 1's raw weights (GW of slice sl - 2)
    if (wt && sl + 1 < n) split_w(sl + 1);
    copy_w(sl + 3);  // GW, into the stage just consumed
    mma_steps<KIND, XLO, ST, BN, 2, MMA_BK / 16>(smem, sl & 1, sl % MMA_XBUF, j0, j1, acc);
    cp_async_wait<3>();  // slice sl + 1's x (GX of slice sl - 1)
    __syncthreads();
  }
}

}  // namespace tpl
