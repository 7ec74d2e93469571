// Group-scaled tensor-core tile body: the prefill routes of qmm_tiled
// (qmm.cu, T > 8; Pallas kernel `kernel` of quantized_matmul,
// tpullama/ops/pallas/qmm.py:296) and qmm_gathered_t (qmm_gathered_t.cuh,
// tiles of more than one row; Pallas kernel `kernel` of _qmm_gathered_t,
// qmm.py:771).
//
// The algebra is the reference's own (qmm.py:12-15, :241-253):
//   y[t, n] = sum_c s[n,c] * (sum_a q[n,c,a] * x[t, nu(c)*g + a])
//             - sum_c m[n,c] * xgsum[t, c]
// over the scale columns c of a row (G = K/g of them), a < g. All g weights
// of one column share one scale and one min, and their quantized values are
// small integers (0..15 Q4, 0..63 Q6, -128..127 Q8), exact in bf16. So the
// tensor cores multiply the raw integers by x (bf16, or f32 x split into
// bf16 hi + lo once per call) with no dequantized weight and no weight split,
// each column's sum is scaled once in f32, and the min term runs as its own
// small product (m16n8k8 over each slice's 4 columns, minv and xgsum split
// into bf16 hi/lo).
//
// Byte table: with G = K/g, column c's bytes lie at c + jG of each plane:
//   Q4 {q4}:     a < 16 the low nibble of q4[c + aG], a >= 16 the high
//                nibble of q4[c + (a-16)G]                       (j < 16)
//   Q6 {q4, q2}: nib(q4[c + (a%8)G], a/8) | crumb(q2[c + (a%4)G], a/4) << 4
//                                                     (j < 8 and j < 4)
//   Q5 {q4, q1}: nib(q4[c + (a%16)G], a/16) | bit(q1[c + (a%4)G], a/4) << 4
//                                                    (j < 16 and j < 4)
//   Q3 {q2, q1}: crumb(q2[c + (a%4)G], a/4) | bit(q1[c + (a%2)G], a/2) << 2
//                                                     (j < 4 and j < 2)
//   Q2 {q2}:     crumb(q2[c + (a%4)G], a/4)                       (j < 4)
//   Q8 {q8}:     the signed byte q8[c + aG]                      (j < 32)
//   MXFP4 {q4_lut}: Q4's nibble idx, the integer LUT[idx] (-12..12)
//   MXFP4 A/r {q4a, q1r}: Q5's nibble a and bit r, the integer 2 (a - 8) + r
// (qmm_dequant.cuh Planes; MXFP4's sets have no min term). A weight buffer
// holds the low plane's runs, then the high plane's (transposed stages
// likewise).
// Column c holds natural group nu(c): c in stripe order, (c % R)*(128/g) +
// c / R in fourblock order (R = K/128). The callers pass x in column order
// (x_col[t, c*g + a] = x[t, nu(c)*g + a]), so the body never permutes.
//
// What bounds it on an H100: operations (Llama-3-8B's 14336 x 4096 at a
// packed 1024-token chunk: 120 GFLOP, 0.12 ms at the bf16 peak). The weight
// side costs a byte permute, a mask and a bf16 subtraction per two weights,
// the products are one bf16 pass (two for f32 x), and the per-column scaling
// is one f32 FMA per accumulator per 32 products (16 for Q6_K). With one
// 8-warp block per SM (255 registers a thread) the copies, the unpacking,
// the products and the scaling barely overlap (scripts/torch_mma_probe.py),
// so the design keeps the copies off the warps' instruction streams: x and
// the row-major planes (bytes, scales, mins) come by tensor copies (TMA),
// issued by one warp and completed on mbarriers. A producer warpgroup with
// register moves (setmaxnreg) was slower on the H100: ptxas kept the
// consumers at 168 registers and spilled.
//
// Shape: one block of 8 warps computes 128 weight rows x BN activation
// columns (BN = 128, or 64 where three stages of 128 do not fit in shared
// memory); warp (wm, wn) = (warp % 4, warp / 4) holds rows 32 wm.. and
// columns BN/2 * wn... K is walked in slices of GM_CS = 4 scale columns, in
// a ring of up to 4 stages, each holding a slice's x (swizzled by the
// tensor copies; hi and lo for f32 x), its xgsum and, for transposed
// planes, its bytes, scales and mins (cp.async, 16-byte runs of 128 rows).
// Row-major planes come 16 columns (4 slices) at a time into two weight
// buffers. Copies run STAGES - 1 slices ahead; one block barrier per slice.
//
// Each output depends only on its own weight row, its own activation row
// and the fixed order of columns, k-steps and passes: a route is batch-
// invariant. Weight rows past the plane's last and x rows past the last
// (or marked -1) come as zeros and contribute exactly 0.
//
// Word layouts: row-major planes: buffer run j holds [row][16 columns]
// bytes, one 32-bit word is one row's bytes of a slice's 4 columns.
// Transposed planes ((kcols, R)): stage run j holds [column][128 rows], one
// word is 4 neighbouring rows of one column; the transposed route maps mma
// row g + 8h + 16mi of a warp to its weight row 4g + 2mi + h, so that one
// word feeds one lane, and GM_JW = 132 words per run keeps a warp's word
// loads on distinct banks.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "qmm_mma.cuh"

namespace tpl {

constexpr int GM_BM = 128;      // weight rows per block
constexpr int GM_THREADS = 256; // 8 warps: 4 along the rows x 2 along the columns
constexpr int GM_CS = 4;        // scale columns per slice
constexpr int GM_MAX_STAGES = 4;
constexpr int GM_BARS = GM_MAX_STAGES + 2;  // a stage's x, and the two weight buffers
constexpr int GM_JW = 132;      // words per byte run of a transposed stage (128 + 4)

template <int KIND, bool XLO, typename ST, int BN, bool TRANS>
struct GroupGeo {
  static constexpr int GROUP = Geo<KIND>::GROUP;
  static constexpr bool MIN = has_min<KIND>();
  static constexpr int KS = GROUP / 16;                    // k16 steps per column
  using P = Planes<KIND>;
  static constexpr int L = P::L;                           // the byte layout's set
  static constexpr int QJ = KIND == KIND_Q8 ? 32 : P::JL + P::JH;  // byte runs
  // runs one lane reads: 2 of each plane a k-half (4 of the q4 plane
  // over Q4/Q5's two k16 steps), 8 for Q8_0
  static constexpr int QL = KIND == KIND_Q8 ? 8
                            : (L == KIND_Q4 || L == KIND_Q5 ? 4 : 2) + (P::BH ? 2 : 0);
  static constexpr int SP = GM_CS * GROUP;                 // x positions per slice
  static constexpr int XPLANES = XLO ? 2 : 1;
  static constexpr int NB = SP * 2 * XPLANES / 128;        // 128-byte x boxes per row
  static constexpr int SCOL = GM_BM * GM_CS * (int)sizeof(ST);  // one slice of a scale plane
  // one slice stage, 1024-byte aligned: x first ([box][BN rows][128 bytes],
  // 128-byte swizzled by the tensor copies)
  static constexpr int WX = 0;
  static constexpr int WQ = WX + NB * BN * 128;            // transposed bytes: [run][GM_JW words]
  static constexpr int WS = WQ + (TRANS ? QJ * GM_JW * 4 : 0);  // transposed scales: [4][row]
  static constexpr int WM = WS + (TRANS ? SCOL : 0);       // transposed mins, likewise
  static constexpr int WG = WM + (TRANS && MIN ? SCOL : 0);  // xgsum: [col][4] hi, then lo
  static constexpr int STAGE = (WG + (MIN ? BN * GM_CS * 4 : 0) + 1023) / 1024 * 1024;
  // row-major planes: two buffers of WCOLS columns of every row, by tensor
  // copies: the bytes [run][row][WCOLS], then scales and mins [row][WCOLS]
  static constexpr int WCOLS = 16;
  static constexpr int WSL = WCOLS / GM_CS;                // slices per buffer
  static constexpr int BQ = 0;
  static constexpr int BS = BQ + QJ * GM_BM * WCOLS;
  static constexpr int BM = BS + GM_BM * WCOLS * (int)sizeof(ST);
  static constexpr int WBUF = TRANS ? 0 : BM + (MIN ? GM_BM * WCOLS * (int)sizeof(ST) : 0);
  // as many stages (4 at most) as fit beside the weight buffers, with 1 KB
  // of slack to align them; a buffer outlasts the 3 slices a step's copies
  // run ahead
  static constexpr int STAGES = 2 * WBUF + 4 * STAGE + 1024 <= 226 * 1024   ? 4
                                : 2 * WBUF + 3 * STAGE + 1024 <= 226 * 1024 ? 3
                                                                            : 2;
  static constexpr int RING = STAGES * STAGE;              // the weight buffers follow
  static constexpr int BYTES = RING + 2 * WBUF + 1024;
  static constexpr int NG = BN / 16;                       // n8 groups per warp
  static_assert(WS % 16 == 0 && NG % 4 == 0 && (SP * 2 * XPLANES) % 128 == 0, "stage layout");

  // shared address of the 16 bytes of x row n holding positions kpos ..
  // kpos + 7 of the slice (hi, or with lo = 1 the lo half of split x): the
  // 128-byte swizzle puts 16-byte chunk c of row n at chunk c ^ (n % 8)
  __device__ static unsigned x_addr(unsigned st, int n, int kpos, int lo) {
    const int kc = XLO ? 2 * (kpos >> 3) + lo : kpos >> 3;
    return st + WX + (kc >> 3) * BN * 128 + n * 128 + (((kc & 7) ^ (n & 7)) << 4);
  }
  // byte run of lane-local run index q (see the header note): a lane's
  // k positions are a = 16 ks + 8 kh + 2 tig + e (g = 32) or 8 kh + 2 tig
  // + e (g = 16), e = q & 1
  __device__ static int run(int q, int tig) {
    if constexpr (L == KIND_Q8) return 16 * (q >> 2) + 2 * tig + (q & 1) + 8 * ((q >> 1) & 1);
    else if constexpr (L == KIND_Q6) return q < 2 ? 2 * tig + q : 8 + 2 * (tig & 1) + (q & 1);
    else if constexpr (L == KIND_Q5)  // a % 16, then the q1 runs a % 4
      return q < 4 ? 2 * tig + (q & 1) + 8 * (q >> 1) : 16 + 2 * (tig & 1) + (q & 1);
    else if constexpr (L == KIND_Q3)  // a % 4 of q2, then a % 2 of q1
      return q < 2 ? 2 * (tig & 1) + q : 4 + (q & 1);
    else if constexpr (L == KIND_Q2) return 2 * (tig & 1) + q;
    else return 2 * tig + (q & 1) + 8 * (q >> 1);
  }
  // warp-local weight row of accumulator row (mi, h) of lane group g
  __device__ static int row(int mi, int h, int g) {
    return TRANS ? 4 * g + 2 * mi + h : 16 * mi + 8 * h + g;
  }
};

// The widest BN (128 or 64) for which three slice stages (and the
// row-major weight buffers) fit in a block's shared memory (227 KB, less
// 1 KB for the kernels' static arrays); a fourth stage is added where it
// fits too. MXFP4's LUT set on transposed planes takes 64: at 128 its
// table lookups spilled 156-356 bytes (ptxas -v, sm_90a) and it ran 4.49 ms
// at Mixtral's down over 2048 slots, against 3.35 for the A/r set at 64
// (NVIDIA H100 80GB HBM3, 700.00 W).
template <int KIND, bool XLO, typename ST, bool TRANS>
constexpr int group_bn() {
  using G128 = GroupGeo<KIND, XLO, ST, 128, TRANS>;
  if (KIND == KIND_MXFP4 && TRANS) return 64;
  return 2 * G128::WBUF + 3 * G128::STAGE + 1024 <= 226 * 1024 ? 128 : 64;
}

// Tensor copies of x: `boxes` boxes of `rows` rows each, box r from global
// row row0 + r * step into shared rows 8 r .. (one box of BN rows for
// qmm_tiled; one per tile of tt rows for qmm_gathered_t).
struct GroupX {
  const CUtensorMap* map;
  int row0, step, rows, boxes;
};

// A 2-D tensor map over rows of `inner` elements of type dt spaced
// row_bytes apart: boxes of box_inner x box_rows, zeros past the edges.
// Returns a CUDA error code.
inline int group_map(CUtensorMap* m, CUtensorMapDataType dt, const void* base,
                     long long inner, long long rows, long long row_bytes, int box_inner,
                     int box_rows, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(m, dt, 2, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Column-order x for group_copy_x: bf16 rows of row_elems values (K, or 2K
// for split f32 x), boxes of 64 values x box_rows rows, 128-byte swizzle.
inline int group_x_map(CUtensorMap* m, const void* x, int row_elems, int rows, int box_rows) {
  return group_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, row_elems, rows,
                   (long long)row_elems * 2, 64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The row-major planes of one matrix for the weight buffers: the low
// plane (q4, q8, or q2 for Q3_K/Q2_K), the high plane (q2 of Q6_K, q1 of
// Q5/Q3_K) and the scale and min planes, in boxes of 16 columns x 128 rows.
// Returns a CUDA error code.
template <int KIND, typename ST>
inline int group_w_maps(CUtensorMap (&m)[4], const void* qa, const void* qb, const void* s,
                        const void* mn, int N, int K) {
  using P = Planes<KIND>;
  const int G = K / P::GROUP;
  const long long qcols = (long long)K / 8 * P::BL, hcols = (long long)K / 8 * P::BH;
  const CUtensorMapDataType sdt =
      sizeof(ST) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  int err = group_map(&m[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, qa, qcols, N, qcols, 16, GM_BM, none);
  if (!err && P::BH)
    err = group_map(&m[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, qb, hcols, N, hcols, 16, GM_BM, none);
  if (!err)
    err = group_map(&m[2], sdt, s, G, N, (long long)G * sizeof(ST), 16, GM_BM, none);
  if (!err && has_min<KIND>())
    err = group_map(&m[3], sdt, mn, G, N, (long long)G * sizeof(ST), 16, GM_BM, none);
  return err;
}

__device__ __forceinline__ void gm_bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void gm_bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` of barrier bar. A phase that never
// completes (a lost copy) traps after ~2^34 cycles (~9 s) instead of hanging
// the card.
__device__ __forceinline__ void gm_bar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// Warp 0: the tensor copies of slice x positions [p0, p0 + SP) into stage
// st, completing on barrier bar (which expects their bytes first).
template <int KIND, bool XLO, typename ST, int BN, bool TRANS>
__device__ __forceinline__ void group_copy_x(unsigned st, unsigned bar, const GroupX& gx, int p0) {
  using GG = GroupGeo<KIND, XLO, ST, BN, TRANS>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) gm_bar_expect(bar, (unsigned)(GG::NB * gx.boxes * gx.rows * 128));
  __syncwarp();
  const int e0 = (XLO ? 2 * p0 : p0);  // first bf16 element of the slice in a row
  for (int i = lane; i < GG::NB * gx.boxes; i += 32) {
    const int b = i % GG::NB, r = i / GG::NB;
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(st + GG::WX + b * BN * 128 + r * 8 * 128),
        "l"(reinterpret_cast<uint64_t>(gx.map)), "r"(e0 + 64 * b), "r"(gx.row0 + r * gx.step),
        "r"(bar)
        : "memory");
  }
}

// 4, 8 or 16 bytes, zeros where !valid, through L1 (.ca)
template <int BYTES>
__device__ __forceinline__ void gm_cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(BYTES),
               "r"(valid ? BYTES : 0) : "memory");
}

// The row-major planes' tensor maps (group_w_maps), a kernel argument.
struct GroupMaps {
  CUtensorMap m[4];
};

// One block's weights. Transposed planes: pointers at the expert's planes
// and the block's first row (byte (kc, r) at kc * ld + r; the high plane's
// at qb, likewise). Row-major
// planes: group_w_maps' tensor maps and the block's first row n0, and the
// low and high planes themselves (qa, rows of ld bytes, n_rows of them;
// qb, rows of ldb bytes) for byte runs the tensor copies cannot start
// (group_copy_wbytes).
template <typename ST>
struct GroupW {
  const uint8_t* qa;  // the low plane (transposed: q4, q4_lut, q4a or q8)
  const ST* scale;
  const ST* minv;     // null for the sets without a min plane
  int ld;             // the planes' row stride: R (transposed), bytes (row-major)
  const CUtensorMap* maps;
  int n0;
  int n_rows;         // row-major: the plane's rows
  const uint8_t* qb = nullptr;  // the high plane (Q5's q1, the A/r set's q1r), or null
  int ldb = 0;
};

// Columns of group_prep's xgsum planes per row: G rounded up to a whole
// slice, so that a slice's 4 values are one aligned 8-byte copy.
__host__ __device__ __forceinline__ int group_xg_cols(int G) { return (G + GM_CS - 1) / GM_CS * GM_CS; }

// cp.async copies of slice c0 (scale columns c0 .. c0 + 3) into stage st
// by threads tid = 0 .. nthr - 1: the raw bytes, scales and mins of
// transposed planes (row-major ones come by group_copy_wt), and xgsum (xg:
// group_prep's planes, hi then lo, xg_rows rows of group_xg_cols(G)) for
// the min term. x comes by group_copy_x. Columns at or past G (the last
// slice when G % 4 != 0) come as zero bytes, and their scales, mins and
// xgsum are zeros too (the transposed scale planes are zero-padded).
template <int KIND, bool XLO, typename ST, int BN, bool TRANS>
__device__ __forceinline__ void group_copy(char* st, const GroupW<ST>& w,
                                           const __nv_bfloat16* __restrict__ xg, int xg_rows,
                                           const int* xrow, int K, int c0, int tid, int nthr) {
  using GG = GroupGeo<KIND, XLO, ST, BN, TRANS>;
  const int G = K / GG::GROUP;
  const int GX = group_xg_cols(G);
  char* wq = st + GG::WQ;
  if constexpr (TRANS) {
    // run j, column cc: 128 row bytes at plane row c0 + cc + jG (the high
    // plane's runs, j >= JL, at its row c0 + cc + (j - JL)G)
    constexpr int JL = KIND == KIND_Q8 ? GG::QJ : Planes<KIND>::JL;
    for (int i = tid; i < GG::QJ * GM_CS * 8; i += nthr) {
      const int j = i / (GM_CS * 8), cc = i / 8 % GM_CS, p = i % 8;
      const bool ok = c0 + cc < G;
      const bool high = j >= JL;
      const uint8_t* src = (high ? w.qb : w.qa) +
                           (size_t)(ok ? c0 + cc + (high ? j - JL : j) * G : 0) * w.ld + 16 * p;
      gm_cp_async<16>(wq + (j * GM_JW + cc * 32) * 4 + 16 * p, src, ok);
    }
    constexpr int SPC = GM_BM * (int)sizeof(ST) / 16;  // 16-byte pieces per column
    for (int i = tid; i < (GG::MIN ? 2 : 1) * GM_CS * SPC; i += nthr) {
      const int pl = i / (GM_CS * SPC), cc = i / SPC % GM_CS, p = i % SPC;
      const ST* src = (pl ? w.minv : w.scale) + (size_t)(c0 + cc) * w.ld;
      gm_cp_async<16>(st + (pl ? GG::WM : GG::WS) + 16 * (i % (GM_CS * SPC)),
                      reinterpret_cast<const char*>(src) + 16 * p, true);
    }
  }
  if constexpr (GG::MIN) {
    // xgsum of the slice's 4 columns: 8 bytes of hi and of lo per x row
    for (int i = tid; i < 2 * BN; i += nthr) {
      const int lo = i / BN, col = i % BN;
      const int xr = xrow[col];
      gm_cp_async<8>(st + GG::WG + 8 * i,
                     xg + (size_t)lo * xg_rows * GX + (size_t)(xr < 0 ? 0 : xr) * GX + c0, xr >= 0);
    }
  }
}

// Warp 0, row-major planes: the tensor copies of columns c0 .. c0 + 15 of
// the block's rows (every run's bytes, the scales and the mins) into the
// weight buffer at wb, completing on barrier bar. Rows past the plane's
// last come as zeros. A tensor copy must start on a 16-byte boundary, and
// run j starts at byte c0 + jG of a row: without bytes (G % 16 != 0) only
// the scales and mins come here, the runs by group_copy_wbytes.
template <int KIND, bool XLO, typename ST, int BN, bool TRANS>
__device__ __forceinline__ void group_copy_wt(unsigned wb, unsigned bar, const GroupW<ST>& w,
                                              int K, int c0, bool bytes) {
  using GG = GroupGeo<KIND, XLO, ST, BN, TRANS>;
  constexpr int NBOX = GG::QJ + (GG::MIN ? 2 : 1);
  constexpr int QBYTES = GG::QJ * GM_BM * GG::WCOLS;
  const int G = K / GG::GROUP;
  const int lane = threadIdx.x & 31;
  if (lane == 0) gm_bar_expect(bar, (unsigned)(bytes ? GG::WBUF : GG::WBUF - QBYTES));
  __syncwarp();
  constexpr int JL = KIND == KIND_Q8 ? GG::QJ : Planes<KIND>::JL;
  for (int i = bytes ? lane : GG::QJ + lane; i < NBOX; i += 32) {
    const bool high = i >= JL && i < GG::QJ;  // a run of the high plane
    const CUtensorMap* map = i < GG::QJ ? &w.maps[high ? 1 : 0] : &w.maps[i == GG::QJ ? 2 : 3];
    const int col = i < GG::QJ ? c0 + (high ? i - JL : i) * G : c0;
    const unsigned dst = wb + (i < GG::QJ ? GG::BQ + i * GM_BM * GG::WCOLS
                                          : i == GG::QJ ? GG::BS : GG::BM);
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(w.n0), "r"(bar)
        : "memory");
  }
}

// Row-major planes of g = 32 whose runs are not 16-byte aligned (G % 16 !=
// 0; G % 8 == 0): the byte runs of columns c0 .. c0 + 15 (the low plane's,
// then Q5's q1 runs) by 8-byte cp.async into the weight buffer at wb, by
// threads tid = 0 .. nthr - 1, in the tensor copies' layout. Rows past
// n_rows and columns at or past G (the last buffer of a row) come as zeros.
template <int KIND, bool XLO, typename ST, int BN, bool TRANS>
__device__ __forceinline__ void group_copy_wbytes(char* wb, const GroupW<ST>& w, int K, int c0,
                                                  int tid, int nthr) {
  using GG = GroupGeo<KIND, XLO, ST, BN, TRANS>;
  static_assert(GG::GROUP == 32, "g = 16 planes keep G % 16 == 0 (K % 256)");
  constexpr int JL = KIND == KIND_Q8 ? GG::QJ : Planes<KIND>::JL;
  const int G = K / GG::GROUP;
  for (int i = tid; i < GG::QJ * GM_BM * 2; i += nthr) {
    const int j = i / (2 * GM_BM), r = i / 2 % GM_BM, h = i % 2;
    const bool ok = w.n0 + r < w.n_rows && c0 + 8 * h < G;
    const bool high = j >= JL;
    const uint8_t* src =
        (high ? w.qb : w.qa) +
        (ok ? (size_t)(w.n0 + r) * (high ? w.ldb : w.ld) + c0 + (high ? j - JL : j) * G + 8 * h
            : 0);
    gm_cp_async<8>(wb + GG::BQ + (j * GM_BM + r) * GG::WCOLS + 8 * h, src, ok);
  }
}

// Two bf16 integers from byte `bi` of words u (first) and v: the byte pair
// as [u.b, u.b, v.b, v.b], for the unpacking below.
__device__ __forceinline__ uint32_t gm_pair(uint32_t u, uint32_t v, int bi) {
  return __byte_perm(u, v, (unsigned)(bi | bi << 4 | (4 + bi) << 8 | (4 + bi) << 12));
}

// 0x4300 | v is bf16 128 + v for v < 128; subtracting 128 leaves v exactly
// (subtracting `bias` >= 128, v - (bias - 128): MXFP4's biased values).
__device__ __forceinline__ uint32_t gm_bf16_ints(uint32_t biased, float bias = 128.f) {
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased), __floats2bfloat162_rn(bias, bias));
  return bf16x2_bits(r);
}

// ldsm_x4 from a shared address
__device__ __forceinline__ void gm_ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d = a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 out: mma_bf16
// with zero accumulators, which need no zeroed registers
__device__ __forceinline__ void gm_mma_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += a (16 x 8, row) * b (8 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void gm_mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

template <int KIND, bool XLO, typename ST, int BN, bool TRANS>
struct GroupWarp {
  using GG = GroupGeo<KIND, XLO, ST, BN, TRANS>;
  static constexpr int NG = GG::NG;
  static constexpr int NH = 2;  // n8 groups per part: one ldmatrix x4 of x

  // The A fragment (a[mi][4], rows of `row`, k-step ks) of column cc from
  // this lane's words: wd(q, rs) is run q's word for row set rs = 2 mi + h
  // (row-major: byte cc; transposed: the column's word, byte rs).
  template <typename WD>
  __device__ static void frag_a(const WD& wd, int cc, int ks, int tig, uint32_t (&a)[2][4]) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rs = 2 * mi + h;
        const int bi = TRANS ? rs : cc;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          uint32_t v;
          if constexpr (KIND == KIND_Q4) {
            const uint32_t t = gm_pair(wd(2 * kh, rs), wd(2 * kh + 1, rs), bi);
            v = gm_bf16_ints(((ks ? t >> 4 : t) & 0x000F000Fu) | 0x43004300u);
          } else if constexpr (KIND == KIND_MXFP4) {
            // Q4's nibbles, through the table: 12 + LUT[idx] per half
            const uint32_t t = gm_pair(wd(2 * kh, rs), wd(2 * kh + 1, rs), bi);
            const uint32_t u = mxfp4_biased((ks ? t >> 4 : t) & 0x000F000Fu) & 0x00FF00FFu;
            v = gm_bf16_ints(u | 0x43004300u, 140.f);
          } else if constexpr (KIND == KIND_MXFP4_AR) {
            // Q5's nibble a and bit r as 16 + 2 (a - 8) + r = 2 a + r
            const uint32_t t = gm_pair(wd(2 * kh, rs), wd(2 * kh + 1, rs), bi);
            const uint32_t t1 = gm_pair(wd(4, rs), wd(5, rs), bi);
            const int bs = 4 * ks + 2 * kh + (tig >> 1);
            v = gm_bf16_ints((((ks ? t >> 4 : t) & 0x000F000Fu) << 1) |
                             ((t1 >> bs) & 0x00010001u) | 0x43004300u, 144.f);
          } else if constexpr (KIND == KIND_Q6) {
            const uint32_t t4 = gm_pair(wd(0, rs), wd(1, rs), bi);
            const uint32_t t2 = gm_pair(wd(2, rs), wd(3, rs), bi);
            const int cs = 2 * (2 * kh + (tig >> 1));  // crumb shift
            v = gm_bf16_ints(((t4 >> (4 * kh)) & 0x000F000Fu) |
                             (((t2 >> cs) & 0x00030003u) << 4) | 0x43004300u);
          } else if constexpr (KIND == KIND_Q5) {
            // nibble ks of runs a % 16, bit a / 4 = 4 ks + 2 kh + tig / 2
            // of runs a % 4
            const uint32_t t = gm_pair(wd(2 * kh, rs), wd(2 * kh + 1, rs), bi);
            const uint32_t t1 = gm_pair(wd(4, rs), wd(5, rs), bi);
            const int bs = 4 * ks + 2 * kh + (tig >> 1);
            v = gm_bf16_ints(((ks ? t >> 4 : t) & 0x000F000Fu) |
                             (((t1 >> bs) & 0x00010001u) << 4) | 0x43004300u);
          } else if constexpr (KIND == KIND_Q3 || KIND == KIND_Q2) {
            // crumb a / 4 = 2 kh + tig / 2 of runs a % 4; Q3_K's bit
            // a / 2 = 4 kh + tig of runs a % 2
            const uint32_t t2 = gm_pair(wd(0, rs), wd(1, rs), bi);
            uint32_t u = (t2 >> (2 * (2 * kh + (tig >> 1)))) & 0x00030003u;
            if constexpr (KIND == KIND_Q3)
              u |= ((gm_pair(wd(2, rs), wd(3, rs), bi) >> (4 * kh + tig)) & 0x00010001u) << 2;
            v = gm_bf16_ints(u | 0x43004300u);
          } else {
            const uint32_t t = gm_pair(wd(4 * ks + 2 * kh, rs), wd(4 * ks + 2 * kh + 1, rs), bi);
            v = bf16x2_bits(__floats2bfloat162_rn((float)(int8_t)(t & 0xff),
                                                  (float)(int8_t)((t >> 16) & 0xff)));
          }
          a[mi][2 * kh + h] = v;
        }
      }
  }

  // The products of the slice in stage st (row-major planes: its bytes are
  // word cg of each row of buffer wb) for this warp's n8 groups
  // [ja, jb) (ALL: every one, with no branch around the products): per
  // column and part of the groups, the raw integers times x summed in ca
  // (the first products with zero accumulators), then folded into acc with the column's scale. Each ca
  // element takes its k-steps and passes in a fixed order.
  template <bool ALL>
  __device__ static void slice(const char* st, const char* wb, int cg, int ja, int jb,
                               float (&acc)[2][NG][4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, tig = lane & 3;
    const int lr = lane & 7, li = lane >> 3;
    const uint32_t* wq = reinterpret_cast<const uint32_t*>(st + GG::WQ);
    const ST* ss = reinterpret_cast<const ST*>(st + GG::WS);
    float sv[GM_CS][4];  // [column][row set 2 mi + h]
    uint32_t w[GG::QL][4];
    if constexpr (TRANS) {
#pragma unroll
      for (int cc = 0; cc < GM_CS; ++cc) {
        float f[4];
        load_f<ST, 4>(ss + cc * GM_BM + 32 * wm + 4 * g, f);
#pragma unroll
        for (int rs = 0; rs < 4; ++rs) sv[cc][rs] = f[rs];
      }
    } else {
#pragma unroll
      for (int rs = 0; rs < 4; ++rs) {
        const int r = 32 * wm + GG::row(rs >> 1, rs & 1, g);
        float f[4];
        load_f<ST, 4>(reinterpret_cast<const ST*>(wb + GG::BS) + r * GG::WCOLS + GM_CS * cg, f);
#pragma unroll
        for (int cc = 0; cc < GM_CS; ++cc) sv[cc][rs] = f[cc];
#pragma unroll
        for (int q = 0; q < GG::QL; ++q)
          w[q][rs] = reinterpret_cast<const uint32_t*>(
              wb)[(GG::run(q, tig) * GM_BM + r) * (GG::WCOLS / 4) + cg];
      }
    }
    const unsigned sx = (unsigned)__cvta_generic_to_shared(st);
    const int nb = 8 * (NG * wn + (li >> 1)) + lr;  // this lane's ldmatrix row, first group pair
#pragma unroll
    for (int cc = 0; cc < GM_CS; ++cc) {
      if constexpr (TRANS) {
#pragma unroll
        for (int q = 0; q < GG::QL; ++q)
          w[q][0] = wq[GG::run(q, tig) * GM_JW + cc * 32 + 8 * wm + g];
      }
      auto wd = [&](int q, int rs) { return TRANS ? w[q][0] : w[q][rs]; };
      uint32_t a[GG::KS][2][4];
#pragma unroll
      for (int ks = 0; ks < GG::KS; ++ks) frag_a(wd, cc, ks, tig, a[ks]);
      // the warp's groups in parts of NH, so that one part's column sums
      // (ca) are live at a time
#pragma unroll
      for (int hf = 0; hf < NG / NH; ++hf) {
        const int h0 = hf * NH;
        if (!ALL && (h0 + NH <= ja || h0 >= jb)) continue;
        float ca[2][NH][4];
#pragma unroll
        for (int ks = 0; ks < GG::KS; ++ks) {
#pragma unroll
          for (int p = 0; p < GG::XPLANES; ++p) {
            const int kpos = cc * GG::GROUP + 16 * ks + 8 * (li & 1);
            uint32_t b[NH / 2][4];
#pragma unroll
            for (int jp = 0; jp < NH / 2; ++jp) {
              if (!ALL && (h0 + 2 * jp + 1 < ja || h0 + 2 * jp >= jb)) continue;
              gm_ldsm_x4(b[jp], GG::x_addr(sx, nb + 8 * h0 + 16 * jp, kpos, p));
            }
#pragma unroll
            for (int j = 0; j < NH; ++j)
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
                if (ALL || (h0 + j >= ja && h0 + j < jb)) {
                  if (ks == 0 && p == 0)  // the column's first products
                    gm_mma_first(ca[mi][j], a[ks][mi], b[j / 2][2 * (j % 2)],
                                 b[j / 2][2 * (j % 2) + 1]);
                  else
                    mma_bf16(ca[mi][j], a[ks][mi], b[j / 2][2 * (j % 2)],
                             b[j / 2][2 * (j % 2) + 1]);
                }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < NH; ++j)
            if (ALL || (h0 + j >= ja && h0 + j < jb))
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[mi][h0 + j][e] =
                    fmaf(sv[cc][2 * mi + (e >> 1)], ca[mi][j][e], acc[mi][h0 + j][e]);
      }
    }
    if constexpr (GG::MIN) GroupWarp::template min_slice<ALL>(st, wb, cg, ja, jb, acc);
  }

  // acc -= minv . xgsum over the slice's 4 columns, on the tensor cores:
  // m16n8k8 products whose k = 0..3 are the columns (lanes tig < 2) and
  // k = 4..7 zeros; -minv split into bf16 hi/lo (lo is 0 for bf16 planes),
  // xgsum staged as bf16 hi and lo.
  template <bool ALL>
  __device__ static void min_slice(const char* st, const char* wb, int cg, int ja, int jb,
                                   float (&acc)[2][NG][4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, tig = lane & 3;
    const ST* sm = reinterpret_cast<const ST*>(TRANS ? st + GG::WM : wb + GG::BM);
    const __nv_bfloat16* sg = reinterpret_cast<const __nv_bfloat16*>(st + GG::WG);
    uint32_t mh[2][2] = {{0u, 0u}, {0u, 0u}}, ml[2][2] = {{0u, 0u}, {0u, 0u}};
    if (tig < 2) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m0, m1;
          if constexpr (TRANS) {
            const int r = 32 * wm + 4 * g + 2 * mi + h;
            m0 = to_f(sm[2 * tig * GM_BM + r]);
            m1 = to_f(sm[(2 * tig + 1) * GM_BM + r]);
          } else {
            const int r = 32 * wm + GG::row(mi, h, g);
            m0 = to_f(sm[r * GG::WCOLS + GM_CS * cg + 2 * tig]);
            m1 = to_f(sm[r * GG::WCOLS + GM_CS * cg + 2 * tig + 1]);
          }
          split2(-m0, -m1, mh[mi][h], ml[mi][h]);
        }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (!ALL && (j < ja || j >= jb)) continue;
      uint32_t bh = 0u, bl = 0u;
      if (tig < 2) {
        const int o = (8 * (NG * wn + j) + g) * GM_CS + 2 * tig;
        bh = *reinterpret_cast<const uint32_t*>(sg + o);
        bl = *reinterpret_cast<const uint32_t*>(sg + BN * GM_CS + o);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        gm_mma_k8(acc[mi][j], mh[mi][0], mh[mi][1], bh);
        gm_mma_k8(acc[mi][j], mh[mi][0], mh[mi][1], bl);
        if constexpr (sizeof(ST) == 4) gm_mma_k8(acc[mi][j], ml[mi][0], ml[mi][1], bh);
      }
    }
  }
};

// acc += W . x over all of K for the block's n8 column groups [j0, j1)
// (groups outside are left untouched), the min term included.
// acc[mi][j][2 h + c] is weight row 32 wm + GroupGeo::row(mi, h, g) of the
// block and column 8 (NG wn + j) + 2 tig + c (warp = 4 wn + wm, lane = 4 g
// + tig). x comes through the tensor copies gx; xrow (-1 for none) and xg
// (group_prep's xgsum planes over xg_rows rows, unused for Q8) feed the min
// term. bars: shared address of GM_BARS barriers of 8 bytes, each
// initialised to one arrival (the stages' x, then the row-major weight
// buffers' tensor copies); phases: their next parities,
// carried from call to call. Every thread of the block calls it with the
// same arguments; it begins with a barrier, so xrow may be written just
// before.
//
// Copy groups: slice s's copies are issued in slice s - STAGES + 1's step
// (the first STAGES - 1 before the loop), with, for row-major planes, the
// next buffer of WCOLS columns' bytes when s starts one; every thread
// commits one cp.async group per step, so "all but the STAGES - 2 most
// recent" names the slice a step needs, and its x barrier the slice's
// tensor copies. One block barrier per slice: it publishes that slice's
// copies and frees the stage (and buffer) the step's copies overwrite.
template <int KIND, bool XLO, typename ST, int BN, bool TRANS>
__device__ __forceinline__ void group_tile(char* smem, const GroupX& gx, const int* xrow,
                                           const __nv_bfloat16* __restrict__ xg, int xg_rows,
                                           const GroupW<ST>& w, int K, int j0, int j1,
                                           unsigned bars, unsigned& phases,
                                           float (&acc)[2][BN / 16][4]) {
  using GG = GroupGeo<KIND, XLO, ST, BN, TRANS>;
  using GW = GroupWarp<KIND, XLO, ST, BN, TRANS>;
  constexpr int NG = GG::NG;
  constexpr int S = GG::STAGES;
  static_assert(GG::BYTES <= 227 * 1024, "shared memory");
  const int n = (K / GG::GROUP + GM_CS - 1) / GM_CS;  // slices; the last may be partial
  const bool wbytes = !TRANS && (K / GG::GROUP) % 16 == 0;  // byte runs by tensor copies
  const int wn = threadIdx.x >> 7;
  const int ja = max(j0 - NG * wn, 0), jb = min(j1 - NG * wn, NG);
  // the stages, 1024-byte aligned for the swizzled tensor copies; the
  // weight buffers after them
  const unsigned s0 = (unsigned)__cvta_generic_to_shared(smem);
  char* ring = smem + (((s0 + 1023) & ~1023u) - s0);
  char* wbuf = ring + GG::RING;
  auto copy = [&](int sl) {
    if (sl < n) {
      char* st = ring + (sl % S) * GG::STAGE;
      if (threadIdx.x < 32) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the reads
        group_copy_x<KIND, XLO, ST, BN, TRANS>((unsigned)__cvta_generic_to_shared(st),
                                               bars + 8 * (sl % S), gx, sl * GM_CS * GG::GROUP);
        if (!TRANS && sl % GG::WSL == 0) {
          const int b = sl / GG::WSL % 2;
          group_copy_wt<KIND, XLO, ST, BN, TRANS>(
              (unsigned)__cvta_generic_to_shared(wbuf + b * GG::WBUF),
              bars + 8 * (GM_MAX_STAGES + b), w, K, sl * GM_CS, wbytes);
        }
      }
      if constexpr (!TRANS && GG::GROUP == 32) {
        // in this slice's cp.async group, which its step waits for
        if (!wbytes && sl % GG::WSL == 0)
          group_copy_wbytes<KIND, XLO, ST, BN, TRANS>(wbuf + sl / GG::WSL % 2 * GG::WBUF, w, K,
                                                      sl * GM_CS, threadIdx.x, GM_THREADS);
      }
      group_copy<KIND, XLO, ST, BN, TRANS>(st, w, xg, xg_rows, xrow, K, sl * GM_CS, threadIdx.x,
                                           GM_THREADS);
    }
    cp_async_commit();
  };
  __syncthreads();  // xrow written; the last run's readers of the ring are done
#pragma unroll
  for (int s = 0; s < S - 1; ++s) copy(s);
  for (int sl = 0; sl < n; ++sl) {
    const int s = sl % S;
    cp_async_wait<S - 2>();                    // slice sl's cp.async copies (this thread's)
    gm_bar_wait(bars + 8 * s, (phases >> s) & 1);  // and its x
    phases ^= 1u << s;
    if (!TRANS && sl % GG::WSL == 0) {  // and its weight buffer
      const int b = GM_MAX_STAGES + sl / GG::WSL % 2;
      gm_bar_wait(bars + 8 * b, (phases >> b) & 1);
      phases ^= 1u << b;
    }
    __syncthreads();  // everyone's copies; slice sl - 1's readers are done
    copy(sl + S - 1);  // into the stage slice sl - 1 held
    const char* st = ring + s * GG::STAGE;
    const char* wb = wbuf + (sl / GG::WSL % 2) * GG::WBUF;
    if (ja == 0 && jb == NG)
      GW::template slice<true>(st, wb, sl % GG::WSL, 0, NG, acc);
    else if (ja < jb)
      GW::template slice<false>(st, wb, sl % GG::WSL, ja, jb, acc);
  }
}

// Thread 0: group_tile's barriers (GM_BARS), one arrival each.
__device__ __forceinline__ void group_bars_init(uint64_t* bars) {
  for (int s = 0; s < GM_BARS; ++s) gm_bar_init((unsigned)__cvta_generic_to_shared(bars + s), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread per (row, scale column) of column-order x, rows of G columns:
// xgsum (the f32 sum of the column's g values, in order) as bf16 hi and lo
// into xg's two planes of rows x GX columns (MIN; columns at or past G are
// zeros), and f32 x split in place into blocks of 8 hi then 8 lo values
// (SPLIT). n = rows * GX threads.
template <typename XT, int GRP, bool MIN, bool SPLIT>
__global__ void __launch_bounds__(256) group_prep(XT* __restrict__ x,
                                                  __nv_bfloat16* __restrict__ xg, int n, int G,
                                                  int GX) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int row = i / GX, col = i % GX;
  if (col >= G) {
    if constexpr (MIN) xg[i] = xg[(size_t)n + i] = __float2bfloat16_rn(0.f);
    return;
  }
  XT* p = x + ((size_t)row * G + col) * GRP;
  float v[GRP];
  load_f<XT, GRP>(p, v);
  if constexpr (MIN) {
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < GRP; ++a) s += v[a];
    const __nv_bfloat16 hi = __float2bfloat16_rn(s);
    xg[i] = hi;
    xg[(size_t)n + i] = __float2bfloat16_rn(__fsub_rn(s, __bfloat162float(hi)));
  }
  if constexpr (SPLIT) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int b = 0; b < GRP / 8; ++b) {
      const float* f = v + 8 * b;
      uint4 h, l;
      split2(f[0], f[1], h.x, l.x);
      split2(f[2], f[3], h.y, l.y);
      split2(f[4], f[5], h.z, l.z);
      split2(f[6], f[7], h.w, l.w);
      q[2 * b] = h;
      q[2 * b + 1] = l;
    }
  }
}

// group_prep over `rows` column-order rows of K values, where the kind
// and the type of x need it (Q8 and MXFP4 have no min term; bf16 x is not
// split).
template <int KIND, typename XT>
inline cudaError_t group_prep_launch(XT* x, __nv_bfloat16* xg, int rows, int K, cudaStream_t st) {
  constexpr int GRP = Geo<KIND>::GROUP;
  constexpr bool MIN = has_min<KIND>(), SPLIT = sizeof(XT) == 4;
  if constexpr (MIN || SPLIT) {
    const int G = K / GRP, GX = group_xg_cols(G);
    const int n = rows * GX;
    group_prep<XT, GRP, MIN, SPLIT><<<(n + 255) / 256, 256, 0, st>>>(x, xg, n, G, GX);
  }
  return cudaGetLastError();
}

}  // namespace tpl
