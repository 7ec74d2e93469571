// Gathered dequantize x matmul for MoE experts kept packed on the card:
// y[t*tt : (t+1)*tt] = x[t*tt : (t+1)*tt] @ W[sel[t]]^T for every tile t of
// tt rows (the ggml_mul_mat_id analog). sel holds one expert per tile and
// stays on the card: no launch reads it back to the host.
//
// Replaces two Pallas kernels of tpullama/ops/pallas/qmm.py:
//   - qmm_gathered: `kernel` of quantized_matmul_gathered (:655, wrapper
//     :525) on row-major expert planes (M, R, kcols);
//   - qmm_gathered_t: `kernel` of _qmm_gathered_t (:771, wrapper :704) on
//     transposed planes (M, kcols, R) whose scale/minv planes hold Gp >= G
//     group rows (zero-padded to 16), with the min term hoisted out of the
//     weights as the TPU kernel does: y = x . (q * scale) - xgsum . minv,
//     xgsum being x's per-group sums. The kernel sums each group of x as it
//     walks that group's stored positions, so every output row depends on
//     its own x row alone, whatever the tile holds.
// R is the stored rows per expert (rows padded to 128 by the loader), N <= R
// the rows computed. x is f32: in stored (group-permuted) order for
// qmm_gathered, as in qmm.cu; in natural order for qmm_gathered_t, whose
// walk over one scale group's stored positions meets that group's 32
// natural elements in order. The dequantization helpers are qmm.cu's
// (qmm_dequant.cuh), so the weights equal the plain version's bit for bit.
//
// What bounds it on an H100:
//   - decode (tt = 1, one tile per (token, k) slot): bytes. A step reads
//     only the selected experts' packed planes; qmm_gathered gives each warp
//     one packed row and streams it with 16-byte loads, qmm_gathered_t gives
//     each lane 4 neighbouring rows (4-byte loads, 128 bytes per warp) and
//     splits the groups of K over 8 warps so that ~2000 warps are in flight.
//   - prefill (tt = 8 rows per tile, slots sorted by expert): operations,
//     which these f32 FMA bodies are far from (no tensor cores yet).
//     The grid runs the tiles fastest, so the tiles of one expert that
//     share a block of rows run next to each other and read those rows
//     from the 50 MB L2 once. qmm_gathered's warp loads each x value for
//     one output row only, so at prefill it is bound by its L1 traffic;
//     qmm_gathered_t stages each group of x in shared memory.
//
// Field sets: qmm_gathered covers KIND_Q4, KIND_Q6 and KIND_Q8;
// qmm_gathered_t covers KIND_Q4 and KIND_Q8 (the loader stores no other
// field set transposed). The wrappers raise on the rest.

#include "qmm_dequant.cuh"

namespace {

using namespace tpl;

// Row-major: grid (tile, block of 4 rows), one warp per output row.
template <int KIND, typename ST, int TT>
__global__ void __launch_bounds__(128) qmm_gathered_kernel(
    const float* __restrict__ x, const int* __restrict__ sel,
    const uint8_t* __restrict__ qa, const uint8_t* __restrict__ qb,
    const ST* __restrict__ scale, const ST* __restrict__ minv,
    float* __restrict__ y, int tt, int N, int R, int K) {
  const int n = blockIdx.y * 4 + (threadIdx.x >> 5);
  if (n >= N) return;
  const int tile = blockIdx.x;
  const int e = sel[tile];
  warp_row_dot<KIND, float, ST, TT>(x + (size_t)tile * tt * K, qa, qb, scale, minv,
                                    e * R + n, tt, K, y + (size_t)tile * tt * N + n,
                                    N, threadIdx.x & 31);
}

constexpr int T_ROWS = 4;    // output rows per lane
constexpr int T_WARPS = 8;   // warps splitting the groups of K
constexpr int T_BLOCK_N = 32 * T_ROWS;

// Transposed: grid (tile, block of 128 rows), 8 warps. Lane l holds rows
// n0..n0+3 (n0 = 4 l); warp w takes the groups gi = w, w + 8, ... For
// group gi it stages the tile's x over natural elements gi*32 .. gi*32+31
// in shared memory (one 128-byte load per row), loads the 4 rows' scales
// once, then walks the stored positions p = gi + j G whose scale that is:
// for Q4 the byte rows p < K/2 (low nibble: stored position p, natural
// element gi*32 + j; high nibble: p + K/2, element gi*32 + 16 + j), for Q8
// the rows p < K (element gi*32 + j). The group's x sum for the min term
// accumulates on the way. The 8 warps' partial sums meet in shared memory.
template <int KIND, typename ST, int TT>
__global__ void __launch_bounds__(T_WARPS * 32) qmm_gathered_t_kernel(
    const float* __restrict__ x, const int* __restrict__ sel, const uint8_t* __restrict__ q,
    const ST* __restrict__ scale, const ST* __restrict__ minv,
    float* __restrict__ y, int tt, int N, int R, int K, int Gp) {
  __shared__ float part[T_WARPS][TT][T_BLOCK_N];
  __shared__ float xg[T_WARPS][TT][32];  // each warp's group of x
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int nb = blockIdx.y * T_BLOCK_N;
  const int n0 = nb + lane * T_ROWS;
  const int e = sel[tile];
  const int G = K / 32;
  const int q_rows = KIND == KIND_Q8 ? K : K / 2;
  const float* xt = x + (size_t)tile * tt * K;
  const uint8_t* qe = q + (size_t)e * q_rows * R + n0;
  const ST* se = scale + (size_t)e * Gp * R + n0;
  const ST* me = KIND == KIND_Q8 ? nullptr : minv + (size_t)e * Gp * R + n0;
  float acc[TT][T_ROWS];
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int i = 0; i < T_ROWS; ++i) acc[r][i] = 0.f;

  for (int gi = warp; gi < G; gi += T_WARPS) {
#pragma unroll
    for (int r = 0; r < TT; ++r)
      xg[warp][r][lane] = r < tt ? xt[(size_t)r * K + gi * 32 + lane] : 0.f;
    __syncwarp();
    float s[T_ROWS];
    load_f<ST, T_ROWS>(se + (size_t)gi * R, s);
    float xs[TT];  // natural group gi's x sum per row
#pragma unroll
    for (int r = 0; r < TT; ++r) xs[r] = 0.f;
    if constexpr (KIND == KIND_Q4) {
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int c = gi + j * G;
        const uint32_t qv = *reinterpret_cast<const uint32_t*>(qe + (size_t)c * R);
        float wl[T_ROWS], wh[T_ROWS];
#pragma unroll
        for (int i = 0; i < T_ROWS; ++i) {
          const int b = (qv >> (8 * i)) & 0xff;
          wl[i] = __fmul_rn((float)(b & 15), s[i]);
          wh[i] = __fmul_rn((float)(b >> 4), s[i]);
        }
#pragma unroll
        for (int r = 0; r < TT; ++r) {
          if (r < tt) {
            const float xl = xg[warp][r][j];
            const float xh = xg[warp][r][16 + j];
            xs[r] += xl;
            xs[r] += xh;
#pragma unroll
            for (int i = 0; i < T_ROWS; ++i) {
              acc[r][i] = fmaf(xl, wl[i], acc[r][i]);
              acc[r][i] = fmaf(xh, wh[i], acc[r][i]);
            }
          }
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const int c = gi + j * G;
        const uint32_t qv = *reinterpret_cast<const uint32_t*>(qe + (size_t)c * R);
        float w[T_ROWS];
#pragma unroll
        for (int i = 0; i < T_ROWS; ++i)
          w[i] = __fmul_rn((float)(int8_t)((qv >> (8 * i)) & 0xff), s[i]);
#pragma unroll
        for (int r = 0; r < TT; ++r) {
          if (r < tt) {
            const float xv = xg[warp][r][j];
#pragma unroll
            for (int i = 0; i < T_ROWS; ++i) acc[r][i] = fmaf(xv, w[i], acc[r][i]);
          }
        }
      }
    }
    if constexpr (KIND != KIND_Q8) {
      float m[T_ROWS];
      load_f<ST, T_ROWS>(me + (size_t)gi * R, m);
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int i = 0; i < T_ROWS; ++i) acc[r][i] = fmaf(-xs[r], m[i], acc[r][i]);
    }
    __syncwarp();  // every lane has read xg before the next group overwrites it
  }
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int i = 0; i < T_ROWS; ++i) part[warp][r][lane * T_ROWS + i] = acc[r][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < tt * T_BLOCK_N; idx += T_WARPS * 32) {
    const int r = idx / T_BLOCK_N, nl = idx % T_BLOCK_N;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < T_WARPS; ++w) v += part[w][r][nl];
    const int n = nb + nl;
    if (n < N) y[((size_t)tile * tt + r) * N + n] = v;
  }
}

using RmFn = void (*)(const float*, const int*, const void*, const void*, const void*,
                     const void*, float*, int, int, int, int, int, cudaStream_t);
using TFn = void (*)(const float*, const int*, const void*, const void*, const void*,
                    float*, int, int, int, int, int, int, cudaStream_t);

template <int KIND, typename ST, int TT>
void launch_rm(const float* x, const int* sel, const void* qa, const void* qb,
               const void* s, const void* m, float* y, int n_tiles, int tt, int N,
               int R, int K, cudaStream_t st) {
  dim3 grid(n_tiles, (N + 3) / 4), block(128);
  qmm_gathered_kernel<KIND, ST, TT><<<grid, block, 0, st>>>(
      x, sel, static_cast<const uint8_t*>(qa), static_cast<const uint8_t*>(qb),
      static_cast<const ST*>(s), static_cast<const ST*>(m), y, tt, N, R, K);
}

template <int KIND, typename ST, int TT>
void launch_t(const float* x, const int* sel, const void* q, const void* s,
              const void* m, float* y, int n_tiles, int tt, int N, int R, int K, int Gp,
              cudaStream_t st) {
  dim3 grid(n_tiles, (N + T_BLOCK_N - 1) / T_BLOCK_N), block(T_WARPS * 32);
  qmm_gathered_t_kernel<KIND, ST, TT><<<grid, block, 0, st>>>(
      x, sel, static_cast<const uint8_t*>(q), static_cast<const ST*>(s),
      static_cast<const ST*>(m), y, tt, N, R, K, Gp);
}

// the instance for the smallest TT in {1, 2, 4, 8} that holds tt rows
template <int KIND, typename ST>
RmFn pick_rm(int tt) {
  return tt <= 1 ? &launch_rm<KIND, ST, 1> : tt <= 2 ? &launch_rm<KIND, ST, 2>
       : tt <= 4 ? &launch_rm<KIND, ST, 4> : &launch_rm<KIND, ST, 8>;
}

template <int KIND, typename ST>
TFn pick_t(int tt) {
  return tt <= 1 ? &launch_t<KIND, ST, 1> : tt <= 2 ? &launch_t<KIND, ST, 2>
       : tt <= 4 ? &launch_t<KIND, ST, 4> : &launch_t<KIND, ST, 8>;
}

}  // namespace

// Row-major. x: (n_tiles * tt, K) f32 in stored order; sel: (n_tiles,)
// int32 expert per tile, on the card; qa: q4 or q8 planes (M, R, K*bits/8);
// qb: q2 planes (Q6) or null; s, m: (M, R, K/g) f32 or bf16 (m null for
// Q8); y: (n_tiles * tt, N) f32. tt <= 8. Returns cudaGetLastError().
extern "C" int tpl_qmm_gathered(int kind, int s_bf16, const float* x, const int* sel,
                                const void* qa, const void* qb, const void* s,
                                const void* m, float* y, int n_tiles, int tt, int N,
                                int R, int K, void* stream) {
  using bf = __nv_bfloat16;
  if (tt < 1 || tt > 8) return (int)cudaErrorInvalidValue;
  RmFn fn;
  if (kind == KIND_Q4) fn = s_bf16 ? pick_rm<KIND_Q4, bf>(tt) : pick_rm<KIND_Q4, float>(tt);
  else if (kind == KIND_Q6) fn = s_bf16 ? pick_rm<KIND_Q6, bf>(tt) : pick_rm<KIND_Q6, float>(tt);
  else if (kind == KIND_Q8) fn = s_bf16 ? pick_rm<KIND_Q8, bf>(tt) : pick_rm<KIND_Q8, float>(tt);
  else return (int)cudaErrorInvalidValue;
  fn(x, sel, qa, qb, s, m, y, n_tiles, tt, N, R, K, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Transposed. x: (n_tiles * tt, K) f32 in natural order; sel as above; q:
// q4 or q8 planes (M, K*bits/8, R); s, m: (M, Gp, R) f32 or bf16 (m null
// for Q8); y: (n_tiles * tt, N) f32. R % 128 == 0, tt <= 8.
extern "C" int tpl_qmm_gathered_t(int kind, int s_bf16, const float* x, const int* sel,
                                  const void* q, const void* s, const void* m, float* y,
                                  int n_tiles, int tt, int N, int R, int K, int Gp,
                                  void* stream) {
  using bf = __nv_bfloat16;
  if (tt < 1 || tt > 8 || R % T_BLOCK_N) return (int)cudaErrorInvalidValue;
  TFn fn;
  if (kind == KIND_Q4) fn = s_bf16 ? pick_t<KIND_Q4, bf>(tt) : pick_t<KIND_Q4, float>(tt);
  else if (kind == KIND_Q8) fn = s_bf16 ? pick_t<KIND_Q8, bf>(tt) : pick_t<KIND_Q8, float>(tt);
  else return (int)cudaErrorInvalidValue;
  fn(x, sel, q, s, m, y, n_tiles, tt, N, R, K, Gp, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
