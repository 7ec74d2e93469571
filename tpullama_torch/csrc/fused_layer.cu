// Fused post-attention decode step (T == 1, one sequence):
//
//   r1  = x_res + attn_output(att)        quantized matvec, E rows of Dq
//   h   = rms_norm(r1) * norm_w
//   g   = [gate | up] = ffn_up(h)         quantized matvec, 2*Fd rows of E
//   act = silu(gate) * up
//
// returning (act, r1); the caller finishes the layer with
// y = r1 + ffn_down(act).
//
// Replaces the Pallas kernel `_kernel` of fused_postattn
// (tpullama/ops/pallas/fused_layer.py:112, launched :230). The TPU kernel
// walks a sequential grid (o-projection tiles, then [gate|up] tiles) and
// keeps r1, the permuted h and g in VMEM scratch across steps. On Hopper
// the blocks run in parallel, so the one dependency that crosses blocks
// (rms_norm needs all of r1 before any [gate|up] row) is a grid barrier:
// one cooperative launch (every block resident), cg::this_grid().sync().
//   Phase A: each block stages att in shared memory in the o planes'
//     fourblock stored order (stored p = a*(K/g) + m*R + s holds natural
//     element s*128 + m*g + a, R = K/128; ops/qweights.py), then its
//     warps take o-projection rows: r1[n] = x_res[n] + dot.
//   grid sync.
//   Phase B: every block sums r1^2 itself (16 KB from L2, in one fixed
//     order, so all blocks get the same norm), stages h in fourblock
//     order in shared memory, and each warp takes a pair of rows (j,
//     Fd + j) and writes act[j] = silu(gate) * up. No gate/up scratch and
//     no second barrier.
//
// Arithmetic: each weight is dequantized as q * scale - minv with two
// roundings (qmm_dequant.cuh), bit-equal to the plain version's; dots
// accumulate in f32. The reference rounds weights and activations to bf16
// before its dots (fused_layer.py:101-104); this kernel does not.
//
// What bounds it on an H100: bytes. One call streams the o planes (E x
// Dq/2 bytes + bf16 scale/min planes) and the [gate|up] planes (2Fd x E/2
// + planes) once: ~80.6 MB at ChatGLM3-6B's E = Dq = 4096, 2Fd = 27392,
// 0.024 ms at 3.35 TB/s. Every warp streams whole packed rows with
// 16-byte loads (the warp_row_sums body of qmm_gemv); the activations
// are read from shared memory.
//
// Field set: {q4, scale, minv}, g = 32 (Q4_0, Q4_1, Q4_K), the set the
// reference's fused_ok admits; att, x_res and norm_w f32 or bf16; scale
// planes f32 or bf16.

#include <cooperative_groups.h>

#include "qmm_dequant.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tpl;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int G = 32;  // quant group of the {q4, scale, minv} field set

// fourblock stored position of natural element e of a K-wide row
__device__ __forceinline__ int fourblock_pos(int e, int K) {
  const int s = e >> 7, rem = e & 127;
  const int m = rem / G, a = rem % G;
  return a * (K / G) + m * (K >> 7) + s;
}

template <typename XT, typename ST>
__global__ void __launch_bounds__(THREADS) fused_postattn_kernel(
    const XT* __restrict__ att, const XT* __restrict__ x_res,
    const XT* __restrict__ norm_w, const uint8_t* __restrict__ oq,
    const ST* __restrict__ osc, const ST* __restrict__ omn,
    const uint8_t* __restrict__ gq, const ST* __restrict__ gsc,
    const ST* __restrict__ gmn, float* __restrict__ act, float* r1, int E, int Dq,
    int Fd, float eps) {
  extern __shared__ __align__(16) float xs[];  // max(Dq, E) floats, stored order
  __shared__ float red[WARPS];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * WARPS + warp, nw = gridDim.x * WARPS;

  // Phase A: r1 = x_res + o-projection(att)
  for (int e = threadIdx.x; e < Dq; e += THREADS) xs[fourblock_pos(e, Dq)] = to_f(att[e]);
  __syncthreads();
  for (int n = gw; n < E; n += nw) {
    float acc[1];
    warp_row_sums<KIND_Q4, float, ST, 1>(xs, oq, nullptr, osc, omn, n, 1, Dq, 0, Dq / 32,
                                         lane, acc);
    if (lane == 0) r1[n] = to_f(x_res[n]) + acc[0];
  }
  grid.sync();

  // Phase B: h = rms_norm(r1) * norm_w; act = silu(gate) * up
  float ss = 0.f;
  for (int e = threadIdx.x; e < E; e += THREADS) {
    const float v = __ldcg(r1 + e);  // written by other blocks: read past L1
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) tot += red[w];
  const float inv = 1.0f / sqrtf(tot / (float)E + eps);
  for (int e = threadIdx.x; e < E; e += THREADS)
    xs[fourblock_pos(e, E)] = __ldcg(r1 + e) * inv * to_f(norm_w[e]);
  __syncthreads();
  for (int j = gw; j < Fd; j += nw) {
    float gate[1], up[1];
    warp_row_sums<KIND_Q4, float, ST, 1>(xs, gq, nullptr, gsc, gmn, j, 1, E, 0, E / 32, lane,
                                         gate);
    warp_row_sums<KIND_Q4, float, ST, 1>(xs, gq, nullptr, gsc, gmn, Fd + j, 1, E, 0, E / 32,
                                         lane, up);
    if (lane == 0) act[j] = gate[0] / (1.0f + expf(-gate[0])) * up[0];
  }
}

template <typename XT, typename ST>
int launch(const void* att, const void* x_res, const void* norm_w, const void* oq,
           const void* osc, const void* omn, const void* gq, const void* gsc,
           const void* gmn, float* act, float* r1, int E, int Dq, int Fd, float eps,
           cudaStream_t st) {
  auto kern = fused_postattn_kernel<XT, ST>;
  const size_t smem = (size_t)(Dq > E ? Dq : E) * sizeof(float);
  // every block must be resident for the grid barrier: as many blocks as
  // the card holds at once (cached per shared-memory size), no more than
  // there are warps' worth of rows
  static size_t cached_smem = 0;
  static int resident = 0;
  if (cached_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * sms;
    cached_smem = smem;
  }
  const int rows = E > Fd ? E : Fd;
  int blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > resident) blocks = resident;
  auto a = static_cast<const XT*>(att);
  auto xr = static_cast<const XT*>(x_res);
  auto nw = static_cast<const XT*>(norm_w);
  auto oqp = static_cast<const uint8_t*>(oq);
  auto gqp = static_cast<const uint8_t*>(gq);
  auto os = static_cast<const ST*>(osc);
  auto om = static_cast<const ST*>(omn);
  auto gs = static_cast<const ST*>(gsc);
  auto gm = static_cast<const ST*>(gmn);
  void* args[] = {&a, &xr, &nw, &oqp, &os, &om, &gqp, &gs, &gm, &act, &r1, &E, &Dq, &Fd, &eps};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(blocks),
                                              dim3(THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// att: (Dq,), x_res, norm_w: (E,), all f32 or all bf16 (x_bf16); o planes:
// q4 (E, Dq/2), scale/minv (E, Dq/32); [gate|up] planes: q4 (2Fd, E/2),
// scale/minv (2Fd, E/32), all in fourblock order, scales f32 or bf16
// (s_bf16); act: (Fd,) f32, r1: (E,) f32 outputs. Dq and E multiples of
// 512, max(Dq, E) * 4 bytes of shared memory at most 48 KB (the wrapper
// checks). Returns a CUDA error code (0 on success).
extern "C" int tpl_fused_postattn(int x_bf16, int s_bf16, const void* att, const void* x_res,
                                  const void* norm_w, const void* oq, const void* osc,
                                  const void* omn, const void* gq, const void* gsc,
                                  const void* gmn, float* act, float* r1, int E, int Dq,
                                  int Fd, float eps, void* stream) {
  using bf = __nv_bfloat16;
  auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return s_bf16 ? launch<bf, bf>(att, x_res, norm_w, oq, osc, omn, gq, gsc, gmn, act, r1, E,
                                   Dq, Fd, eps, st)
                  : launch<bf, float>(att, x_res, norm_w, oq, osc, omn, gq, gsc, gmn, act, r1,
                                      E, Dq, Fd, eps, st);
  }
  return s_bf16 ? launch<float, bf>(att, x_res, norm_w, oq, osc, omn, gq, gsc, gmn, act, r1, E,
                                    Dq, Fd, eps, st)
                : launch<float, float>(att, x_res, norm_w, oq, osc, omn, gq, gsc, gmn, act, r1,
                                       E, Dq, Fd, eps, st);
}
