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
// Both matvecs run the decode body of qmm_gemv.cuh (gv_tile) at T = 1,
// blocks walking row tiles of 32 rows:
//   Phase A: the tiles of attn_output's E rows, x = att staged by the
//     body in scale-column order (column c of the fourblock planes holds
//     natural group (c % R) * 4 + c / R, R = K/128; ops/cuda/qmm.py
//     column_x) with its column sums; r1[n] = x_res[n] + sum.
//   grid sync.
//   Phase B: every block sums r1^2 itself (from L2, in one fixed order,
//     so all blocks get the same norm) and stages h = r1 * inv * norm_w
//     straight into the body's x slice, with no global copy of h. A tile
//     holds 16 pairs of rows, gate j and up Fd + j interleaved, so the
//     thread that holds gate j's sum also holds up j's and writes
//     act[j] = silu(gate) * up. No gate/up scratch and no second barrier.
// A block stages each phase's x once when it fits one slice of the body
// (K <= 8192) and keeps it for every tile it takes.
//
// Arithmetic (qmm_gemv.cuh): the integers of each scale column summed
// against x in f32, each column's sum scaled once, the min term from the
// staged column sums; the plain version dequantizes q * scale - minv
// first, so the two differ by f32 rounding. The reference rounds weights
// and activations to bf16 before its dots (fused_layer.py:101-104); this
// kernel does not.
//
// What bounds it on an H100: bytes. One call streams the o planes (E x
// Dq/2 bytes + bf16 scale/min planes) and the [gate|up] planes (2Fd x E/2
// + planes) once: ~80.6 MB at ChatGLM3-6B's E = Dq = 4096, 2Fd = 27392,
// 0.024 ms at 3.35 TB/s. The body streams each step's weight tile by
// cooperative 16-byte cp.async into a 2-stage shared-memory ring; 2 blocks
// of 256 threads fit an SM, so the grid is 2 blocks per SM.
//
// Field set: {q4, scale, minv}, g = 32 (Q4_0, Q4_1, Q4_K), the set the
// reference's fused_ok admits; att, x_res and norm_w f32 or bf16; scale
// planes f32 or bf16 (both runtime flags of one instance).

#include <cooperative_groups.h>

#include "qmm_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tpl;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = THREADS / GV_L * GV_RT;  // rows of a body tile
static_assert(GV_RT == 2, "a [gate|up] tile holds one (gate, up) pair per row group");
constexpr int G = 32;  // quant group of the {q4, scale, minv} field set
constexpr int SMEM = gv_smem_bytes<KIND_Q4, 1>(THREADS);

// first natural element of scale column c of a K-wide fourblock row
__device__ __forceinline__ int fourblock_col(int c, int K) {
  const int R = K >> 7;
  return ((c % R) * (128 / G) + c / R) * G;
}

__device__ __forceinline__ float ld_x(const void* p, bool bf16, int i) {
  return bf16 ? to_f(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(THREADS, 2) fused_postattn_kernel(
    const void* __restrict__ att, const void* __restrict__ x_res,
    const void* __restrict__ norm_w, const uint8_t* __restrict__ oq,
    const void* __restrict__ osc, const void* __restrict__ omn,
    const uint8_t* __restrict__ gq, const void* __restrict__ gsc,
    const void* __restrict__ gmn, float* __restrict__ act, float* r1, int x_bf16, int s_bf16,
    int E, int Dq, int Fd, float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[WARPS];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lead = (threadIdx.x & (GV_L - 1)) == 0;
  const int rg = threadIdx.x / GV_L;
  float part[GV_RT][1];
  int staged = -1;  // the slice the block's x buffer holds

  // Phase A: r1 = x_res + o-projection(att)
  auto stage_att = [&](float* xs, float* xsum, int cs) {
    if (cs == staged) return;
    gv_stage_with<KIND_Q4, 1>(
        [&](int, int c, float (&v)[G]) {
          const int e0 = fourblock_col(c, Dq);
          if (x_bf16) load_f<__nv_bfloat16, G>(static_cast<const __nv_bfloat16*>(att) + e0, v);
          else load_f<float, G>(static_cast<const float*>(att) + e0, v);
        },
        xs, xsum, 1, Dq / G, cs);
    staged = cs;
  };
  for (int nb = blockIdx.x * ROWS; nb < E; nb += gridDim.x * ROWS) {
    gv_tile<KIND_Q4, 1>(oq, nullptr, osc, omn, s_bf16, Dq,
                        [&](int rr) { return (size_t)min(nb + rr, E - 1); }, stage_att, smem,
                        part);
    if (lead)
#pragma unroll
      for (int r = 0; r < GV_RT; ++r) {
        const int n = nb + rg * GV_RT + r;
        if (n < E) r1[n] = ld_x(x_res, x_bf16, n) + part[r][0];
      }
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
  staged = -1;
  auto stage_h = [&](float* xs, float* xsum, int cs) {
    if (cs == staged) return;
    gv_stage_with<KIND_Q4, 1>(
        [&](int, int c, float (&v)[G]) {
          const int e0 = fourblock_col(c, E);
          float w[G];
          if (x_bf16) load_f<__nv_bfloat16, G>(static_cast<const __nv_bfloat16*>(norm_w) + e0, w);
          else load_f<float, G>(static_cast<const float*>(norm_w) + e0, w);
#pragma unroll
          for (int i = 0; i < G / 4; ++i) {
            const float4 u = __ldcg(reinterpret_cast<const float4*>(r1 + e0) + i);
            v[4 * i] = u.x * inv * w[4 * i];
            v[4 * i + 1] = u.y * inv * w[4 * i + 1];
            v[4 * i + 2] = u.z * inv * w[4 * i + 2];
            v[4 * i + 3] = u.w * inv * w[4 * i + 3];
          }
        },
        xs, xsum, 1, E / G, cs);
    staged = cs;
  };
  // tile row rr: gate row j0 + rr / 2 (rr even) or up row Fd + j0 + rr / 2
  for (int j0 = blockIdx.x * (ROWS / 2); j0 < Fd; j0 += gridDim.x * (ROWS / 2)) {
    gv_tile<KIND_Q4, 1>(
        gq, nullptr, gsc, gmn, s_bf16, E,
        [&](int rr) { return (size_t)(rr & 1) * Fd + min(j0 + (rr >> 1), Fd - 1); }, stage_h,
        smem, part);
    const int j = j0 + rg;
    if (lead && j < Fd) {
      const float gate = part[0][0], up = part[1][0];
      act[j] = gate / (1.0f + expf(-gate)) * up;
    }
  }
}

// Blocks the card holds at once with this kernel's shared memory, or a
// negative CUDA error code; queried once per process.
int resident_blocks() {
  static const int resident = [] {
    cudaError_t e = cudaFuncSetAttribute(fused_postattn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_postattn_kernel, THREADS,
                                                        SMEM);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    return per_sm * sms;
  }();
  return resident;
}

}  // namespace

// att: (Dq,), x_res, norm_w: (E,), all f32 or all bf16 (x_bf16); o planes:
// q4 (E, Dq/2), scale/minv (E, Dq/32); [gate|up] planes: q4 (2Fd, E/2),
// scale/minv (2Fd, E/32), all in fourblock order, scales f32 or bf16
// (s_bf16); act: (Fd,) f32, r1: (E,) f32 outputs; every pointer 16-byte
// aligned. Dq and E multiples of 128 (the fourblock order). One
// cooperative launch of as many blocks as the card holds at once, no more
// than the larger phase's tiles. Returns a CUDA error code (0 on success).
extern "C" int tpl_fused_postattn(int x_bf16, int s_bf16, const void* att, const void* x_res,
                                  const void* norm_w, const void* oq, const void* osc,
                                  const void* omn, const void* gq, const void* gsc,
                                  const void* gmn, float* act, float* r1, int E, int Dq,
                                  int Fd, float eps, void* stream) {
  if (E % 128 || Dq % 128 || Fd < 1) return (int)cudaErrorInvalidValue;
  const int resident = resident_blocks();
  if (resident < 0) return -resident;
  const int tiles = max((E + ROWS - 1) / ROWS, (Fd + ROWS / 2 - 1) / (ROWS / 2));
  const int blocks = min(resident, tiles);
  void* args[] = {&att, &x_res, &norm_w, &oq,     &osc, &omn, &gq,  &gsc, &gmn,
                  &act, &r1,    &x_bf16, &s_bf16, &E,   &Dq,  &Fd, &eps};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_postattn_kernel),
                                              dim3(blocks), dim3(THREADS), args, SMEM,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
