// One D2Q9-BGK timestep on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_single` (the whole grid in
// one program) and `_step_kernel_blocked` (BY-row blocks with carried
// ghost rows), both built by `build_fused_program`, with their shared body
// `_compute` / `_collide` / `_body_force_okf`.  One kernel covers every
// grid: the periodic pull below takes the place of the in-block wrap of
// the first and of the ghost slots of the second.
//
// Bound: device-memory bytes.  A cell update reads 9 fp32 populations and
// one uint8 mask byte and writes 9 fp32 populations: 73 B, against ~100
// fp32 operations, far below Hopper's ~20 flop/B balance point.  Design
// for that bound, kept simple for a first kernel:
//   * one thread per cell, neighbouring threads on neighbouring x, so
//     each of the 9 plane reads and writes is a coalesced warp access
//     (the +-1 column shifts straddle one extra 32 B sector, which L1/L2
//     absorb);
//   * ping-pong f_in -> f_out: Hopper blocks run concurrently, so the
//     TPU's in-place update (safe there only because its grid is
//     sequential) would race;
//   * the body force of row ny-2 is folded into the pull (no extra pass):
//     the kick is gated on the SOURCE cell's pre-kick values, which equals
//     the reference's accelerate-then-stream order because the kicked
//     buffer is read only by this step's stream;
//   * the |u| sum has no float atomics: each block reduces its cells in a
//     fixed shared-memory tree and writes one partial; `av_reduce_kernel`
//     sums the partials in a fixed order, so av_vels is the same bits on
//     every run.
// fp32 throughout, IEEE division and sqrt (no --use_fast_math), no FMA
// contraction (-fmad=false; _build.py says why); the weights, omega, aw1,
// aw2 and 1/free_cells come from the host as the same fp32 values lbm_tpu
// uses.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors `_StepParams` in lbm_tpu_torch/ops/fused.py field for field.
// At namespace scope: a type with internal linkage in the signature of
// lbm_fused_step would keep that function out of the library's symbols.
struct StepParams {
  int ny;
  int nx;
  float omega;
  float aw1;
  float aw2;
  float free_cells_inv;
  float weights[9];
  float kick[9];
};

namespace {

constexpr int kBlockX = 128;
constexpr int kBlockY = 2;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kReduceThreads = 1024;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ int wrap_dec(int i, int n) { return i == 0 ? n - 1 : i - 1; }
__device__ __forceinline__ int wrap_inc(int i, int n) { return i == n - 1 ? 0 : i + 1; }

// Body-force gate of source cell (ny-2, xs) on the pre-kick populations
// (`_body_force_okf`, kernels.cl:29-33).
__device__ __forceinline__ bool kick_gate(const float* __restrict__ f_in,
                                          const uint8_t* __restrict__ fluid,
                                          size_t plane, int nx, int row, int xs,
                                          float aw1, float aw2) {
  const size_t c = static_cast<size_t>(row) * nx + xs;
  return fluid[c] != 0 && f_in[3 * plane + c] - aw1 > 0.0f &&
         f_in[6 * plane + c] - aw2 > 0.0f && f_in[7 * plane + c] - aw2 > 0.0f;
}

__global__ void __launch_bounds__(kThreads)
lbm_step_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                const uint8_t* __restrict__ fluid, float* __restrict__ partials,
                const StepParams p) {
  __shared__ float red[kThreads];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  float speed = 0.0f;

  if (x < p.nx && y < p.ny) {
    const int nx = p.nx;
    const int ny = p.ny;
    const size_t plane = static_cast<size_t>(ny) * nx;
    // Source coordinates of the pull tmp[k](y, x) = f[k](y - cy_k, x - cx_k)
    // with periodic wrap: xm/ym for c = +1, xp/yp for c = -1.
    const int xm = wrap_dec(x, nx);
    const int xp = wrap_inc(x, nx);
    const int ym = wrap_dec(y, ny);
    const int yp = wrap_inc(y, ny);
    const size_t ry = static_cast<size_t>(y) * nx;
    const size_t rm = static_cast<size_t>(ym) * nx;
    const size_t rp = static_cast<size_t>(yp) * nx;

    float t0 = f_in[0 * plane + ry + x];
    float t1 = f_in[1 * plane + ry + xm];
    float t2 = f_in[2 * plane + rm + x];
    float t3 = f_in[3 * plane + ry + xp];
    float t4 = f_in[4 * plane + rp + x];
    float t5 = f_in[5 * plane + rm + xm];
    float t6 = f_in[6 * plane + rm + xp];
    float t7 = f_in[7 * plane + rp + xp];
    float t8 = f_in[8 * plane + rp + xm];

    // Fused accelerate_flow: kicked speeds 1,3 (source row y), 5,6 (source
    // row y-1) and 7,8 (source row y+1), each when its source row is ny-2.
    const int kr = ny - 2;
    if (y == kr) {
      if (kick_gate(f_in, fluid, plane, nx, kr, xm, p.aw1, p.aw2)) t1 = t1 + p.kick[1];
      if (kick_gate(f_in, fluid, plane, nx, kr, xp, p.aw1, p.aw2)) t3 = t3 + p.kick[3];
    }
    if (ym == kr) {
      if (kick_gate(f_in, fluid, plane, nx, kr, xm, p.aw1, p.aw2)) t5 = t5 + p.kick[5];
      if (kick_gate(f_in, fluid, plane, nx, kr, xp, p.aw1, p.aw2)) t6 = t6 + p.kick[6];
    }
    if (yp == kr) {
      if (kick_gate(f_in, fluid, plane, nx, kr, xp, p.aw1, p.aw2)) t7 = t7 + p.kick[7];
      if (kick_gate(f_in, fluid, plane, nx, kr, xm, p.aw1, p.aw2)) t8 = t8 + p.kick[8];
    }

    // BGK + bounce-back, operation for operation as `_collide`.
    const float rho = t0 + t1 + t2 + t3 + t4 + t5 + t6 + t7 + t8;
    const float rho_inv = 1.0f / rho;
    const float mx = t1 + t5 + t8 - t3 - t6 - t7;
    const float my = t2 + t5 + t6 - t4 - t7 - t8;
    const float msq = mx * mx + my * my;
    const float half_icsq_rinv = 1.5f * rho_inv;
    const float om = p.omega;
    const size_t c = ry + x;
    const bool is_fluid = fluid[c] != 0;

    float o0, o1, o2, o3, o4, o5, o6, o7, o8;
    if (is_fluid) {
      const float feq0 = p.weights[0] * (rho - half_icsq_rinv * msq);
      o0 = t0 + om * (feq0 - t0);
      {
        const float w = p.weights[1];
        const float equ = 3.0f * mx;
        const float shared = w * (rho + half_icsq_rinv * (equ * mx - msq));
        const float beta = w * equ;
        o1 = t1 + om * ((shared + beta) - t1);
        o3 = t3 + om * ((shared - beta) - t3);
      }
      {
        const float w = p.weights[2];
        const float equ = 3.0f * my;
        const float shared = w * (rho + half_icsq_rinv * (equ * my - msq));
        const float beta = w * equ;
        o2 = t2 + om * ((shared + beta) - t2);
        o4 = t4 + om * ((shared - beta) - t4);
      }
      {
        const float w = p.weights[5];
        const float eu = mx + my;
        const float equ = 3.0f * eu;
        const float shared = w * (rho + half_icsq_rinv * (equ * eu - msq));
        const float beta = w * equ;
        o5 = t5 + om * ((shared + beta) - t5);
        o7 = t7 + om * ((shared - beta) - t7);
      }
      {
        const float w = p.weights[6];
        const float eu = my - mx;
        const float equ = 3.0f * eu;
        const float shared = w * (rho + half_icsq_rinv * (equ * eu - msq));
        const float beta = w * equ;
        o6 = t6 + om * ((shared + beta) - t6);
        o8 = t8 + om * ((shared - beta) - t8);
      }
      speed = sqrtf(msq) * rho_inv;
    } else {
      // Bounce-back: out[k] = tmp[OPPOSITE[k]].
      o0 = t0;
      o1 = t3; o3 = t1;
      o2 = t4; o4 = t2;
      o5 = t7; o7 = t5;
      o6 = t8; o8 = t6;
    }
    f_out[0 * plane + c] = o0;
    f_out[1 * plane + c] = o1;
    f_out[2 * plane + c] = o2;
    f_out[3 * plane + c] = o3;
    f_out[4 * plane + c] = o4;
    f_out[5 * plane + c] = o5;
    f_out[6 * plane + c] = o6;
    f_out[7 * plane + c] = o7;
    f_out[8 * plane + c] = o8;
  }

  // Fixed-order tree over the block's cells (idle threads contribute 0).
  red[tid] = speed;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

// av[t] = (sum of the block partials) / free_cells, in a fixed order: each
// thread sums a fixed strided subset sequentially, then a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
av_reduce_kernel(const float* __restrict__ partials, int n, float scale,
                 float* __restrict__ av_t) {
  __shared__ float red[kReduceThreads];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) acc += partials[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *av_t = red[0] * scale;
}

dim3 step_grid(int ny, int nx) {
  return dim3((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY);
}

}  // namespace

extern "C" {

// Number of per-block partial sums one step writes, or -1 when the grid
// exceeds the launch limits.
int lbm_num_partials(int ny, int nx) {
  if (ny < 2 || nx < 1) return -1;
  const dim3 g = step_grid(ny, nx);
  if (g.y > static_cast<unsigned>(kMaxGridY)) return -1;
  return static_cast<int>(g.x * g.y);
}

// One step f_in -> f_out; writes av_t[0] = mean |u| over fluid cells.
// Both launches go on `stream`; returns cudaGetLastError() (0 = launched).
int lbm_fused_step(const float* f_in, float* f_out, const uint8_t* fluid,
                   float* partials, float* av_t, const StepParams* params,
                   void* stream) {
  const StepParams p = *params;
  const dim3 grid = step_grid(p.ny, p.nx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lbm_step_kernel<<<grid, dim3(kBlockX, kBlockY), 0, s>>>(f_in, f_out, fluid,
                                                         partials, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  av_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      partials, static_cast<int>(grid.x * grid.y), p.free_cells_inv, av_t);
  return static_cast<int>(cudaGetLastError());
}

const char* lbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
