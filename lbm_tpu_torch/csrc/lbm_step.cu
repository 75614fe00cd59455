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
// uses.  The per-cell update itself is `lbm::update_cell` (lbm_cell.cuh),
// shared with the multi-step and temporal kernels.

#include "lbm_cell.cuh"

namespace {

constexpr int kBlockX = 128;
constexpr int kBlockY = 2;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kReduceThreads = 1024;
constexpr int kMaxGridY = 65535;
// Five blocks per SM (at most 51 registers a thread): the occupancy the
// kernel had before its update moved into lbm_cell.cuh.  Left to itself,
// ptxas gave the shared update 56 registers, four blocks per SM, and the
// bandwidth-bound step lost 1.5-2% of its device time (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).
constexpr int kMinBlocksPerSM = 5;

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
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
    // Periodic neighbours: xm/ym for c = +1, xp/yp for c = -1.
    const int ym = lbm::wrap_dec(y, ny);
    const int yp = lbm::wrap_inc(y, ny);
    const size_t ry = static_cast<size_t>(y) * nx;
    const int kr = ny - 2;
    const lbm::GlobalSrc<false> src{
        f_in, fluid, plane, static_cast<size_t>(ym) * nx, ry,
        static_cast<size_t>(yp) * nx, lbm::wrap_dec(x, nx), x, lbm::wrap_inc(x, nx),
        nx, kr};
    float o[9];
    speed = lbm::update_cell(src, y == kr, ym == kr, yp == kr, p, o);
    const size_t c = ry + x;
#pragma unroll
    for (int k = 0; k < 9; ++k) f_out[k * plane + c] = o[k];
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

// av[b] = (sum of partials[b * n .. b * n + n)) * scale for block b, in a
// fixed order: each thread sums a fixed strided subset sequentially, then
// a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
av_reduce_kernel(const float* __restrict__ partials, int n, float scale,
                 float* __restrict__ av) {
  __shared__ float red[kReduceThreads];
  const float* row = partials + static_cast<size_t>(blockIdx.x) * n;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) acc += row[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) av[blockIdx.x] = red[0] * scale;
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

int lbm_av_reduce(const float* partials, int n, int rows, float scale,
                  float* av_out, void* stream) {
  av_reduce_kernel<<<rows, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n, scale, av_out);
  return static_cast<int>(cudaGetLastError());
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
  return lbm_av_reduce(partials, static_cast<int>(grid.x * grid.y), 1,
                       p.free_cells_inv, av_t, stream);
}

const char* lbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
