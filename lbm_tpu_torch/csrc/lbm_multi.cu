// N D2Q9-BGK timesteps per launch on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_multi` (built by
// `build_multi_step_program`): the whole grid resident, `steps` timesteps
// per launch, one av per step.  The TPU kernel keeps the 9 planes in VMEM
// and loops inside one program; on Hopper the grid is spread over all SMs,
// so the time loop runs inside one cooperative launch instead, with a
// grid-wide barrier between steps.
//
// The route (ops/schedule.py `multi_route`) gives it the multi-step grids
// (at most ~0.7M cells) that `lbm_multi_bands.cu` does not take in one
// chunk a band, such as 384^2, 512^2 and rows wider than 512; the three
// small canonical grids went to the bands kernel, which is faster there
// (PERF.md).  `MultiStep(route="grid")` still runs it at any grid, and
// phase 3 of chip_smoke.py times it beside the bands kernel.
//
// Bound: the two f buffers stay in the 50 MB L2, so a step moves 73 B per
// cell through L2, not device memory, and the floor is L2 bandwidth plus
// one grid barrier per step; measured, the barrier and one L2 round trip
// per cell are most of a step (PERF.md; NVIDIA H100 80GB HBM3, 700 W).
// The one-step kernel at these sizes is bound by host launch overhead
// (two launches and one ctypes call per step); this kernel makes one
// launch per `steps` steps.  Design, the port's first for this kernel:
//   * one cooperative launch of at most as many 256-thread blocks as are
//     co-resident (occupancy x SM count), and no more than the cells need;
//   * a fixed grid-stride map of cells to threads, neighbouring threads on
//     neighbouring x; step s reads f0 when s is even and f1 when odd and
//     writes the other, through L2 (`ld.global.cg`): other blocks wrote
//     those cells in the previous step, and the read-only path is not
//     coherent within a launch;
//   * `cooperative_groups::this_grid().sync()` between steps;
//   * each block writes one |u| partial per step into partials[s][block];
//     after the last barrier, block b sums step s = b, b + G, ... in a
//     fixed order.  No float atomics: av_vels is the same bits every run.
// fp32 throughout, IEEE division and sqrt, -fmad=false, as lbm_step.cu.

#include <cooperative_groups.h>

#include "lbm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lbm_multi_kernel(float* f0, float* f1, const uint8_t* __restrict__ fluid,
                 float* partials, float* __restrict__ av, int steps,
                 const StepParams p) {
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx;
  const int ny = p.ny;
  const int kr = ny - 2;
  const int ncells = ny * nx;
  const size_t plane = static_cast<size_t>(ncells);
  const int nblocks = gridDim.x;
  const int stride = nblocks * kThreads;

  for (int s = 0; s < steps; ++s) {
    const float* f_in = (s & 1) ? f1 : f0;
    float* f_out = (s & 1) ? f0 : f1;
    float acc = 0.0f;
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < ncells; c += stride) {
      const int y = c / nx;
      const int x = c - y * nx;
      const int ym = lbm::wrap_dec(y, ny);
      const int yp = lbm::wrap_inc(y, ny);
      const lbm::GlobalSrc<true> src{
          f_in, fluid, plane, static_cast<size_t>(ym) * nx,
          static_cast<size_t>(y) * nx, static_cast<size_t>(yp) * nx,
          lbm::wrap_dec(x, nx), x, lbm::wrap_inc(x, nx), nx, kr};
      float o[9];
      acc += lbm::update_cell(src, y == kr, ym == kr, yp == kr, p, o);
#pragma unroll
      for (int k = 0; k < 9; ++k) f_out[k * plane + c] = o[k];
    }
    const float total = lbm::block_sum<kThreads>(acc, red);
    if (threadIdx.x == 0) partials[static_cast<size_t>(s) * nblocks + blockIdx.x] = total;
    grid.sync();
  }

  // Every step's partials are written and visible after the last barrier.
  for (int s = blockIdx.x; s < steps; s += nblocks) {
    const float* row = partials + static_cast<size_t>(s) * nblocks;
    float acc = 0.0f;
    for (int i = threadIdx.x; i < nblocks; i += kThreads) acc += __ldcg(row + i);
    const float total = lbm::block_sum<kThreads>(acc, red);
    if (threadIdx.x == 0) av[s] = total * p.free_cells_inv;
  }
}

}  // namespace

extern "C" {

// Blocks of one launch on the current device for an ny x nx grid: as many
// as are co-resident, capped at what the cells need; -1 on error.
int lbm_multi_num_blocks(int ny, int nx) {
  if (ny < 2 || nx < 1) return -1;
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_multi_kernel, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  const long long need = (static_cast<long long>(ny) * nx + kThreads - 1) / kThreads;
  const long long coresident = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(need < coresident ? need : coresident);
}

// `steps` steps in one cooperative launch of `nblocks` blocks: step s reads
// f0 (s even) or f1 (s odd) and writes the other; av[s] = mean |u| over
// fluid cells after step s.  `partials` holds steps * nblocks floats.
// Returns the launch's error code (0 = launched).
int lbm_multi_step(float* f0, float* f1, const uint8_t* fluid, float* partials,
                   float* av, int steps, int nblocks, const StepParams* params,
                   void* stream) {
  StepParams p = *params;
  void* args[] = {&f0, &f1, &fluid, &partials, &av, &steps, &p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lbm_multi_kernel), dim3(nblocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
