// K D2Q9-BGK timesteps per pass on 2-D tiles, on Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_temporal` (body
// `_window_advance`, built by `build_temporal_kernel` /
// `build_temporal_program`): trapezoidal temporal blocking, K steps per
// pass of f through device memory, K av values per pass.  The TPU kernel
// takes windows of whole rows and carries [P, K, 9, nx] ghost slabs
// between passes; a 1024-wide row of 9 fp32 planes is 36 KiB, and a
// Hopper block has at most 227 KB of shared memory, so here the window is
// a 2-D tile and the halo is simply re-read from f_in each pass.
//
// Bound: its bytes, 73/K per cell update, are the least it must move.  A
// pass reads a (BY+2K) x (BX+2K) window (9 fp32 + 1 uint8 mask byte per
// cell) and writes the BY x BX centre (9 fp32), for BY*BX*K cell updates:
// at 32 x 64 tiles and K = 4 (the chooser's pick at 1024^2) that is 22 B
// per update against the one-step kernel's 73.  The price is redundant
// work on the halo (the valid region shrinks by one cell per side per
// step, and only it is computed) and shared-memory traffic.  As built it
// is bound by instruction throughput, not bytes: about a quarter of its bytes
// bound on an NVIDIA H100 80GB HBM3 at 700 W, flat across tile shapes
// and K (PERF.md).
// Design, kept simple for a first kernel:
//   * one block per tile, grid (nx/BX, ny/BY); the window, with periodic
//     wrap in both axes, and its mask go into dynamic shared memory, and
//     `lbm::advance_window` (lbm_window.cuh, shared with the x-tiled and
//     mega kernels) runs the K steps there;
//   * the |u| of the owned BY x BX cells at each sub-step goes into one
//     partial per (step, tile) from a fixed tree; `lbm_av_reduce` then sums
//     each step's partials in a fixed order.  No float atomics.
// fp32 throughout, IEEE division and sqrt, -fmad=false, as lbm_step.cu.

#include "lbm_window.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
lbm_temporal_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                    const uint8_t* __restrict__ fluid, float* __restrict__ partials,
                    const StepParams p, int by, int bx, int ksteps) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int nx = p.nx;
  const int ny = p.ny;
  const size_t plane = static_cast<size_t>(ny) * nx;
  const int wy = by + 2 * ksteps;
  const int wx = bx + 2 * ksteps;
  const int wcells = wy * wx;
  uint8_t* mask = reinterpret_cast<uint8_t*>(smem + 18 * wcells);
  // Global row and column of window cell (0, 0); may lie outside the grid.
  const int gy0 = blockIdx.y * by - ksteps;
  const int gx0 = blockIdx.x * bx - ksteps;
  const int tid = threadIdx.x;

  for (lbm::RegionWalk<kThreads> w(tid, wx); w.r < wy; w.next()) {
    const int i = w.r * wx + w.c;
    const size_t g = static_cast<size_t>(lbm::wrap(gy0 + w.r, ny)) * nx +
                     lbm::wrap(gx0 + w.c, nx);
#pragma unroll
    for (int k = 0; k < 9; ++k) smem[k * wcells + i] = f_in[k * plane + g];
    mask[i] = fluid[g];
  }
  __syncthreads();

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int ntiles = gridDim.x * gridDim.y;
  const float* fin = lbm::advance_window<kThreads>(smem, by, bx, ksteps, gy0, p, red,
                                                   partials + tile, ntiles);
  for (lbm::RegionWalk<kThreads> w(tid, bx); w.r < by; w.next()) {
    const int idx = (w.r + ksteps) * wx + w.c + ksteps;
    const size_t g =
        static_cast<size_t>(blockIdx.y * by + w.r) * nx + blockIdx.x * bx + w.c;
#pragma unroll
    for (int k = 0; k < 9; ++k) f_out[k * plane + g] = fin[k * wcells + idx];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: two window buffers and the mask.
int lbm_temporal_smem_bytes(int by, int bx, int ksteps) {
  return lbm::window_smem_bytes(by, bx, ksteps);
}

// One pass of `ksteps` steps f_in -> f_out on by x bx tiles (by | ny,
// bx | nx); av[s] = mean |u| over fluid cells after step s.  `partials`
// holds ksteps * (ny/by) * (nx/bx) floats.  Returns the first launch
// error (0 = both kernels launched).
int lbm_temporal_step(const float* f_in, float* f_out, const uint8_t* fluid,
                      float* partials, float* av, const StepParams* params, int by,
                      int bx, int ksteps, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || p.ny % by != 0 || p.nx % bx != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lbm_temporal_smem_bytes(by, bx, ksteps);
  cudaError_t err = cudaFuncSetAttribute(
      lbm_temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid(p.nx / bx, p.ny / by);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lbm_temporal_kernel<<<grid, kThreads, smem, s>>>(f_in, f_out, fluid, partials, p,
                                                   by, bx, ksteps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return lbm_av_reduce(partials, static_cast<int>(grid.x * grid.y), ksteps,
                       p.free_cells_inv, av, stream);
}

}  // extern "C"
