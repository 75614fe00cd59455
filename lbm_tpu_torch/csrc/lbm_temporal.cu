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
// runs at about a quarter of its bytes bound on an NVIDIA H100 80GB HBM3
// at 700 W, flat across tile shapes and K.  The ablation
// (tools/ablate_step.py, csrc/lbm_ablate.cu; PERF.md) puts about half its
// step in the window's global<->shared loads and stores, which nothing
// overlaps with the K steps; what bounds the rest is not measured yet.
// Design, kept simple for a first kernel:
//   * one block per tile, grid (nx/BX, ny/BY); the window, with periodic
//     wrap in both axes, and its mask go into dynamic shared memory, and
//     `lbm::advance_window` (lbm_window.cuh, shared with the x-tiled and
//     mega kernels) runs the K steps there;
//   * the |u| of the owned BY x BX cells at each sub-step goes into one
//     partial per (step, tile) from a fixed tree; `lbm_av_reduce` then sums
//     each step's partials in a fixed order.  No float atomics.
// fp32 throughout, IEEE division and sqrt, -fmad=false, as lbm_step.cu.
// The same pass with f stored in 16 bits is lbm_temporal16.cu.
//
// The shard entry, `lbm_shard_temporal_step`, replaces the same kernel as
// the sharded factories use it (lbm_tpu/parallel/sharded.py:1310, the 1-D
// temporal run, and :856, the 2-D one on an x-padded tile, with the two
// kick gates of :1325-1330).  `lbm_shard_temporal_kernel` runs the same
// window steps (`lbm::advance_window`) on one shard's tile padded by K
// cells on every side ([9][nyl + 2K][stride], the owned columns from
// `lpad`, the layout of lbm_shard.cu), whose halo the host fills before
// each pass from the neighbouring shards.  Only the window load and the
// write-back differ: they address the tile without wrap.  advance_window
// gets each window's global row, so the kick lands wherever a window row
// is ny-2, in the shard's own rows or in a halo (JAX's interior and wrap
// sites alike), and its partials cover the owned tiles only.  It needs
// BY | nyl, BX | nxl and K <= min(nyl, nxl) (the halo comes from one
// neighbour); JAX's K <= BY-2 is not needed, since kicks go by global row.
// The single-device kernel stays as it was, its code generation included.

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

// The shard kernel: lbm_temporal_kernel on one shard's tile padded by K
// cells ([9][nyl + 2K][stride], owned cell (0, 0) at element `origin`),
// whose global row 0 is row0.
__global__ void __launch_bounds__(kThreads)
lbm_shard_temporal_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                          const uint8_t* __restrict__ mask_in,
                          float* __restrict__ partials, const StepParams p, int by,
                          int bx, int ksteps, int stride, size_t plane, size_t origin,
                          int row0) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int wy = by + 2 * ksteps;
  const int wx = bx + 2 * ksteps;
  const int wcells = wy * wx;
  uint8_t* mask = reinterpret_cast<uint8_t*>(smem + 18 * wcells);
  // Element of window cell (0, 0): tile row by*blockIdx.y - K, column
  // bx*blockIdx.x - K; both at least -K, within the halo.
  const size_t w0 = origin - static_cast<size_t>(ksteps) * stride - ksteps +
                    static_cast<size_t>(blockIdx.y) * by * stride +
                    static_cast<size_t>(blockIdx.x) * bx;
  const int tid = threadIdx.x;

  for (lbm::RegionWalk<kThreads> w(tid, wx); w.r < wy; w.next()) {
    const int i = w.r * wx + w.c;
    const size_t g = w0 + static_cast<size_t>(w.r) * stride + w.c;
#pragma unroll
    for (int k = 0; k < 9; ++k) smem[k * wcells + i] = f_in[k * plane + g];
    mask[i] = mask_in[g];
  }
  __syncthreads();

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int ntiles = gridDim.x * gridDim.y;
  const int gy0 = row0 + static_cast<int>(blockIdx.y) * by - ksteps;
  const float* fin = lbm::advance_window<kThreads>(smem, by, bx, ksteps, gy0, p, red,
                                                   partials + tile, ntiles);
  const size_t c0 = w0 + static_cast<size_t>(ksteps) * stride + ksteps;
  for (lbm::RegionWalk<kThreads> w(tid, bx); w.r < by; w.next()) {
    const int idx = (w.r + ksteps) * wx + w.c + ksteps;
    const size_t g = c0 + static_cast<size_t>(w.r) * stride + w.c;
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

// One pass of `ksteps` steps on an nyl x nxl shard whose global row 0 is
// row0: f_in (its K-cell halo filled) -> the owned cells of f_out, both
// [9][nyl + 2K][stride] with the owned columns at [lpad, lpad + nxl);
// sums[s] = the unscaled |u| sum over the shard's fluid cells after step
// s.  `partials` holds ksteps * (nyl/by) * (nxl/bx) floats.  Returns the
// first launch error (0 = both kernels launched).
int lbm_shard_temporal_step(const float* f_in, float* f_out, const uint8_t* mask,
                            float* partials, float* sums, const StepParams* params,
                            int nyl, int nxl, int stride, int lpad, int row0, int by,
                            int bx, int ksteps, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || nyl % by != 0 || nxl % bx != 0 ||
      ksteps > nyl || ksteps > nxl || lpad < ksteps || stride < lpad + nxl + ksteps ||
      row0 < 0 || row0 + nyl > p.ny)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lbm_temporal_smem_bytes(by, bx, ksteps);
  cudaError_t err = cudaFuncSetAttribute(
      lbm_shard_temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid(nxl / bx, nyl / by);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lbm_shard_temporal_kernel<<<grid, kThreads, smem, s>>>(
      f_in, f_out, mask, partials, p, by, bx, ksteps, stride,
      static_cast<size_t>(nyl + 2 * ksteps) * stride,
      static_cast<size_t>(ksteps) * stride + lpad, row0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return lbm_av_reduce(partials, static_cast<int>(grid.x * grid.y), ksteps, 1.0f, sums,
                       stream);
}

}  // extern "C"
