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
// at 32 x 64 tiles and K = 4 that is 22 B per update against the one-step
// kernel's 73.  The price is redundant work on the halo (the valid region
// shrinks by one cell per side per step, and only it is computed) and
// shared-memory traffic.  A first design (one block per tile, a
// synchronous window load, K steps, a write-back pass) ran at a quarter of
// its bytes bound on an NVIDIA H100 80GB HBM3 at 700 W, and the ablation
// (tools/ablate_step.py, csrc/lbm_ablate.cu; PERF.md) put half its step in
// the window's global<->shared traffic, which nothing overlapped: one
// 210 KB block an SM, every SM loading, then stepping, then storing.
// Design now (lbm_persistent.cuh, shared with the ablation; its times in
// PERF.md):
//   * persistent blocks, as many as the card holds at once (the wrapper
//     reads the SM count and the occupancy once), each walking tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ...;
//   * the next tile's window and mask go by `cp.async` into the buffer the
//     last step of the current tile no longer needs, overlapping that step
//     (two window buffers; a third, whose copy would overlap all K steps,
//     fits only tiles of 32 x 32 and below and measured no faster on an
//     H100, PERF.md);
//   * the last step stores the owned centre straight from registers to
//     f_out;
//   * the |u| of the owned BY x BX cells at each sub-step goes into one
//     partial per (step, tile) from a fixed tree (shuffles within each
//     warp, then the warps' sums in order); `lbm_av_reduce` then sums each
//     step's partials in a fixed order.  No float atomics.
// The per-cell update is `lbm::update_cell` (lbm_cell.cuh), so f is the
// plain version's to the bit.  fp32 throughout, IEEE division and sqrt,
// -fmad=false, as lbm_step.cu.  The x-tiled kernel and the megakernel run
// the in-place sibling of this pass (`lbm::inplace_pass`), the 16-bit
// kernel a sibling with 16-bit copies (lbm_temporal16.cu).
//
// The shard entry, `lbm_shard_temporal_step`, replaces the same kernel as
// the sharded factories use it (lbm_tpu/parallel/sharded.py:1310, the 1-D
// temporal run, and :856, the 2-D one on an x-padded tile, with the two
// kick gates of :1325-1330).  `lbm_shard_temporal_kernel` runs the same
// pass on one shard's tile padded by K cells on every side
// ([9][nyl + 2K][stride], the owned columns from `lpad`, the layout of
// lbm_shard.cu), whose halo the host fills before each pass from the
// neighbouring shards; only its addressing differs (no wrap).  Each
// window cell knows its global row, so the kick lands wherever a window
// row is ny-2, in the shard's own rows or in a halo (JAX's interior and
// wrap sites alike), and its partials cover the owned tiles only.  It
// needs BY | nyl, BX | nxl and K <= min(nyl, nxl) (the halo comes from one
// neighbour); JAX's K <= BY-2 is not needed, since kicks go by global row.

#include "lbm_persistent.cuh"

namespace {

using lbm::kPassThreads;

__global__ void __launch_bounds__(kPassThreads)
lbm_temporal_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                    const uint8_t* __restrict__ fluid, float* __restrict__ partials,
                    const StepParams p, const lbm::PassGeom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[lbm::kRedFloats<kPassThreads>];
  lbm::persistent_pass<kPassThreads, lbm::Stage::kFull>(f_in, f_out, fluid, partials, p,
                                                        g, smem, red);
}

// The shard kernel: the same pass on one shard's K-padded tile.
__global__ void __launch_bounds__(kPassThreads)
lbm_shard_temporal_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                          const uint8_t* __restrict__ mask_in,
                          float* __restrict__ partials, const StepParams p,
                          const lbm::PassGeom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[lbm::kRedFloats<kPassThreads>];
  lbm::persistent_pass<kPassThreads, lbm::Stage::kFull>(f_in, f_out, mask_in, partials, p,
                                                        g, smem, red);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: two window buffers and two mask
// windows.
int lbm_temporal_smem_bytes(int by, int bx, int ksteps) {
  return lbm::pass_smem_bytes(by, bx, ksteps);
}

// The SM count of CUDA device `device` (cudaDevAttrMultiProcessorCount),
// or a negative CUDA error.
int lbm_sm_count(int device) {
  int n = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Blocks of the pass (shard != 0: the shard entry's) that one SM of the
// current device holds at once at this tile: 0 where the windows do not
// fit a block, negative on a CUDA error.
int lbm_temporal_blocks_per_sm(int by, int bx, int ksteps, int shard) {
  return shard ? lbm::pass_blocks_per_sm<kPassThreads>(lbm_shard_temporal_kernel, by, bx,
                                                      ksteps)
               : lbm::pass_blocks_per_sm<kPassThreads>(lbm_temporal_kernel, by, bx,
                                                      ksteps);
}

// One pass of `ksteps` steps f_in -> f_out on by x bx tiles (by | ny,
// bx | nx) by `nblocks` persistent blocks (1 <= nblocks <= tiles); av[s]
// = mean |u| over fluid cells after step s.  `partials` holds ksteps *
// (ny/by) * (nx/bx) floats.  Any base address of f_in and fluid is taken
// (the copies narrow to their alignment).  Returns the first launch error
// (0 = both kernels launched).
int lbm_temporal_step(const float* f_in, float* f_out, const uint8_t* fluid,
                      float* partials, float* av, const StepParams* params, int by,
                      int bx, int ksteps, int nblocks, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || p.ny % by != 0 || p.nx % bx != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const lbm::PassGeom g = lbm::grid_geom(p.ny, p.nx, by, bx, ksteps, f_in, fluid);
  const int err = lbm::launch_pass<kPassThreads>(lbm_temporal_kernel, g, nblocks, stream,
                                                 f_in, f_out, fluid, partials, p);
  if (err != 0) return err;
  return lbm_av_reduce(partials, g.tiles, ksteps, p.free_cells_inv, av, stream);
}

// One pass of `ksteps` steps on an nyl x nxl shard whose global row 0 is
// row0, by `nblocks` persistent blocks (1 <= nblocks <= tiles): f_in (its
// K-cell halo filled) -> the owned cells of f_out, both [9][nyl + 2K]
// [stride] with the owned columns at [lpad, lpad + nxl); sums[s] = the
// unscaled |u| sum over the shard's fluid cells after step s.  `partials`
// holds ksteps * (nyl/by) * (nxl/bx) floats.  Returns the first launch
// error (0 = both kernels launched).
int lbm_shard_temporal_step(const float* f_in, float* f_out, const uint8_t* mask,
                            float* partials, float* sums, const StepParams* params,
                            int nyl, int nxl, int stride, int lpad, int row0, int by,
                            int bx, int ksteps, int nblocks, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || nyl % by != 0 || nxl % bx != 0 ||
      ksteps > nyl || ksteps > nxl || lpad < ksteps || stride < lpad + nxl + ksteps ||
      row0 < 0 || row0 + nyl > p.ny)
    return static_cast<int>(cudaErrorInvalidValue);
  const lbm::PassGeom g =
      lbm::shard_geom(nyl, nxl, stride, lpad, row0, by, bx, ksteps, f_in, mask);
  const int err = lbm::launch_pass<kPassThreads>(lbm_shard_temporal_kernel, g, nblocks,
                                                 stream, f_in, f_out, mask, partials, p);
  if (err != 0) return err;
  return lbm_av_reduce(partials, g.tiles, ksteps, 1.0f, sums, stream);
}

}  // extern "C"
