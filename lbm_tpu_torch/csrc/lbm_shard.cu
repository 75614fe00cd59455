// One D2Q9-BGK timestep on one shard's halo-padded tile, on Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_blocked_gated` (the blocked
// kernel with its runtime kick gate in SMEM, `dynamic_accel_gate=True`),
// as the sharded factories build it (lbm_tpu/parallel/sharded.py:407, the
// 1-D fused run, and :563, the 2-D fused run on an x-padded tile), and
// with it `_step_kernel_blocked` as those factories use it.
//
// The tile.  A shard of a py x px mesh owns nyl x nxl cells.  Its buffer
// is [9][nyl + 2][stride]: one halo row above and below, and the owned
// columns start at `lpad` (a whole number of 32 floats, so every owned row
// starts on a 128-byte boundary and the warps' plane reads stay coalesced
// as in lbm_step.cu) with one halo column on each side of them; `stride` is
// also a multiple of 32.  The host fills the halo before each step (two
// phases: rows from the y-neighbours, then columns over all padded rows
// from the x-neighbours, so the corners ride along; halo.py), and the
// uint8 mask is padded the same way with the neighbours' cells.  So the
// pull reads its nine sources straight from the tile, with no wrap.
//
// The kick.  Instead of JAX's gate (only the shard that owns row ny-2
// kicks), each thread is given its global row: row0 + y.  It kicks the
// speeds whose source row, modulo ny, is ny-2, gated on the source cell's
// pre-kick values, as every other kernel of the port does (lbm_cell.cuh).
// A halo row holds the neighbour's pre-step values and mask, so a tile's
// f equals the same cells of a single-device step to the bit.
//
// Bound: device-memory bytes, as lbm_step.cu: 73 B an owned cell plus the
// halo ring read once (9 fp32 and the mask byte), about 2 * (nyl + nxl)
// cells.  One thread per cell, 128 x 2 blocks on neighbouring x, ping-pong
// f_in -> f_out (only the owned cells of f_out are written).
//
// The |u| sum: one partial per block from a fixed tree, and
// `lbm_av_reduce` (scale 1) sums them in a fixed order into the shard's
// unscaled sum for the step; the host adds the shards' sums in mesh order
// and scales by 1/free_cells.  No float atomics.
// fp32 throughout, IEEE division and sqrt, -fmad=false, as lbm_step.cu.

#include "lbm_cell.cuh"

namespace {

constexpr int kBlockX = 128;
constexpr int kBlockY = 2;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kMaxGridY = 65535;
constexpr int kMinBlocksPerSM = 5;  // as lbm_step.cu

// Source cells in the padded tile: the cell at element offset c of a plane
// and its neighbours dy rows and dx columns away.
struct PaddedSrc {
  const float* base;
  const uint8_t* mask;
  size_t plane;
  size_t c;
  int stride;

  __device__ __forceinline__ ptrdiff_t at(int dy, int dx) const {
    return static_cast<ptrdiff_t>(c) + static_cast<ptrdiff_t>(dy) * stride + dx;
  }
  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return __ldg(base + static_cast<ptrdiff_t>(k * plane) + at(dy, dx));
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return __ldg(mask + at(dy, dx)) != 0;
  }
  __device__ __forceinline__ bool gate(int dy, int dx, float aw1, float aw2) const {
    return fluid(dy, dx) && f(3, dy, dx) - aw1 > 0.0f && f(6, dy, dx) - aw2 > 0.0f &&
           f(7, dy, dx) - aw2 > 0.0f;
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
lbm_shard_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                 const uint8_t* __restrict__ mask, float* __restrict__ partials,
                 const StepParams p, int nyl, int nxl, int stride, size_t plane,
                 size_t origin, int row0) {
  __shared__ float red[kThreads];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  float speed = 0.0f;

  if (x < nxl && y < nyl) {
    const int ny = p.ny;
    const int kr = ny - 2;
    const int gy = row0 + y;  // an owned row: in [0, ny)
    const size_t c = origin + static_cast<size_t>(y) * stride + x;
    const PaddedSrc src{f_in, mask, plane, c, stride};
    float o[9];
    speed = lbm::update_cell(src, gy == kr, lbm::wrap_dec(gy, ny) == kr,
                             lbm::wrap_inc(gy, ny) == kr, p, o);
#pragma unroll
    for (int k = 0; k < 9; ++k) f_out[k * plane + c] = o[k];
  }

  const float total = lbm::block_sum<kThreads>(speed, red);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

dim3 shard_grid(int nyl, int nxl) {
  return dim3((nxl + kBlockX - 1) / kBlockX, (nyl + kBlockY - 1) / kBlockY);
}

}  // namespace

extern "C" {

// Number of per-block partial sums one shard step writes, or -1 when the
// tile exceeds the launch limits.
int lbm_shard_num_partials(int nyl, int nxl) {
  if (nyl < 1 || nxl < 1) return -1;
  const dim3 g = shard_grid(nyl, nxl);
  if (g.y > static_cast<unsigned>(kMaxGridY)) return -1;
  return static_cast<int>(g.x * g.y);
}

// One step of an nyl x nxl shard whose global row 0 is row0: f_in (its
// one-cell halo filled) -> the owned cells of f_out, both [9][nyl + 2]
// [stride] with the owned columns at [lpad, lpad + nxl); sum_out[0] = the
// unscaled |u| sum over the shard's fluid cells.  Returns the first launch
// error (0 = both kernels launched).
int lbm_shard_step(const float* f_in, float* f_out, const uint8_t* mask, float* partials,
                   float* sum_out, const StepParams* params, int nyl, int nxl, int stride,
                   int lpad, int row0, void* stream) {
  const StepParams p = *params;
  const int n = lbm_shard_num_partials(nyl, nxl);
  if (n < 0 || lpad < 1 || stride < lpad + nxl + 1 || row0 < 0 || row0 + nyl > p.ny)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t plane = static_cast<size_t>(nyl + 2) * stride;
  const size_t origin = static_cast<size_t>(stride) + lpad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lbm_shard_kernel<<<shard_grid(nyl, nxl), dim3(kBlockX, kBlockY), 0, s>>>(
      f_in, f_out, mask, partials, p, nyl, nxl, stride, plane, origin, row0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return lbm_av_reduce(partials, n, 1, 1.0f, sum_out, stream);
}

}  // extern "C"
