// K D2Q9-BGK timesteps per pass on 2-D tiles with f stored in 16 bits
// (__half or __nv_bfloat16) in device memory, on Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_temporal` built with
// `storage=` float16 or bfloat16 (`build_temporal_program(storage=...)`,
// `build_temporal_kernel`): f and the ghost slabs live in device memory
// in the storage type, every operation runs in fp32 on the widened
// values, and the pass rounds once, on store (`final[k].astype(storage)`).
// The TPU kernel carries ghost slabs between passes; here, as in
// lbm_temporal.cu, each tile's halo is re-read from f_in, which holds the
// same rounded values the ghost slabs would.
//
// Bound: its bytes, (9*2 + 9*2 + 1)/K = 37/K per cell update (each cell's
// 9 16-bit populations and its mask byte read once, the 9 populations
// written once), half the fp32 kernel's 73/K; at 32 x 64 tiles and K 4
// that is 2.90 us a step at 1024^2 on an H100 (3.35 TB/s).  Its 104 fp32
// operations an update are then the larger floor (the 18 conversions an
// update are not in that count).  What the halved bytes buy on the card
// is measured (chip_smoke.py phase 10; PERF.md), not assumed: the
// one-tile-per-block fp32 kernel spent about half its step in the window's
// loads and stores, which are latency- more than byte-bound.
// Design, kept simple: the first fp32 temporal kernel's one block per tile,
// grid, 512 threads and two fp32 window buffers in dynamic shared memory
// (`lbm::window_smem_bytes`, no more than the persistent fp32 kernel's, so
// every tile the chooser admits holds), and the same window steps
// (`lbm::advance_window`).  Only the two loops that touch f differ: the
// load widens each value (`__half2float` / `__bfloat162float`), the store
// rounds it to nearest even (`__float2half_rn` / `__float2bfloat16_rn`),
// as torch's `.to()` and XLA's convert do.  The partials and
// `lbm_av_reduce` stay fp32: av comes from the fp32 window, before the
// rounding.  The fp32 kernel (lbm_temporal.cu, now persistent) is not
// templated over the storage type, so its code generation is its own.
// IEEE division and sqrt, -fmad=false, as every kernel of the port.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "lbm_window.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lbm_temporal16_kernel(const T* __restrict__ f_in, T* __restrict__ f_out,
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
    for (int k = 0; k < 9; ++k) smem[k * wcells + i] = widen(f_in[k * plane + g]);
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
    for (int k = 0; k < 9; ++k) f_out[k * plane + g] = narrow<T>(fin[k * wcells + idx]);
  }
}

template <typename T>
int launch_temporal16(const void* f_in, void* f_out, const uint8_t* fluid,
                      float* partials, const StepParams& p, int by, int bx, int ksteps,
                      int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      lbm_temporal16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid(p.nx / bx, p.ny / by);
  lbm_temporal16_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(f_in), static_cast<T*>(f_out), fluid, partials, p, by, bx,
      ksteps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One pass of `ksteps` steps f_in -> f_out on by x bx tiles (by | ny,
// bx | nx), f in 16 bits: bfloat16 when `bf16` is non-zero, else float16.
// av[s] = mean |u| over fluid cells after step s, from the fp32 window.
// `partials` holds ksteps * (ny/by) * (nx/bx) floats.  Returns the first
// launch error (0 = both kernels launched).
int lbm_temporal16_step(const void* f_in, void* f_out, const uint8_t* fluid,
                        float* partials, float* av, const StepParams* params, int by,
                        int bx, int ksteps, int bf16, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || p.ny % by != 0 || p.nx % bx != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lbm::window_smem_bytes(by, bx, ksteps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      bf16 ? launch_temporal16<__nv_bfloat16>(f_in, f_out, fluid, partials, p, by, bx,
                                              ksteps, smem, s)
           : launch_temporal16<__half>(f_in, f_out, fluid, partials, p, by, bx, ksteps,
                                       smem, s);
  if (err != 0) return err;
  return lbm_av_reduce(partials, (p.nx / bx) * (p.ny / by), ksteps, p.free_cells_inv,
                       av, stream);
}

}  // extern "C"
