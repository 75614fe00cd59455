// The temporal kernel with its stages removed, for attributing its step
// time: hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces: tools/ablate_step.py `_ablated_kernel` (built by
// `build_ablated`): the TPU's temporal schedule (row windows, ghost-slab
// carry) with the body cut down to `noop` (DMA only), `stream` (+ the
// pull rolls) and `collide` (the full physics minus the av reduction).
// Here the three kernels run the schedule of lbm_temporal.cu instead: one
// block per BY x BX tile, its (BY + 2K) x (BX + 2K) window with periodic
// wrap and its mask loaded into the same dynamic shared memory as
// `lbm_temporal_kernel` (so the same occupancy), one launch per pass of K
// steps, ping-pong f_in -> f_out, the BY x BX centre written back:
//   * noop: load the window and its mask, write the centre back;
//   * stream: and K pull-streams between the two window buffers (the
//     valid region shrinking by one cell a side a step, as in
//     `lbm::advance_window`), no kick and no collision;
//   * collide: the full per-cell update (`lbm::update_cell`: kick, pull,
//     BGK, bounce-back) at every step, without the |u| partials.
// The production kernel is the fourth mode (`full`), timed as it is.  The
// differences attribute a step to global<->shared loads and stores
// (noop), the streaming moves (stream - noop), the kick and collision
// (collide - stream), and the |u| reduction (full - collide).  The
// production kernels (lbm_temporal.cu, lbm_window.cuh) are not templated
// or flagged for this: these loops are written here, so their code stays
// as it was.
//
// Bound: bytes for noop and stream (each pass must read f and the mask
// once and write f once, 73/K B an update; they do no fp32 arithmetic);
// collide as the temporal kernel.  fp32, IEEE division and sqrt,
// -fmad=false, as every kernel of the port.

#include "lbm_window.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kNoop = 0;
constexpr int kStream = 1;
constexpr int kCollide = 2;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
lbm_ablate_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                  const uint8_t* __restrict__ fluid, const StepParams p, int by, int bx,
                  int ksteps) {
  extern __shared__ float smem[];
  const int nx = p.nx;
  const int ny = p.ny;
  const size_t plane = static_cast<size_t>(ny) * nx;
  const int wy = by + 2 * ksteps;
  const int wx = bx + 2 * ksteps;
  const int wcells = wy * wx;
  uint8_t* mask = reinterpret_cast<uint8_t*>(smem + 18 * wcells);
  const int gy0 = blockIdx.y * by - ksteps;
  const int gx0 = blockIdx.x * bx - ksteps;
  const int tid = threadIdx.x;

  // The window load of lbm_temporal_kernel.
  for (lbm::RegionWalk<kThreads> w(tid, wx); w.r < wy; w.next()) {
    const int i = w.r * wx + w.c;
    const size_t g = static_cast<size_t>(lbm::wrap(gy0 + w.r, ny)) * nx +
                     lbm::wrap(gx0 + w.c, nx);
#pragma unroll
    for (int k = 0; k < 9; ++k) smem[k * wcells + i] = f_in[k * plane + g];
    mask[i] = fluid[g];
  }
  __syncthreads();

  if (kMode != kNoop) {
    const int kr = ny - 2;
    for (int s = 0; s < ksteps; ++s) {
      const float* src = smem + (s & 1) * 9 * wcells;
      float* dst = smem + ((s + 1) & 1) * 9 * wcells;
      const int lo = s + 1;
      for (lbm::RegionWalk<kThreads> w(tid, wx - 2 * lo); w.r < wy - 2 * lo; w.next()) {
        const int idx = (lo + w.r) * wx + lo + w.c;
        const lbm::WindowSrc cell{src, mask, wx, wcells, idx};
        float o[9];
        if (kMode == kStream) {
          // The pull of update_cell: tmp[k](y, x) = f[k](y - cy_k, x - cx_k).
          o[0] = cell.f(0, 0, 0);
          o[1] = cell.f(1, 0, -1);
          o[2] = cell.f(2, -1, 0);
          o[3] = cell.f(3, 0, 1);
          o[4] = cell.f(4, 1, 0);
          o[5] = cell.f(5, -1, -1);
          o[6] = cell.f(6, -1, 1);
          o[7] = cell.f(7, 1, 1);
          o[8] = cell.f(8, 1, -1);
        } else {
          const int gy = lbm::wrap(gy0 + lo + w.r, ny);
          lbm::update_cell(cell, gy == kr, lbm::wrap_dec(gy, ny) == kr,
                           lbm::wrap_inc(gy, ny) == kr, p, o);
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k * wcells + idx] = o[k];
      }
      __syncthreads();
    }
  }

  const float* fin = kMode == kNoop ? smem : smem + (ksteps & 1) * 9 * wcells;
  for (lbm::RegionWalk<kThreads> w(tid, bx); w.r < by; w.next()) {
    const int idx = (w.r + ksteps) * wx + w.c + ksteps;
    const size_t g =
        static_cast<size_t>(blockIdx.y * by + w.r) * nx + blockIdx.x * bx + w.c;
#pragma unroll
    for (int k = 0; k < 9; ++k) f_out[k * plane + g] = fin[k * wcells + idx];
  }
}

template <int kMode>
int launch(const float* f_in, float* f_out, const uint8_t* fluid, const StepParams* params,
           int by, int bx, int ksteps, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || p.ny % by != 0 || p.nx % bx != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lbm::window_smem_bytes(by, bx, ksteps);
  cudaError_t err = cudaFuncSetAttribute(
      lbm_ablate_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid(p.nx / bx, p.ny / by);
  lbm_ablate_kernel<kMode><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      f_in, f_out, fluid, p, by, bx, ksteps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One pass of `ksteps` steps f_in -> f_out on by x bx tiles (by | ny,
// bx | nx), each with the stages its name says.  Returns the launch error
// (0 = launched).
int lbm_ablate_noop(const float* f_in, float* f_out, const uint8_t* fluid,
                    const StepParams* params, int by, int bx, int ksteps, void* stream) {
  return launch<kNoop>(f_in, f_out, fluid, params, by, bx, ksteps, stream);
}

int lbm_ablate_stream(const float* f_in, float* f_out, const uint8_t* fluid,
                      const StepParams* params, int by, int bx, int ksteps, void* stream) {
  return launch<kStream>(f_in, f_out, fluid, params, by, bx, ksteps, stream);
}

int lbm_ablate_collide(const float* f_in, float* f_out, const uint8_t* fluid,
                       const StepParams* params, int by, int bx, int ksteps,
                       void* stream) {
  return launch<kCollide>(f_in, f_out, fluid, params, by, bx, ksteps, stream);
}

}  // extern "C"
