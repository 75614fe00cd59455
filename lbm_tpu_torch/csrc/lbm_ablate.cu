// The temporal kernel with its stages removed, for attributing its step
// time: hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces: tools/ablate_step.py `_ablated_kernel` (built by
// `build_ablated`): the TPU's temporal schedule (row windows, ghost-slab
// carry) with the body cut down to `noop` (DMA only), `stream` (+ the
// pull rolls) and `collide` (the full physics minus the av reduction).
// Here the three kernels run the schedule of lbm_temporal.cu instead, the
// same code (`lbm::persistent_pass`, lbm_persistent.cuh) at another stage:
// persistent blocks walking the BY x BX tiles, each tile's (BY + 2K) x
// (BX + 2K) window and mask copied by `cp.async` into a free buffer while
// the previous tile steps, the same shared memory and grid as
// `lbm_temporal_kernel`, one launch per pass of K steps, ping-pong f_in ->
// f_out, the last step stored straight to f_out:
//   * noop: load each window and its mask, copy its centre to f_out;
//   * stream: K pull-streams (the valid region shrinking by one cell a side
//     a step), no kick and no collision;
//   * collide: the full per-cell update (`lbm::update_cell`: kick, pull,
//     BGK, bounce-back) at every step, without the |u| partials.
// The production kernel is the fourth mode (`full`), timed as it is.  The
// differences attribute a step to global<->shared loads and stores as
// scheduled, with what of them the steps do not hide (noop), the streaming
// moves (stream - noop), the kick and collision (collide - stream), and
// the |u| reduction (full - collide).
//
// Bound: bytes for noop and stream (each pass must read f and the mask
// once and write f once, 73/K B an update; they do no fp32 arithmetic);
// collide as the temporal kernel.  fp32, IEEE division and sqrt,
// -fmad=false, as every kernel of the port.

#include "lbm_persistent.cuh"

namespace {

using lbm::kPassThreads;
using lbm::Stage;

template <Stage kStage>
__global__ void __launch_bounds__(kPassThreads)
lbm_ablate_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                  const uint8_t* __restrict__ fluid, float* __restrict__ partials,
                  const StepParams p, const lbm::PassGeom g) {
  extern __shared__ __align__(16) float smem[];
  lbm::persistent_pass<kPassThreads, kStage>(f_in, f_out, fluid, partials, p, g, smem,
                                             nullptr);
}

template <Stage kStage>
int launch(const float* f_in, float* f_out, const uint8_t* fluid, const StepParams* params,
           int by, int bx, int ksteps, int nblocks, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || p.ny % by != 0 || p.nx % bx != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return lbm::launch_pass<kPassThreads>(
      lbm_ablate_kernel<kStage>, lbm::grid_geom(p.ny, p.nx, by, bx, ksteps, f_in, fluid),
      nblocks, stream, f_in, f_out, fluid, static_cast<float*>(nullptr), p);
}

}  // namespace

extern "C" {

// One pass of `ksteps` steps f_in -> f_out on by x bx tiles (by | ny,
// bx | nx) by `nblocks` persistent blocks (1 <= nblocks <= tiles), each
// with the stages its name says.  Returns the launch error (0 = launched).
int lbm_ablate_noop(const float* f_in, float* f_out, const uint8_t* fluid,
                    const StepParams* params, int by, int bx, int ksteps, int nblocks,
                    void* stream) {
  return launch<Stage::kNoop>(f_in, f_out, fluid, params, by, bx, ksteps, nblocks, stream);
}

int lbm_ablate_stream(const float* f_in, float* f_out, const uint8_t* fluid,
                      const StepParams* params, int by, int bx, int ksteps, int nblocks,
                      void* stream) {
  return launch<Stage::kStream>(f_in, f_out, fluid, params, by, bx, ksteps, nblocks,
                                stream);
}

int lbm_ablate_collide(const float* f_in, float* f_out, const uint8_t* fluid,
                       const StepParams* params, int by, int bx, int ksteps, int nblocks,
                       void* stream) {
  return launch<Stage::kCollide>(f_in, f_out, fluid, params, by, bx, ksteps, nblocks,
                                 stream);
}

}  // extern "C"
