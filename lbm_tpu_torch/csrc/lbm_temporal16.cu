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
// is measured (chip_smoke.py phase 10; PERF.md), not assumed.
//
// Design: the fp32 kernel's persistent pass (lbm_persistent.cuh), as a
// sibling function, `persistent16_pass`, with the same walk, window
// buffers, |u| slots and `warp0_tree_sum`, so av keeps its bits, and the
// same footprint (`lbm::pass_smem_bytes`), so every tile the chooser
// admits fits with no budget of its own.  Only the copies of f differ:
//   * staging: the next tile's 16-bit window goes by `cp.async` into the
//     fp32 buffer the current tile's last step frees (it stores to f_out),
//     as the fp32 window does; the tile's first step reads it there,
//     widening each value as it reads it (`__half2float` /
//     `__bfloat162float`, exact), and writes fp32 into the other buffer,
//     which the last step read; the other K - 1 steps run on fp32 as
//     before (a separate widening pass into the other buffer before K fp32
//     steps, one more pass over the window and one more barrier a tile,
//     measured slower in turns on an H100);
//   * copy width: chunks of `vec` values (8, 4 or 2: 16-, 8- or 4-byte
//     copies), the largest that divides nx, BX, K and f_in's base address
//     in values (the fp32 rule of lbm::pass_vec), so every window row
//     starts on a chunk and the stage is the window itself (at 32 x 64
//     and K 4: 8-byte copies; copying each row's aligned span in 16-byte
//     chunks instead took, by `fp16_experiment time` on an H100, 1.5%
//     longer at 1024^2 and 5% less at 4096^2, for a span stride and a
//     per-tile offset: PERF.md); where one of them is odd in values (a
//     cp.async moves at least 4 bytes), plain loads, as the mask's where
//     it is not 4-byte aligned;
//   * the last step rounds (`__float2half_rn` / `__float2bfloat16_rn`, to
//     nearest even, as torch's `.to()` and XLA's convert) and stores from
//     registers straight to f_out.
// The partials and `lbm_av_reduce` stay fp32: av comes from the fp32
// window, before the rounding.  The fp32 kernel (lbm_temporal.cu) is not
// templated over the storage type, so its code generation is its own.
// IEEE division and sqrt, -fmad=false, as every kernel of the port.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "lbm_persistent.cuh"

namespace {

using lbm::kPassThreads;

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

// The geometry of a 16-bit pass over the periodic ny x nx grid.  A staged
// window is [9][wy][wx] 16-bit values at the start of its fp32 buffer
// (aligned to a chunk: the buffer's offset, 9 wy wx floats, is a multiple
// of wx, so of vec).
struct Geom16 {
  int by, bx, ksteps;
  int tiles_x, tiles;  // tiles along x, and in all
  int vec;             // 16-bit values per f copy: 8, 4, 2, or 1 (plain loads); -1: misaligned
  int mvec;            // mask bytes per copy: 4 (cp.async) or 1 (plain loads)
  int ny, nx;
  size_t plane;
};

// Source cells in a staged 16-bit window, widened as they are read (step
// 0 of a tile): planes [9][wy][wx], as lbm::WindowSrc.
template <typename T>
struct StagedSrc {
  const T* buf;
  const uint8_t* mask;
  int wx;
  int wcells;
  int idx;

  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return widen(buf[k * wcells + idx + dy * wx + dx]);
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return mask[idx + dy * wx + dx] != 0;
  }
  __device__ __forceinline__ bool gate(int dy, int dx, float aw1, float aw2) const {
    return fluid(dy, dx) && f(3, dy, dx) - aw1 > 0.0f && f(6, dy, dx) - aw2 > 0.0f &&
           f(7, dy, dx) - aw2 > 0.0f;
  }
};

// Issues the copies of tile t's window: 9 16-bit planes into `stage`, the
// mask into `m`; the caller commits them.
template <typename T, int kThreads>
__device__ __forceinline__ void issue_window16(const T* __restrict__ f,
                                               const uint8_t* __restrict__ mask,
                                               const Geom16& g, int t, T* stage, uint8_t* m) {
  const int k = g.ksteps;
  const int wx = g.bx + 2 * k;
  const int wy = g.by + 2 * k;
  const int ty = t / g.tiles_x;
  const int y0 = ty * g.by - k;
  const int x0 = (t - ty * g.tiles_x) * g.bx - k;
  const int wcells = wy * wx;
  const int v = g.vec;
  for (lbm::RegionWalk<kThreads> w(threadIdx.x, wx / v); w.r < wy; w.next()) {
    const int i = w.r * wx + v * w.c;
    // A chunk starts v-aligned and v divides nx, so it never straddles the wrap.
    const size_t s = static_cast<size_t>(lbm::wrap(y0 + w.r, g.ny)) * g.nx +
                     lbm::wrap(x0 + v * w.c, g.nx);
    if (v == 8) {
#pragma unroll
      for (int q = 0; q < 9; ++q) lbm::cp_async16(stage + q * wcells + i, f + q * g.plane + s);
    } else if (v == 4) {
#pragma unroll
      for (int q = 0; q < 9; ++q) lbm::cp_async8(stage + q * wcells + i, f + q * g.plane + s);
    } else if (v == 2) {
#pragma unroll
      for (int q = 0; q < 9; ++q) lbm::cp_async4(stage + q * wcells + i, f + q * g.plane + s);
    } else {
#pragma unroll
      for (int q = 0; q < 9; ++q) stage[q * wcells + i] = f[q * g.plane + s];
    }
  }
  const int mv = g.mvec;
  for (lbm::RegionWalk<kThreads> w(threadIdx.x, wx / mv); w.r < wy; w.next()) {
    const int i = w.r * wx + mv * w.c;
    const size_t s = static_cast<size_t>(lbm::wrap(y0 + w.r, g.ny)) * g.nx +
                     lbm::wrap(x0 + mv * w.c, g.nx);
    if (mv == 4)
      lbm::cp_async4(m + i, mask + s);
    else
      m[i] = mask[s];
  }
}

// One 16-bit pass over this block's tiles by kThreads threads: the walk,
// steps, |u| slots and partials of lbm::persistent_pass<kThreads,
// Stage::kFull>, with each window staged in 16 bits, its first step
// reading the stage, and the last step rounded on store.
template <typename T, int kThreads>
__device__ __forceinline__ void persistent16_pass(const T* __restrict__ f_in,
                                                  T* __restrict__ f_out,
                                                  const uint8_t* __restrict__ mask_in,
                                                  float* __restrict__ partials,
                                                  const StepParams& p, const Geom16& g,
                                                  float* smem, float* red) {
  const int ksteps = g.ksteps;
  const int wy = g.by + 2 * ksteps;
  const int wx = g.bx + 2 * ksteps;
  const int wcells = wy * wx;
  const int planes = 9 * wcells;
  const int ny = p.ny;
  const int kr = ny - 2;
  const int tid = threadIdx.x;
  uint8_t* const masks = reinterpret_cast<uint8_t*>(smem + 2 * planes);
  auto stage_of = [&](int buf) { return reinterpret_cast<T*>(smem + buf); };
  int staged = 0;  // the buffer that holds the tile's staged window
  int mcur = 0;
  int parity = 0;  // the |u| slot, alternating over every step of the pass

  int t = blockIdx.x;
  if (t < g.tiles) issue_window16<T, kThreads>(f_in, mask_in, g, t, stage_of(staged), masks);
  lbm::cp_async_commit();
  for (; t < g.tiles; t += gridDim.x) {
    const int tn = t + gridDim.x;
    uint8_t* const mask_next = masks + wcells - mcur;
    lbm::cp_async_wait<0>();
    __syncthreads();

    const int ty = t / g.tiles_x;
    const int tx = t - ty * g.tiles_x;
    const int y0 = ty * g.by - ksteps;
    const int x0 = tx * g.bx - ksteps;
    const uint8_t* mask = masks + mcur;
    const T* const st = stage_of(staged);
    // Step 0 reads the stage in buffer `staged` and writes the other.
    int src = staged, dst = planes - staged;
    for (int s = 0; s < ksteps; ++s) {
      const bool last = s == ksteps - 1;
      if (last) {
        // The last step writes f_out, so its destination buffer is free.
        if (tn < g.tiles)
          issue_window16<T, kThreads>(f_in, mask_in, g, tn, stage_of(dst), mask_next);
        lbm::cp_async_commit();
      }
      // Cells valid after this step: [s+1, w-s-1) in each axis; the last
      // step's are the owned centre.
      const int lo = s + 1;
      float acc = 0.0f;
      for (lbm::RegionWalk<kThreads> w(tid, wx - 2 * lo); w.r < wy - 2 * lo; w.next()) {
        const int r = lo + w.r;
        const int c = lo + w.c;
        const int idx = r * wx + c;
        float o[9];
        const int gy = lbm::wrap(y0 + r, ny);
        float speed;
        if (s == 0) {
          const StagedSrc<T> cell{st, mask, wx, wcells, idx};
          speed = lbm::update_cell(cell, gy == kr, lbm::wrap_dec(gy, ny) == kr,
                                   lbm::wrap_inc(gy, ny) == kr, p, o);
        } else {
          const lbm::WindowSrc cell{smem + src, mask, wx, wcells, idx};
          speed = lbm::update_cell(cell, gy == kr, lbm::wrap_dec(gy, ny) == kr,
                                   lbm::wrap_inc(gy, ny) == kr, p, o);
        }
        if (r >= ksteps && r < ksteps + g.by && c >= ksteps && c < ksteps + g.bx)
          acc += speed;
        if (last) {
          const size_t out = static_cast<size_t>(y0 + r) * g.nx + x0 + c;
#pragma unroll
          for (int q = 0; q < 9; ++q) f_out[q * g.plane + out] = narrow<T>(o[q]);
        } else {
          float* d = smem + dst;
#pragma unroll
          for (int q = 0; q < 9; ++q) d[q * wcells + idx] = o[q];
        }
      }
      red[parity * kThreads + tid] = acc;
      // Ends this step's reads of `src` and orders its writes (and the
      // threads' sums) before the next step's reads.
      __syncthreads();
      if (tid < 32) {
        const float total = lbm::warp0_tree_sum<kThreads>(red + parity * kThreads);
        if (tid == 0) partials[static_cast<size_t>(s) * g.tiles + t] = total;
      }
      parity ^= 1;
      const int tmp = src;
      src = dst;
      dst = tmp;
    }
    // The next tile's staged window is in the last step's destination,
    // now `src`.
    staged = src;
    mcur = wcells - mcur;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPassThreads)
lbm_temporal16_kernel(const T* __restrict__ f_in, T* __restrict__ f_out,
                      const uint8_t* __restrict__ fluid, float* __restrict__ partials,
                      const StepParams p, const Geom16 g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[lbm::kRedFloats<kPassThreads>];
  persistent16_pass<T, kPassThreads>(f_in, f_out, fluid, partials, p, g, smem, red);
}

// The geometry of a 16-bit pass from f_in (its mask `fluid`): vec the
// largest of 8, 4, 2 dividing nx, BX, K and f_in's address in values,
// else 1 (plain loads; -1 where f_in is not 2-byte aligned); the mask's
// 4-byte copies where nx, BX, K and its address are multiples of 4.
Geom16 geom16(int ny, int nx, int by, int bx, int ksteps, const void* f_in,
              const uint8_t* fluid) {
  Geom16 g{};
  g.by = by;
  g.bx = bx;
  g.ksteps = ksteps;
  g.tiles_x = nx / bx;
  g.tiles = (ny / by) * g.tiles_x;
  g.ny = ny;
  g.nx = nx;
  g.plane = static_cast<size_t>(ny) * nx;
  const uintptr_t fa = reinterpret_cast<uintptr_t>(f_in);
  const uintptr_t all = static_cast<uintptr_t>(nx | bx | ksteps) | (fa >> 1);
  g.vec = (fa & 1) ? -1 : (all & 7) == 0 ? 8 : (all & 3) == 0 ? 4 : (all & 1) == 0 ? 2 : 1;
  const bool m4 = nx % 4 == 0 && bx % 4 == 0 && ksteps % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(fluid) & 3) == 0;
  g.mvec = m4 ? 4 : 1;
  return g;
}

}  // namespace

extern "C" {

// Blocks of the 16-bit pass (bf16 != 0: its bfloat16 instantiation) that
// one SM of the current device holds at once at this tile: 0 where the
// windows do not fit a block, negative on a CUDA error.
int lbm_temporal16_blocks_per_sm(int by, int bx, int ksteps, int bf16) {
  return bf16 ? lbm::pass_blocks_per_sm<kPassThreads>(lbm_temporal16_kernel<__nv_bfloat16>,
                                                      by, bx, ksteps)
              : lbm::pass_blocks_per_sm<kPassThreads>(lbm_temporal16_kernel<__half>, by,
                                                      bx, ksteps);
}

// One pass of `ksteps` steps f_in -> f_out on by x bx tiles (by | ny,
// bx | nx) by `nblocks` persistent blocks (1 <= nblocks <= tiles), f in 16
// bits: bfloat16 when `bf16` is non-zero, else float16.  av[s] = mean |u|
// over fluid cells after step s, from the fp32 window.  `partials` holds
// ksteps * (ny/by) * (nx/bx) floats.  Any 2-byte-aligned base address of
// f_in and any of fluid is taken (the copies narrow to them).  Returns the
// first launch error (0 = both kernels launched).
int lbm_temporal16_step(const void* f_in, void* f_out, const uint8_t* fluid,
                        float* partials, float* av, const StepParams* params, int by,
                        int bx, int ksteps, int nblocks, int bf16, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || p.ny % by != 0 || p.nx % bx != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom16 g = geom16(p.ny, p.nx, by, bx, ksteps, f_in, fluid);
  const int err =
      bf16 ? lbm::launch_pass<kPassThreads>(
                 lbm_temporal16_kernel<__nv_bfloat16>, g, nblocks, stream,
                 static_cast<const __nv_bfloat16*>(f_in), static_cast<__nv_bfloat16*>(f_out),
                 fluid, partials, p)
           : lbm::launch_pass<kPassThreads>(lbm_temporal16_kernel<__half>, g, nblocks,
                                            stream, static_cast<const __half*>(f_in),
                                            static_cast<__half*>(f_out), fluid, partials, p);
  if (err != 0) return err;
  return lbm_av_reduce(partials, g.tiles, ksteps, p.free_cells_inv, av, stream);
}

}  // extern "C"
