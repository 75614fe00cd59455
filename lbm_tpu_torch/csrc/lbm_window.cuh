// The one-tile temporal window of the mega and 16-bit kernels: a
// (by + 2K) x (bx + 2K) window of 9 fp32 planes and its uint8 mask in
// dynamic shared memory, advanced K steps in place of the one-step pull.
// The persistent passes (lbm_persistent.cuh) take its cell accessor, walk
// and wrap.
//
// Layout: planes [9][wy][wx] in two buffers (step s reads buffer s & 1 and
// writes the other), then the mask [wy][wx] as bytes; neighbouring threads
// on neighbouring x, so the +-1 column shifts stay conflict-free.  Every
// window cell knows its global row modulo ny, so the body force kicks
// wherever that row is ny-2, at every sub-step, gated on the source cell's
// values in shared memory at that sub-step (JAX's interior and `gate_wrap`
// sites alike; no K <= BY-2 limit).

#pragma once

#include "lbm_cell.cuh"

namespace lbm {

// Source cells in the shared-memory window: planes [9][wy][wx].
struct WindowSrc {
  const float* buf;
  const uint8_t* mask;
  int wx;
  int wcells;
  int idx;

  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return buf[k * wcells + idx + dy * wx + dx];
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return mask[idx + dy * wx + dx] != 0;
  }
  __device__ __forceinline__ bool gate(int dy, int dx, float aw1, float aw2) const {
    return fluid(dy, dx) && f(3, dy, dx) - aw1 > 0.0f && f(6, dy, dx) - aw2 > 0.0f &&
           f(7, dy, dx) - aw2 > 0.0f;
  }
};

// i mod n for any i (window rows and columns lie within K of the grid, so
// the division is rarely taken).
__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// Walks cells [tid, tid + kThreads, ...) of a rows x cols region in row
// order without dividing per cell: the index advances by a fixed number of
// rows and columns, carried.
template <int kThreads>
struct RegionWalk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ RegionWalk(int tid, int cols_)
      : r(tid / cols_), c(tid % cols_), dr(kThreads / cols_), dc(kThreads % cols_),
        cols(cols_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// Dynamic shared memory of one window: two buffers of 9 planes and the mask.
__host__ __device__ __forceinline__ int window_smem_bytes(int by, int bx, int ksteps) {
  const int wcells = (by + 2 * ksteps) * (bx + 2 * ksteps);
  return 18 * wcells * static_cast<int>(sizeof(float)) + wcells;
}

// K steps on the loaded window `smem` (buffer 0 and the mask filled, and a
// barrier passed).  gy0 is the global row of window row 0 (may lie outside
// the grid).  The |u| sum of the owned by x bx centre after step s goes to
// partials[s * pstride] from a fixed tree (thread 0 writes it).  Returns
// the buffer that holds the result; the last tree's barriers order this
// block's writes before any read of it.
template <int kThreads>
__device__ __forceinline__ const float* advance_window(float* smem, int by, int bx,
                                                       int ksteps, int gy0,
                                                       const StepParams& p, float* red,
                                                       float* partials, size_t pstride) {
  const int ny = p.ny;
  const int kr = ny - 2;
  const int wy = by + 2 * ksteps;
  const int wx = bx + 2 * ksteps;
  const int wcells = wy * wx;
  const uint8_t* mask = reinterpret_cast<const uint8_t*>(smem + 18 * wcells);
  const int tid = threadIdx.x;
  for (int s = 0; s < ksteps; ++s) {
    const float* src = smem + (s & 1) * 9 * wcells;
    float* dst = smem + ((s + 1) & 1) * 9 * wcells;
    // Cells valid after this step: [s+1, w-s-1) in each axis.
    const int lo = s + 1;
    float acc = 0.0f;
    for (RegionWalk<kThreads> w(tid, wx - 2 * lo); w.r < wy - 2 * lo; w.next()) {
      const int r = lo + w.r;
      const int c = lo + w.c;
      const int idx = r * wx + c;
      const int gy = wrap(gy0 + r, ny);
      const WindowSrc src_cell{src, mask, wx, wcells, idx};
      float o[9];
      const float speed = update_cell(src_cell, gy == kr, wrap_dec(gy, ny) == kr,
                                      wrap_inc(gy, ny) == kr, p, o);
#pragma unroll
      for (int k = 0; k < 9; ++k) dst[k * wcells + idx] = o[k];
      if (r >= ksteps && r < ksteps + by && c >= ksteps && c < ksteps + bx) acc += speed;
    }
    // The tree's barriers also order this step's writes before the next
    // step's reads.
    const float total = block_sum<kThreads>(acc, red);
    if (tid == 0) partials[static_cast<size_t>(s) * pstride] = total;
  }
  return smem + (ksteps & 1) * 9 * wcells;
}

}  // namespace lbm
