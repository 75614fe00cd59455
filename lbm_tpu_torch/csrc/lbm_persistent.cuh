// The persistent temporal passes of every window kernel: the temporal
// kernel and its shard entry (lbm_temporal.cu), the ablation kernels
// (lbm_ablate.cu), which cut its steps down stage by stage, and the 16-bit
// kernel (lbm_temporal16.cu, a sibling that stages 16-bit copies); and the
// in-place sibling, `inplace_pass`, of the x-tiled kernel, its shard entry
// and the megakernel (lbm_temporal_xt.cu).
//
// A pass does K steps on every BY x BX tile of the grid (or of one shard's
// K-padded tile), each on its (BY + 2K) x (BX + 2K) window of 9 fp32
// planes and its uint8 mask in shared memory, advanced K steps in place of
// the one-step pull.  Neighbouring threads take neighbouring x, so the
// +-1 column shifts stay conflict-free.  Every window cell knows its
// global row modulo ny, so the body force kicks wherever that row is
// ny-2, at every sub-step, gated on the source cell's values in shared
// memory at that sub-step (JAX's interior and `gate_wrap` sites alike; no
// K <= BY-2 limit).  The schedule:
//   * persistent blocks: the grid has at most as many blocks as the card
//     holds at once (the wrapper sizes it), and block b walks tiles b,
//     b + gridDim.x, ... in that order;
//   * the next tile's window and mask are copied by `cp.async` into the
//     window buffer the current tile no longer reads: of the two buffers,
//     the destination of its last step, issued before that step, which is
//     free because
//   * the last step writes the owned centre, which is exactly its valid
//     region, from registers straight to f_out: no write-back pass.
//   16-byte copies where every window row segment is 16-byte aligned (f's
//   base address, the row stride, BX and K multiples of 4 floats), else 8-
//   or 4-byte ones; the mask goes by 4-byte copies in the aligned case
//   (its base address too a multiple of 4), and by plain loads otherwise
//   (a cp.async moves at least 4 bytes).
// Each step's |u| partial stays indexed by (step, tile), so av does not
// depend on which block ran a tile, and lbm_av_reduce sums it as before.
//
// Layout of the dynamic shared memory: two window buffers of 9 fp32
// planes [9][wy][wx], then two uint8 mask windows [wy][wx] (the current
// tile's and the next one's).  Ordering: a buffer is refilled only after
// the barrier that ends every read of it (the end of a step), and read
// only after `cp.async.wait_group` and a barrier.

#pragma once

#include "lbm_cell.cuh"

namespace lbm {

// Source cells in a shared-memory window: planes [9][wy][wx].
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

constexpr int kPassThreads = 512;
// Shared memory of the |u| sums: one value per thread in each of two slots
// (by step parity).
template <int kThreads>
constexpr int kRedFloats = 2 * kThreads;
// Dynamic shared memory a block may take: the H100's 227 KB opt-in maximum
// (232,448 bytes) less the pass's static memory, its |u| slots
// (schedule.PERSISTENT_SMEM_BUDGET).
constexpr int kPassSmemBudget =
    232448 - kRedFloats<kPassThreads> * static_cast<int>(sizeof(float));

// What a pass computes at each step: the production kernel (kFull), or the
// ablation's stages (copy the centre, pull only, the update without |u|).
enum class Stage { kNoop, kStream, kCollide, kFull };

// Dynamic shared memory of the two window buffers and the two mask windows.
__host__ __device__ __forceinline__ int pass_smem_bytes(int by, int bx, int ksteps) {
  const int wcells = (by + 2 * ksteps) * (bx + 2 * ksteps);
  return 2 * 9 * wcells * static_cast<int>(sizeof(float)) + 2 * wcells;
}

// Floats per copy (4, 2 or 1): the largest that divides every offset along
// a window row (the row stride, the owned column 0, BX and K) and f's base
// address in floats; 2 at most unless the mask's base address is a
// multiple of 4 bytes (its 4-byte copies).  -1 where f is not 4-byte
// aligned.
inline int pass_vec(int a, int b, int c, int d, const float* f, const uint8_t* mask) {
  const uintptr_t fa = reinterpret_cast<uintptr_t>(f);
  if (fa & 3) return -1;
  const uintptr_t all = a | b | c | d | (fa >> 2) |
                        ((reinterpret_cast<uintptr_t>(mask) & 3) ? 2 : 0);
  return (all & 3) == 0 ? 4 : (all & 1) == 0 ? 2 : 1;
}

// A pass's geometry.  Owned cell (y, x) of the grid or shard, for y in
// [-K, rows + K) and x in [-K, cols + K), is element origin + y * stride +
// x of each f plane and of the mask; where `periodic` (the single-device
// grid: stride nx, origin 0), y and x wrap modulo ny and nx first.
struct PassGeom {
  int by, bx, ksteps;
  int tiles_x, tiles;  // tiles along x, and in all
  int vec;             // floats per copy (pass_vec)
  int periodic, ny, nx;
  int stride;
  long long origin;
  size_t plane;
  int row0;  // global row of owned row 0
};

__device__ __forceinline__ size_t cell_at(const PassGeom& g, int y, int x) {
  if (g.periodic)
    return static_cast<size_t>(wrap(y, g.ny)) * g.nx + wrap(x, g.nx);
  return static_cast<size_t>(g.origin + static_cast<long long>(y) * g.stride + x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issues the copies of tile t's window (9 planes into `buf`, the mask into
// `m`); the caller commits them as a group.
template <int kThreads>
__device__ __forceinline__ void issue_window(const float* __restrict__ f,
                                             const uint8_t* __restrict__ mask,
                                             const PassGeom& g, int t, float* buf,
                                             uint8_t* m) {
  const int wx = g.bx + 2 * g.ksteps;
  const int wy = g.by + 2 * g.ksteps;
  const int wcells = wy * wx;
  const int ty = t / g.tiles_x;
  const int y0 = ty * g.by - g.ksteps;
  const int x0 = (t - ty * g.tiles_x) * g.bx - g.ksteps;
  const int v = g.vec;
  for (RegionWalk<kThreads> w(threadIdx.x, wx / v); w.r < wy; w.next()) {
    const int i = w.r * wx + v * w.c;
    // A chunk of v cells starts v-aligned and so never straddles the wrap.
    const size_t s = cell_at(g, y0 + w.r, x0 + v * w.c);
    if (v == 4) {
#pragma unroll
      for (int k = 0; k < 9; ++k) cp_async16(buf + k * wcells + i, f + k * g.plane + s);
      cp_async4(m + i, mask + s);
    } else if (v == 2) {
#pragma unroll
      for (int k = 0; k < 9; ++k) cp_async8(buf + k * wcells + i, f + k * g.plane + s);
      m[i] = mask[s];
      m[i + 1] = mask[s + 1];
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) cp_async4(buf + k * wcells + i, f + k * g.plane + s);
      m[i] = mask[s];
    }
  }
}

// x[j] += x[j + kH] for j < kH, then the same at kH / 2, ... 1: block_sum's
// levels above 32, with every index a constant so x stays in registers.
template <int kH>
__device__ __forceinline__ void fold_columns(float* x) {
  if constexpr (kH > 0) {
#pragma unroll
    for (int j = 0; j < kH; ++j) x[j] += x[j + kH];
    fold_columns<kH / 2>(x);
  }
}

// The sum of red[0, kThreads) in `block_sum`'s fixed tree (lbm_cell.cuh),
// to the bit, by warp 0 alone after the barrier that published the values
// (the caller's threads 0-31; valid in thread 0): lane l folds red[l + 32j]
// over j as block_sum's levels 256 down to 32 pair them, then the warp's
// shuffles take its levels 16 down to 1.  One barrier a step instead of
// the tree's ten, and the same partials as the tree gives.
template <int kThreads>
__device__ __forceinline__ float warp0_tree_sum(const float* red) {
  constexpr int kCols = kThreads / 32;
  const int lane = threadIdx.x;
  float x[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) x[j] = red[lane + 32 * j];
  fold_columns<kCols / 2>(x);
  float v = x[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One pass over this block's tiles by kThreads threads.  `smem` is the
// dynamic shared memory (pass_smem_bytes(by, bx, K) bytes, 16-byte
// aligned).  kFull writes each step's |u| sum over tile t's owned cells to
// partials[s * tiles + t], each thread's sum into `red` (kRedFloats floats)
// and then `warp0_tree_sum` after the step's barrier.
template <int kThreads, Stage kStage>
__device__ __forceinline__ void persistent_pass(const float* __restrict__ f_in,
                                                float* __restrict__ f_out,
                                                const uint8_t* __restrict__ mask_in,
                                                float* __restrict__ partials,
                                                const StepParams& p, const PassGeom& g,
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
  // noop copies the loaded centre in one step; the others run K steps.
  const int nsteps = kStage == Stage::kNoop ? 1 : ksteps;
  // The tile's loaded window and the other buffer, as offsets into smem.
  int cur = 0, work = planes;
  int mcur = 0;
  int parity = 0;  // the |u| slot, alternating over every step of the pass

  int t = blockIdx.x;
  if (t < g.tiles) issue_window<kThreads>(f_in, mask_in, g, t, smem + cur, masks);
  cp_async_commit();
  for (; t < g.tiles; t += gridDim.x) {
    const int tn = t + gridDim.x;
    uint8_t* const mask_next = masks + wcells - mcur;
    cp_async_wait<0>();
    __syncthreads();

    const int ty = t / g.tiles_x;
    const int y0 = ty * g.by - ksteps;
    const int x0 = (t - ty * g.tiles_x) * g.bx - ksteps;
    const int gy0 = g.row0 + y0;
    const uint8_t* mask = masks + mcur;
    int src = cur, dst = work;
    for (int s = 0; s < nsteps; ++s) {
      const bool last = s == nsteps - 1;
      if (last) {
        // The last step writes f_out, so its destination buffer is free.
        if (tn < g.tiles)
          issue_window<kThreads>(f_in, mask_in, g, tn, smem + dst, mask_next);
        cp_async_commit();
      }
      // Cells valid after this step: [lo, w - lo) in each axis; the last
      // step's are the owned centre.
      const int lo = kStage == Stage::kNoop ? ksteps : s + 1;
      float acc = 0.0f;
      for (RegionWalk<kThreads> w(tid, wx - 2 * lo); w.r < wy - 2 * lo; w.next()) {
        const int r = lo + w.r;
        const int c = lo + w.c;
        const int idx = r * wx + c;
        const WindowSrc cell{smem + src, mask, wx, wcells, idx};
        float o[9];
        if constexpr (kStage == Stage::kNoop) {
#pragma unroll
          for (int k = 0; k < 9; ++k) o[k] = cell.f(k, 0, 0);
        } else if constexpr (kStage == Stage::kStream) {
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
          const int gy = wrap(gy0 + r, ny);
          const float speed = update_cell(cell, gy == kr, wrap_dec(gy, ny) == kr,
                                          wrap_inc(gy, ny) == kr, p, o);
          if constexpr (kStage == Stage::kFull) {
            if (r >= ksteps && r < ksteps + g.by && c >= ksteps && c < ksteps + g.bx)
              acc += speed;
          }
        }
        if (last) {
          const size_t out = cell_at(g, y0 + r, x0 + c);
#pragma unroll
          for (int k = 0; k < 9; ++k) f_out[k * g.plane + out] = o[k];
        } else {
          float* d = smem + dst;
#pragma unroll
          for (int k = 0; k < 9; ++k) d[k * wcells + idx] = o[k];
        }
      }
      if constexpr (kStage == Stage::kFull) red[parity * kThreads + tid] = acc;
      // Ends this step's reads of `src` and orders its writes (and the
      // threads' sums) before the next step's reads.
      __syncthreads();
      if constexpr (kStage == Stage::kFull) {
        // The slot is written again two steps on, after a barrier warp 0
        // passes only when these reads are done.
        if (tid < 32) {
          const float total = warp0_tree_sum<kThreads>(red + parity * kThreads);
          if (tid == 0) partials[static_cast<size_t>(s) * g.tiles + t] = total;
        }
      }
      parity ^= 1;
      const int tmp = src;
      src = dst;
      dst = tmp;
    }
    // The next tile's window is the last step's destination, now `src`.
    cur = src;
    work = dst;
    mcur = wcells - mcur;
  }
}

// The in-place pass (the x-tiled kernel, its shard entry and, between
// grid barriers, the megakernel): the same
// walk, buffers, copy groups and |u| slots as persistent_pass, on ONE f
// buffer updated in place.  Two operations differ:
//   * a window cell comes from its owner tile (lbm_temporal_xt.cu's head
//     note): f where that is the tile itself, the row bands of the pass's
//     parity where the owner lies in another tile row, else the column
//     bands; in the shard entry, slab rows outside [0, rows) from the
//     read-only ghost rows.  The source is chosen once per chunk of `vec`
//     cells: a chunk starts vec-aligned and vec divides BX, K and nx, so it
//     never straddles a tile edge, a band's two halves or the wrap;
//   * the last step stores the owned centre from registers to f, and each
//     cell within K of a tile edge also to the bands of the next parity.
// Tile t + gridDim.x's window may be copied while tile t steps and
// stores: a pass reads from f only cells the reading tile owns, and from
// the bands and ghost rows only what no tile writes in the pass.
// kL2 (the megakernel): f and the bands are read through L2 alone, since
// other blocks wrote them earlier in the same launch and L1 is not
// coherent across SMs: the 16-byte copies are `cp.async.cg` already, and
// where a chunk is narrower (a 4- or 8-byte cp.async goes through L1) its
// floats are loaded by `__ldcg` instead, synchronously.

// A band's slot of local row (column) r of a tile b wide: rows r < K keep
// r, rows r >= b - K follow them (all b rows where 2K >= b).
__host__ __device__ __forceinline__ int band_slot(int r, int b, int k) {
  return (2 * k >= b || r < k) ? r : r - b + 2 * k;
}

// An in-place pass's geometry: BY x BX tiles of a slab of `rows` x nx
// cells whose row 0 is global row row0 (the whole grid, row0 0, or one
// shard's rows), f [9][rows][nx], and the bands of one parity: RB
// [9][tiles_y * nbr][nx], then CB [9][rows][tiles_x * nbc] at rb_total.
struct InPlaceGeom {
  int by, bx, ksteps;
  int tiles_x, tiles;  // tiles along x, and in all
  int vec;             // floats per copy (pass_vec over every base address)
  int rows, nx, row0;
  int nbr, nbc;        // band rows per tile row, band columns per tile column
  int cb_row;          // tiles_x * nbc: a CB row
  size_t plane;        // rows * nx: an f plane
  size_t rb_plane, cb_plane, rb_total;
};

// Issues the copies of tile t's window (9 planes into `buf`, the mask into
// `m`), each chunk from its owner's source; the caller commits them.
// kShard: slab rows outside [0, rows) from `ghost` ([9][2K][nx]: rows -K..-1,
// then rows..rows+K-1) and the mask [rows + 2K][nx] by slab row + K; else
// rows wrap modulo rows (= ny) and the mask is [ny][nx].
template <int kThreads, bool kShard, bool kL2 = false>
__device__ __forceinline__ void issue_inplace_window(const float* f, const float* bin,
                                                     const float* __restrict__ ghost,
                                                     const uint8_t* __restrict__ mask,
                                                     const InPlaceGeom& g, int t,
                                                     float* buf, uint8_t* m) {
  const int k = g.ksteps;
  const int wx = g.bx + 2 * k;
  const int wy = g.by + 2 * k;
  const int wcells = wy * wx;
  const int ty = t / g.tiles_x;
  const int tx = t - ty * g.tiles_x;
  const int y0 = ty * g.by - k;
  const int x0 = tx * g.bx - k;
  const int v = g.vec;
  for (RegionWalk<kThreads> w(threadIdx.x, wx / v); w.r < wy; w.next()) {
    const int i = w.r * wx + v * w.c;
    const int ly = y0 + w.r;
    const int gx = wrap(x0 + v * w.c, g.nx);
    const float* src;
    size_t stride, off, moff;
    if (kShard && (ly < 0 || ly >= g.rows)) {
      src = ghost;
      stride = static_cast<size_t>(2 * k) * g.nx;
      off = static_cast<size_t>(ly < 0 ? ly + k : ly - g.rows + k) * g.nx + gx;
      moff = static_cast<size_t>(ly + k) * g.nx + gx;
    } else {
      const int sy = kShard ? ly : wrap(ly, g.rows);
      const int oy = sy / g.by;
      const int ox = gx / g.bx;
      if (oy != ty) {
        src = bin;
        stride = g.rb_plane;
        off = static_cast<size_t>(oy * g.nbr + band_slot(sy - oy * g.by, g.by, k)) * g.nx +
              gx;
      } else if (ox != tx) {
        src = bin + g.rb_total;
        stride = g.cb_plane;
        off = static_cast<size_t>(sy) * g.cb_row + ox * g.nbc +
              band_slot(gx - ox * g.bx, g.bx, k);
      } else {
        src = f;
        stride = g.plane;
        off = static_cast<size_t>(sy) * g.nx + gx;
      }
      moff = static_cast<size_t>(kShard ? ly + k : sy) * g.nx + gx;
    }
    if (v == 4) {
#pragma unroll
      for (int q = 0; q < 9; ++q) cp_async16(buf + q * wcells + i, src + q * stride + off);
      cp_async4(m + i, mask + moff);
    } else if constexpr (kL2) {
      for (int j = 0; j < v; ++j) {
#pragma unroll
        for (int q = 0; q < 9; ++q) buf[q * wcells + i + j] = __ldcg(src + q * stride + off + j);
        m[i + j] = mask[moff + j];
      }
    } else if (v == 2) {
#pragma unroll
      for (int q = 0; q < 9; ++q) cp_async8(buf + q * wcells + i, src + q * stride + off);
      m[i] = mask[moff];
      m[i + 1] = mask[moff + 1];
    } else {
#pragma unroll
      for (int q = 0; q < 9; ++q) cp_async4(buf + q * wcells + i, src + q * stride + off);
      m[i] = mask[moff];
    }
  }
}

// One in-place pass over this block's tiles: reads f and the bands `bin`
// of the pass's parity (and, kShard, the ghost rows), writes f and the
// bands `bout` of the next parity.  smem, red and the partials as
// persistent_pass<kThreads, Stage::kFull>; kL2 as issue_inplace_window.
template <int kThreads, bool kShard, bool kL2 = false>
__device__ __forceinline__ void inplace_pass(float* f, const float* bin, float* bout,
                                             const float* __restrict__ ghost,
                                             const uint8_t* __restrict__ mask_in,
                                             float* __restrict__ partials,
                                             const StepParams& p, const InPlaceGeom& g,
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
  int cur = 0, work = planes;
  int mcur = 0;
  int parity = 0;

  int t = blockIdx.x;
  if (t < g.tiles)
    issue_inplace_window<kThreads, kShard, kL2>(f, bin, ghost, mask_in, g, t, smem + cur,
                                                masks);
  cp_async_commit();
  for (; t < g.tiles; t += gridDim.x) {
    const int tn = t + gridDim.x;
    uint8_t* const mask_next = masks + wcells - mcur;
    cp_async_wait<0>();
    __syncthreads();

    const int ty = t / g.tiles_x;
    const int tx = t - ty * g.tiles_x;
    const int gy0 = g.row0 + ty * g.by - ksteps;
    const uint8_t* mask = masks + mcur;
    int src = cur, dst = work;
    for (int s = 0; s < ksteps; ++s) {
      const bool last = s == ksteps - 1;
      if (last) {
        if (tn < g.tiles)
          issue_inplace_window<kThreads, kShard, kL2>(f, bin, ghost, mask_in, g, tn,
                                                      smem + dst, mask_next);
        cp_async_commit();
      }
      const int lo = s + 1;
      float acc = 0.0f;
      for (RegionWalk<kThreads> w(tid, wx - 2 * lo); w.r < wy - 2 * lo; w.next()) {
        const int r = lo + w.r;
        const int c = lo + w.c;
        const int idx = r * wx + c;
        const WindowSrc cell{smem + src, mask, wx, wcells, idx};
        float o[9];
        const int gy = wrap(gy0 + r, ny);
        const float speed = update_cell(cell, gy == kr, wrap_dec(gy, ny) == kr,
                                        wrap_inc(gy, ny) == kr, p, o);
        if (r >= ksteps && r < ksteps + g.by && c >= ksteps && c < ksteps + g.bx)
          acc += speed;
        if (last) {
          // The owned cell (lr, lc) of tile (ty, tx): f, and the bands
          // where it lies within K of the tile's edges.
          const int lr = r - ksteps;
          const int lc = c - ksteps;
          const int sy = ty * g.by + lr;
          const int gx = tx * g.bx + lc;
          const size_t of = static_cast<size_t>(sy) * g.nx + gx;
#pragma unroll
          for (int q = 0; q < 9; ++q) f[q * g.plane + of] = o[q];
          if (lr < ksteps || lr >= g.by - ksteps) {
            const size_t ob =
                static_cast<size_t>(ty * g.nbr + band_slot(lr, g.by, ksteps)) * g.nx + gx;
#pragma unroll
            for (int q = 0; q < 9; ++q) bout[q * g.rb_plane + ob] = o[q];
          }
          if (lc < ksteps || lc >= g.bx - ksteps) {
            const size_t ob = g.rb_total + static_cast<size_t>(sy) * g.cb_row +
                              tx * g.nbc + band_slot(lc, g.bx, ksteps);
#pragma unroll
            for (int q = 0; q < 9; ++q) bout[q * g.cb_plane + ob] = o[q];
          }
        } else {
          float* d = smem + dst;
#pragma unroll
          for (int q = 0; q < 9; ++q) d[q * wcells + idx] = o[q];
        }
      }
      red[parity * kThreads + tid] = acc;
      __syncthreads();
      if (tid < 32) {
        const float total = warp0_tree_sum<kThreads>(red + parity * kThreads);
        if (tid == 0) partials[static_cast<size_t>(s) * g.tiles + t] = total;
      }
      parity ^= 1;
      const int tmp = src;
      src = dst;
      dst = tmp;
    }
    cur = src;
    work = dst;
    mcur = wcells - mcur;
  }
}

// The geometry of a pass over the periodic ny x nx grid from f (its mask
// `mask`); `vec` follows from the shapes and the base addresses.
inline PassGeom grid_geom(int ny, int nx, int by, int bx, int ksteps, const float* f,
                          const uint8_t* mask) {
  PassGeom g{};
  g.by = by;
  g.bx = bx;
  g.ksteps = ksteps;
  g.tiles_x = nx / bx;
  g.tiles = (ny / by) * g.tiles_x;
  g.vec = pass_vec(nx, bx, ksteps, 0, f, mask);
  g.periodic = 1;
  g.ny = ny;
  g.nx = nx;
  g.stride = nx;
  g.origin = 0;
  g.plane = static_cast<size_t>(ny) * nx;
  g.row0 = 0;
  return g;
}

// The geometry of a pass over one shard's nyl x nxl tile padded by K cells
// ([9][nyl + 2K][stride], owned column 0 at lpad), whose global row 0 is
// row0, from f (its mask `mask`).
inline PassGeom shard_geom(int nyl, int nxl, int stride, int lpad, int row0, int by, int bx,
                           int ksteps, const float* f, const uint8_t* mask) {
  PassGeom g{};
  g.by = by;
  g.bx = bx;
  g.ksteps = ksteps;
  g.tiles_x = nxl / bx;
  g.tiles = (nyl / by) * g.tiles_x;
  g.vec = pass_vec(stride, lpad, bx, ksteps, f, mask);
  g.periodic = 0;
  g.stride = stride;
  g.origin = static_cast<long long>(ksteps) * stride + lpad;
  g.plane = static_cast<size_t>(nyl + 2 * ksteps) * stride;
  g.row0 = row0;
  return g;
}

// Launches a pass kernel on `nblocks` persistent blocks (1 <= nblocks <=
// g.tiles), `g` (a PassGeom or an InPlaceGeom) its last argument; returns
// the launch error (cudaErrorInvalidValue where the grid does not, f is
// not 4-byte aligned or the windows do not fit).
template <int kThreads, class Kernel, class Geom, class... Args>
int launch_pass(Kernel kernel, const Geom& g, int nblocks, void* stream,
                Args... args) {
  const int smem = pass_smem_bytes(g.by, g.bx, g.ksteps);
  if (nblocks < 1 || nblocks > g.tiles || g.vec < 1 || smem > kPassSmemBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args..., g);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a pass kernel one SM holds at once at this tile (0 where the
// windows do not fit a block), or a negative CUDA error.
template <int kThreads, class Kernel>
int pass_blocks_per_sm(Kernel kernel, int by, int bx, int ksteps) {
  const int smem = pass_smem_bytes(by, bx, ksteps);
  if (by < 1 || bx < 1 || ksteps < 1 || smem > kPassSmemBudget) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return n;
}

}  // namespace lbm
