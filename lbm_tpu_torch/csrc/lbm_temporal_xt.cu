// K D2Q9-BGK timesteps per pass, updating f IN PLACE, on Hopper (sm_90a),
// hand-written CUDA C++: the x-tiled pass (one launch per pass) and the
// megakernel (T passes in one cooperative launch).
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_temporal_xt` (built by
// `build_temporal_xtiled_kernel` / `build_temporal_xtiled_program`: the
// giant-grid schedule, column strips x row blocks, strip state aliased in
// place, halos carried in ghost slabs and edge arrays) and
// `_step_kernel_mega` (`build_mega_program`, `kernel="mega"`: T temporal
// passes in one call, f aliased in HBM, parity-buffered ghost slabs).
// Both keep one f buffer instead of two and take each window's halo from
// state carried outside f.  Here both are one design: a temporal pass over
// BY x BX tiles of f[9][ny][nx] that updates f in place and reads each
// tile's K-wide halo only from carried BANDS.  The TPU's strip-major
// layout, 128-lane pad and edge arrays exist for its (8, 128) tiling and
// are not carried over: f keeps its [9][ny][nx] layout.
//
// Bands.  A tile publishes its owned cells within K of its edges:
//   * row bands RB[9][Ty * NBR][nx]: tile row ty's local rows r < K and
//     r >= BY - K (all BY rows when 2K >= BY; NBR = min(2K, BY) rows per
//     tile row), at every column;
//   * column bands CB[9][ny][Tx * NBC]: tile column tx's local columns
//     c < K and c >= BX - K (NBC = min(2K, BX)), at every row.
// Bands come in two parities, each RB then CB (the host sizes them:
// `TemporalXtStep.band_floats` in ops/fused.py).  Pass p reads parity p
// and writes parity p + 1.
//
// Why no tile reads a cell another tile writes in the same pass (the
// in-place proof, cf. `_step_kernel_mega`'s docstring):
//   * f: a tile reads from f only the cells it owns, and writes only them,
//     all reads before a barrier and all writes after it;
//   * halo: a window cell (gy, gx) owned by another tile (oy, ox) lies
//     within K (periodic) of this tile, hence within K of the owner's edge
//     that faces this tile.  If oy != ty it is within K of the owner's top
//     or bottom edge, so in RB (the full-width row band, which also holds
//     the corners from the diagonal tiles); else ox != tx and it is within
//     K of the owner's left or right edge, so in CB.  The band at parity p
//     holds the cell's value at the start of the pass: its owner wrote it
//     at the end of pass p - 1 (or the host filled it from f, as JAX's
//     `ghosts_of` does), and in this pass every tile writes parity p + 1
//     only.  Between passes a kernel boundary (x-tiled) or `grid.sync()`
//     (mega) orders the writes before the reads; both read f and the bands
//     through L2 (`__ldcg`), since the read-only path is not coherent
//     within a launch.
// So the pass equals the ping-pong temporal pass (lbm_temporal.cu), and K
// one-steps, bit for bit in f.
//
// Bound: bytes.  A pass must read f, the mask and one parity of the bands
// once and write f and the other parity once: 73 B per cell plus 72 B per
// band cell, over K steps.  At 32 x 64 tiles and K = 4 the bands are
// 0.375 f a parity, so 100 B per cell a pass, 25 B per update.  The kernel
// itself reads each window once (the halo from the bands) and writes the
// centre and its band cells.  Like the temporal kernel it runs well
// below its bytes bound (PERF.md: about half the temporal step is the
// window's loads and stores), and the window update is the same code
// (`lbm::advance_window`, lbm_window.cuh).  What the in-place
// design buys is memory: f plus two band parities, 1.75 f at 32 x 64 and
// K 4, against the ping-pong pair's 2 f.
//
// The megakernel is one cooperative launch of the co-resident blocks (one
// per SM at ~210 KB of shared memory); each block walks tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... in every pass, with `grid.sync()`
// between passes.  Each tile writes one |u| partial per (step, tile), and
// `lbm_av_reduce` sums each step's partials in a fixed order: no float
// atomics, the same bits every run.
// fp32 throughout, IEEE division and sqrt, -fmad=false, as lbm_step.cu.
//
// The shard entry, `lbm_shard_temporal_xt_step`, replaces the same kernel
// as the sharded factory uses it (lbm_tpu/parallel/sharded.py:987-1199,
// `make_sharded_temporal_xt_run`: each row shard runs the x-tiled schedule
// on its slab, and only K-row ghost slabs cross shards).  Its kernel,
// `lbm_shard_xt_kernel`, runs the same in-place pass on one shard's row
// slab f[9][nyl][nx] (global rows [row0, row0 + nyl)).  x is never split
// between shards, so the column bands stay local, with periodic wrap in x;
// only the y halo differs.  Window rows below and above the slab come from
// a read-only ghost buffer G[9][2K][nx] (the south neighbour's last K rows,
// then the north neighbour's first K rows), which the host fills before
// each pass straight from the neighbours' f (`GhostExchange`,
// parallel/halo.py); between passes f holds exactly the pass-start values
// the bands would hold, so K > BY (ghost rows from several of the
// neighbour's tile rows) needs nothing more.  Rows inside the slab come
// from the bands as above, without the periodic wrap in y.  Nothing in the
// pass writes G, so the in-place proof above holds unchanged.  The mask is
// [nyl + 2K][nx] by global row (periodic), the kick goes by global row,
// and one |u| partial per (step, tile) becomes the shard's unscaled sum;
// the host adds the shards' sums in mesh order.  It has its own pass
// function and kernel, so the two kernels above keep their code
// (templating a kernel once changed its registers and made it spill).

#include <cooperative_groups.h>

#include "lbm_window.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

struct BandLayout {
  int by, bx, k;
  int tiles_y, tiles_x;
  int nbr, nbc;     // band rows per tile row, band columns per tile column
  size_t rb_plane;  // floats of one RB plane: tiles_y * nbr * nx
  size_t cb_plane;  // floats of one CB plane: ny * tiles_x * nbc
  size_t rb_total;  // 9 * rb_plane: CB starts here

  __host__ BandLayout(int ny, int nx, int by_, int bx_, int k_) : by(by_), bx(bx_), k(k_) {
    tiles_y = ny / by;
    tiles_x = nx / bx;
    nbr = 2 * k < by ? 2 * k : by;
    nbc = 2 * k < bx ? 2 * k : bx;
    rb_plane = static_cast<size_t>(tiles_y) * nbr * nx;
    cb_plane = static_cast<size_t>(ny) * tiles_x * nbc;
    rb_total = 9 * rb_plane;
  }

  // Slot of local row r (column c) among its tile's band rows (columns);
  // valid where r < K or r >= BY - K.
  __device__ __forceinline__ int slot_r(int r) const {
    return (2 * k >= by || r < k) ? r : r - by + 2 * k;
  }
  __device__ __forceinline__ int slot_c(int c) const {
    return (2 * k >= bx || c < k) ? c : c - bx + 2 * k;
  }
  __device__ __forceinline__ bool in_rows(int r) const { return r < k || r >= by - k; }
  __device__ __forceinline__ bool in_cols(int c) const { return c < k || c >= bx - k; }
};

// One K-step pass of tile (ty, tx): load its window (own cells from f, the
// halo from the bands `bin`), advance it, write the centre back into f and
// the tile's band cells into `bout`.  Ends with a barrier, so the block may
// load its next tile into the same shared memory.
__device__ __forceinline__ void tile_pass(float* f, const float* bin, float* bout,
                                          const uint8_t* __restrict__ fluid,
                                          float* partials, size_t pstride,
                                          const StepParams& p, const BandLayout& L,
                                          int ty, int tx, float* smem, float* red) {
  const int nx = p.nx;
  const int ny = p.ny;
  const int by = L.by, bx = L.bx, k = L.k;
  const size_t plane = static_cast<size_t>(ny) * nx;
  const int wy = by + 2 * k;
  const int wx = bx + 2 * k;
  const int wcells = wy * wx;
  uint8_t* mask = reinterpret_cast<uint8_t*>(smem + 18 * wcells);
  const int gy0 = ty * by - k;
  const int gx0 = tx * bx - k;
  const int tid = threadIdx.x;
  const size_t cb_row = static_cast<size_t>(L.tiles_x) * L.nbc;

  // The centre: this tile's own cells, from f.
  for (lbm::RegionWalk<kThreads> w(tid, bx); w.r < by; w.next()) {
    const int i = (w.r + k) * wx + w.c + k;
    const size_t g = static_cast<size_t>(ty * by + w.r) * nx + tx * bx + w.c;
#pragma unroll
    for (int q = 0; q < 9; ++q) smem[q * wcells + i] = __ldcg(f + q * plane + g);
    mask[i] = __ldg(fluid + g);
  }
  // The halo ring: k rows above and below the centre, then k columns on
  // each side of its rows.  Each cell comes from its owner tile: the row
  // bands where that tile lies in another tile row, else the column
  // bands, or f where the periodic wrap brings the window back onto this
  // tile.
  const int strip = k * wx;
  const int sides = 2 * k;
  for (int t = tid; t < 2 * strip + by * sides; t += kThreads) {
    int r, c;
    if (t < 2 * strip) {
      r = t / wx;
      c = t - r * wx;
      if (r >= k) r += by;
    } else {
      const int u = t - 2 * strip;
      const int rr = u / sides;
      const int cc = u - rr * sides;
      r = k + rr;
      c = cc < k ? cc : bx + cc;
    }
    const int i = r * wx + c;
    const int gy = lbm::wrap(gy0 + r, ny);
    const int gx = lbm::wrap(gx0 + c, nx);
    const int oy = gy / by;
    const int ox = gx / bx;
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    const float* base;
    size_t stride, off;
    if (oy == ty && ox == tx) {
      base = f;
      stride = plane;
      off = g;
    } else if (oy != ty) {
      base = bin;
      stride = L.rb_plane;
      off = static_cast<size_t>(oy * L.nbr + L.slot_r(gy - oy * by)) * nx + gx;
    } else {
      base = bin + L.rb_total;
      stride = L.cb_plane;
      off = static_cast<size_t>(gy) * cb_row + ox * L.nbc + L.slot_c(gx - ox * bx);
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) smem[q * wcells + i] = __ldcg(base + q * stride + off);
    mask[i] = __ldg(fluid + g);
  }
  __syncthreads();

  const float* fin =
      lbm::advance_window<kThreads>(smem, by, bx, k, gy0, p, red, partials, pstride);

  for (lbm::RegionWalk<kThreads> w(tid, bx); w.r < by; w.next()) {
    const int idx = (w.r + k) * wx + w.c + k;
    const int gy = ty * by + w.r;
    const int gx = tx * bx + w.c;
    const size_t g = static_cast<size_t>(gy) * nx + gx;
    const bool rows = L.in_rows(w.r);
    const bool cols = L.in_cols(w.c);
    const size_t rb = static_cast<size_t>(ty * L.nbr + L.slot_r(w.r)) * nx + gx;
    const size_t cb = L.rb_total + static_cast<size_t>(gy) * cb_row + tx * L.nbc +
                      L.slot_c(w.c);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float v = fin[q * wcells + idx];
      f[q * plane + g] = v;
      if (rows) bout[q * L.rb_plane + rb] = v;
      if (cols) bout[q * L.cb_plane + cb] = v;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
lbm_xt_kernel(float* f, const float* bin, float* bout, const uint8_t* __restrict__ fluid,
              float* partials, const StepParams p, const BandLayout L) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  tile_pass(f, bin, bout, fluid, partials + tile, gridDim.x * gridDim.y, p, L, blockIdx.y,
            blockIdx.x, smem, red);
}

__global__ void __launch_bounds__(kThreads)
lbm_mega_kernel(float* f, float* b0, float* b1, const uint8_t* __restrict__ fluid,
                float* partials, const StepParams p, const BandLayout L, int tpasses,
                int parity) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int ntiles = L.tiles_y * L.tiles_x;
  for (int pass = 0; pass < tpasses; ++pass) {
    const bool odd = (parity + pass) & 1;
    const float* bin = odd ? b1 : b0;
    float* bout = odd ? b0 : b1;
    float* part = partials + static_cast<size_t>(pass) * L.k * ntiles;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      tile_pass(f, bin, bout, fluid, part + tile, ntiles, p, L, tile / L.tiles_x,
                tile % L.tiles_x, smem, red);
    }
    grid.sync();
  }
}

// One in-place pass of tile (ty, tx) of a shard's row slab f[9][nyl][nx]:
// tile_pass with the y halo outside the slab read from `ghost`
// ([9][2K][nx]: slab rows -K..-1, then nyl..nyl+K-1) instead of wrapping.
// `mask` is [nyl + 2K][nx], slab row r at mask row r + K.
__device__ __forceinline__ void shard_tile_pass(float* f, const float* __restrict__ ghost,
                                                const float* bin, float* bout,
                                                const uint8_t* __restrict__ mask,
                                                float* partials, size_t pstride,
                                                const StepParams& p, const BandLayout& L,
                                                int nyl, int row0, int ty, int tx,
                                                float* smem, float* red) {
  const int nx = p.nx;
  const int by = L.by, bx = L.bx, k = L.k;
  const size_t plane = static_cast<size_t>(nyl) * nx;
  const size_t gplane = static_cast<size_t>(2 * k) * nx;
  const int wy = by + 2 * k;
  const int wx = bx + 2 * k;
  const int wcells = wy * wx;
  uint8_t* wmask = reinterpret_cast<uint8_t*>(smem + 18 * wcells);
  const int ly0 = ty * by - k;  // slab row of window row 0 (-K for tile row 0)
  const int gx0 = tx * bx - k;
  const int tid = threadIdx.x;
  const size_t cb_row = static_cast<size_t>(L.tiles_x) * L.nbc;

  // The centre: this tile's own cells, from f.
  for (lbm::RegionWalk<kThreads> w(tid, bx); w.r < by; w.next()) {
    const int i = (w.r + k) * wx + w.c + k;
    const int ly = ty * by + w.r;
    const int gx = tx * bx + w.c;
    const size_t g = static_cast<size_t>(ly) * nx + gx;
#pragma unroll
    for (int q = 0; q < 9; ++q) smem[q * wcells + i] = __ldcg(f + q * plane + g);
    wmask[i] = __ldg(mask + static_cast<size_t>(ly + k) * nx + gx);
  }
  // The halo ring, as tile_pass walks it.  A cell outside the slab comes
  // from the ghost rows; inside it, from its owner tile: the row bands
  // where that tile lies in another tile row, else the column bands, or f
  // where the periodic wrap in x brings the window back onto this tile.
  const int strip = k * wx;
  const int sides = 2 * k;
  for (int t = tid; t < 2 * strip + by * sides; t += kThreads) {
    int r, c;
    if (t < 2 * strip) {
      r = t / wx;
      c = t - r * wx;
      if (r >= k) r += by;
    } else {
      const int u = t - 2 * strip;
      const int rr = u / sides;
      const int cc = u - rr * sides;
      r = k + rr;
      c = cc < k ? cc : bx + cc;
    }
    const int i = r * wx + c;
    const int ly = ly0 + r;
    const int gx = lbm::wrap(gx0 + c, nx);
    const float* base;
    size_t stride, off;
    if (ly < 0 || ly >= nyl) {
      base = ghost;
      stride = gplane;
      off = static_cast<size_t>(ly < 0 ? ly + k : ly - nyl + k) * nx + gx;
    } else {
      const int oy = ly / by;
      const int ox = gx / bx;
      if (oy == ty && ox == tx) {
        base = f;
        stride = plane;
        off = static_cast<size_t>(ly) * nx + gx;
      } else if (oy != ty) {
        base = bin;
        stride = L.rb_plane;
        off = static_cast<size_t>(oy * L.nbr + L.slot_r(ly - oy * by)) * nx + gx;
      } else {
        base = bin + L.rb_total;
        stride = L.cb_plane;
        off = static_cast<size_t>(ly) * cb_row + ox * L.nbc + L.slot_c(gx - ox * bx);
      }
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) smem[q * wcells + i] = __ldcg(base + q * stride + off);
    wmask[i] = __ldg(mask + static_cast<size_t>(ly + k) * nx + gx);
  }
  __syncthreads();

  const float* fin = lbm::advance_window<kThreads>(smem, by, bx, k, row0 + ly0, p, red,
                                                   partials, pstride);

  for (lbm::RegionWalk<kThreads> w(tid, bx); w.r < by; w.next()) {
    const int idx = (w.r + k) * wx + w.c + k;
    const int ly = ty * by + w.r;
    const int gx = tx * bx + w.c;
    const size_t g = static_cast<size_t>(ly) * nx + gx;
    const bool rows = L.in_rows(w.r);
    const bool cols = L.in_cols(w.c);
    const size_t rb = static_cast<size_t>(ty * L.nbr + L.slot_r(w.r)) * nx + gx;
    const size_t cb = L.rb_total + static_cast<size_t>(ly) * cb_row + tx * L.nbc +
                      L.slot_c(w.c);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float v = fin[q * wcells + idx];
      f[q * plane + g] = v;
      if (rows) bout[q * L.rb_plane + rb] = v;
      if (cols) bout[q * L.cb_plane + cb] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lbm_shard_xt_kernel(float* f, const float* __restrict__ ghost, const float* bin,
                    float* bout, const uint8_t* __restrict__ mask, float* partials,
                    const StepParams p, const BandLayout L, int nyl, int row0) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  shard_tile_pass(f, ghost, bin, bout, mask, partials + tile, gridDim.x * gridDim.y, p,
                  L, nyl, row0, blockIdx.y, blockIdx.x, smem, red);
}

bool valid(const StepParams& p, int by, int bx, int ksteps) {
  return by >= 1 && bx >= 1 && ksteps >= 1 && p.ny % by == 0 && p.nx % bx == 0;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" {

// One in-place pass of `ksteps` steps on by x bx tiles: f is read and
// written, the halo comes from `bands_in` and the tiles' band cells go to
// `bands_out` (distinct buffers of one parity each, laid out as above); av[s] =
// mean |u| over fluid cells after step s.  `partials` holds ksteps *
// tiles floats.  Returns the first launch error (0 = both launched).
int lbm_temporal_xt_step(float* f, const float* bands_in, float* bands_out,
                         const uint8_t* fluid, float* partials, float* av,
                         const StepParams* params, int by, int bx, int ksteps,
                         void* stream) {
  const StepParams p = *params;
  if (!valid(p, by, bx, ksteps)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lbm::window_smem_bytes(by, bx, ksteps);
  cudaError_t err = allow_smem(lbm_xt_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BandLayout L(p.ny, p.nx, by, bx, ksteps);
  const dim3 grid(L.tiles_x, L.tiles_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lbm_xt_kernel<<<grid, kThreads, smem, s>>>(f, bands_in, bands_out, fluid, partials, p, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return lbm_av_reduce(partials, static_cast<int>(grid.x * grid.y), ksteps,
                       p.free_cells_inv, av, stream);
}

// Blocks of one megakernel launch on the current device: as many as are
// co-resident at this tiling's shared memory, capped at the tile count; -1
// on error.
int lbm_mega_num_blocks(int ny, int nx, int by, int bx, int ksteps) {
  if (by < 1 || bx < 1 || ksteps < 1 || ny % by != 0 || nx % bx != 0) return -1;
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const int smem = lbm::window_smem_bytes(by, bx, ksteps);
  if (allow_smem(lbm_mega_kernel, smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_mega_kernel, kThreads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  const long long tiles = static_cast<long long>(ny / by) * (nx / bx);
  const long long coresident = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(tiles < coresident ? tiles : coresident);
}

// `tpasses` in-place passes of `ksteps` steps in one cooperative launch of
// `nblocks` blocks: pass t reads bands0 when (parity + t) is even, else
// bands1, and writes the other.  av[s] = mean |u| after step s of the
// tpasses * ksteps.  `partials` holds tpasses * ksteps * tiles floats.
// Returns the first launch error (0 = both launched).
int lbm_mega_step(float* f, float* bands0, float* bands1, const uint8_t* fluid,
                  float* partials, float* av, const StepParams* params, int by, int bx,
                  int ksteps, int tpasses, int parity, int nblocks, void* stream) {
  StepParams p = *params;
  if (!valid(p, by, bx, ksteps) || tpasses < 1 || nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lbm::window_smem_bytes(by, bx, ksteps);
  cudaError_t err = allow_smem(lbm_mega_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  BandLayout L(p.ny, p.nx, by, bx, ksteps);
  void* args[] = {&f, &bands0, &bands1, &fluid, &partials, &p, &L, &tpasses, &parity};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_mega_kernel),
                                    dim3(nblocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error
    return static_cast<int>(err);
  }
  return lbm_av_reduce(partials, L.tiles_y * L.tiles_x, tpasses * ksteps,
                       p.free_cells_inv, av, stream);
}

// One in-place pass of `ksteps` steps of one shard's row slab f[9][nyl][nx]
// (global rows [row0, row0 + nyl)) on by x bx tiles: the halo outside the
// slab from `ghost` ([9][2K][nx], filled by the host before the pass), the
// rest from `bands_in`, the tiles' band cells to `bands_out` (the bands of
// an nyl x nx grid); `mask` is [nyl + 2K][nx] by global row.  sums[s] =
// the unscaled |u| sum over the slab's fluid cells after step s.
// `partials` holds ksteps * tiles floats.  Needs K <= nyl (the ghost rows
// come from one neighbour).  Returns the first launch error (0 = both
// launched).
int lbm_shard_temporal_xt_step(float* f, const float* ghost, const float* bands_in,
                               float* bands_out, const uint8_t* mask, float* partials,
                               float* sums, const StepParams* params, int nyl, int row0,
                               int by, int bx, int ksteps, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || nyl < 1 || nyl % by != 0 || p.nx % bx != 0 ||
      ksteps > nyl || row0 < 0 || row0 + nyl > p.ny)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lbm::window_smem_bytes(by, bx, ksteps);
  cudaError_t err = allow_smem(lbm_shard_xt_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BandLayout L(nyl, p.nx, by, bx, ksteps);
  const dim3 grid(L.tiles_x, L.tiles_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lbm_shard_xt_kernel<<<grid, kThreads, smem, s>>>(f, ghost, bands_in, bands_out, mask,
                                                   partials, p, L, nyl, row0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return lbm_av_reduce(partials, static_cast<int>(grid.x * grid.y), ksteps, 1.0f, sums,
                       stream);
}

}  // extern "C"
