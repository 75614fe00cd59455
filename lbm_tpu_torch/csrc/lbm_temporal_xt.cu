// K D2Q9-BGK timesteps per pass, updating f IN PLACE, on Hopper (sm_90a),
// hand-written CUDA C++: the x-tiled pass (one launch per pass, and its
// shard entry) and the megakernel (T passes in one cooperative launch).
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
//   * f: a tile reads from f only the cells it owns, and writes only them;
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
//     (mega) orders the writes before the reads; the megakernel reads f
//     and the bands through L2 alone (`cp.async.cg`, or `__ldcg` where a
//     chunk is narrower than 16 bytes), since L1 is not coherent within a
//     launch.
// So the pass equals the ping-pong temporal pass (lbm_temporal.cu), and K
// one-steps, bit for bit in f.
//
// The x-tiled pass (`lbm_xt_kernel`) is persistent, as the temporal kernel
// is (`lbm::inplace_pass`, lbm_persistent.cuh): the wrapper launches at
// most as many blocks as the card holds at once, and block b walks tiles
// b, b + gridDim.x, ...  While tile t takes its last step, the block
// copies tile t + gridDim.x's window by `cp.async` into the buffer that
// step does not need.  The proof above makes that copy race-free in any
// walk order: it reads the next tile's own f cells (which no other tile
// writes, and this block writes only after the copy has landed), the
// bands of parity p and the mask (which nothing in the pass writes).  The
// last step stores from registers to f and to the bands of parity p + 1;
// there is no write-back pass.  The source of each window cell is chosen
// once per chunk of 4, 2 or 1 floats (the copy width, from the shapes and
// the base addresses of f, both parities, the ghost rows and the mask).
//
// Bound: bytes.  A pass must read f, the mask and one parity of the bands
// once and write f and the other parity once: 73 B per cell plus 72 B per
// band cell, over K steps.  What the kernel moves per pass: the window (9
// fp32 and the mask byte a cell, its halo from the bands), the centre and
// the tile's band cells written once (`fused.inplace_bytes_per_update`):
// at 32 x 64 tiles and K 4, 25.1 B per update, against the row temporal
// kernel's 21.9 (a 40 x 72 window read, the centre written).  What the
// in-place design buys is memory: f plus two band parities, 1.75 f at
// 32 x 64 and K 4, against the ping-pong pair's 2 f.
//
// The megakernel (`lbm_mega_kernel`) runs the same persistent in-place
// pass T times in one cooperative launch of min(tiles, SMs x co-resident
// blocks) blocks of 512 threads, sized from its own occupancy at the
// persistent footprint (`lbm_mega_num_blocks`): pass t reads the bands of
// parity (parity + t) & 1 and writes the other, then `grid.sync()`.  Each
// block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... in every pass,
// copying the next tile's window while the current one steps, as the
// x-tiled kernel does.  The in-place proof extends across the barrier:
// within a pass it holds as above, whatever the walk; no copy crosses the
// barrier (a pass's last tile issues none, and the next pass issues its
// first windows after `grid.sync()`), and the barrier orders every write
// of pass t (f and the bands of parity t + 1) before every read of pass
// t + 1, which reads f and exactly those bands.  So T passes of one launch
// equal T launches of the x-tiled kernel, and T*K one-steps, bit for bit
// in f.  Each tile writes one |u| partial per (step, tile), and
// `lbm_av_reduce` sums each step's partials in a fixed order: no float
// atomics, the same bits every run, and the same bits in both kernels.
// fp32 throughout, IEEE division and sqrt, -fmad=false, as lbm_step.cu.
//
// The shard entry, `lbm_shard_temporal_xt_step`, replaces the same kernel
// as the sharded factory uses it (lbm_tpu/parallel/sharded.py:987-1199,
// `make_sharded_temporal_xt_run`: each row shard runs the x-tiled schedule
// on its slab, and only K-row ghost slabs cross shards).  Its kernel,
// `lbm_shard_xt_kernel`, runs the same persistent in-place pass on one
// shard's row slab f[9][nyl][nx] (global rows [row0, row0 + nyl)).  x is
// never split between shards, so the column bands stay local, with
// periodic wrap in x; only the y halo differs.  Window rows below and
// above the slab come from a read-only ghost buffer G[9][2K][nx] (the
// south neighbour's last K rows, then the north neighbour's first K rows),
// which the host fills before each pass straight from the neighbours' f
// (`GhostExchange`, parallel/halo.py); between passes f holds exactly the
// pass-start values the bands would hold, so K > BY (ghost rows from
// several of the neighbour's tile rows) needs nothing more.  Rows inside
// the slab come from the bands as above, without the periodic wrap in y.
// Nothing in the pass writes G, so the in-place proof and the prefetch
// hold unchanged.  The mask is [nyl + 2K][nx] by global row (periodic),
// the kick goes by global row, and one |u| partial per (step, tile)
// becomes the shard's unscaled sum; the host adds the shards' sums in
// mesh order.

#include <cooperative_groups.h>

#include "lbm_persistent.cuh"

namespace cg = cooperative_groups;

namespace {

using lbm::kPassThreads;

// The persistent in-place pass over the periodic grid.
__global__ void __launch_bounds__(kPassThreads)
lbm_xt_kernel(float* f, const float* bin, float* bout, const uint8_t* __restrict__ fluid,
              float* __restrict__ partials, const StepParams p, const lbm::InPlaceGeom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[lbm::kRedFloats<kPassThreads>];
  lbm::inplace_pass<kPassThreads, false>(f, bin, bout, nullptr, fluid, partials, p, g, smem,
                                         red);
}

// The same pass on one shard's row slab, the rows beyond it from `ghost`.
__global__ void __launch_bounds__(kPassThreads)
lbm_shard_xt_kernel(float* f, const float* __restrict__ ghost, const float* bin,
                    float* bout, const uint8_t* __restrict__ mask,
                    float* __restrict__ partials, const StepParams p,
                    const lbm::InPlaceGeom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[lbm::kRedFloats<kPassThreads>];
  lbm::inplace_pass<kPassThreads, true>(f, bin, bout, ghost, mask, partials, p, g, smem,
                                        red);
}

// `tpasses` persistent in-place passes over the periodic grid in one
// cooperative launch, a grid barrier between passes; f and the bands read
// through L2 alone.
__global__ void __launch_bounds__(kPassThreads)
lbm_mega_kernel(float* f, float* b0, float* b1, const uint8_t* __restrict__ fluid,
                float* __restrict__ partials, const StepParams p, const lbm::InPlaceGeom g,
                int tpasses, int parity) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[lbm::kRedFloats<kPassThreads>];
  cg::grid_group grid = cg::this_grid();
  for (int pass = 0; pass < tpasses; ++pass) {
    if (pass > 0) grid.sync();
    const bool odd = (parity + pass) & 1;
    lbm::inplace_pass<kPassThreads, false, true>(
        f, odd ? b1 : b0, odd ? b0 : b1, nullptr, fluid,
        partials + static_cast<size_t>(pass) * g.ksteps * g.tiles, p, g, smem, red);
  }
}

// The in-place geometry of a slab of `rows` x nx cells from global row
// row0 in BY x BX tiles, whose copies narrow to the base addresses of f,
// both band parities, the ghost rows (nullptr: none) and the mask.
lbm::InPlaceGeom inplace_geom(int rows, int nx, int row0, int by, int bx, int ksteps,
                              const float* f, const float* b0, const float* b1,
                              const float* ghost, const uint8_t* mask) {
  lbm::InPlaceGeom g{};
  g.by = by;
  g.bx = bx;
  g.ksteps = ksteps;
  g.tiles_x = nx / bx;
  g.tiles = (rows / by) * g.tiles_x;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(b0) | reinterpret_cast<uintptr_t>(b1) |
                          reinterpret_cast<uintptr_t>(ghost);
  g.vec = (bases & 3) ? -1 : lbm::pass_vec(nx, bx, ksteps, static_cast<int>(bases >> 2 & 3),
                                           f, mask);
  g.rows = rows;
  g.nx = nx;
  g.row0 = row0;
  g.nbr = 2 * ksteps < by ? 2 * ksteps : by;
  g.nbc = 2 * ksteps < bx ? 2 * ksteps : bx;
  g.cb_row = g.tiles_x * g.nbc;
  g.plane = static_cast<size_t>(rows) * nx;
  g.rb_plane = static_cast<size_t>(rows / by) * g.nbr * nx;
  g.cb_plane = static_cast<size_t>(rows) * g.cb_row;
  g.rb_total = 9 * g.rb_plane;
  return g;
}

bool valid(const StepParams& p, int by, int bx, int ksteps) {
  return by >= 1 && bx >= 1 && ksteps >= 1 && p.ny % by == 0 && p.nx % bx == 0;
}

}  // namespace

extern "C" {

// Blocks of the in-place pass (shard != 0: the shard entry's) that one SM
// of the current device holds at once at this tile: 0 where the windows do
// not fit a block, negative on a CUDA error.
int lbm_temporal_xt_blocks_per_sm(int by, int bx, int ksteps, int shard) {
  return shard ? lbm::pass_blocks_per_sm<kPassThreads>(lbm_shard_xt_kernel, by, bx, ksteps)
               : lbm::pass_blocks_per_sm<kPassThreads>(lbm_xt_kernel, by, bx, ksteps);
}

// One in-place pass of `ksteps` steps on by x bx tiles by `nblocks`
// persistent blocks (1 <= nblocks <= tiles): f is read and written, the
// halo comes from `bands_in` and the tiles' band cells go to `bands_out`
// (distinct buffers of one parity each, laid out as above); av[s] = mean
// |u| over fluid cells after step s.  `partials` holds ksteps * tiles
// floats.  Any base address of f, the bands and fluid is taken (the
// copies narrow to their alignment).  Returns the first launch error (0 =
// both kernels launched).
int lbm_temporal_xt_step(float* f, const float* bands_in, float* bands_out,
                         const uint8_t* fluid, float* partials, float* av,
                         const StepParams* params, int by, int bx, int ksteps, int nblocks,
                         void* stream) {
  const StepParams p = *params;
  if (!valid(p, by, bx, ksteps)) return static_cast<int>(cudaErrorInvalidValue);
  const lbm::InPlaceGeom g = inplace_geom(p.ny, p.nx, 0, by, bx, ksteps, f, bands_in,
                                          bands_out, nullptr, fluid);
  const int err = lbm::launch_pass<kPassThreads>(lbm_xt_kernel, g, nblocks, stream, f,
                                                 bands_in, bands_out, fluid, partials, p);
  if (err != 0) return err;
  return lbm_av_reduce(partials, g.tiles, ksteps, p.free_cells_inv, av, stream);
}

// Blocks of one megakernel launch on the current device: as many as are
// co-resident at this tiling's persistent footprint (the megakernel's own
// occupancy), capped at the tile count; 0 where the windows do not fit a
// block, -1 where the card admits no cooperative launch or on a CUDA error.
int lbm_mega_num_blocks(int ny, int nx, int by, int bx, int ksteps) {
  if (by < 1 || bx < 1 || ksteps < 1 || ny % by != 0 || nx % bx != 0) return -1;
  int device = 0, sms = 0, coop = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const int per_sm = lbm::pass_blocks_per_sm<kPassThreads>(lbm_mega_kernel, by, bx, ksteps);
  if (per_sm < 0) return -1;
  const long long tiles = static_cast<long long>(ny / by) * (nx / bx);
  const long long coresident = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(tiles < coresident ? tiles : coresident);
}

// `tpasses` in-place passes of `ksteps` steps in one cooperative launch of
// `nblocks` blocks (1 <= nblocks <= tiles, all co-resident:
// lbm_mega_num_blocks): pass t reads bands0 when (parity + t) is even,
// else bands1, and writes the other.  av[s] = mean |u| after step s of the
// tpasses * ksteps.  `partials` holds tpasses * ksteps * tiles floats.  Any
// base address of f, the bands and fluid is taken (the copies narrow to
// their alignment).  Returns the first launch error (0 = both launched).
int lbm_mega_step(float* f, float* bands0, float* bands1, const uint8_t* fluid,
                  float* partials, float* av, const StepParams* params, int by, int bx,
                  int ksteps, int tpasses, int parity, int nblocks, void* stream) {
  StepParams p = *params;
  if (!valid(p, by, bx, ksteps) || tpasses < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  lbm::InPlaceGeom g = inplace_geom(p.ny, p.nx, 0, by, bx, ksteps, f, bands0, bands1,
                                    nullptr, fluid);
  const int smem = lbm::pass_smem_bytes(by, bx, ksteps);
  if (nblocks < 1 || nblocks > g.tiles || g.vec < 1 || smem > lbm::kPassSmemBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(lbm_mega_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    void* args[] = {&f, &bands0, &bands1, &fluid, &partials, &p, &g, &tpasses, &parity};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_mega_kernel),
                                      dim3(nblocks), dim3(kPassThreads), args, smem,
                                      static_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error
    return static_cast<int>(err);
  }
  return lbm_av_reduce(partials, g.tiles, tpasses * ksteps, p.free_cells_inv, av, stream);
}

// One in-place pass of `ksteps` steps of one shard's row slab f[9][nyl][nx]
// (global rows [row0, row0 + nyl)) on by x bx tiles by `nblocks`
// persistent blocks (1 <= nblocks <= tiles): the halo outside the slab
// from `ghost` ([9][2K][nx], filled by the host before the pass), the rest
// from `bands_in`, the tiles' band cells to `bands_out` (the bands of an
// nyl x nx grid); `mask` is [nyl + 2K][nx] by global row.  sums[s] = the
// unscaled |u| sum over the slab's fluid cells after step s.  `partials`
// holds ksteps * tiles floats.  Needs K <= nyl (the ghost rows come from
// one neighbour).  Returns the first launch error (0 = both kernels
// launched).
int lbm_shard_temporal_xt_step(float* f, const float* ghost, const float* bands_in,
                               float* bands_out, const uint8_t* mask, float* partials,
                               float* sums, const StepParams* params, int nyl, int row0,
                               int by, int bx, int ksteps, int nblocks, void* stream) {
  const StepParams p = *params;
  if (by < 1 || bx < 1 || ksteps < 1 || nyl < 1 || nyl % by != 0 || p.nx % bx != 0 ||
      ksteps > nyl || row0 < 0 || row0 + nyl > p.ny)
    return static_cast<int>(cudaErrorInvalidValue);
  const lbm::InPlaceGeom g = inplace_geom(nyl, p.nx, row0, by, bx, ksteps, f, bands_in,
                                          bands_out, ghost, mask);
  const int err = lbm::launch_pass<kPassThreads>(lbm_shard_xt_kernel, g, nblocks, stream, f,
                                                 ghost, bands_in, bands_out, mask, partials,
                                                 p);
  if (err != 0) return err;
  return lbm_av_reduce(partials, g.tiles, ksteps, 1.0f, sums, stream);
}

}  // extern "C"
