// N D2Q9-BGK timesteps per launch with the state held in shared memory
// across the whole card on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_multi` (built by
// `build_multi_step_program`) on the grids the route gives it
// (ops/schedule.py `multi_route`).  The TPU kernel keeps the 9 planes in
// VMEM inside one program and loops over the steps with no barrier.
// `lbm_multi.cu` spreads the grid over the card, but each step pays a
// grid-wide barrier and an L2 round trip of the whole state.  Here the
// state stays in shared memory, spread over one block an SM, and a block
// waits each step for its two neighbours' edge rows alone, which come
// through L2.
//
// Bound: the function moves 73 B a cell once per launch (f in, f out, the
// mask), so at 200 steps a launch its bound is its 104 operations a cell
// update at the card's fp32 rate.  A step is not near that bound: it is
// one handoff of an edge row to each neighbour through L2 (a store, and
// the neighbour's load once it is there) plus the update of the band's
// cells out of shared memory, one cell a thread.  No step waits for any
// block but the two neighbours, so the ring steps at the pace of that sum
// (`lbm_handoff_probe` times the handoff alone: 0.740 us with rows
// 128 wide, 1.211 us 256 wide, on an NVIDIA H100 80GB HBM3 at 700 W).  The
// update is not bound by the SM's issue rate but by one thread's chain of
// dependent instructions: 1-2 rows of one cell a thread are 4-16 warps,
// too few to hide it, and the update took about 0.92, 0.97 and 1.06 us at
// 128^2, 128x256 and 256^2 (4, 8 and 16 warps), where the general step
// below took 1.662, 1.706 and 2.274 us a step.  So a step is shortened by
// shortening that chain: the one-chunk step below took 1.163, 1.186 and
// 1.599 us there, the general step 1.711, 1.662 and 2.258 in the same
// turns, chunk 200 (PERF.md).
//
// Design:
//   * one cooperative launch of G <= SMs blocks, each block's dynamic
//     shared memory above half an SM's so that no two blocks share one;
//     block b owns the band of rows `band_of(ny, G, b)` (the first ny % G
//     bands one row more than ny / G), loaded once at the start of a launch
//     and stored once at its end, one cell a thread (at most 512 threads a
//     block, so nx <= 512);
//   * two steps, chosen by the shape alone (`width_of`, mirrored by
//     ops/schedule.py `bands_width`).  Where the widest band is one chunk
//     (its cells fit the block's threads) and nx is 128 or 256, the widths
//     of the canonical grids, the one-chunk step, compiled for that width:
//     the band and its two ghost rows in one array [rows + 2][9][nx], two
//     copies of it, step s reading copy s & 1 and writing the other, so the
//     rows below and above a cell are always 9 nx floats before and after
//     it and no row is saved; the ghost rows received for step s go
//     straight into rows 0 and rows + 1 of the copy it reads, and every
//     edge row carries all five populations of its side, so that each
//     word's population is known when the step is compiled.  Every
//     address, row pointer, column and kick flag is computed once before
//     the step loop, which is only: receive the ghost rows, one block
//     barrier, nine shared-memory loads (and the cell's mask byte),
//     `lbm::update_cell`, the edge sends, nine shared-memory stores into
//     the other copy, the |u| tree.  This removes from the chain the chunk
//     loop, the three-way row selects, the saved rows and their copy and
//     the barrier between a chunk's reads and writes, `k * nx` at a run
//     time width, the kick flags' wrap tests, the count of populations a
//     row carries and their decode from nibbles.  The width is compiled
//     in because a run-time one cost 6-9% of a step: with nx read at run
//     time the same step's loop held 632 SASS instructions, not 519, in 94
//     registers, not 80, and took 1.250, 1.285 and 1.669 us a step at
//     128^2, 128x256 and 256^2 against 1.143, 1.190 and 1.571 compiled, in
//     the same turns (PERF.md).  Any other band keeps the general step,
//     which takes any band of rows at most 512 wide in one copy: the band
//     [rows][9][nx] updated in place in chunks of blockDim / nx whole
//     rows, a block barrier between a chunk's reads and its writes, the row
//     below a chunk from one of two saved rows;
//   * handoffs: after step s a band's new first row goes to the block
//     below, its last row to the block above, each into that block's slot
//     of parity (s + 1) & 1 in device memory.  Only the populations that
//     cross the edge travel: 2, 5 and 6 to the row above the edge, 4, 7
//     and 8 to the row below it, and also 3 and 7 (3 and 6) where the
//     travelling row is row ny-2, whose kick gate its reader evaluates (in
//     the one-chunk step always).
//     Each value is stored beside its step's tag (epoch + s + 1) in one
//     64-bit word by `st.relaxed.gpu`, so the word carries its own
//     readiness and no fence or flag is needed: the reader's threads load
//     the words of step s by `ld.relaxed.gpu`, all at once, and poll again
//     only the words whose tag is not yet s's.  A slot of parity p is
//     rewritten two steps after it was read, by a sender that has since
//     received the reader's next row, so the reading is over; the epoch
//     advances by the steps of each launch, so no tag of an earlier launch
//     is taken for this one's (for 2^31 steps).  A poll that waits longer
//     than five seconds traps (the launch fails) instead of hanging.  A
//     general step has two block barriers, after its ghost rows arrive and
//     between a chunk's reads and writes, a one-chunk step only the first;
//     neither has one at its end;
//   * no clusters: the card admits a cooperative launch in clusters
//     (`lbm_handoff_probe` in clusters of two), but the ring of bands steps
//     at the pace of its slowest link, since a delay passes to the
//     neighbours in the next step, and a ring of 128 bands spans several
//     clusters, so some links, and with them every step, would still go
//     through L2;
//   * the mask's two ghost rows are loaded once a launch; the body-force
//     gate reads row ny-2 wherever it lies, band or ghost row;
//   * the per-cell arithmetic is `lbm::update_cell`, through `lbm::RowSrc`
//     in the general step and `CopySrc` in the one-chunk step, so f is
//     bitwise what the one-step and grid-barrier kernels give;
//   * |u|: each thread sums its cells in chunk order, warps by a shuffle
//     tree, the warp sums by the same tree in warp 0 (0 for the warps a
//     block lacks), one partial a step and block into partials[s][b] (the
//     one-chunk step keeps the warp sums of two steps and adds step s's in
//     step s + 1, after its barrier); after the last step one grid barrier,
//     then step s's partials are added in block order.  No float atomics:
//     av is the same bits every run, and the bits of the band algorithm
//     in torch (`fused.band_steps`) at these bands and threads.
// fp32 throughout, IEEE division and sqrt, -fmad=false, as lbm_step.cu.

#include <cooperative_groups.h>

#include "lbm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

// At most 512 threads a block, so that a thread may hold 128 registers.
constexpr int kMaxThreads = 512;
// Dynamic shared memory a block may take: the 227 KB opt-in maximum less
// 1 KiB for its static memory (the warp sums).
constexpr int kSmemBudget = 232448 - 1024;
// The least dynamic shared memory a block asks for: more than half of an
// SM's 228 KB, so that the scheduler puts one block on an SM.
constexpr int kSpreadSmem = 233472 / 2 + 1024;
// A slot holds up to five populations of a row.  Side 0 (the row below
// the band) carries 2, 5, 6, then 3, 7 where that row is ny-2; side 1
// (the row above) 4, 7, 8, then 3, 6; one population a nibble.
constexpr int kSlotPops = 5;
constexpr unsigned kPopsBelow = 0x73652u, kPopsAbove = 0x63874u;
// Words a thread loads a step: at most 2 * kSlotPops slot rows of nx, a
// column of them to each thread of a chunk row, and a block has at least
// nx threads.
constexpr int kMaxLoads = 2 * kSlotPops;
// A poll that has not seen its step's tag after this many SM cycles (five
// seconds at 2 GHz) traps.
constexpr long long kSpinTimeoutCycles = 10000000000ll;

// Band b of ny rows over g blocks: ny / g rows, one more for b < ny % g.
__host__ __device__ __forceinline__ void band_of(int ny, int g, int b, int* row0,
                                                 int* rows) {
  const int h = ny / g, extra = ny % g;
  *rows = h + (b < extra ? 1 : 0);
  *row0 = b * h + (b < extra ? b : extra);
}

__host__ __device__ __forceinline__ bool valid(int ny, int nx, int g) {
  return ny >= 2 && g >= 1 && g <= ny && nx >= 1 && nx <= kMaxThreads;
}

// Threads of a block: one a cell of the widest band, in whole warps, at
// least one row's and at most kMaxThreads.
__host__ __device__ __forceinline__ int threads_of(int ny, int nx, int g) {
  const int hmax = (ny + g - 1) / g;
  const long long cells = static_cast<long long>(hmax) * nx;
  const int lo = (nx + 31) / 32 * 32;
  const long long t = (cells + 31) / 32 * 32;
  return static_cast<int>(t < lo ? lo : t > kMaxThreads ? kMaxThreads : t);
}

// The width the one-chunk step is compiled for where it takes the grid:
// nx, where nx is one of the canonical grids' widths and the widest band
// is one chunk (its cells fit kMaxThreads threads); else 0, the general
// step.
__host__ __device__ __forceinline__ int width_of(int ny, int nx, int g) {
  const int hmax = (ny + g - 1) / g;
  return (nx == 128 || nx == 256) && static_cast<long long>(hmax) * nx <= kMaxThreads ? nx
                                                                                       : 0;
}

// Dynamic shared memory of one block.  The one-chunk step: two copies of
// the widest band's rows and its two ghost rows, each 9 fp32 planes of nx,
// then the mask of the band and its ghost rows.  The general step: the
// widest band's rows, the two ghost rows and two saved rows, each 9 fp32
// planes of nx, then the mask of the band and its ghost rows.
__host__ __device__ __forceinline__ long long smem_bytes(int ny, int nx, int g) {
  const long long hmax = (ny + g - 1) / g;
  if (width_of(ny, nx, g) != 0)
    return (2 * 9LL * nx * static_cast<long long>(sizeof(float)) + nx) * (hmax + 2);
  return 9LL * nx * static_cast<long long>(sizeof(float)) * (hmax + 4) + (hmax + 2) * nx;
}

__device__ __forceinline__ unsigned long long ld_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_word(unsigned long long* p, float v, unsigned tag) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned tag_of(unsigned long long w) {
  return static_cast<unsigned>(w >> 32);
}

// Slot (block, parity, side): kSlotPops rows of nx words.
__device__ __forceinline__ unsigned long long* slot(unsigned long long* slots, int b, int parity,
                                                    int side, int nx) {
  return slots + (static_cast<size_t>(b * 2 + parity) * 2 + side) * kSlotPops * nx;
}

// Ghost rows of a step: the `nb` populations of the row below from `below`
// and the `na` of the row above from `above`, tagged `tag`, into `ghost`
// ([below, above][9][nx]).  The thread of column x and chunk row cy takes
// the slot rows cy, cy + `every`, ...: it loads all its words at once, then
// loads again together those whose tag is not yet `tag`, until none is
// left; after kSpinTimeoutCycles of that it traps.
__device__ __forceinline__ void receive_rows(const unsigned long long* below,
                                             const unsigned long long* above, int nb, int na,
                                             unsigned tag, float* ghost, int nx, int cy,
                                             int every, int x) {
  const int n = nb + na;
  unsigned long long w[kMaxLoads];
#pragma unroll
  for (int j = 0; j < kMaxLoads; ++j) {
    const int r = cy + j * every;
    if (r < n) w[j] = ld_word(r < nb ? below + r * nx + x : above + (r - nb) * nx + x);
  }
  const long long t0 = clock64();
  for (unsigned round = 1;; ++round) {
    bool ready = true;
#pragma unroll
    for (int j = 0; j < kMaxLoads; ++j)
      if (cy + j * every < n && tag_of(w[j]) != tag) ready = false;
    if (ready) break;
#pragma unroll
    for (int j = 0; j < kMaxLoads; ++j) {
      const int r = cy + j * every;
      if (r < n && tag_of(w[j]) != tag)
        w[j] = ld_word(r < nb ? below + r * nx + x : above + (r - nb) * nx + x);
    }
    if ((round & 255) == 0 && clock64() - t0 > kSpinTimeoutCycles) __trap();
  }
#pragma unroll
  for (int j = 0; j < kMaxLoads; ++j) {
    const int r = cy + j * every;
    if (r < n) {
      const bool up = r >= nb;
      const int k = ((up ? kPopsAbove : kPopsBelow) >> (4 * (up ? r - nb : r))) & 15;
      ghost[(up ? 9 * nx : 0) + k * nx + x] = __uint_as_float(static_cast<unsigned>(w[j]));
    }
  }
}

// Column x of a new edge row into slot `dst`: its first n populations of
// the side's order.
template <unsigned kPops>
__device__ __forceinline__ void send_row(unsigned long long* dst, int n, const float o[9],
                                         int x, int nx, unsigned tag) {
#pragma unroll
  for (int r = 0; r < kSlotPops; ++r)
    if (r < n) st_word(dst + r * nx + x, o[(kPops >> (4 * r)) & 15], tag);
}

__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// After the grid barrier that follows the last step: av[s] = the sum of
// step s's partials in block order, times fcinv, each step by one thread
// of the grid.
__device__ __forceinline__ void sum_partials(const float* partials, float* __restrict__ av,
                                             int steps, float fcinv) {
  const int g = static_cast<int>(gridDim.x), nthreads = static_cast<int>(blockDim.x);
  for (int s = static_cast<int>(blockIdx.x) * nthreads + static_cast<int>(threadIdx.x);
       s < steps; s += g * nthreads) {
    const float* row = partials + static_cast<size_t>(s) * g;
    float sum = 0.0f;
    for (int q = 0; q < g; ++q) sum += __ldcg(row + q);
    av[s] = sum * fcinv;
  }
}

// The general step: the band updated in place in chunks of blockDim / nx
// rows (the design's second step).
__device__ __forceinline__ void general_steps(const float* f_in, float* f_out,
                                              const uint8_t* __restrict__ fluid,
                                              unsigned long long* slots, float* partials,
                                              float* __restrict__ av, int steps, unsigned epoch,
                                              const StepParams& p, unsigned char* smem) {
  __shared__ float warp_sums[32];
  cg::grid_group grid = cg::this_grid();
  const int g = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  const int nthreads = static_cast<int>(blockDim.x), tid = static_cast<int>(threadIdx.x);
  const int nx = p.nx, ny = p.ny, kr = ny - 2;
  const int rowf = 9 * nx;  // floats in a row
  const size_t plane = static_cast<size_t>(ny) * nx;
  int row0, rows;
  band_of(ny, g, b, &row0, &rows);
  const int hmax = (ny + g - 1) / g;
  float* band = reinterpret_cast<float*>(smem);  // [hmax][9][nx]
  float* ghost = band + hmax * rowf;              // [below, above][9][nx]
  float* saved = ghost + 2 * rowf;                // [2][9][nx]
  uint8_t* mask = reinterpret_cast<uint8_t*>(saved + 2 * rowf);  // [rows + 2][nx]

  // Rows -1 .. rows of the band from f_in, and the mask's.  Nothing reads
  // f_in after the first step, and f_out is written after the grid barrier
  // that follows the last, so f_out may be f_in.
  for (int i = tid; i < (rows + 2) * rowf; i += nthreads) {
    const int e = i / rowf;
    const int k = (i - e * rowf) / nx;
    const int x = i - e * rowf - k * nx;
    const int y = (row0 - 1 + e + ny) % ny;
    float* dst = e == 0 ? ghost : e == rows + 1 ? ghost + rowf : band + (e - 1) * rowf;
    dst[k * nx + x] = f_in[k * plane + static_cast<size_t>(y) * nx + x];
  }
  for (int i = tid; i < (rows + 2) * nx; i += nthreads) {
    const int e = i / nx;
    const int y = (row0 - 1 + e + ny) % ny;
    mask[i] = fluid[static_cast<size_t>(y) * nx + (i - e * nx)];
  }
  __syncthreads();

  // The populations each ghost row carries: five where it is row ny-2.
  // The band's first row is the lower block's row above, its last row the
  // upper block's row below.
  const int lower = b == 0 ? g - 1 : b - 1, upper = b == g - 1 ? 0 : b + 1;
  const int n_below = (row0 - 1 + ny) % ny == kr ? kSlotPops : 3;
  const int n_above = (row0 + rows) % ny == kr ? kSlotPops : 3;
  const int n_first = row0 == kr ? kSlotPops : 3;
  const int n_last = row0 + rows - 1 == kr ? kSlotPops : 3;

  const int chunk_rows = nthreads / nx;
  const int nchunks = (rows + chunk_rows - 1) / chunk_rows;
  const int nwarps = nthreads / 32;
  const int cy = tid / nx;  // this thread's row within a chunk
  const int x = tid - cy * nx;
  const int xm = lbm::wrap_dec(x, nx), xp = lbm::wrap_inc(x, nx);
  const bool in_chunk = cy < chunk_rows;

  for (int s = 0; s < steps; ++s) {
    if (s > 0) {
      // The rows sent in step s - 1, in slots of parity s & 1.
      if (in_chunk)
        receive_rows(slot(slots, b, s & 1, 0, nx), slot(slots, b, s & 1, 1, nx), n_below,
                     n_above, epoch + s, ghost, nx, cy, chunk_rows, x);
      __syncthreads();
    }
    const int sp = (s + 1) & 1;  // the parity this step's rows go to
    const bool sends = s + 1 < steps;
    const unsigned tag = epoch + s + 1;
    float acc = 0.0f;
    for (int j = 0; j < nchunks; ++j) {
      const int first = j * chunk_rows;
      const int ly = first + cy;
      const bool mine = in_chunk && ly < rows;
      float o[9];
      if (mine) {
        const float* rc = band + ly * rowf;
        const float* rs = ly == 0 ? ghost : ly == first ? saved + (j & 1) * rowf : rc - rowf;
        const float* rn = ly == rows - 1 ? ghost + rowf : rc + rowf;
        const uint8_t* mc = mask + (ly + 1) * nx;
        const lbm::RowSrc src{rs, rc, rn, mc - nx, mc, mc + nx, xm, x, xp, nx};
        const int y = row0 + ly;
        acc += lbm::update_cell(src, y == kr, lbm::wrap_dec(y, ny) == kr,
                                lbm::wrap_inc(y, ny) == kr, p, o);
        if (ly == first + chunk_rows - 1 && ly < rows - 1) {
          // The next chunk's row below, before this chunk rewrites it.
          float* sv = saved + ((j + 1) & 1) * rowf;
#pragma unroll
          for (int k = 0; k < 9; ++k) sv[k * nx + x] = rc[k * nx + x];
        }
      }
      if (j == nchunks - 1) {
        const float w = warp_tree(acc);
        if ((tid & 31) == 0) warp_sums[tid >> 5] = w;
      }
      __syncthreads();  // every pulled value read before any is rewritten
      if (mine) {
        // The edge rows leave first: the neighbours wait on them.
        if (sends && ly == 0)
          send_row<kPopsAbove>(slot(slots, lower, sp, 1, nx), n_first, o, x, nx, tag);
        if (sends && ly == rows - 1)
          send_row<kPopsBelow>(slot(slots, upper, sp, 0, nx), n_last, o, x, nx, tag);
        float* rc = band + ly * rowf;
#pragma unroll
        for (int k = 0; k < 9; ++k) rc[k * nx + x] = o[k];
      }
    }
    if (tid < 32) {
      const float total = warp_tree(tid < nwarps ? warp_sums[tid] : 0.0f);
      if (tid == 0) partials[static_cast<size_t>(s) * g + b] = total;
    }
    // No barrier here: the next step's, after its ghost rows arrive, keeps
    // the band's new rows and warp 0's read of the warp sums before any
    // thread reads or rewrites them; the ghost rows were last read before
    // this step's last chunk barrier.
  }
  // Every block's partials are written and visible, and every block has
  // loaded f_in, before any block stores f_out or sums.
  grid.sync();

  for (int i = tid; i < rows * rowf; i += nthreads) {
    const int e = i / rowf;
    const int k = (i - e * rowf) / nx;
    const int xx = i - e * rowf - k * nx;
    f_out[k * plane + static_cast<size_t>(row0 + e) * nx + xx] = band[i];
  }
  sum_partials(partials, av, steps, p.free_cells_inv);
}

// Source cells of the one-chunk step: the cell's row in the copy it reads,
// at its columns x-1, x and x+1, the rows below and above it 9 kNx floats
// before and after; the same cells' mask bytes, kNx apart.
template <int kNx>
struct CopySrc {
  const float* west;
  const float* here;
  const float* east;
  const uint8_t* mwest;
  const uint8_t* mhere;
  const uint8_t* meast;

  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return (dx < 0 ? west : dx > 0 ? east : here)[dy * 9 * kNx + k * kNx];
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return (dx < 0 ? mwest : dx > 0 ? meast : mhere)[dy * kNx] != 0;
  }
  // RowSrc's gate with its four loads issued at once, not one after the
  // other's test: the same value, one load's latency on the kick rows'
  // chain.
  __device__ __forceinline__ bool gate(int dy, int dx, float aw1, float aw2) const {
    const bool fl = fluid(dy, dx);
    const float f3 = f(3, dy, dx), f6 = f(6, dy, dx), f7 = f(7, dy, dx);
    return fl & (f3 - aw1 > 0.0f) & (f6 - aw2 > 0.0f) & (f7 - aw2 > 0.0f);
  }
};

// v, opaque to the compiler: a value computed once before the step loop
// stays in its register instead of being recomputed from the thread index
// in every step.
__device__ __forceinline__ int kept(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
template <class T>
__device__ __forceinline__ T* kept(T* v) {
  asm volatile("" : "+l"(v));
  return v;
}

// Population r of a side's slot row order (kPopsBelow or kPopsAbove).
template <unsigned kPops>
__device__ __forceinline__ constexpr int pop_of(int r) {
  return static_cast<int>((kPops >> (4 * r)) & 15);
}

// The one-chunk step (the design's first), for bands of rows kNx wide
// whose widest is one chunk: thread tid holds the cell of band row
// tid / kNx and column tid % kNx, as in the general step's one chunk.
// Every edge row carries all five populations of its side, the kick row's
// or not: the two beyond the three that cross the edge are the row's own
// values, read only where the row is ny-2, and the ring steps at the pace
// of its slowest link, which carries five anyway.  So no band decides how
// many, and no word's population is decoded.
template <int kNx>
__device__ __forceinline__ void one_chunk_steps(const float* f_in, float* f_out,
                                                const uint8_t* __restrict__ fluid,
                                                unsigned long long* slots, float* partials,
                                                float* __restrict__ av, int steps,
                                                unsigned epoch, const StepParams& p,
                                                unsigned char* smem) {
  constexpr int kRow = 9 * kNx;                 // floats in a row
  constexpr int kSide = kSlotPops * kNx;        // words of one side of a slot
  constexpr int kParity = 2 * kSide;            // words from one slot parity to the next
  __shared__ float warp_sums[2][32];            // steps of parity 0 and 1
  cg::grid_group grid = cg::this_grid();
  const int g = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  const int nthreads = static_cast<int>(blockDim.x), tid = static_cast<int>(threadIdx.x);
  const int ny = p.ny, kr = ny - 2;
  const size_t plane = static_cast<size_t>(ny) * kNx;
  int row0, rows;
  band_of(ny, g, b, &row0, &rows);
  const int hmax = (ny + g - 1) / g;
  const int copy = (hmax + 2) * kRow;           // floats in a copy
  float* buf = reinterpret_cast<float*>(smem);  // [2][hmax + 2][9][kNx]
  uint8_t* mask = reinterpret_cast<uint8_t*>(buf + 2 * copy);  // [rows + 2][kNx]

  // Rows -1 .. rows of the band from f_in into copy 0, and the mask's.
  // Nothing reads f_in after this, and f_out is written after the grid
  // barrier that follows the last step, so f_out may be f_in.
  for (int i = tid; i < (rows + 2) * kRow; i += nthreads) {
    const int e = i / kRow;
    const int k = (i - e * kRow) / kNx;
    const int x = i - e * kRow - k * kNx;
    const int y = (row0 - 1 + e + ny) % ny;
    buf[i] = f_in[k * plane + static_cast<size_t>(y) * kNx + x];
  }
  for (int i = tid; i < (rows + 2) * kNx; i += nthreads) {
    const int e = i / kNx;
    const int y = (row0 - 1 + e + ny) % ny;
    mask[i] = fluid[static_cast<size_t>(y) * kNx + (i - e * kNx)];
  }

  // Everything a step needs but the values, once.
  const int ly = tid / kNx, x = tid - ly * kNx;  // this thread's band row and column
  const bool mine = ly < rows;
  const int xm = lbm::wrap_dec(x, kNx), xp = lbm::wrap_inc(x, kNx);
  const int y = row0 + ly;
  const bool kick_c = mine && y == kr, kick_s = mine && lbm::wrap_dec(y, ny) == kr,
             kick_n = mine && lbm::wrap_inc(y, ny) == kr;
  // The cell in a copy at columns x-1, x and x+1, and its mask byte.
  const int cw = kept((ly + 1) * kRow + xm), cc = kept((ly + 1) * kRow + x),
            ce = kept((ly + 1) * kRow + xp);
  const int mw = kept((ly + 1) * kNx + xm), mcc = kept((ly + 1) * kNx + x),
            me = kept((ly + 1) * kNx + xp);
  // The ghost rows: with one band row a chunk its threads take both sides,
  // else band row 0 takes side 0 (the row below, into row 0 of the copy)
  // and band row 1 side 1 (the row above, into row rows + 1).
  const int every = nthreads / kNx;
  const bool take_below = ly == 0, take_above = ly == (every == 1 ? 0 : 1);
  const int below = kept(x), above = kept((rows + 1) * kRow + x);
  const int lower = b == 0 ? g - 1 : b - 1, upper = b == g - 1 ? 0 : b + 1;
  const unsigned long long* in = kept(slots + static_cast<size_t>(b) * 2 * kParity + x);
  unsigned long long* to_lower =
      kept(slots + static_cast<size_t>(lower) * 2 * kParity + kSide + x);
  unsigned long long* to_upper = kept(slots + static_cast<size_t>(upper) * 2 * kParity + x);
  const bool first = ly == 0, last = ly == rows - 1;  // the band's edge rows
  const int nwarps = nthreads / 32;
  unsigned long long w[2 * kSlotPops] = {};  // the words of a step's ghost rows
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int par = s & 1;
    float* const rd = buf + par * copy;
    if (s > 0) {
      // The rows sent in step s - 1, in slots of parity s & 1, into the
      // ghost rows of the copy this step reads.
      const unsigned long long* from = in + par * kParity;
      const unsigned tag = epoch + s;
#pragma unroll
      for (int j = 0; j < kSlotPops; ++j) {
        if (take_below) w[j] = ld_word(from + j * kNx);
        if (take_above) w[kSlotPops + j] = ld_word(from + kSide + j * kNx);
      }
      const long long t0 = clock64();
      for (unsigned round = 1;; ++round) {
        bool ready_below = true, ready_above = true;
#pragma unroll
        for (int j = 0; j < kSlotPops; ++j) {
          ready_below &= tag_of(w[j]) == tag;
          ready_above &= tag_of(w[kSlotPops + j]) == tag;
        }
        if ((ready_below || !take_below) && (ready_above || !take_above)) break;
#pragma unroll
        for (int j = 0; j < kSlotPops; ++j) {
          if (take_below && tag_of(w[j]) != tag) w[j] = ld_word(from + j * kNx);
          if (take_above && tag_of(w[kSlotPops + j]) != tag)
            w[kSlotPops + j] = ld_word(from + kSide + j * kNx);
        }
        if ((round & 255) == 0 && clock64() - t0 > kSpinTimeoutCycles) __trap();
      }
      if (take_below) {
#pragma unroll
        for (int j = 0; j < kSlotPops; ++j)
          rd[below + pop_of<kPopsBelow>(j) * kNx] =
              __uint_as_float(static_cast<unsigned>(w[j]));
      }
      if (take_above) {
#pragma unroll
        for (int j = 0; j < kSlotPops; ++j)
          rd[above + pop_of<kPopsAbove>(j) * kNx] =
              __uint_as_float(static_cast<unsigned>(w[kSlotPops + j]));
      }
      __syncthreads();
    }
    float acc = 0.0f;
    if (mine) {
      const CopySrc<kNx> src{rd + cw, rd + cc, rd + ce, mask + mw, mask + mcc, mask + me};
      float o[9];
      acc += lbm::update_cell(src, kick_c, kick_s, kick_n, p, o);
      if (s + 1 < steps) {
        // The edge rows leave first: the neighbours wait on them.
        const int sp = (par ^ 1) * kParity;  // the parity this step's rows go to
        const unsigned tag = epoch + s + 1;
        if (first) {
#pragma unroll
          for (int j = 0; j < kSlotPops; ++j)
            st_word(to_lower + sp + j * kNx, o[pop_of<kPopsAbove>(j)], tag);
        }
        if (last) {
#pragma unroll
          for (int j = 0; j < kSlotPops; ++j)
            st_word(to_upper + sp + j * kNx, o[pop_of<kPopsBelow>(j)], tag);
        }
      }
      float* const wc = buf + (par ^ 1) * copy + cc;
#pragma unroll
      for (int k = 0; k < 9; ++k) wc[k * kNx] = o[k];
    }
    const float wsum = warp_tree(acc);
    if ((tid & 31) == 0) warp_sums[par][tid >> 5] = wsum;
    if (s > 0 && tid < 32) {
      // Step s - 1's warp sums, written before this step's barrier; they
      // are rewritten only after the next one.
      const float total = warp_tree(tid < nwarps ? warp_sums[par ^ 1][tid] : 0.0f);
      if (tid == 0) partials[static_cast<size_t>(s - 1) * g + b] = total;
    }
  }
  __syncthreads();
  if (tid < 32) {
    const float total = warp_tree(tid < nwarps ? warp_sums[(steps - 1) & 1][tid] : 0.0f);
    if (tid == 0) partials[static_cast<size_t>(steps - 1) * g + b] = total;
  }
  // Every block's partials are written and visible, and every block has
  // loaded f_in, before any block stores f_out or sums.
  grid.sync();

  const float* last_copy = buf + (steps & 1) * copy + kRow;
  for (int i = tid; i < rows * kRow; i += nthreads) {
    const int e = i / kRow;
    const int k = (i - e * kRow) / kNx;
    const int xx = i - e * kRow - k * kNx;
    f_out[k * plane + static_cast<size_t>(row0 + e) * kNx + xx] = last_copy[i];
  }
  sum_partials(partials, av, steps, p.free_cells_inv);
}

// kNx 0: the general step; 128 or 256: the one-chunk step at that width
// (`width_of`).
template <int kNx>
__global__ void __launch_bounds__(kMaxThreads, 1)
lbm_multi_bands_kernel(const float* f_in, float* f_out, const uint8_t* __restrict__ fluid,
                       unsigned long long* slots, float* partials, float* __restrict__ av,
                       int steps, unsigned epoch, const StepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kNx == 0)
    general_steps(f_in, f_out, fluid, slots, partials, av, steps, epoch, p, smem);
  else
    one_chunk_steps<kNx>(f_in, f_out, fluid, slots, partials, av, steps, epoch, p, smem);
}

// The handoff probe: `steps` steps of the kernel's handoff and nothing
// else, over `gridDim.x` cooperative blocks in a ring, rows `nx` wide:
// each step a block waits for the three populations of both ghost rows
// and, after a block barrier, sends three of each edge row to both
// neighbours.  Its slots are its own, zeroed at the start.
constexpr int kProbeMaxBlocks = 256, kProbeMaxWidth = 256;
__device__ unsigned long long probe_slots[kProbeMaxBlocks * 4 * kSlotPops * kProbeMaxWidth];

__global__ void __launch_bounds__(kMaxThreads, 1) lbm_handoff_kernel(int steps, int nx) {
  __shared__ float ghost[2 * 9 * kProbeMaxWidth];
  cg::grid_group grid = cg::this_grid();
  const int g = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  const int tid = static_cast<int>(threadIdx.x), nthreads = static_cast<int>(blockDim.x);
  for (int i = tid; i < 4 * kSlotPops * nx; i += nthreads)
    probe_slots[static_cast<size_t>(b) * 4 * kSlotPops * nx + i] = 0;
  grid.sync();
  const int lower = b == 0 ? g - 1 : b - 1, upper = b == g - 1 ? 0 : b + 1;
  const int every = nthreads / nx;
  float o[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) o[k] = 1.0f;
  for (int s = 0; s < steps; ++s) {
    if (s > 0 && tid < every * nx)
      receive_rows(slot(probe_slots, b, s & 1, 0, nx), slot(probe_slots, b, s & 1, 1, nx), 3,
                   3, s, ghost, nx, tid / nx, every, tid % nx);
    __syncthreads();
    if (s + 1 < steps && tid < nx) {
      send_row<kPopsAbove>(slot(probe_slots, lower, (s + 1) & 1, 1, nx), 3, o, tid, nx, s + 1);
      send_row<kPopsBelow>(slot(probe_slots, upper, (s + 1) & 1, 0, nx), 3, o, tid, nx, s + 1);
    }
  }
}

// The kernel of width kNx, its shared memory budget set.
template <int kNx>
int kernel_of(const void** fn) {
  *fn = reinterpret_cast<const void*>(lbm_multi_bands_kernel<kNx>);
  const cudaError_t err =
      cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block's footprint for an ny x nx grid on g
// blocks, or -1 where the kernel cannot take it (g > ny, nx > 512, the
// footprint beyond a block's budget).
int lbm_multi_bands_smem_bytes(int ny, int nx, int g) {
  if (!valid(ny, nx, g)) return -1;
  const long long b = smem_bytes(ny, nx, g);
  return b > kSmemBudget ? -1 : static_cast<int>(b);
}

// Threads of a block for an ny x nx grid on g blocks, or -1.
int lbm_multi_bands_threads(int ny, int nx, int g) {
  return lbm_multi_bands_smem_bytes(ny, nx, g) < 0 ? -1 : threads_of(ny, nx, g);
}

// The width of the one-chunk step that takes an ny x nx grid on g blocks
// (128 or 256), 0 where the general step takes it, or -1.
int lbm_multi_bands_width(int ny, int nx, int g) {
  return lbm_multi_bands_smem_bytes(ny, nx, g) < 0 ? -1 : width_of(ny, nx, g);
}

// `steps` steps in one cooperative launch of g blocks: f_in to f_out
// (f_out may be f_in); av[s] = mean |u| over fluid cells after step s.
// `partials` holds steps * g floats; `slots` g * 2 * 2 * 5 * nx 64-bit
// words, zeroed once when allocated; `epoch` advances by `steps` from one
// launch on the same slots to the next.  Returns the launch's error code
// (0 = launched): a grid of more blocks than the card runs at once is
// refused.
int lbm_multi_bands_step(const float* f_in, float* f_out, const uint8_t* fluid, void* slots,
                         float* partials, float* av, int steps, int g, int epoch,
                         const StepParams* params, void* stream) {
  StepParams p = *params;
  const int need = lbm_multi_bands_smem_bytes(p.ny, p.nx, g);
  if (steps < 1 || need < 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = nullptr;
  const int width = width_of(p.ny, p.nx, g);
  const int err = width == 128   ? kernel_of<128>(&fn)
                  : width == 256 ? kernel_of<256>(&fn)
                                 : kernel_of<0>(&fn);
  if (err != 0) return err;
  const int threads = threads_of(p.ny, p.nx, g);
  const size_t smem = static_cast<size_t>(need < kSpreadSmem ? kSpreadSmem : need);
  unsigned long long* words = static_cast<unsigned long long*>(slots);
  unsigned e = static_cast<unsigned>(epoch);
  void* args[] = {&f_in, &f_out, &fluid, &words, &partials, &av, &steps, &e, &p};
  const cudaError_t le = cudaLaunchCooperativeKernel(
      fn, dim3(g), dim3(threads), args, smem, static_cast<cudaStream_t>(stream));
  if (le != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(le);
  }
  return static_cast<int>(cudaGetLastError());
}

// The handoff probe: `steps` steps of the handoff over `blocks`
// cooperative blocks of min(2 nx, 512) threads, rows nx <= 256 wide;
// cluster > 1 launches the same grid cooperatively in clusters of that many
// blocks (whether the card admits a cooperative cluster launch).  Returns
// the launch's error code.
int lbm_handoff_probe(int blocks, int nx, int steps, int cluster, void* stream) {
  if (blocks < 1 || blocks > kProbeMaxBlocks || nx < 1 || nx > kProbeMaxWidth || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = 2 * nx < 32 ? 32 : (2 * nx + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, lbm_handoff_kernel, steps, nx);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
