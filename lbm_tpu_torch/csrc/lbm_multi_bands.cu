// N D2Q9-BGK timesteps per launch with the state held in shared memory
// across the whole card on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_multi` (built by
// `build_multi_step_program`) on the grids the route gives it
// (ops/schedule.py `multi_route`).  The TPU kernel keeps the 9 planes in
// VMEM inside one program and loops over the steps with no barrier.
// `lbm_multi_cluster.cu` keeps one copy of f in the shared memory of one
// cluster, 16 SMs, and so runs a band of more than one chunk a block beyond
// 128^2; `lbm_multi.cu` spreads the grid over the card, but each step pays
// a grid-wide barrier and an L2 round trip of the whole state.  Here the
// state stays in shared memory as in the cluster kernel, spread over one
// block an SM, and a block waits each step for its two neighbours' edge
// rows alone, which come through L2.
//
// Bound: the function moves 73 B a cell once per launch (f in, f out, the
// mask), so at 200 steps a launch its bound is its 104 operations a cell
// update at the card's fp32 rate.  A step is the update of the band's
// cells (512 at 256^2 on 128 SMs) out of shared memory and one handoff of
// an edge row to each neighbour through L2: a store, and the neighbour's
// load once it is there.  No step waits for any block but the two
// neighbours, so the step's time is the update plus one such handoff
// (`lbm_barrier_probe` mode 3 times the handoff alone).  On an NVIDIA H100
// 80GB HBM3 (700 W) a step took 1.662, 1.706 and 2.274 us at 128^2,
// 128x256 and 256^2, the grid kernel's 3.099, 3.238 and 3.681 in the same
// turns, and the handoff alone 0.740 (rows 128 wide) and 1.211 us (256):
// a one-cell-a-thread update of 1-2 rows is a chain of dependent
// instructions that few warps cannot hide (PERF.md).
//
// Design:
//   * one cooperative launch of G <= SMs blocks, each block's dynamic
//     shared memory above half an SM's so that no two blocks share one;
//     block b owns the band of rows `band_of(ny, G, b)` (the first ny % G
//     bands one row more than ny / G), loaded once at the start of a launch
//     and stored once at its end, laid out [row][9][nx] as in
//     `lbm_multi_cluster.cu`, whose in-place update it keeps: chunks of
//     blockDim / nx whole rows (one cell a thread, at most 512 threads a
//     block, so nx <= 512), a block barrier
//     between a chunk's reads and its writes, the row below a chunk from
//     one of two saved rows;
//   * handoffs: after step s a band's new first row goes to the block
//     below, its last row to the block above, each into that block's slot
//     of parity (s + 1) & 1 in device memory.  Only the populations that
//     cross the edge travel: 2, 5 and 6 to the row above the edge, 4, 7
//     and 8 to the row below it, and also 3 and 7 (3 and 6) where the
//     travelling row is row ny-2, whose kick gate its reader evaluates.
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
//     step has two block barriers, after its ghost rows arrive and between
//     a chunk's reads and writes, and none at its end;
//   * no clusters: the card admits a cooperative launch in clusters
//     (`lbm_barrier_probe` mode 4), but the ring of bands steps at the pace
//     of its slowest link, since a delay passes to the neighbours in the
//     next step, and a ring of 128 bands spans several clusters, so some
//     links, and with them every step, would still go through L2;
//   * the mask's two ghost rows are loaded once a launch; the body-force
//     gate reads row ny-2 wherever it lies, band or ghost row;
//   * the per-cell arithmetic is `lbm::update_cell` through `lbm::RowSrc`,
//     so f is bitwise what the one-step, grid-barrier and cluster kernels
//     give;
//   * |u|: each thread sums its cells in chunk order, warps by a shuffle
//     tree, the warp sums by the same tree in warp 0 (0 for the warps a
//     block lacks), one partial a step and block into partials[s][b];
//     after the last step one grid barrier, then step s's partials are
//     added in block order.  No float atomics: av is the same bits every
//     run, and the bits of the cluster kernel's band algorithm
//     (`fused.cluster_steps`) at these bands and threads.
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

// Dynamic shared memory of one block: the widest band's rows, the two
// ghost rows and two saved rows, each 9 fp32 planes of nx, then the mask
// of the band and its ghost rows.
__host__ __device__ __forceinline__ long long smem_bytes(int ny, int nx, int g) {
  const long long hmax = (ny + g - 1) / g;
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

__global__ void __launch_bounds__(kMaxThreads, 1)
lbm_multi_bands_kernel(const float* f_in, float* f_out, const uint8_t* __restrict__ fluid,
                       unsigned long long* slots, float* partials, float* __restrict__ av,
                       int steps, unsigned epoch, const StepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  for (int s = b * nthreads + tid; s < steps; s += g * nthreads) {
    const float* row = partials + static_cast<size_t>(s) * g;
    float sum = 0.0f;
    for (int q = 0; q < g; ++q) sum += __ldcg(row + q);
    av[s] = sum * p.free_cells_inv;
  }
}

// The handoff probe: `steps` steps of this kernel's handoff and nothing
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

int smem_attribute() {
  const cudaError_t err =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(lbm_multi_bands_kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
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
  const int err = smem_attribute();
  if (err != 0) return err;
  const int threads = threads_of(p.ny, p.nx, g);
  const size_t smem = static_cast<size_t>(need < kSpreadSmem ? kSpreadSmem : need);
  unsigned long long* words = static_cast<unsigned long long*>(slots);
  unsigned e = static_cast<unsigned>(epoch);
  void* args[] = {&f_in, &f_out, &fluid, &words, &partials, &av, &steps, &e, &p};
  const cudaError_t le = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lbm_multi_bands_kernel), dim3(g), dim3(threads), args,
      smem, static_cast<cudaStream_t>(stream));
  if (le != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(le);
  }
  return static_cast<int>(cudaGetLastError());
}

// The handoff probe (`lbm_barrier_probe` modes 3 and 4): `steps` steps of
// the handoff over `blocks` cooperative blocks of min(2 nx, 512) threads,
// rows nx <= 256 wide; cluster > 1 launches the same grid cooperatively in
// clusters of that many blocks (whether the card admits a cooperative
// cluster launch).  Returns the launch's error code.
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
