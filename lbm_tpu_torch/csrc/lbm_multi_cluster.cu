// N D2Q9-BGK timesteps per launch in one thread-block cluster on Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces: lbm_tpu/ops/fused.py `_step_kernel_multi` (built by
// `build_multi_step_program`) for the grids whose one copy of f fits a
// cluster's shared memory in one chunk a band and that `lbm_multi_bands.cu`
// does not take (rows wider than 512; ops/schedule.py `multi_route`: the
// bands kernel is the faster at 128^2, 128x256 and 256^2, PERF.md).
// The TPU kernel keeps the 9 planes in VMEM inside one program and loops
// over the steps with no barrier; `lbm_multi.cu` spreads the grid over
// the card instead, and pays each step one L2 round trip of the whole
// state and one grid-wide barrier in software (global atomics).  Here the
// state stays on chip for the whole launch, as it does in VMEM: a cluster
// of C <= 16 blocks on neighbouring SMs (16 x 227 KB = 3.72 MB) holds one
// fp32 copy of f, and a block waits each step for its two neighbours'
// edge rows alone, not for the whole grid.
//
// Bound: the function moves 73 B a cell once per launch (f in, f out, the
// mask), so at 200 steps a launch its bound is its 104 operations a cell
// update at the card's fp32 rate.  A step is the update of ny*nx/C cells
// a block out of shared memory on C SMs, in chunks of one cell a thread,
// and the exchange of one row with each neighbour.  On an NVIDIA H100 80GB
// HBM3 (700 W) a chunk of 1,024 cells a block took about 1.3 us and the
// exchange 0.49 (rows 128 wide), so a band of one chunk beats the grid
// kernel (2.05 against 3.17 us a step at 128^2) and a band of more loses
// to it; the bands kernel, on one block an SM, beats both (PERF.md).
//
// Design:
//   * block r of the cluster owns a band of whole rows (the first ny % C
//     bands one row more than ny / C), loaded once at the start of a
//     launch and stored once at its end; rows are laid out [row][9][nx], so
//     a row is one contiguous run of 9 planes;
//   * the update runs in place on that one copy, in chunks of
//     kThreads / nx whole rows (one cell a thread): a chunk reads every
//     pulled value into registers, then a block barrier, then it writes
//     them; the row below a chunk is the previous chunk's last row as it
//     was before that chunk wrote it, kept in one of two saved rows;
//   * ghost rows: the row below and the row above the band, in two
//     parities.  Step s reads parity s & 1; its new first and last rows go
//     by `st.async` into the neighbours' ghost rows of parity (s + 1) & 1
//     (periodic: rank 0's lower neighbour is rank C - 1), each store
//     counted on the receiving row's mbarrier, which the receiver arms
//     with the row's bytes.  A cell of the first (last) row waits on its
//     ghost row's mbarrier before it reads it; nothing else waits on
//     another block.  A sender rewrites a slot only after it has waited
//     for the row the receiver sent after reading that slot, so no
//     cluster barrier is needed between steps: one costs more than this
//     exchange, by the fence it implies (`lbm_barrier_probe`, PERF.md);
//   * the mask's two ghost rows are loaded once a launch; the body-force
//     gate reads row ny-2 wherever it lies, band or ghost row;
//   * the per-cell arithmetic is `lbm::update_cell` through `lbm::RowSrc`,
//     so f is bitwise what the one-step and grid-barrier kernels give;
//   * |u|: each thread sums its cells in chunk order, warps by a shuffle
//     tree, the 32 warp sums by the same tree in warp 0, one partial a
//     step and block into partials[s][rank]; after the last step a cluster
//     barrier, then block 0 adds them in rank order.  No float atomics: av
//     is the same bits every run.
// fp32 throughout, IEEE division and sqrt, -fmad=false, as lbm_step.cu.

#include <cooperative_groups.h>

#include "lbm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// Dynamic shared memory a block may take: the 227 KB opt-in maximum less
// 1 KiB for its static memory (the warp sums and the mbarriers).
constexpr int kSmemBudget = 232448 - 1024;
static_assert(kWarps == 32, "warp 0 sums one value per warp");

// Band r of ny rows over c blocks: ny / c rows, one more for r < ny % c.
__host__ __device__ __forceinline__ void band_of(int ny, int c, int r, int* row0,
                                                 int* rows) {
  const int h = ny / c, extra = ny % c;
  *rows = h + (r < extra ? 1 : 0);
  *row0 = r * h + (r < extra ? r : extra);
}

// Dynamic shared memory of one block: the band's rows, four ghost rows
// (two parities of the row below and the row above) and two saved rows,
// each 9 fp32 planes of nx, then the mask of the band and its ghost rows.
// -1 where the cluster cannot take the grid.
__host__ __device__ __forceinline__ long long smem_bytes(int ny, int nx, int c) {
  if (c < 1 || c > kMaxCluster || ny < 2 || c > ny || nx < 1 || nx > kThreads)
    return -1;
  const long long hmax = (ny + c - 1) / c;
  return 9LL * nx * static_cast<long long>(sizeof(float)) * (hmax + 6) + (hmax + 2) * nx;
}

// The ghost-row exchange: an mbarrier in the receiver's shared memory per
// ghost row, whose phase completes when the receiver has announced the
// row's bytes and the sender's `st.async` stores of them have all landed.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The address in the shared::cluster window of `addr` in block `rank`.
__device__ __forceinline__ uint32_t remote(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(mbar),
      "r"(parity)
      : "memory");
}
// One float into block-remote shared memory, counted on its mbarrier.
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::
                   "r"(addr),
               "r"(__float_as_uint(v)), "r"(mbar)
               : "memory");
}

__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
lbm_multi_cluster_kernel(const float* f_in, float* f_out, const uint8_t* __restrict__ fluid,
                         float* partials, float* __restrict__ av, int steps,
                         const StepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_sums[kWarps];
  __shared__ __align__(8) uint64_t ghost_bar[4];  // [parity][below, above]
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nx = p.nx, ny = p.ny, kr = ny - 2;
  const int rowf = 9 * nx;  // floats in a row
  const size_t plane = static_cast<size_t>(ny) * nx;
  const int tid = threadIdx.x;
  int row0, rows;
  band_of(ny, c, rank, &row0, &rows);
  const int hmax = (ny + c - 1) / c;
  float* band = reinterpret_cast<float*>(smem);  // [hmax][9][nx]
  float* ghost = band + hmax * rowf;              // [parity][below, above][9][nx]
  float* saved = ghost + 4 * rowf;                // [2][9][nx]
  uint8_t* mask = reinterpret_cast<uint8_t*>(saved + 2 * rowf);  // [rows + 2][nx]

  // Rows -1 .. rows of the band from f_in: the band, and the ghost rows of
  // parity 0; the mask's the same rows.  Nothing reads f_in after the
  // barrier below, so f_out may be f_in.
  for (int i = tid; i < (rows + 2) * rowf; i += kThreads) {
    const int e = i / rowf;
    const int k = (i - e * rowf) / nx;
    const int x = i - e * rowf - k * nx;
    const int y = (row0 - 1 + e + ny) % ny;
    float* dst = e == 0 ? ghost : e == rows + 1 ? ghost + rowf : band + (e - 1) * rowf;
    dst[k * nx + x] = f_in[k * plane + static_cast<size_t>(y) * nx + x];
  }
  for (int i = tid; i < (rows + 2) * nx; i += kThreads) {
    const int e = i / nx;
    const int y = (row0 - 1 + e + ny) % ny;
    mask[i] = fluid[static_cast<size_t>(y) * nx + (i - e * nx)];
  }
  const uint32_t bars = smem_addr(ghost_bar);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every block has started, loaded and set up its mbarriers before any
  // writes another's ghost rows.
  cluster.sync();

  // Ghost rows of the neighbours: the band's first row is the row above
  // (side 1) of the block below, its last row the row below (side 0) of
  // the block above; each with the mbarrier of its slot.
  const int lower = rank == 0 ? c - 1 : rank - 1, upper = rank == c - 1 ? 0 : rank + 1;
  const uint32_t to_below = remote(smem_addr(ghost + rowf), lower);
  const uint32_t to_above = remote(smem_addr(ghost), upper);
  const uint32_t bar_below = remote(bars + 8, lower), bar_above = remote(bars, upper);
  const uint32_t row_bytes = static_cast<uint32_t>(rowf * sizeof(float));

  const int chunk_rows = kThreads / nx;
  const int nchunks = (rows + chunk_rows - 1) / chunk_rows;
  const int cy = tid / nx;  // this thread's row within a chunk
  const int x = tid - cy * nx;
  const int xm = lbm::wrap_dec(x, nx), xp = lbm::wrap_inc(x, nx);
  const bool in_chunk = cy < chunk_rows;

  for (int s = 0; s < steps; ++s) {
    const float* below = ghost + 2 * (s & 1) * rowf;
    const float* above = below + rowf;
    const int sp = (s + 1) & 1;  // the parity this step's rows go to
    const bool sends = s + 1 < steps;
    if (tid == 0 && sends) {
      // The rows the neighbours send this step: that slot's last phase
      // was waited on in the step before.
      mbar_expect(bars + 16 * sp, row_bytes);
      mbar_expect(bars + 16 * sp + 8, row_bytes);
    }
    // Step s >= 1 reads the rows sent in step s - 1: phase (s - 1) / 2 of
    // the slot's mbarrier.
    const uint32_t phase = ((s - 1) >> 1) & 1;
    float acc = 0.0f;
    for (int j = 0; j < nchunks; ++j) {
      const int first = j * chunk_rows;
      const int ly = first + cy;
      const bool mine = in_chunk && ly < rows;
      float o[9];
      if (mine) {
        if (s > 0 && ly == 0) mbar_wait(bars + 16 * (s & 1), phase);
        if (s > 0 && ly == rows - 1) mbar_wait(bars + 16 * (s & 1) + 8, phase);
        const float* rc = band + ly * rowf;
        const float* rs = ly == 0 ? below : ly == first ? saved + (j & 1) * rowf : rc - rowf;
        const float* rn = ly == rows - 1 ? above : rc + rowf;
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
        float* rc = band + ly * rowf;
#pragma unroll
        for (int k = 0; k < 9; ++k) rc[k * nx + x] = o[k];
        if (sends && ly == 0) {
          const uint32_t dst = to_below + 4 * (2 * sp * rowf + x);
#pragma unroll
          for (int k = 0; k < 9; ++k) st_async(dst + 4 * k * nx, o[k], bar_below + 16 * sp);
        }
        if (sends && ly == rows - 1) {
          const uint32_t dst = to_above + 4 * (2 * sp * rowf + x);
#pragma unroll
          for (int k = 0; k < 9; ++k) st_async(dst + 4 * k * nx, o[k], bar_above + 16 * sp);
        }
      }
    }
    if (tid < 32) {
      const float total = warp_tree(warp_sums[tid]);
      if (tid == 0) partials[static_cast<size_t>(s) * c + rank] = total;
    }
    __syncthreads();  // the band's new rows before the next step reads them
  }
  // Every block's partials are written and visible, and no block is still
  // reading a ghost row, before block 0 sums and any block exits.
  cluster.sync();

  for (int i = tid; i < rows * rowf; i += kThreads) {
    const int e = i / rowf;
    const int k = (i - e * rowf) / nx;
    const int xx = i - e * rowf - k * nx;
    f_out[k * plane + static_cast<size_t>(row0 + e) * nx + xx] = band[i];
  }
  if (rank == 0) {
    for (int s = tid; s < steps; s += kThreads) {
      const float* row = partials + static_cast<size_t>(s) * c;
      float sum = 0.0f;
      for (int q = 0; q < c; ++q) sum += __ldcg(row + q);
      av[s] = sum * p.free_cells_inv;
    }
  }
}

// The synchronisation probe: `steps` steps of synchronisation and nothing
// else, in one cooperative launch (the grid barrier of lbm_multi.cu), or
// one cluster: the cluster barrier, or this kernel's exchange (each step
// the first nx threads wait for both ghost rows and, after a block
// barrier, send their 9 floats of a row to both neighbours).
__global__ void __launch_bounds__(256) lbm_grid_barrier_kernel(int steps) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < steps; ++s) grid.sync();
}

__global__ void __launch_bounds__(kThreads, 1) lbm_cluster_barrier_kernel(int steps) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int s = 0; s < steps; ++s) cluster.sync();
}

__global__ void __launch_bounds__(kThreads, 1) lbm_exchange_kernel(int steps, int nx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t ghost_bar[4];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, rowf = 9 * nx;
  float* ghost = reinterpret_cast<float*>(smem);
  const uint32_t bars = smem_addr(ghost_bar);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  const int lower = rank == 0 ? c - 1 : rank - 1, upper = rank == c - 1 ? 0 : rank + 1;
  const uint32_t to_below = remote(smem_addr(ghost + rowf), lower);
  const uint32_t to_above = remote(smem_addr(ghost), upper);
  const uint32_t bar_below = remote(bars + 8, lower), bar_above = remote(bars, upper);
  for (int s = 0; s < steps; ++s) {
    const int sp = (s + 1) & 1;
    const bool sends = s + 1 < steps;
    if (tid == 0 && sends) {
      mbar_expect(bars + 16 * sp, rowf * 4);
      mbar_expect(bars + 16 * sp + 8, rowf * 4);
    }
    if (s > 0 && tid < nx) {
      mbar_wait(bars + 16 * (s & 1), ((s - 1) >> 1) & 1);
      mbar_wait(bars + 16 * (s & 1) + 8, ((s - 1) >> 1) & 1);
    }
    __syncthreads();
    if (sends && tid < nx) {
      for (int k = 0; k < 9; ++k) {
        st_async(to_below + 4 * (2 * sp * rowf + k * nx + tid), 1.0f, bar_below + 16 * sp);
        st_async(to_above + 4 * (2 * sp * rowf + k * nx + tid), 1.0f, bar_above + 16 * sp);
      }
    }
    __syncthreads();
  }
  cluster.sync();
}

int cluster_attributes(const void* kernel) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

cudaLaunchConfig_t cluster_config(int c, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block for an ny x nx grid on a cluster of c
// blocks, or -1 where the kernel cannot take it (c > ny, nx > 1024).
int lbm_multi_cluster_smem_bytes(int ny, int nx, int c) {
  const long long b = smem_bytes(ny, nx, c);
  return b < 0 || b > kSmemBudget ? -1 : static_cast<int>(b);
}

// Clusters of c blocks of this kernel, each block with `smem` bytes of
// dynamic shared memory, that device `device` runs at once
// (cudaOccupancyMaxActiveClusters): 0 where it refuses the cluster; a
// negative CUDA error.
int lbm_multi_cluster_active(int device, int c, int smem) {
  int old = 0;
  if (cudaGetDevice(&old) != cudaSuccess || cudaSetDevice(device) != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  int n = 0;
  int err = cluster_attributes(reinterpret_cast<const void*>(lbm_multi_cluster_kernel));
  if (err == 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(c, smem, nullptr, &attr);
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(lbm_multi_cluster_kernel), &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();
      err = static_cast<int>(e);
    }
  }
  cudaSetDevice(old);
  return err != 0 ? -err : n;
}

// `steps` steps in one launch of one cluster of c blocks: f_in to f_out
// (f_out may be f_in); av[s] = mean |u| over fluid cells after step s.
// `partials` holds steps * c floats.  Returns the launch's error code
// (0 = launched).
int lbm_multi_cluster_step(const float* f_in, float* f_out, const uint8_t* fluid,
                           float* partials, float* av, int steps, int c,
                           const StepParams* params, void* stream) {
  const StepParams p = *params;
  const int smem = lbm_multi_cluster_smem_bytes(p.ny, p.nx, c);
  if (steps < 1 || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      cluster_attributes(reinterpret_cast<const void*>(lbm_multi_cluster_kernel));
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(c, smem, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, lbm_multi_cluster_kernel, f_in, f_out,
                                           fluid, partials, av, steps, p);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The handoff of lbm_multi_bands.cu alone (defined there).
int lbm_handoff_probe(int blocks, int nx, int steps, int cluster, void* stream);

// The synchronisation probe: `steps` grid barriers over `blocks`
// cooperative blocks of 256 threads (mode 0), `steps` cluster barriers
// over one cluster of `blocks` blocks of 1,024 threads (mode 1), `steps`
// steps of this kernel's ghost-row exchange of rows nx wide over such a
// cluster (mode 2), or `steps` steps of `lbm_multi_bands.cu`'s handoff
// through device memory over `blocks` cooperative blocks in a ring, rows
// nx wide (mode 3; mode 4 the same launched in cooperative clusters of two
// blocks, refused where the card does not admit that).  Returns the
// launch's error code.
int lbm_barrier_probe(int mode, int blocks, int nx, int steps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == 3 || mode == 4) return lbm_handoff_probe(blocks, nx, steps, mode == 4 ? 2 : 1,
                                                       stream);
  if (mode == 0) {
    void* args[] = {&steps};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_grid_barrier_kernel),
                                    dim3(blocks), dim3(256), args, 0, s);
  } else {
    const void* kernel = mode == 1 ? reinterpret_cast<const void*>(lbm_cluster_barrier_kernel)
                                   : reinterpret_cast<const void*>(lbm_exchange_kernel);
    const int err = cluster_attributes(kernel);
    if (err != 0) return err;
    if (mode == 2 && (nx < 1 || nx > kThreads)) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(blocks, mode == 1 ? 0 : 36 * nx * 4, s,
                                                  &attr);
    e = mode == 1 ? cudaLaunchKernelEx(&cfg, lbm_cluster_barrier_kernel, steps)
                  : cudaLaunchKernelEx(&cfg, lbm_exchange_kernel, steps, nx);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
