// The D2Q9-BGK per-cell update shared by every kernel of the port, and the
// constants they take from the host.
//
// One cell update is the pull of the 9 populations from the neighbouring
// source cells, the body-force kick of those whose source row is ny-2
// (gated on the SOURCE cell's pre-kick values, `_body_force_okf`,
// kernels.cl:29-33), then BGK relaxation or bounce-back and |u|
// (`_collide`, lbm_tpu/ops/fused.py:240).  The kernels differ only in where
// the source values live (device memory with periodic wrap, or a window in
// shared memory), which the `Src` accessor hides: `src.f(k, dy, dx)` is
// population k of the source cell at row offset dy and column offset dx,
// `src.fluid(dy, dx)` its mask, and `src.gate(dy, dx, aw1, aw2)` the
// body-force gate of that cell when its row is ny-2: fluid, and f3, f6 and
// f7 stay positive after the kick, on the pre-kick values.  The offsets
// are compile-time constants once `update_cell` is inlined.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors `_StepParams` in lbm_tpu_torch/ops/fused.py field for field.
// At namespace scope: a type with internal linkage in the signature of an
// exported function would keep that function out of the library's symbols.
struct StepParams {
  int ny;
  int nx;
  float omega;
  float aw1;
  float aw2;
  float free_cells_inv;
  float weights[9];
  float kick[9];
};

// av_out[r] = scale * (fixed-order sum of partials[r * n .. r * n + n)) for
// r in [0, rows); defined in lbm_step.cu.  Returns cudaGetLastError().
extern "C" int lbm_av_reduce(const float* partials, int n, int rows, float scale,
                             float* av_out, void* stream);

namespace lbm {

__device__ __forceinline__ int wrap_dec(int i, int n) { return i == 0 ? n - 1 : i - 1; }
__device__ __forceinline__ int wrap_inc(int i, int n) { return i == n - 1 ? 0 : i + 1; }

// One cell: writes the 9 post-collision populations to o[] and returns
// |u| (0 for an obstacle cell).  kick_c, kick_s and kick_n say whether the
// cell's own row, the row below (y-1) and the row above (y+1) is ny-2.
template <class Src>
__device__ __forceinline__ float update_cell(const Src& s, bool kick_c, bool kick_s,
                                             bool kick_n, const StepParams& p,
                                             float o[9]) {
  // Pull tmp[k](y, x) = f[k](y - cy_k, x - cx_k).
  float t0 = s.f(0, 0, 0);
  float t1 = s.f(1, 0, -1);
  float t2 = s.f(2, -1, 0);
  float t3 = s.f(3, 0, 1);
  float t4 = s.f(4, 1, 0);
  float t5 = s.f(5, -1, -1);
  float t6 = s.f(6, -1, 1);
  float t7 = s.f(7, 1, 1);
  float t8 = s.f(8, 1, -1);

  // Fused accelerate_flow: kicked speeds 1,3 (source row y), 5,6 (source
  // row y-1) and 7,8 (source row y+1), each when its source row is ny-2.
  if (kick_c) {
    if (s.gate(0, -1, p.aw1, p.aw2)) t1 = t1 + p.kick[1];
    if (s.gate(0, 1, p.aw1, p.aw2)) t3 = t3 + p.kick[3];
  }
  if (kick_s) {
    if (s.gate(-1, -1, p.aw1, p.aw2)) t5 = t5 + p.kick[5];
    if (s.gate(-1, 1, p.aw1, p.aw2)) t6 = t6 + p.kick[6];
  }
  if (kick_n) {
    if (s.gate(1, 1, p.aw1, p.aw2)) t7 = t7 + p.kick[7];
    if (s.gate(1, -1, p.aw1, p.aw2)) t8 = t8 + p.kick[8];
  }

  // BGK + bounce-back, operation for operation as `_collide`.
  const float rho = t0 + t1 + t2 + t3 + t4 + t5 + t6 + t7 + t8;
  const float rho_inv = 1.0f / rho;
  const float mx = t1 + t5 + t8 - t3 - t6 - t7;
  const float my = t2 + t5 + t6 - t4 - t7 - t8;
  const float msq = mx * mx + my * my;
  const float half_icsq_rinv = 1.5f * rho_inv;
  const float om = p.omega;

  if (s.fluid(0, 0)) {
    const float feq0 = p.weights[0] * (rho - half_icsq_rinv * msq);
    o[0] = t0 + om * (feq0 - t0);
    {
      const float w = p.weights[1];
      const float equ = 3.0f * mx;
      const float shared = w * (rho + half_icsq_rinv * (equ * mx - msq));
      const float beta = w * equ;
      o[1] = t1 + om * ((shared + beta) - t1);
      o[3] = t3 + om * ((shared - beta) - t3);
    }
    {
      const float w = p.weights[2];
      const float equ = 3.0f * my;
      const float shared = w * (rho + half_icsq_rinv * (equ * my - msq));
      const float beta = w * equ;
      o[2] = t2 + om * ((shared + beta) - t2);
      o[4] = t4 + om * ((shared - beta) - t4);
    }
    {
      const float w = p.weights[5];
      const float eu = mx + my;
      const float equ = 3.0f * eu;
      const float shared = w * (rho + half_icsq_rinv * (equ * eu - msq));
      const float beta = w * equ;
      o[5] = t5 + om * ((shared + beta) - t5);
      o[7] = t7 + om * ((shared - beta) - t7);
    }
    {
      const float w = p.weights[6];
      const float eu = my - mx;
      const float equ = 3.0f * eu;
      const float shared = w * (rho + half_icsq_rinv * (equ * eu - msq));
      const float beta = w * equ;
      o[6] = t6 + om * ((shared + beta) - t6);
      o[8] = t8 + om * ((shared - beta) - t8);
    }
    return sqrtf(msq) * rho_inv;
  }
  // Bounce-back: out[k] = tmp[OPPOSITE[k]].
  o[0] = t0;
  o[1] = t3; o[3] = t1;
  o[2] = t4; o[4] = t2;
  o[5] = t7; o[7] = t5;
  o[6] = t8; o[8] = t6;
  return 0.0f;
}

// Source cells in device memory, f[9][ny][nx], with periodic wrap resolved
// by the caller into the three row offsets and three columns.  kCoherent
// reads through L2 only (`ld.global.cg`), for a kernel that reads cells
// other blocks wrote earlier in the same launch; otherwise through the
// read-only path (`ld.global.nc`), for a buffer no block writes.
template <bool kCoherent>
struct GlobalSrc {
  const float* base;
  const uint8_t* mask;
  size_t plane;
  size_t rm, ry, rp;  // row starts of y-1, y, y+1
  int xm, x, xp;      // columns x-1, x, x+1
  int nx, kr;         // the grid's width and the kicked row ny-2

  __device__ __forceinline__ int col(int dx) const { return dx < 0 ? xm : dx > 0 ? xp : x; }
  __device__ __forceinline__ size_t at(int dy, int dx) const {
    return (dy < 0 ? rm : dy > 0 ? rp : ry) + col(dx);
  }
  __device__ __forceinline__ float load(size_t i) const {
    return kCoherent ? __ldcg(base + i) : __ldg(base + i);
  }
  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return load(k * plane + at(dy, dx));
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return __ldg(mask + at(dy, dx)) != 0;
  }
  // The gate's cell lies in row ny-2 by definition; its address is taken
  // from that row, so the y-1 and y+1 row starts need not outlive the
  // nine loads.
  __device__ __forceinline__ bool gate(int, int dx, float aw1, float aw2) const {
    const size_t c = static_cast<size_t>(kr) * nx + col(dx);
    return __ldg(mask + c) != 0 && load(3 * plane + c) - aw1 > 0.0f &&
           load(6 * plane + c) - aw2 > 0.0f && load(7 * plane + c) - aw2 > 0.0f;
  }
};

// Source cells in shared-memory rows, each row its 9 planes [9][nx] in
// turn, so the rows y-1, y and y+1 may lie in different buffers (a band,
// its ghost rows, a saved row); x wraps inside a row.
struct RowSrc {
  const float* rs;  // rows y-1, y, y+1
  const float* rc;
  const float* rn;
  const uint8_t* ms;  // their masks
  const uint8_t* mc;
  const uint8_t* mn;
  int xm, x, xp;  // columns x-1, x, x+1
  int nx;

  __device__ __forceinline__ int col(int dx) const { return dx < 0 ? xm : dx > 0 ? xp : x; }
  __device__ __forceinline__ const float* row(int dy) const {
    return dy < 0 ? rs : dy > 0 ? rn : rc;
  }
  __device__ __forceinline__ const uint8_t* mrow(int dy) const {
    return dy < 0 ? ms : dy > 0 ? mn : mc;
  }
  __device__ __forceinline__ float f(int k, int dy, int dx) const {
    return row(dy)[k * nx + col(dx)];
  }
  __device__ __forceinline__ bool fluid(int dy, int dx) const {
    return mrow(dy)[col(dx)] != 0;
  }
  __device__ __forceinline__ bool gate(int dy, int dx, float aw1, float aw2) const {
    return fluid(dy, dx) && f(3, dy, dx) - aw1 > 0.0f && f(6, dy, dx) - aw2 > 0.0f &&
           f(7, dy, dx) - aw2 > 0.0f;
  }
};

// Block-wide sum of one value per thread in a fixed tree (kThreads a power
// of two).  The result is valid in thread 0 only: the others may already
// be writing `red` again for the next sum.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return threadIdx.x + threadIdx.y * blockDim.x == 0 ? red[0] : 0.0f;
}

}  // namespace lbm
