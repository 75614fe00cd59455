// The fields readback's reconstruction on Hopper (sm_90a), hand-written
// CUDA C++: the float16 payload [u_x, u_y, rho - density] of a run's final
// state, and the obstacle mask, to the float32 planes [u_x, u_y, |u|,
// pressure] of final_state.dat.
//
// Replaces: no Pallas kernel.  lbm_tpu reconstructs on the host in fp64
// numpy (lbm_tpu/runtime.py `expand_fields`), and so did this port
// (lbm_tpu_torch/runtime.py `_expand_on_host`, kept for host payloads);
// at 1024^2 that was some 60 ms a solve with the card idle.
//
// The bits are numpy's.  Each value is computed in fp64 as numpy computes
// it and rounded once to fp32 (round to nearest even):
//   u_x, u_y  the fp16 values, widened exactly;
//   |u|       sqrt(u_x*u_x + u_y*u_y): two products and a sum, each
//             rounded (no fused multiply-add: the intrinsics below, and
//             -fmad=false besides), then IEEE sqrt;
//   pressure  ((double)float32(density) + (rho - density)) / 3 on a fluid
//             cell, density / 3 with density the caller's unrounded double
//             on an obstacle cell: numpy uses both densities, and so must
//             this kernel.
// fp64 division and sqrt round correctly in CUDA, as in numpy, and nothing
// here is built with --use_fast_math, so NaN and inf follow IEEE as well.
//
// Bound: device-memory bytes.  A cell reads 6 payload bytes and a mask
// byte and writes 16: 23 MB at 1024^2, a few microseconds on the card; the
// fp64 sqrt and division of a cell are some tens of instructions, well
// under that at the card's fp64 rate.  Design: each thread takes four
// neighbouring cells a turn of a grid-stride loop, with one 8-byte load a
// payload plane, one 4-byte mask load and one 16-byte store an output
// plane, so every warp access is coalesced and wide; a grid or slab whose
// cell count or bases do not allow that takes one cell a turn.  A slab of
// rows reads the payload and mask at its first cell and writes its own
// buffer, so a caller expands a grid whose output does not fit the card a
// slab at a time.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

struct Cell {
  float ux, uy, speed, pressure;
};

__device__ __forceinline__ double widen(uint32_t bits) {
  return static_cast<double>(__half2float(__ushort_as_half(static_cast<unsigned short>(bits))));
}

__device__ __forceinline__ Cell expand_cell(uint32_t bx, uint32_t by, uint32_t br,
                                            uint32_t obstacle, double density32,
                                            double pressure_obstacle) {
  const double ux = widen(bx);
  const double uy = widen(by);
  const double speed = __dsqrt_rn(__dadd_rn(__dmul_rn(ux, ux), __dmul_rn(uy, uy)));
  const double pressure =
      obstacle ? pressure_obstacle : __ddiv_rn(__dadd_rn(density32, widen(br)), 3.0);
  return {__double2float_rn(ux), __double2float_rn(uy), __double2float_rn(speed),
          __double2float_rn(pressure)};
}

// Cells [0, n) of the slab: payload plane p at raw + p * raw_stride, output
// plane p at out + p * out_stride.  kVec: four cells a turn (n a multiple
// of 4, every plane's base aligned to its vector).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    expand_kernel(const unsigned short* __restrict__ raw, long long raw_stride,
                  const uint8_t* __restrict__ obstacles, long long n,
                  float* __restrict__ out, long long out_stride, double density32,
                  double density) {
  const double pressure_obstacle = __ddiv_rn(density, 3.0);
  const unsigned short* rx = raw;
  const unsigned short* ry = raw + raw_stride;
  const unsigned short* rr = raw + 2 * raw_stride;
  float* ox = out;
  float* oy = out + out_stride;
  float* os = out + 2 * out_stride;
  float* op = out + 3 * out_stride;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (kVec) {
    for (long long i = first; i < n / 4; i += stride) {
      const uint2 x = reinterpret_cast<const uint2*>(rx)[i];
      const uint2 y = reinterpret_cast<const uint2*>(ry)[i];
      const uint2 r = reinterpret_cast<const uint2*>(rr)[i];
      const uint32_t m = reinterpret_cast<const uint32_t*>(obstacles)[i];
      const Cell c0 = expand_cell(x.x, y.x, r.x, m & 0xffu, density32, pressure_obstacle);
      const Cell c1 = expand_cell(x.x >> 16, y.x >> 16, r.x >> 16, (m >> 8) & 0xffu,
                                  density32, pressure_obstacle);
      const Cell c2 = expand_cell(x.y, y.y, r.y, (m >> 16) & 0xffu, density32,
                                  pressure_obstacle);
      const Cell c3 = expand_cell(x.y >> 16, y.y >> 16, r.y >> 16, m >> 24, density32,
                                  pressure_obstacle);
      reinterpret_cast<float4*>(ox)[i] = make_float4(c0.ux, c1.ux, c2.ux, c3.ux);
      reinterpret_cast<float4*>(oy)[i] = make_float4(c0.uy, c1.uy, c2.uy, c3.uy);
      reinterpret_cast<float4*>(os)[i] = make_float4(c0.speed, c1.speed, c2.speed, c3.speed);
      reinterpret_cast<float4*>(op)[i] =
          make_float4(c0.pressure, c1.pressure, c2.pressure, c3.pressure);
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      const Cell c = expand_cell(rx[i], ry[i], rr[i], obstacles[i], density32,
                                 pressure_obstacle);
      ox[i] = c.ux;
      oy[i] = c.uy;
      os[i] = c.speed;
      op[i] = c.pressure;
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// Expands cells [0, n) of one slab: raw is the slab's first payload cell
// (float16 planes raw_stride elements apart), obstacles its first mask byte
// (nonzero = obstacle), out its first output cell (float32 planes
// out_stride elements apart).  density32 is (double)float32(density).
int lbm_expand_fields(const void* raw, long long raw_stride, const void* obstacles,
                      long long n, void* out, long long out_stride, double density32,
                      double density, void* stream) {
  if (n < 0 || raw_stride < n || out_stride < n) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const bool vec = n % 4 == 0 && raw_stride % 4 == 0 && out_stride % 4 == 0 &&
                   aligned(raw, 8) && aligned(obstacles, 4) && aligned(out, 16);
  const long long items = vec ? n / 4 : n;
  const int blocks = static_cast<int>(
      (items + kThreads - 1) / kThreads < kMaxBlocks ? (items + kThreads - 1) / kThreads
                                                     : kMaxBlocks);
  const auto* r = static_cast<const unsigned short*>(raw);
  const auto* m = static_cast<const uint8_t*>(obstacles);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    expand_kernel<true><<<blocks, kThreads, 0, s>>>(r, raw_stride, m, n, o, out_stride,
                                                    density32, density);
  } else {
    expand_kernel<false><<<blocks, kThreads, 0, s>>>(r, raw_stride, m, n, o, out_stride,
                                                     density32, density);
  }
  return cudaGetLastError();
}

}  // extern "C"
