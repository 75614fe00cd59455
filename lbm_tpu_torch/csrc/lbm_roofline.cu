// The issue-rate probe: hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces: tools/vpu_roofline.py `_build` (its Pallas `body`): a
// VMEM-resident [rows, 128] f32 block run through `inner` iterations of
// one of three recurrences, timed to give the chip's practical element-op
// rate.  Here one thread carries one element of `rows * 128` through the
// same recurrences, from device memory to a register and back:
//   * add: x = x + b, `unroll` times an iteration (1 op each);
//   * fma: x = x * a + b, `unroll` times an iteration (2 ops each: this
//     library is built with -fmad=false, so a multiply and an add, as the
//     production kernels compile `a * b + c`);
//   * mix: the 106-op blend of vpu_roofline.py once an iteration (1
//     compare, 81 add/sub/mul, 10 selects with their 10 adds, 2 adds, an
//     IEEE division and an IEEE sqrt): the production per-cell update's
//     op mix, as this build compiles it.
// `a` and `b` are kernel arguments and every result is stored, so nothing
// folds at compile time.
//
// Bound: operations.  An element's 4 bytes are read and written once a
// launch against `inner * unroll` (add, fma: x1, x2) or `inner * 106` (mix)
// operations; the probe's point is that this rate, not the datasheet's, is
// what an issue-bound kernel of this build can reach.  Every element is
// independent, so a warp never waits on another; the latency of one chain
// is hidden by the other warps of the SM, which is why the launch must hold
// enough elements to fill every SM many times over (the tool's default).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAdd = 0;
constexpr int kFma = 1;
constexpr int kMix = 2;

template <int kOp>
__global__ void __launch_bounds__(kThreads)
lbm_roofline_kernel(const float* __restrict__ x_in, float* __restrict__ out, int n,
                    int inner, int unroll, float a, float b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = x_in[i];
  if (kOp == kMix) {
    for (int it = 0; it < inner; ++it) {
      const bool m = x > 0.5f;
#pragma unroll
      for (int j = 0; j < 10; ++j) x = (x + b) * a - b;
#pragma unroll
      for (int j = 0; j < 20; ++j) x = x + b;
#pragma unroll
      for (int j = 0; j < 20; ++j) x = x * a;
#pragma unroll
      for (int j = 0; j < 11; ++j) x = x - b;
#pragma unroll
      for (int j = 0; j < 10; ++j) x = m ? x : x + b;
      x = 1.0f / (x + 1.0f);
      x = sqrtf(x + 1.0f);
    }
  } else {
    const int reps = inner * unroll;
#pragma unroll 16
    for (int t = 0; t < reps; ++t) x = kOp == kAdd ? x + b : x * a + b;
  }
  out[i] = x;
}

template <int kOp>
int launch(const float* x_in, float* out, int n, int inner, int unroll, float a, float b,
           void* stream) {
  if (n < 1 || inner < 0 || unroll < 1 ||
      static_cast<long long>(inner) * unroll > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  lbm_roofline_kernel<kOp><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x_in, out, n, inner, unroll, a, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[i] = x_in[i] after `inner` iterations of the named recurrence
// (`unroll` ops an iteration for add and fma; mix ignores it), for i in
// [0, n).  Returns the launch error (0 = launched).
int lbm_roofline_add(const float* x_in, float* out, int n, int inner, int unroll,
                     float a, float b, void* stream) {
  return launch<kAdd>(x_in, out, n, inner, unroll, a, b, stream);
}

int lbm_roofline_fma(const float* x_in, float* out, int n, int inner, int unroll,
                     float a, float b, void* stream) {
  return launch<kFma>(x_in, out, n, inner, unroll, a, b, stream);
}

int lbm_roofline_mix(const float* x_in, float* out, int n, int inner, int unroll,
                     float a, float b, void* stream) {
  return launch<kMix>(x_in, out, n, inner, unroll, a, b, stream);
}

}  // extern "C"
