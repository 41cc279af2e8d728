// Shared device helpers for the e2e_asr_tpu_torch kernels (float32).
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#define E2E_EXPORT extern "C" __attribute__((visibility("default")))

namespace e2e {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF sentinel

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// tf BasicLSTMCell update for gate pre-activations in order i, j, f, o with
// the +1.0 forget bias; c is updated in place, the new h is returned.
__device__ __forceinline__ float lstm_cell(float gi, float gj, float gf,
                                           float go, float& c) {
  c = c * sigmoid(gf + 1.f) + sigmoid(gi) * tanhf(gj);
  return sigmoid(go) * tanhf(c);
}

// Asynchronous 16-byte copies from device to shared memory (cp.async,
// through L2 only), committed in groups; wait_async<N>() returns once at
// most N groups are still in flight.
__device__ __forceinline__ void copy_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// One float, or zero when !in (nothing is read then).
__device__ __forceinline__ void copy_async4(float* smem, const float* gmem,
                                            bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether beam candidate (v, i) ranks before (bv, bi) in the selection
// order of the plain versions' stable descending sort: NaN above
// everything, then by value, ties to the lower flat index (as lax.top_k).
// Index -1 is "none". A strict total order on distinct indices.
__device__ __forceinline__ bool ranks_before(float v, int i, float bv,
                                             int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

}  // namespace e2e
