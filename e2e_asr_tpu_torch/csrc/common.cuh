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

}  // namespace e2e
