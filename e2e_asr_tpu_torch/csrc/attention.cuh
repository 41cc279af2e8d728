// The forward of the masked additive attention for one row, shared by the
// training decoders (dec_train.cu, dec_train_gru.cu) and kernel #13
// (attn_output.cu). Runs inside a cooperative launch built from tiles.cuh.
#pragma once

#include "tiles.cuh"

namespace {

// Offset of row n at step t of a [S, B, width] buffer.
__device__ __forceinline__ size_t at(int t, int n, int B, int width) {
  return (static_cast<size_t>(t) * B + n) * width;
}

// Masked additive attention of row n at step t over the frames of
// encoder row src: scores v . tanh(hf[src] + y[t, n]), masked softmax over
// the T frames -> alpha[t, n] [T] (exactly 0 on padded frames), context
// ctx[t, n] = alpha @ enc[src] [E]. hf [*,T,A], enc [*,T,E], amask [*,T],
// y [S,B,A]; smem holds at least A + T floats. One block per row.
__device__ void attention_row(const float* hf, const float* enc,
                              const float* amask, const float* v,
                              const float* y, float* alpha, float* ctx,
                              int t, int n, int src, int B, int T, int A,
                              int E, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ys = smem;      // [A]
  float* sc = smem + A;  // [T] scores, then alpha
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    ys[a] = __ldcg(y + at(t, n, B, A) + a);
  __syncthreads();
  for (int tt = warp; tt < T; tt += kWarps) {
    const float* h = hf + (static_cast<size_t>(src) * T + tt) * A;
    float s = 0.f;
    for (int a = lane; a < A; a += 32)
      s += __ldg(v + a) * tanhf(__ldg(h + a) + ys[a]);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sc[tt] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const float* am = amask + static_cast<size_t>(src) * T;
    float m = -INFINITY;
    for (int tt = lane; tt < T; tt += 32)
      m = fmaxf(m, __ldg(am + tt) > 0.f ? sc[tt] : e2e::kNegInf);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float z = 0.f;
    for (int tt = lane; tt < T; tt += 32) {
      const float s = __ldg(am + tt) > 0.f ? sc[tt] : e2e::kNegInf;
      const float e = expf(s - m) * __ldg(am + tt);
      sc[tt] = e;
      z += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      z += __shfl_xor_sync(0xffffffffu, z, off);
    __syncwarp();
    for (int tt = lane; tt < T; tt += 32) {
      const float al = sc[tt] / z;
      sc[tt] = al;
      alpha[at(t, n, B, T) + tt] = al;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const float* en = enc + static_cast<size_t>(src) * T * E + e;
    float s = 0.f;
    for (int tt = 0; tt < T; ++tt) s += sc[tt] * __ldg(en + tt * E);
    ctx[at(t, n, B, E) + e] = s;
  }
  __syncthreads();
}

}  // namespace
