// The forward chain of one LSTM direction over one batch row: kernel #3's
// (lstm_seq.cu: one direction). Kernel A's forward (lstm_bidir.cu) ran it
// too, until it became a cluster walk with W_h in shared memory.
//
// One block runs one chain: it loops over all T steps itself (blocks run in
// no order on the GPU, so the time loop cannot be the grid). Thread (s, u)
// owns hidden unit u's four gate columns u, H+u, 2H+u, 3H+u of W_h over the
// s-th of S slices of the reduction depth H; the slices' partial sums meet
// in shared memory, where the s = 0 threads finish the gates, keep c in a
// register and publish the new h to shared memory (two __syncthreads per
// step). W_h (1 MiB at H=256) does not fit shared memory: it is read from
// L2 every step, the 32 threads of a warp on 32 neighbouring columns
// (128-byte lines); the S slices multiply the loads in flight, which is
// what bounds a step.
#pragma once

#include "common.cuh"

namespace e2e {

// Reduction slices per hidden unit, and the block's threads (Hp * S, Hp
// = H rounded up to a warp multiple).
inline int fwd_slices(int H) {
  const int Hp = (H + 31) / 32 * 32;
  return max(1, min(4, 1024 / Hp));
}

inline int fwd_threads(int H) { return (H + 31) / 32 * 32 * fwd_slices(H); }

// Dynamic shared memory of a chain: h [H] and the partial sums [S][4][H].
inline size_t fwd_smem(int H) {
  return static_cast<size_t>(H) * (1 + 4 * fwd_slices(H)) * sizeof(float);
}

// xp [T,B,4H] input projections, w [H,4H]; mask [T,B] (1 valid, 0 carry
// the state through the step) or null; out [T,B,H] unmasked h; c_out
// [T,B,H] or null (inference: c is not kept). b: the batch row; sm: the
// block's dynamic shared memory (fwd_smem(H) bytes).
__device__ __forceinline__ void lstm_fwd_chain(
    const float* __restrict__ xp, const float* __restrict__ w,
    const float* __restrict__ mask, float* __restrict__ out,
    float* __restrict__ c_out, int T, int B, int H, int S, int b,
    float* sm) {
  float* hbuf = sm;          // [H] current h of this chain
  float* part = sm + H;      // [S][4][H] partial gate sums
  const int Hp = blockDim.x / S;
  const int u = threadIdx.x % Hp, s = threadIdx.x / Hp;
  const int H4 = 4 * H;
  const int chunk = (H + S - 1) / S;
  const int k0 = min(H, s * chunk), k1 = min(H, k0 + chunk);

  for (int i = threadIdx.x; i < H; i += blockDim.x) hbuf[i] = 0.f;
  float c = 0.f, h = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* x = xp + (static_cast<size_t>(t) * B + b) * H4 + u;
    float xi = 0.f, xj = 0.f, xf = 0.f, xo = 0.f;
    if (s == 0 && u < H) {  // issued before the dot product to hide latency
      xi = x[0];
      xj = x[H];
      xf = x[2 * H];
      xo = x[3 * H];
    }
    if (u < H) {
      float ai = 0.f, aj = 0.f, af = 0.f, ao = 0.f;
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float hk = hbuf[k];
        const float* wk = w + static_cast<size_t>(k) * H4 + u;
        ai = fmaf(hk, __ldg(wk), ai);
        aj = fmaf(hk, __ldg(wk + H), aj);
        af = fmaf(hk, __ldg(wk + 2 * H), af);
        ao = fmaf(hk, __ldg(wk + 3 * H), ao);
      }
      float* p = part + (s * 4) * H + u;
      p[0] = ai;
      p[H] = aj;
      p[2 * H] = af;
      p[3 * H] = ao;
    }
    __syncthreads();
    if (s == 0 && u < H) {
      float gi = 0.f, gj = 0.f, gf = 0.f, go = 0.f;
      for (int q = 0; q < S; ++q) {
        const float* p = part + (q * 4) * H + u;
        gi += p[0];
        gj += p[H];
        gf += p[2 * H];
        go += p[3 * H];
      }
      float nc = c;
      float nh = lstm_cell(xi + gi, xj + gj, xf + gf, xo + go, nc);
      if (mask != nullptr) {  // carry the state through invalid steps
        const float v = mask[t * B + b];
        nc = v * nc + (1.f - v) * c;
        nh = v * nh + (1.f - v) * h;
      }
      c = nc;
      h = nh;
      hbuf[u] = nh;
      const size_t at = (static_cast<size_t>(t) * B + b) * H + u;
      out[at] = nh;
      if (c_out != nullptr) c_out[at] = nc;
    }
    __syncthreads();
  }
}

}  // namespace e2e
