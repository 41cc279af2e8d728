// The forward chain of one GRU direction over one batch row (kernel #6,
// csrc/gru_seq.cu), and the thread layout its backward (csrc/gru_bwd.cu)
// shares.
//
// TF-1 GRUCell over precomputed input contributions gx = x@W_gx + b_g
// [.., 2H] (r | u) and cx = x@W_cx + b_c [.., H]:
//   r, u = sigmoid(gx + h @ W_gh);  c = tanh(cx + (r*h) @ W_ch);
//   h' = u*h + (1-u)*c.
// Two dependent products a step: the candidate's needs the whole r*h.
//
// One block runs one chain and loops over all T steps itself. Thread
// (u, s) = (threadIdx.x / S, threadIdx.x % S) owns hidden unit u over the
// s-th of S slices of the reduction depth: for the gates it reads W_gh's
// columns u and H+u, for the candidate W_ch's column u, on its rows of the
// slice. The S slices of a unit are S neighbouring lanes of one warp, so
// their partial sums meet by warp shuffles (every lane of the unit gets the
// same bits) and a step needs only two __syncthreads: one after r*h is
// published to shared memory, one after the new h is. W_gh (512 KiB at
// H=256) and W_ch (256 KiB) do not fit shared memory and are read from L2
// every step, a warp's lanes on 32/S neighbouring columns of S rows.
#pragma once

#include "common.cuh"

namespace e2e {

// Slices per hidden unit (a power of two, so a unit's lanes share a warp),
// and the block's threads Hp * S (Hp = H rounded up to a warp multiple).
inline int gru_slices(int H) {
  const int Hp = (H + 31) / 32 * 32;
  int S = 4;
  while (S > 1 && Hp * S > 1024) S >>= 1;
  return S;
}

inline int gru_threads(int H) { return (H + 31) / 32 * 32 * gru_slices(H); }

// Sum of v over the S lanes of this thread's unit (butterfly: every lane
// gets the same bits).
__device__ __forceinline__ float unit_sum(float v, int S) {
  for (int off = 1; off < S; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// gx [T,B,2H], cx [T,B,H]; wg [H,2H], wc [H,H]; mask [T,B] (1 valid, 0
// carry h through the step) or null; out [T,B,H] unmasked h; ru [T,B,2H]
// (r | u) and c [T,B,H] of every step, or null (inference). b: the batch
// row; sm: the block's dynamic shared memory, 2H floats.
__device__ __forceinline__ void gru_fwd_chain(
    const float* __restrict__ gx, const float* __restrict__ cx,
    const float* __restrict__ wg, const float* __restrict__ wc,
    const float* __restrict__ mask, float* __restrict__ out,
    float* __restrict__ ru, float* __restrict__ c_out, int T, int B, int H,
    int S, int b, float* sm) {
  float* hbuf = sm;     // [H] h of the previous step
  float* rh = sm + H;   // [H] r * h of this step
  const int u = threadIdx.x / S, s = threadIdx.x % S;
  const bool unit = u < H;
  const int H2 = 2 * H;
  const int chunk = (H + S - 1) / S;
  const int k0 = min(H, s * chunk), k1 = min(H, k0 + chunk);

  for (int i = threadIdx.x; i < H; i += blockDim.x) hbuf[i] = 0.f;
  float h = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    float xr = 0.f, xu = 0.f, xc = 0.f, ar = 0.f, au = 0.f;
    if (unit) {
      xr = gx[row * H2 + u];
      xu = gx[row * H2 + H + u];
      xc = cx[row * H + u];
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float hk = hbuf[k];
        const float* wk = wg + static_cast<size_t>(k) * H2 + u;
        ar = fmaf(hk, __ldg(wk), ar);
        au = fmaf(hk, __ldg(wk + H), au);
      }
    }
    ar = unit_sum(ar, S);
    au = unit_sum(au, S);
    const float r = sigmoid(xr + ar), uu = sigmoid(xu + au);
    if (unit && s == 0) rh[u] = r * h;
    __syncthreads();
    float ac = 0.f;
    if (unit) {
#pragma unroll 8
      for (int k = k0; k < k1; ++k)
        ac = fmaf(rh[k], __ldg(wc + static_cast<size_t>(k) * H + u), ac);
    }
    ac = unit_sum(ac, S);
    const float c = tanhf(xc + ac);
    float nh = uu * h + (1.f - uu) * c;
    if (mask != nullptr) {
      const float v = mask[row];
      nh = v * nh + (1.f - v) * h;
    }
    h = nh;
    if (unit && s == 0) {
      hbuf[u] = nh;
      out[row * H + u] = nh;
      if (ru != nullptr) {
        ru[row * H2 + u] = r;
        ru[row * H2 + H + u] = uu;
        c_out[row * H + u] = c;
      }
    }
    __syncthreads();
  }
}

}  // namespace e2e
