// Kernel A: forward of both directions of one bidirectional LSTM layer.
//
// Replaces e2e_asr_tpu/ops/lstm_pallas.py lstm_seq_bidir (forward, no
// dropout). Inputs are the precomputed input projections x@W_x + b of both
// directions (the backward one of the time-flipped sequence), the recurrent
// kernels W_h [H,4H] and the validity mask of the flipped sequence.
//
// Layout: one block per chain (batch row b, direction d): grid (B, 2). The
// block loops over all T steps itself (blocks run in no order on the GPU, so
// the time loop cannot be the grid). Thread (s, u) owns hidden unit u's four
// gate columns u, H+u, 2H+u, 3H+u of W_h over the s-th of S slices of the
// reduction depth H; the slices' partial sums meet in shared memory, where
// the S = 0 threads finish the gates, keep c in a register and publish the
// new h to shared memory (two __syncthreads per step). W_h (1 MiB per
// direction at H=256) does not fit shared memory: it is read from L2 every
// step, the 32 threads of a warp on 32 neighbouring columns (128-byte
// lines); the S slices multiply the loads in flight, which is what bounds a
// step.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024) lstm_bidir_fwd_kernel(
    const float* __restrict__ xp_fw, const float* __restrict__ xp_bw,
    const float* __restrict__ w_fw, const float* __restrict__ w_bw,
    const float* __restrict__ mask_bw, float* __restrict__ h_fw,
    float* __restrict__ h_bw, int T, int B, int H, int S) {
  extern __shared__ float sm[];
  float* hbuf = sm;          // [H] current h of this chain
  float* part = sm + H;      // [S][4][H] partial gate sums
  const int b = blockIdx.x;
  const bool bw = blockIdx.y == 1;
  const int Hp = blockDim.x / S;  // H rounded up to a warp multiple
  const int u = threadIdx.x % Hp, s = threadIdx.x / Hp;
  const int H4 = 4 * H;
  const int chunk = (H + S - 1) / S;
  const int k0 = min(H, s * chunk), k1 = min(H, k0 + chunk);
  const float* xp = bw ? xp_bw : xp_fw;
  const float* w = bw ? w_bw : w_fw;
  float* out = bw ? h_bw : h_fw;

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
      float nh = e2e::lstm_cell(xi + gi, xj + gj, xf + gf, xo + go, nc);
      if (bw) {
        // Padding leads in the flipped sequence: carry the state through.
        const float v = mask_bw[t * B + b];
        nc = v * nc + (1.f - v) * c;
        nh = v * nh + (1.f - v) * h;
      }
      c = nc;
      h = nh;
      hbuf[u] = nh;
      out[(static_cast<size_t>(t) * B + b) * H + u] = nh;
    }
    __syncthreads();
  }
}

}  // namespace

// x_proj_fw/bw [T,B,4H], w_h_fw/bw [H,4H], mask_bw [T,B] -> h_fw, h_bw [T,B,H]
E2E_EXPORT int e2e_lstm_bidir_fwd(const float* xp_fw, const float* xp_bw,
                                  const float* w_fw, const float* w_bw,
                                  const float* mask_bw, float* h_fw,
                                  float* h_bw, int T, int B, int H,
                                  cudaStream_t stream) {
  if (H < 1 || H > 1024 || B < 1 || B > 65535 || T < 1)
    return cudaErrorInvalidValue;
  const int Hp = (H + 31) / 32 * 32;
  const int S = max(1, min(4, 1024 / Hp));  // reduction slices per unit
  const size_t smem = static_cast<size_t>(H) * (1 + 4 * S) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  lstm_bidir_fwd_kernel<<<dim3(B, 2), Hp * S, smem, stream>>>(
      xp_fw, xp_bw, w_fw, w_bw, mask_bw, h_fw, h_bw, T, B, H, S);
  return cudaGetLastError();
}
