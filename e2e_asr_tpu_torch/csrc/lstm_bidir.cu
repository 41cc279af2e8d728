// Kernel A: forward of both directions of one bidirectional LSTM layer.
//
// Replaces e2e_asr_tpu/ops/lstm_pallas.py lstm_seq_bidir (forward, no
// dropout) and, as e2e_lstm_bidir_fwd_train, its residual-saving training
// form _lstm_seq_bidir_fwd, which also writes the cell state c of every
// step for the backward (csrc/lstm_bidir_bwd.cu). Inputs are the
// precomputed input projections x@W_x + b of both directions (the backward
// one of the time-flipped sequence), the recurrent kernels W_h [H,4H] and
// the validity mask of the flipped sequence.
//
// Layout: one block per chain (batch row b, direction d): grid (B, 2), each
// block running the chain of csrc/lstm_fwd.cuh, the backward direction
// with the carry mask.
#include "lstm_fwd.cuh"

namespace {

__global__ void __launch_bounds__(1024) lstm_bidir_fwd_kernel(
    const float* __restrict__ xp_fw, const float* __restrict__ xp_bw,
    const float* __restrict__ w_fw, const float* __restrict__ w_bw,
    const float* __restrict__ mask_bw, float* __restrict__ h_fw,
    float* __restrict__ h_bw, float* __restrict__ c_fw,
    float* __restrict__ c_bw, int T, int B, int H, int S) {
  extern __shared__ float sm[];
  const bool bw = blockIdx.y == 1;
  // Padding leads in the flipped sequence: the bw chain carries its state
  // through it. c_fw/c_bw null: inference, c is not kept.
  e2e::lstm_fwd_chain(bw ? xp_bw : xp_fw, bw ? w_bw : w_fw,
                      bw ? mask_bw : nullptr, bw ? h_bw : h_fw,
                      bw ? c_bw : c_fw, T, B, H, S, blockIdx.x, sm);
}

cudaError_t launch_fwd(const float* xp_fw, const float* xp_bw,
                       const float* w_fw, const float* w_bw,
                       const float* mask_bw, float* h_fw, float* h_bw,
                       float* c_fw, float* c_bw, int T, int B, int H,
                       cudaStream_t stream) {
  if (H < 1 || H > 1024 || B < 1 || B > 65535 || T < 1)
    return cudaErrorInvalidValue;
  const size_t smem = e2e::fwd_smem(H);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  lstm_bidir_fwd_kernel<<<dim3(B, 2), e2e::fwd_threads(H), smem, stream>>>(
      xp_fw, xp_bw, w_fw, w_bw, mask_bw, h_fw, h_bw, c_fw, c_bw, T, B, H,
      e2e::fwd_slices(H));
  return cudaGetLastError();
}

}  // namespace

// x_proj_fw/bw [T,B,4H], w_h_fw/bw [H,4H], mask_bw [T,B] -> h_fw, h_bw [T,B,H]
E2E_EXPORT int e2e_lstm_bidir_fwd(const float* xp_fw, const float* xp_bw,
                                  const float* w_fw, const float* w_bw,
                                  const float* mask_bw, float* h_fw,
                                  float* h_bw, int T, int B, int H,
                                  cudaStream_t stream) {
  return launch_fwd(xp_fw, xp_bw, w_fw, w_bw, mask_bw, h_fw, h_bw, nullptr,
                    nullptr, T, B, H, stream);
}

// The training form: as e2e_lstm_bidir_fwd, and also c_fw, c_bw [T,B,H].
E2E_EXPORT int e2e_lstm_bidir_fwd_train(const float* xp_fw, const float* xp_bw,
                                        const float* w_fw, const float* w_bw,
                                        const float* mask_bw, float* h_fw,
                                        float* h_bw, float* c_fw, float* c_bw,
                                        int T, int B, int H,
                                        cudaStream_t stream) {
  if (c_fw == nullptr || c_bw == nullptr) return cudaErrorInvalidValue;
  return launch_fwd(xp_fw, xp_bw, w_fw, w_bw, mask_bw, h_fw, h_bw, c_fw,
                    c_bw, T, B, H, stream);
}
