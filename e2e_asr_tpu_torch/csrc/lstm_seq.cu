// Kernel #3: forward of a unidirectional LSTM over a sequence.
//
// Replaces e2e_asr_tpu/ops/lstm_pallas.py _fwd_seq (entries lstm_seq and
// lstm_seq_masked, without in-kernel dropout) and, as the training form,
// _lstm_seq_fwd, which also writes the cell state c of every step for the
// backward (kernel #5, the one-direction entry of csrc/lstm_bidir_bwd.cu).
// Inputs: the precomputed input projection x@W_x + b [T,B,4H], the
// recurrent kernel W_h [H,4H] and, optionally, a validity mask [T,B] whose
// zero steps carry (c, h) through unchanged. Outputs h [T,B,H], unmasked
// (the caller masks), and in the training form c [T,B,H].
//
// Bound on the H100: the recurrence, as kernel A. Each step needs the whole
// previous h, so a chain is serial in time, and every step reads all of
// W_h (1 MiB f32 at H=256), which does not fit a block's shared memory, from
// L2: about 1 MiB of L2 traffic per batch row and step against 2 MFLOP.
//
// Design: the chain of csrc/lstm_fwd.cuh for one direction: one block
// per batch row, grid (B), the time loop inside the block, h in shared
// memory, c in registers, the depth of the W_h product split over 4 thread
// slices per unit. At the LM task's B=128 its 128 chains run in one wave on
// the 132 SMs.
#include "lstm_fwd.cuh"

namespace {

__global__ void __launch_bounds__(1024) lstm_seq_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ w,
    const float* __restrict__ mask, float* __restrict__ h,
    float* __restrict__ c, int T, int B, int H, int S) {
  extern __shared__ float sm[];
  e2e::lstm_fwd_chain(xp, w, mask, h, c, T, B, H, S, blockIdx.x, sm);
}

}  // namespace

// x_proj [T,B,4H], w_h [H,4H], mask [T,B] or NULL -> h [T,B,H], and c
// [T,B,H] unless NULL (the inference form).
E2E_EXPORT int e2e_lstm_seq_fwd(const float* xp, const float* w,
                                const float* mask, float* h, float* c, int T,
                                int B, int H, cudaStream_t stream) {
  if (H < 1 || H > 1024 || B < 1 || B > 65535 || T < 1)
    return cudaErrorInvalidValue;
  const size_t smem = e2e::fwd_smem(H);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  lstm_seq_fwd_kernel<<<B, e2e::fwd_threads(H), smem, stream>>>(
      xp, w, mask, h, c, T, B, H, e2e::fwd_slices(H));
  return cudaGetLastError();
}
