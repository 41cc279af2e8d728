// Kernel #6: forward of a GRU layer over a sequence, one direction or both
// directions of a bidirectional layer in one launch.
//
// Replaces e2e_asr_tpu/ops/gru_pallas.py _fwd_seq (entries gru_seq and
// gru_seq_masked, without in-kernel dropout) and, in the training form,
// its residual-saving use by the custom VJP, which here also writes r | u
// and c of every step so that the backward (kernel #7, csrc/gru_bwd.cu)
// recomputes nothing. Where the JAX package runs a bidirectional GRU layer
// as two launches, gru_seq on the input and gru_seq_masked on the
// time-flipped input (core/rnn.py:373-415), one launch here runs both
// chains: the same function.
//
// Inputs per direction: the precomputed input contributions gates_x
// [T,B,2H] and cand_x [T,B,H], the recurrent kernels W_gh [H,2H] and W_ch
// [H,H], and an optional validity mask [T,B] whose zero steps carry h
// through (the backward direction's leading padding). Outputs h [T,B,H],
// unmasked (the caller masks), and in the training form r | u [T,B,2H] and
// c [T,B,H].
//
// Bound on the H100: the recurrence. Each step needs the whole previous h
// and reads W_gh and W_ch (768 KiB at H=256) from L2, in two dependent
// products; the chains of the batch rows and directions are independent
// and run on separate SMs (one block per chain, csrc/gru_fwd.cuh).
#include "gru_fwd.cuh"

namespace {

struct Dir {
  const float *gx, *cx, *wg, *wc, *mask;
  float *h, *ru, *c;
};

struct Args {
  Dir dir[2];
  int T, B, H, S;
};

__global__ void __launch_bounds__(1024) gru_fwd_kernel(Args a) {
  extern __shared__ float sm[];
  const Dir d = a.dir[blockIdx.y];
  e2e::gru_fwd_chain(d.gx, d.cx, d.wg, d.wc, d.mask, d.h, d.ru, d.c, a.T,
                     a.B, a.H, a.S, blockIdx.x, sm);
}

}  // namespace

// ptrs: per direction (n_dirs of them) gates_x [T,B,2H], cand_x [T,B,H],
// w_gh [H,2H], w_ch [H,H], mask [T,B] or NULL, h [T,B,H] (out), ru
// [T,B,2H] and c [T,B,H] (out, both NULL in the inference form).
E2E_EXPORT int e2e_gru_fwd(const void* const* ptrs, int n_dirs, int T, int B,
                           int H, cudaStream_t stream) {
  if (n_dirs < 1 || n_dirs > 2 || H < 1 || H > 1024 || B < 1 ||
      B > 65535 || T < 1)
    return cudaErrorInvalidValue;
  Args a{};
  for (int d = 0; d < n_dirs; ++d) {
    const void* const* p = ptrs + 8 * d;
    auto out = [&](int i) {
      return static_cast<float*>(const_cast<void*>(p[i]));
    };
    a.dir[d] = {static_cast<const float*>(p[0]),
                static_cast<const float*>(p[1]),
                static_cast<const float*>(p[2]),
                static_cast<const float*>(p[3]),
                static_cast<const float*>(p[4]), out(5), out(6), out(7)};
    if ((a.dir[d].ru == nullptr) != (a.dir[d].c == nullptr))
      return cudaErrorInvalidValue;
  }
  a.T = T;
  a.B = B;
  a.H = H;
  a.S = e2e::gru_slices(H);
  const size_t smem = 2 * static_cast<size_t>(H) * sizeof(float);
  gru_fwd_kernel<<<dim3(B, n_dirs), e2e::gru_threads(H), smem, stream>>>(a);
  return cudaGetLastError();
}
