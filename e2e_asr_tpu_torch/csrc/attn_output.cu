// Kernel #13: the additive attention folded into kernel C, for all k beams
// of a decoder step.
//
// Replaces e2e_asr_tpu/ops/dec_step_pallas.py attn_output_fused (body
// _attn_output_kernel). For every row n = b*k + j (beam j of utterance b;
// the Pallas kernel takes k-major rows j*B + b, the values per (b, j) are
// the same):
//   scores s = v . tanh(hf[b] + y[n]), -1e30 where mask[b] is 0; softmax to
//   alpha (exactly 0 on a padded frame); context = alpha @ enc[b];
//   AttnProjection([query, context]) -> OutputProjection -> log_softmax over
//   the true V (no 128-lane padding, which was a TPU layout artifact).
// Outputs: logp [N, V], context [N, Henc], alpha [N, T].
//
// Bound on the H100: latency, as kernels B and C (dec_step.cu). At the
// serving shape (B=8, k=4, T=64, A=128, Henc=512) the attention reads 1.3 MB
// of hf and enc and the projections 0.8 MB of weights; the plain route pays
// about eight launches for the attention between B and C.
//
// Design: ONE cooperative launch, three stages with a grid barrier between
// them: a block per row computes its T scores, the masked softmax and the
// context (attention.cuh; hf and enc of utterance b are read by the k blocks
// of its beams, from L2 after the first); then dec_step.cuh's output stages
// (AttnProjection and OutputProjection as 8 x 32 tiles, the log_softmax a
// warp per row). Limits, checked here and by the wrapper: A + T <= 8192
// (the block's score buffer), N a multiple of k.
#include "attention.cuh"
#include "dec_step.cuh"

namespace {

struct AttnOutputArgs {
  OutputArgs out;  // out.ctx is written by the attention stage
  const float *y, *hf, *enc, *mask, *v;
  float* alpha;
  int k, T, A;
};

__global__ void __launch_bounds__(kThreads)
    attn_output_kernel(AttnOutputArgs p) {
  __shared__ float smem[kSmem];
  cg::grid_group grid = cg::this_grid();
  float* ctx = const_cast<float*>(p.out.ctx);
  for (int n = blockIdx.x; n < p.out.N; n += gridDim.x)
    attention_row(p.hf, p.enc, p.mask, p.v, p.y, p.alpha, ctx, 0, n, n / p.k,
                  p.out.N, p.T, p.A, p.out.Henc, smem);
  grid.sync();
  output_stages(p.out, smem, grid);
}

}  // namespace

// ptrs: y [N,A], query [N,H], hf [B,T,A], enc [B,T,Henc], mask [B,T],
//   attn_v [A], w_ap [H+Henc,H], b_ap [H], w_out [H,V], b_out [V], then the
//   outputs logp [N,V], context [N,Henc], alpha [N,T] and the scratch proj
//   [N,H].
// dims: N, k, T, A, H, Henc, V.
E2E_EXPORT int e2e_attn_output_fused(const void* const* ptrs, int n_ptrs,
                                     const int* dims, int n_dims,
                                     cudaStream_t stream) {
  if (n_ptrs != 14 || n_dims != 7) return cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[i]));
  };
  AttnOutputArgs p{};
  const int N = dims[0];
  p.k = dims[1];
  p.T = dims[2];
  p.A = dims[3];
  p.out = OutputArgs{in(1), out(11), in(6), in(7), in(8), in(9), out(13),
                     out(10), N, dims[4], dims[5], dims[6]};
  p.y = in(0);
  p.hf = in(2);
  p.enc = in(3);
  p.mask = in(4);
  p.v = in(5);
  p.alpha = out(12);
  if (N < 1 || p.k < 1 || N % p.k != 0 || p.T < 1 || p.A < 1 ||
      p.A + p.T > kSmem || p.out.H < 1 || p.out.Henc < 1 || p.out.V < 1)
    return cudaErrorInvalidValue;
  return launch_cooperative(attn_output_kernel, p,
                            max(N, output_work(p.out)), stream);
}
