// Kernels B and C: one attention-decoder inference step around the additive
// attention (which stays in PyTorch, as the reference leaves it to XLA).
//
// B replaces e2e_asr_tpu/ops/dec_step_pallas.py cells_fused: decoder-LM LSTM
// -> [SimpleProjection] -> InputProjection([lm_out, ctx_prev]) -> L stacked
// decoder LSTMs -> attention query y = c_top @ W_q + b_q, over N = B*k rows.
// C replaces dec_step_pallas.py output_fused: AttnProjection([query,
// context]) -> OutputProjection -> log_softmax. No vocabulary padding (the
// 128-lane padding was a TPU layout artifact).
//
// Both are chains of small dependent products (N = 32 rows), so both are ONE
// cooperative launch each: a grid of at most one block per output tile (and
// no more than the card holds at once) with a grid-wide barrier between the
// stages, built from the tiles of tiles.cuh (8 rows x 32 columns or units,
// the reduction depth split over the 8 warps). Splitting K keeps each
// thread's chain of dependent loads short: the step is bound by load
// latency, not by FLOPs or bandwidth.
#include "tiles.cuh"

namespace {

constexpr int kMaxLayers = 8;

struct CellsArgs {
  const float *x_emb, *ctx, *lm_c, *lm_h, *lm_w, *lm_b, *sp_w, *sp_b, *ip_w,
      *ip_b, *q_w, *q_b;
  float *lm_c_out, *lm_h_out, *sp_out, *x_out, *y_out;
  const float *dec_c[kMaxLayers], *dec_h[kMaxLayers], *dec_w[kMaxLayers],
      *dec_b[kMaxLayers];
  float *dec_c_out[kMaxLayers], *dec_h_out[kMaxLayers];
  int N, E, Henc, Hl, H, A, L;
};

struct OutputArgs {
  const float *q, *ctx, *ap_w, *ap_b, *out_w, *out_b;
  float *proj, *logp;
  int N, H, Henc, V;
};

__global__ void __launch_bounds__(kThreads) cells_fused_kernel(CellsArgs p) {
  __shared__ float smem[kSmem];
  cg::grid_group grid = cg::this_grid();
  for (int t = blockIdx.x; t < num_tiles(p.Hl, p.N); t += gridDim.x)
    lstm_tile(p.x_emb, p.E, p.lm_h, p.lm_c, p.Hl, p.lm_w, p.lm_b, p.lm_c_out,
              p.lm_h_out, p.N, t, smem);
  grid.sync();
  const float* lm_y = p.lm_h_out;
  if (p.sp_w != nullptr) {
    for (int t = blockIdx.x; t < num_tiles(p.H, p.N); t += gridDim.x)
      dense_tile(p.lm_h_out, p.Hl, nullptr, 0, p.sp_w, p.sp_b, p.H, p.sp_out,
                 p.N, t, smem);
    grid.sync();
    lm_y = p.sp_out;
  }
  for (int t = blockIdx.x; t < num_tiles(p.E, p.N); t += gridDim.x)
    dense_tile(lm_y, p.H, p.ctx, p.Henc, p.ip_w, p.ip_b, p.E, p.x_out, p.N, t,
               smem);
  grid.sync();
  const float* x = p.x_out;
  int Kx = p.E;
  for (int l = 0; l < p.L; ++l) {
    for (int t = blockIdx.x; t < num_tiles(p.H, p.N); t += gridDim.x)
      lstm_tile(x, Kx, p.dec_h[l], p.dec_c[l], p.H, p.dec_w[l], p.dec_b[l],
                p.dec_c_out[l], p.dec_h_out[l], p.N, t, smem);
    grid.sync();
    x = p.dec_h_out[l];
    Kx = p.H;
  }
  for (int t = blockIdx.x; t < num_tiles(p.A, p.N); t += gridDim.x)
    dense_tile(p.dec_c_out[p.L - 1], p.H, nullptr, 0, p.q_w, p.q_b, p.A,
               p.y_out, p.N, t, smem);
}

__global__ void __launch_bounds__(kThreads) output_fused_kernel(OutputArgs p) {
  __shared__ float smem[kSmem];
  cg::grid_group grid = cg::this_grid();
  for (int t = blockIdx.x; t < num_tiles(p.H, p.N); t += gridDim.x)
    dense_tile(p.q, p.H, p.ctx, p.Henc, p.ap_w, p.ap_b, p.H, p.proj, p.N, t,
               smem);
  grid.sync();
  for (int t = blockIdx.x; t < num_tiles(p.V, p.N); t += gridDim.x)
    dense_tile(p.proj, p.H, nullptr, 0, p.out_w, p.out_b, p.V, p.logp, p.N, t,
               smem);
  grid.sync();
  // log_softmax in place, one warp per row.
  const int lane = threadIdx.x & 31;
  for (int n = blockIdx.x * kWarps + (threadIdx.x >> 5); n < p.N;
       n += gridDim.x * kWarps) {
    float* l = p.logp + static_cast<size_t>(n) * p.V;
    float m = -INFINITY;
    for (int v = lane; v < p.V; v += 32) m = fmaxf(m, __ldcg(l + v));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int v = lane; v < p.V; v += 32) s += expf(__ldcg(l + v) - m);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float z = logf(s);
    for (int v = lane; v < p.V; v += 32) l[v] = __ldcg(l + v) - m - z;
  }
}

}  // namespace

// ptrs: x_emb, ctx_prev, lm_c, lm_h, lm_w, lm_b, sp_w|NULL, sp_b|NULL, ip_w,
//   ip_b, q_w, q_b, lm_c_out, lm_h_out, sp_out|NULL, x_out (scratch [N,E]),
//   y_out, then per decoder layer: c, h, w, b, c_out, h_out.
// dims: N, E, Henc, Hl, H, A, L.
E2E_EXPORT int e2e_cells_fused(const void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims,
                               cudaStream_t stream) {
  if (n_dims != 7) return cudaErrorInvalidValue;
  CellsArgs p{};
  p.N = dims[0];
  p.E = dims[1];
  p.Henc = dims[2];
  p.Hl = dims[3];
  p.H = dims[4];
  p.A = dims[5];
  p.L = dims[6];
  if (p.L < 1 || p.L > kMaxLayers || n_ptrs != 17 + 6 * p.L || p.N < 1)
    return cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[i]));
  };
  p.x_emb = in(0);
  p.ctx = in(1);
  p.lm_c = in(2);
  p.lm_h = in(3);
  p.lm_w = in(4);
  p.lm_b = in(5);
  p.sp_w = in(6);
  p.sp_b = in(7);
  p.ip_w = in(8);
  p.ip_b = in(9);
  p.q_w = in(10);
  p.q_b = in(11);
  p.lm_c_out = out(12);
  p.lm_h_out = out(13);
  p.sp_out = out(14);
  p.x_out = out(15);
  p.y_out = out(16);
  for (int l = 0; l < p.L; ++l) {
    const int b = 17 + 6 * l;
    p.dec_c[l] = in(b);
    p.dec_h[l] = in(b + 1);
    p.dec_w[l] = in(b + 2);
    p.dec_b[l] = in(b + 3);
    p.dec_c_out[l] = out(b + 4);
    p.dec_h_out[l] = out(b + 5);
  }
  int tiles = num_tiles(p.Hl, p.N);
  tiles = max(tiles, num_tiles(p.H, p.N));
  tiles = max(tiles, num_tiles(p.E, p.N));
  tiles = max(tiles, num_tiles(p.A, p.N));
  return launch_cooperative(cells_fused_kernel, p, tiles, stream);
}

// query [N,H], context [N,Henc], w_ap [H+Henc,H], b_ap [H], w_out [H,V],
// b_out [V], proj (scratch [N,H]) -> logp [N,V]
E2E_EXPORT int e2e_output_fused(const float* q, const float* ctx,
                                const float* w_ap, const float* b_ap,
                                const float* w_out, const float* b_out,
                                float* proj, float* logp, int N, int H,
                                int Henc, int V, cudaStream_t stream) {
  if (N < 1 || H < 1 || V < 1 || Henc < 0) return cudaErrorInvalidValue;
  OutputArgs p{q, ctx, w_ap, b_ap, w_out, b_out, proj, logp, N, H, Henc, V};
  const int tiles = max(max(num_tiles(H, N), num_tiles(V, N)),
                        (N + kWarps - 1) / kWarps);
  return launch_cooperative(output_fused_kernel, p, tiles, stream);
}
