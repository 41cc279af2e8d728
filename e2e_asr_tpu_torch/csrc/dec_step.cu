// Kernels B and C: one attention-decoder inference step around the additive
// attention.
//
// B replaces e2e_asr_tpu/ops/dec_step_pallas.py cells_fused: decoder-LM cell
// -> [SimpleProjection] -> InputProjection([lm_out, ctx_prev]) -> L stacked
// decoder cells -> attention query y = q @ W_q + b_q, over N = B*k rows, for
// LSTM cells (q the top c) and GRU cells (q the top h), as that kernel's two
// branches.
// C replaces dec_step_pallas.py output_fused: AttnProjection([query,
// context]) -> OutputProjection -> log_softmax (dec_step.cuh). Kernel #13
// (attn_output.cu) folds the attention into C.
//
// Both are chains of small dependent products (N = 32 rows), so both are ONE
// cooperative launch each: a grid of at most one block per output tile (and
// no more than the card holds at once) with a grid-wide barrier between the
// stages, built from the tiles of tiles.cuh (8 rows x 32 columns or units,
// the reduction depth split over the 8 warps). Splitting K keeps each
// thread's chain of dependent loads short: the step is bound by load
// latency, not by FLOPs or bandwidth. An LSTM cell is one stage; a GRU cell
// two (its candidate's recurrent product needs all of r*h), so B has
// 2 + L grid barriers with LSTM cells and 3 + 2L with GRU cells, one more
// with SimpleProjection.
#include "dec_step.cuh"

namespace {

constexpr int kMaxLayers = 8;

struct CellsArgs {
  const float *x_emb, *ctx, *sp_w, *sp_b, *ip_w, *ip_b, *q_w, *q_b;
  float *sp_out, *x_out, *y_out, *rh, *ug;
  Cell lm, dec[kMaxLayers];
  int N, E, Henc, Hl, H, A, L, gru;
};

__global__ void __launch_bounds__(kThreads) cells_fused_kernel(CellsArgs p) {
  __shared__ float smem[kSmem];
  cg::grid_group grid = cg::this_grid();
  cell_stages(p.lm, p.x_emb, p.E, p.Hl, p.N, p.rh, p.ug, smem, grid);
  grid.sync();
  const float* lm_y = p.lm.h_out;
  if (p.sp_w != nullptr) {
    for (int t = blockIdx.x; t < num_tiles(p.H, p.N); t += gridDim.x)
      dense_tile(p.lm.h_out, p.Hl, nullptr, 0, p.sp_w, p.sp_b, p.H, p.sp_out,
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
    cell_stages(p.dec[l], x, Kx, p.H, p.N, p.rh, p.ug, smem, grid);
    grid.sync();
    x = p.dec[l].h_out;
    Kx = p.H;
  }
  const Cell& top = p.dec[p.L - 1];
  const float* query = p.gru ? top.h_out : top.c_out;
  for (int t = blockIdx.x; t < num_tiles(p.A, p.N); t += gridDim.x)
    dense_tile(query, p.H, nullptr, 0, p.q_w, p.q_b, p.A, p.y_out, p.N, t,
               smem);
}

__global__ void __launch_bounds__(kThreads) output_fused_kernel(OutputArgs p) {
  __shared__ float smem[kSmem];
  cg::grid_group grid = cg::this_grid();
  output_stages(p, smem, grid);
}

// A cell's 8 pointers: c, h, w, b, wc, bc, c_out, h_out; an LSTM has no
// wc, bc, a GRU no c, c_out.
bool set_cell(Cell& cell, const void* const* ptrs, bool gru) {
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[i]));
  };
  cell = Cell{in(0), in(1), in(2), in(3), in(4), in(5), out(6), out(7)};
  return cell.h != nullptr && cell.w != nullptr && cell.b != nullptr &&
         cell.h_out != nullptr && (cell.c == nullptr) == gru &&
         (cell.c_out == nullptr) == gru && (cell.wc == nullptr) != gru &&
         (cell.bc == nullptr) != gru;
}

}  // namespace

// ptrs: x_emb, ctx_prev, sp_w|NULL, sp_b|NULL, ip_w, ip_b, q_w, q_b,
//   sp_out|NULL, x_out (scratch [N,E]), y_out, rh|NULL, ug|NULL (GRU
//   scratch [N, max(Hl, H)] each), then 8 per cell (set_cell), the LM cell
//   first, then the L decoder layers.
// dims: N, E, Henc, Hl, H, A, L, gru.
E2E_EXPORT int e2e_cells_fused(const void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims,
                               cudaStream_t stream) {
  if (n_dims != 8) return cudaErrorInvalidValue;
  CellsArgs p{};
  p.N = dims[0];
  p.E = dims[1];
  p.Henc = dims[2];
  p.Hl = dims[3];
  p.H = dims[4];
  p.A = dims[5];
  p.L = dims[6];
  p.gru = dims[7];
  if (p.L < 1 || p.L > kMaxLayers || n_ptrs != 13 + 8 * (p.L + 1) ||
      p.N < 1)
    return cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[i]));
  };
  p.x_emb = in(0);
  p.ctx = in(1);
  p.sp_w = in(2);
  p.sp_b = in(3);
  p.ip_w = in(4);
  p.ip_b = in(5);
  p.q_w = in(6);
  p.q_b = in(7);
  p.sp_out = out(8);
  p.x_out = out(9);
  p.y_out = out(10);
  p.rh = out(11);
  p.ug = out(12);
  if ((p.rh == nullptr) == (p.gru != 0) || (p.ug == nullptr) == (p.gru != 0))
    return cudaErrorInvalidValue;
  if (!set_cell(p.lm, ptrs + 13, p.gru)) return cudaErrorInvalidValue;
  for (int l = 0; l < p.L; ++l)
    if (!set_cell(p.dec[l], ptrs + 13 + 8 * (l + 1), p.gru))
      return cudaErrorInvalidValue;
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
  return launch_cooperative(output_fused_kernel, p, output_work(p), stream);
}
