// Kernels #8 and #9: the teacher-forced attention decoder over all output
// steps of a training batch, forward and backward.
//
// Replaces e2e_asr_tpu/ops/dec_train_pallas.py _fwd_call (forward with
// scheduled sampling and dropout, saving what the backward needs) and
// _bwd_call (reverse-time backward giving d(tlmx), d(every weight),
// d(hf) and d(enc)). One LSTM decoder layer, no SimpleProjection; the
// precomputed products tlmx = emb_in @ W_lm_x + b, EWb = E @ W_lm_x + b and
// hf = enc @ attn_w stay outside, so autograd carries their gradients on.
//
// Bound: latency. A step is a chain of about eight dependent products of
// B = 128 rows over weights of about 5 MiB (f32), each far too small to
// fill the card, and the steps are serial. So each direction is ONE
// persistent cooperative launch over all steps, built from the tiles of
// tiles.cuh (8 rows x 32 columns or units; the weights are spread over the
// blocks and every weight column is read once per 8 rows), with grid
// barriers between the dependent stages of a step.
//
// Forward, per step t (B rows):
//   F1 LM cell: input row = tlmx[t], or EWb[argmax(logits[t-1] + gumbel)]
//      when step t-1's sampling coin fired (flag; ties go to the lowest
//      index, as jnp.argmax); gates += h_lm @ W_lm_h; lm_out = h_lm * mask.
//   F2 x_dec = [lm_out | ctx_{t-1}] @ W_ip + b_ip
//   F3 decoder cell: gates = [x_dec | h_{t-1}] @ W_dec + b_dec
//   F4 query y = c_dec @ W_q + b_q
//   F5 attention, one block per batch row: alpha = masked softmax over
//      v . tanh(hf + y), ctx = alpha @ enc
//   F6 proj = [c_dec | ctx] @ W_ap + b_ap
//   F7 logits = proj @ W_out + b_out
// Every intermediate is written to a [steps, B, .] save (the gate
// pre-activations included), so the backward recomputes nothing.
//
// Backward, per step t in reverse, the data gradients only (transposed
// weight copies keep the loads coalesced):
//   B1 dproj = dlogits @ W_out^T
//   B2 [dc_direct | dctx] = dproj @ W_ap^T
//   B3 attention backward per batch row; d(hf) and d(enc) accumulate in the
//      block that owns the row, and so does that row's share of d(v)
//   B4 decoder-cell backward (dc gets the query's dy @ W_q^T)
//   B5 [dx_dec | dh_dec] = dgates_dec @ W_dec^T
//   B6 [dlm_out | dctx_{t-1}] = dx_dec @ W_ip^T, and the LM-cell backward
//   B7 dh_lm = dgates_lm @ W_lm_h^T
// The weight gradients do not feed the recurrence: after the last step the
// grid takes the 64 x 64 tiles of every dW, and the block that owns a tile
// accumulates it over all rows and steps of the saved activations and
// step gradients and writes it once. No atomics; the order is fixed.
// Sampling, the attention and its backward, and the weight-gradient tiles
// live in dec_train.cuh, shared with the GRU decoder's kernel #10.
#include "dec_train.cuh"

namespace {

struct FwdArgs {
  const float *ewb, *wlmh, *ipw, *ipb, *decw, *decb, *qw, *qb, *v, *apw,
      *apb, *opw, *opb;
  const float *hf, *enc, *amask, *tlmx, *gum, *flag, *lm_mask, *zeros;
  float *logits, *gates_lm, *hlm, *clm, *lm_out, *x_dec, *gates_dec, *hdec,
      *cdec, *y, *alpha, *ctx, *proj, *oh;
  int S, B, G, D, M, E, A, V, T;
};

__global__ void __launch_bounds__(kThreads) dec_train_fwd_kernel(FwdArgs p) {
  __shared__ float smem[kSmem];
  __shared__ int sidx[kRows];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, G = p.G, D = p.D, E = p.E, A = p.A, V = p.V, T = p.T;
  for (int t = 0; t < p.S; ++t) {
    // F1: LM cell.
    const bool samp = p.gum != nullptr && t > 0;
    const int utiles = (G + kCols - 1) / kCols;
    for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x) {
      const int n0 = (tile / utiles) * kRows;
      if (samp)
        sample_tile(p.logits, p.gum, p.flag, p.oh, t, n0, B, V,
                    tile % utiles == 0, sidx);
      lstm_tile_ep(
          nullptr, 0, row_prev(p.hlm, t, B, G, p.zeros), G, G, p.wlmh, B,
          tile, smem,
          [&](int n, int u, float si, float sj, float sf, float so) {
            float s4[4] = {si, sj, sf, so};
            const float* tx = p.tlmx + at(t, n, B, 4 * G);
            float fl = 0.f;
            const float* ew = p.ewb;
            if (samp) {
              fl = __ldg(p.flag + static_cast<size_t>(t) * B + n);
              ew = p.ewb + static_cast<size_t>(sidx[n - n0]) * 4 * G;
            }
            float* gs = p.gates_lm + at(t, n, B, 4 * G);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              float pre = __ldg(tx + g * G + u);
              if (samp) pre = fl * __ldg(ew + g * G + u) + (1.f - fl) * pre;
              s4[g] += pre;
              gs[g * G + u] = s4[g];
            }
            float c = t > 0 ? __ldcg(p.clm + at(t - 1, n, B, G) + u) : 0.f;
            const float h = e2e::lstm_cell(s4[0], s4[1], s4[2], s4[3], c);
            const size_t o = at(t, n, B, G) + u;
            p.clm[o] = c;
            p.hlm[o] = h;
            p.lm_out[o] = p.lm_mask != nullptr ? h * __ldg(p.lm_mask + o) : h;
          });
    }
    grid.sync();
    // F2: x_dec = [lm_out | ctx_{t-1}] @ W_ip + b_ip.
    for (int tile = blockIdx.x; tile < num_tiles(p.M, B); tile += gridDim.x)
      dense_tile(p.lm_out + at(t, 0, B, G), G,
                 row_prev(p.ctx, t, B, E, p.zeros), E, p.ipw, p.ipb, p.M,
                 p.x_dec + at(t, 0, B, p.M), B, tile, smem);
    grid.sync();
    // F3: decoder cell.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      lstm_tile_ep(
          p.x_dec + at(t, 0, B, p.M), p.M, row_prev(p.hdec, t, B, D, p.zeros),
          D, D, p.decw, B, tile, smem,
          [&](int n, int u, float si, float sj, float sf, float so) {
            float s4[4] = {si, sj, sf, so};
            float* gs = p.gates_dec + at(t, n, B, 4 * D);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              s4[g] += __ldg(p.decb + g * D + u);
              gs[g * D + u] = s4[g];
            }
            float c = t > 0 ? __ldcg(p.cdec + at(t - 1, n, B, D) + u) : 0.f;
            const float h = e2e::lstm_cell(s4[0], s4[1], s4[2], s4[3], c);
            p.cdec[at(t, n, B, D) + u] = c;
            p.hdec[at(t, n, B, D) + u] = h;
          });
    grid.sync();
    // F4: query.
    for (int tile = blockIdx.x; tile < num_tiles(A, B); tile += gridDim.x)
      dense_tile(p.cdec + at(t, 0, B, D), D, nullptr, 0, p.qw, p.qb, A,
                 p.y + at(t, 0, B, A), B, tile, smem);
    grid.sync();
    // F5: attention, one block per batch row.
    for (int n = blockIdx.x; n < B; n += gridDim.x)
      attention_row(p.hf, p.enc, p.amask, p.v, p.y, p.alpha, p.ctx, t, n, B,
                    T, A, E, smem);
    grid.sync();
    // F6: proj = [c_dec | ctx] @ W_ap + b_ap.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile(p.cdec + at(t, 0, B, D), D, p.ctx + at(t, 0, B, E), E, p.apw,
                 p.apb, D, p.proj + at(t, 0, B, D), B, tile, smem);
    grid.sync();
    // F7: logits.
    for (int tile = blockIdx.x; tile < num_tiles(V, B); tile += gridDim.x)
      dense_tile(p.proj + at(t, 0, B, D), D, nullptr, 0, p.opw, p.opb, V,
                 p.logits + at(t, 0, B, V), B, tile, smem);
    grid.sync();
  }
}

constexpr int kJobs = 13;

struct BwdArgs {
  const float *opwT, *apwT, *qwT, *decwT, *ipwT, *wlmhT, *v;
  const float *hf, *enc, *amask, *flag, *lm_mask, *zeros;
  const float *gates_lm, *clm, *hlm, *lm_out, *x_dec, *gates_dec, *hdec,
      *cdec, *y, *alpha, *ctx, *proj, *oh, *dlog;
  float *dproj, *dy, *dgd, *dxdec, *dgl;
  float *dtlmx, *dhf, *denc;
  float *s2, *dv_rows, *dh_dec, *dc_dec, *dh_lm, *dc_lm, *dctx;
  WJob jobs[kJobs];
  int S, B, G, D, M, E, A, V, T;
};

__device__ __forceinline__ void lstm_cell_bwd(const float* gates, int H, int u,
                                              float c_prev, float c_cur,
                                              float dh_total, float dc_in,
                                              float dg[4], float& dc_out) {
  const float i = e2e::sigmoid(gates[u]), j = tanhf(gates[H + u]);
  const float f = e2e::sigmoid(gates[2 * H + u] + 1.f);
  const float o = e2e::sigmoid(gates[3 * H + u]);
  const float tanh_c = tanhf(c_cur);
  const float dc_total = dh_total * o * (1.f - tanh_c * tanh_c) + dc_in;
  dg[0] = dc_total * j * i * (1.f - i);
  dg[1] = dc_total * i * (1.f - j * j);
  dg[2] = dc_total * c_prev * f * (1.f - f);
  dg[3] = dh_total * tanh_c * o * (1.f - o);
  dc_out = dc_total * f;
}

__global__ void __launch_bounds__(kThreads) dec_train_bwd_kernel(BwdArgs p) {
  __shared__ float smem[kSmem];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, G = p.G, D = p.D, M = p.M, E = p.E, A = p.A, V = p.V,
            T = p.T;
  {  // zero the carries and the accumulators
    const size_t tid = blockIdx.x * blockDim.x + threadIdx.x;
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t i = tid; i < static_cast<size_t>(B) * A; i += stride)
      p.dv_rows[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * D; i += stride)
      p.dh_dec[i] = p.dc_dec[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * G; i += stride)
      p.dh_lm[i] = p.dc_lm[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * E; i += stride)
      p.dctx[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * T * A; i += stride)
      p.dhf[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * T * E; i += stride)
      p.denc[i] = 0.f;
  }
  grid.sync();
  for (int t = p.S - 1; t >= 0; --t) {
    // B1: dproj = dlogits @ W_out^T.
    float* dproj = p.dproj + at(t, 0, B, D);
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile_ep(p.dlog + at(t, 0, B, V), V, nullptr, 0, p.opwT, D, B,
                    tile, smem, [&](int n, int c, float s) {
                      dproj[static_cast<size_t>(n) * D + c] = s;
                    });
    grid.sync();
    // B2: [dc_direct | dctx part] = dproj @ W_ap^T.
    for (int tile = blockIdx.x; tile < num_tiles(D + E, B);
         tile += gridDim.x)
      dense_tile_ep(dproj, D, nullptr, 0, p.apwT, D + E, B, tile, smem,
                    [&](int n, int c, float s) {
                      p.s2[static_cast<size_t>(n) * (D + E) + c] = s;
                    });
    grid.sync();
    // B3: attention backward, one block per batch row.
    for (int n = blockIdx.x; n < B; n += gridDim.x)
      attention_row_bwd(p.hf, p.enc, p.v, p.y, p.alpha, p.ctx,
                        p.s2 + static_cast<size_t>(n) * (D + E) + D,
                        p.dctx + static_cast<size_t>(n) * E, p.dhf, p.denc,
                        p.dv_rows, p.dy, t, n, B, T, A, E, smem);
    grid.sync();
    // B4: decoder-cell backward; dc_direct += dy @ W_q^T.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile_ep(
          p.dy + at(t, 0, B, A), A, nullptr, 0, p.qwT, D, B, tile, smem,
          [&](int n, int u, float s) {
            const size_t o = static_cast<size_t>(n) * D + u;
            const float dc_direct =
                __ldcg(p.s2 + static_cast<size_t>(n) * (D + E) + u) + s;
            const float c_prev =
                t > 0 ? __ldg(p.cdec + at(t - 1, n, B, D) + u) : 0.f;
            float dg[4], dc;
            lstm_cell_bwd(p.gates_dec + at(t, n, B, 4 * D), D, u, c_prev,
                          __ldg(p.cdec + at(t, n, B, D) + u),
                          __ldcg(p.dh_dec + o),
                          __ldcg(p.dc_dec + o) + dc_direct, dg, dc);
            float* out = p.dgd + at(t, n, B, 4 * D);
            for (int g = 0; g < 4; ++g) out[g * D + u] = dg[g];
            p.dc_dec[o] = dc;
          });
    grid.sync();
    // B5: [dx_dec | dh_dec] = dgates_dec @ W_dec^T.
    for (int tile = blockIdx.x; tile < num_tiles(M + D, B);
         tile += gridDim.x)
      dense_tile_ep(p.dgd + at(t, 0, B, 4 * D), 4 * D, nullptr, 0, p.decwT,
                    M + D, B, tile, smem, [&](int n, int c, float s) {
                      if (c < M)
                        p.dxdec[at(t, n, B, M) + c] = s;
                      else
                        p.dh_dec[static_cast<size_t>(n) * D + c - M] = s;
                    });
    grid.sync();
    // B6: [dlm_out | dctx_{t-1}] = dx_dec @ W_ip^T; LM-cell backward.
    for (int tile = blockIdx.x; tile < num_tiles(G + E, B);
         tile += gridDim.x)
      dense_tile_ep(
          p.dxdec + at(t, 0, B, M), M, nullptr, 0, p.ipwT, G + E, B, tile,
          smem, [&](int n, int c, float s) {
            if (c >= G) {
              p.dctx[static_cast<size_t>(n) * E + c - G] = s;
              return;
            }
            const size_t o = static_cast<size_t>(n) * G + c;
            const size_t ot = at(t, n, B, G) + c;
            const float dlm = p.lm_mask != nullptr ? s * __ldg(p.lm_mask + ot)
                                                   : s;
            const float c_prev =
                t > 0 ? __ldg(p.clm + at(t - 1, n, B, G) + c) : 0.f;
            float dg[4], dc;
            lstm_cell_bwd(p.gates_lm + at(t, n, B, 4 * G), G, c, c_prev,
                          __ldg(p.clm + ot), dlm + __ldcg(p.dh_lm + o),
                          __ldcg(p.dc_lm + o), dg, dc);
            const float fl =
                p.flag != nullptr
                    ? __ldg(p.flag + static_cast<size_t>(t) * B + n)
                    : 0.f;
            float* out = p.dgl + at(t, n, B, 4 * G);
            float* dt = p.dtlmx + at(t, n, B, 4 * G);
            for (int g = 0; g < 4; ++g) {
              out[g * G + c] = dg[g];
              dt[g * G + c] = (1.f - fl) * dg[g];
            }
            p.dc_lm[o] = dc;
          });
    grid.sync();
    // B7: dh_lm = dgates_lm @ W_lm_h^T.
    for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x)
      dense_tile_ep(p.dgl + at(t, 0, B, 4 * G), 4 * G, nullptr, 0, p.wlmhT, G,
                    B, tile, smem, [&](int n, int c, float s) {
                      p.dh_lm[static_cast<size_t>(n) * G + c] = s;
                    });
    grid.sync();
  }
  // Weight gradients: every tile of every dW, each by one block.
  run_wjobs(p.jobs, kJobs, smem);
}

}  // namespace

// dims: S, B, G, D, M, E, A, V, T (steps, batch, LM hidden, decoder hidden,
// decoder input, encoder width, attention, vocabulary, encoder frames).
// ptrs (in order): weights ewb [V,4G], wlmh [G,4G], ipw [G+E,M], ipb [M],
// decw [M+D,4D], decb [4D], qw [D,A], qb [A], v [A], apw [D+E,D], apb [D],
// opw [D,V], opb [V]; inputs hf [B,T,A], enc [B,T,E], amask [B,T],
// tlmx [S,B,4G], gum [S,B,V]|NULL, flag [S,B]|NULL, lm_mask [S,B,G]|NULL,
// zeros [>= B*max(G,D,E)]; saves (out) logits [S,B,V], gates_lm [S,B,4G],
// hlm, clm, lm_out [S,B,G], x_dec [S,B,M], gates_dec [S,B,4D], hdec, cdec
// [S,B,D], y [S,B,A], alpha [S,B,T], ctx [S,B,E], proj [S,B,D],
// oh [S,B,V] (zero-filled by the caller; NULL without gum).
E2E_EXPORT int e2e_dec_train_fwd(const void* const* ptrs, int n_ptrs,
                                 const int* dims, cudaStream_t stream) {
  if (n_ptrs != 35) return cudaErrorInvalidValue;
  FwdArgs p{};
  const float** in[] = {&p.ewb, &p.wlmh, &p.ipw, &p.ipb, &p.decw, &p.decb,
                        &p.qw, &p.qb, &p.v, &p.apw, &p.apb, &p.opw, &p.opb,
                        &p.hf, &p.enc, &p.amask, &p.tlmx, &p.gum, &p.flag,
                        &p.lm_mask, &p.zeros};
  float** out[] = {&p.logits, &p.gates_lm, &p.hlm, &p.clm, &p.lm_out,
                   &p.x_dec, &p.gates_dec, &p.hdec, &p.cdec, &p.y,
                   &p.alpha, &p.ctx, &p.proj, &p.oh};
  for (int i = 0; i < 21; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 14; ++i)
    *out[i] = static_cast<float*>(const_cast<void*>(ptrs[21 + i]));
  p.S = dims[0];
  p.B = dims[1];
  p.G = dims[2];
  p.D = dims[3];
  p.M = dims[4];
  p.E = dims[5];
  p.A = dims[6];
  p.V = dims[7];
  p.T = dims[8];
  if (p.S < 1 || p.B < 1 || p.A + p.T > kSmem ||
      (p.gum == nullptr) != (p.flag == nullptr) ||
      (p.gum == nullptr) != (p.oh == nullptr))
    return cudaErrorInvalidValue;
  int tiles = max(num_tiles(p.G, p.B), num_tiles(p.M, p.B));
  tiles = max(tiles, num_tiles(p.D, p.B));
  tiles = max(tiles, num_tiles(p.A, p.B));
  tiles = max(tiles, num_tiles(p.V, p.B));
  tiles = max(tiles, p.B);
  return launch_cooperative(dec_train_fwd_kernel, p, tiles, stream);
}

// ptrs (in order): transposed weights opwT [V,D], apwT [D,D+E], qwT [A,D],
// decwT [4D,M+D], ipwT [M,G+E], wlmhT [4G,G]; v [A]; hf, enc, amask,
// flag|NULL, lm_mask|NULL, zeros (as the forward); the forward's saves
// gates_lm, clm, hlm, lm_out, x_dec, gates_dec, hdec, cdec, y, alpha, ctx,
// proj, oh|NULL; dlogits [S,B,V]; step gradients (scratch) dproj [S,B,D],
// dy [S,B,A], dgd [S,B,4D], dxdec [S,B,M], dgl [S,B,4G]; outputs dtlmx
// [S,B,4G], dhf [B,T,A], denc [B,T,E], then the 13 weight gradients in the
// forward's weight order; scratch s2 [B,D+E], dv_rows [B,A], dh_dec,
// dc_dec [B,D], dh_lm, dc_lm [B,G], dctx [B,E]. dims as the forward.
E2E_EXPORT int e2e_dec_train_bwd(const void* const* ptrs, int n_ptrs,
                                 const int* dims, cudaStream_t stream) {
  if (n_ptrs != 55) return cudaErrorInvalidValue;
  BwdArgs p{};
  const float** in[] = {&p.opwT, &p.apwT, &p.qwT, &p.decwT, &p.ipwT,
                        &p.wlmhT, &p.v, &p.hf, &p.enc, &p.amask, &p.flag,
                        &p.lm_mask, &p.zeros, &p.gates_lm, &p.clm, &p.hlm,
                        &p.lm_out, &p.x_dec, &p.gates_dec, &p.hdec, &p.cdec,
                        &p.y, &p.alpha, &p.ctx, &p.proj, &p.oh, &p.dlog};
  float** out[] = {&p.dproj, &p.dy, &p.dgd, &p.dxdec, &p.dgl, &p.dtlmx,
                   &p.dhf, &p.denc};
  for (int i = 0; i < 27; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 8; ++i)
    *out[i] = static_cast<float*>(const_cast<void*>(ptrs[27 + i]));
  float* dw[kJobs];
  for (int i = 0; i < kJobs; ++i)
    dw[i] = static_cast<float*>(const_cast<void*>(ptrs[35 + i]));
  float** scratch[] = {&p.s2, &p.dv_rows, &p.dh_dec, &p.dc_dec, &p.dh_lm,
                       &p.dc_lm, &p.dctx};
  for (int i = 0; i < 7; ++i)
    *scratch[i] = static_cast<float*>(const_cast<void*>(ptrs[48 + i]));
  p.S = dims[0];
  p.B = dims[1];
  p.G = dims[2];
  p.D = dims[3];
  p.M = dims[4];
  p.E = dims[5];
  p.A = dims[6];
  p.V = dims[7];
  p.T = dims[8];
  const int B = p.B, G = p.G, D = p.D, M = p.M, E = p.E, A = p.A, V = p.V;
  if (p.S < 1 || B < 1 || E + 2 * p.T + 1 > kSmem) return cudaErrorInvalidValue;
  const int R = p.S * B;
  // X [x1 | x2] (k, row shift), ones, dG, columns, rows, out.
  p.jobs[0] = {p.oh, V, 0, nullptr, 0, 0, false, p.dgl, 4 * G, R, dw[0]};
  p.jobs[1] = {p.hlm, G, B, nullptr, 0, 0, false, p.dgl, 4 * G, R, dw[1]};
  p.jobs[2] = {p.lm_out, G, 0, p.ctx, E, B, false, p.dxdec, M, R, dw[2]};
  p.jobs[3] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dxdec, M, R, dw[3]};
  p.jobs[4] = {p.x_dec, M, 0, p.hdec, D, B, false, p.dgd, 4 * D, R, dw[4]};
  p.jobs[5] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dgd, 4 * D, R, dw[5]};
  p.jobs[6] = {p.cdec, D, 0, nullptr, 0, 0, false, p.dy, A, R, dw[6]};
  p.jobs[7] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dy, A, R, dw[7]};
  p.jobs[8] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dv_rows, A, B, dw[8]};
  p.jobs[9] = {p.cdec, D, 0, p.ctx, E, 0, false, p.dproj, D, R, dw[9]};
  p.jobs[10] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dproj, D, R, dw[10]};
  p.jobs[11] = {p.proj, D, 0, nullptr, 0, 0, false, p.dlog, V, R, dw[11]};
  p.jobs[12] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dlog, V, R, dw[12]};
  int tiles = max(num_tiles(D + E, B), num_tiles(M + D, B));
  tiles = max(tiles, num_tiles(G + E, B));
  tiles = max(tiles, B);
  return launch_cooperative(dec_train_bwd_kernel, p, tiles, stream);
}
