// Kernels #8 and #9: the teacher-forced attention decoder over all output
// steps of a training batch, forward and backward.
//
// Replaces e2e_asr_tpu/ops/dec_train_pallas.py _fwd_call (forward with
// scheduled sampling and dropout, saving what the backward needs) and
// _bwd_call (reverse-time backward giving d(tlmx), d(every weight),
// d(hf) and d(enc)). The whole decoder space of the reference: NL stacked
// LSTM decoder cells (1..kMaxLayers) with inter-layer dropout masks, and
// SimpleProjection (lm_hidden != hidden) between the LM cell and the
// InputProjection; ind_softmax is the caller's choice of output weights.
// The precomputed products tlmx = emb_in @ W_lm_x + b, EWb = E @ W_lm_x + b
// and hf = enc @ attn_w stay outside, so autograd carries their gradients
// on.
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
//   F1b with SimpleProjection: lm_sp = lm_out @ W_sp + b_sp (the input
//      projection then reads lm_sp, of the decoder's width)
//   F2 x_dec = [lm_in | ctx_{t-1}] @ W_ip + b_ip (lm_in: lm_sp or lm_out)
//   F3 decoder cells, one stage per layer l: gates = [in_l | h_l,{t-1}] @
//      W_l + b_l, in_0 = x_dec, in_l = h_{l-1} * inter_mask_{l-1} (saved
//      as hdrop, the next layer's input)
//   F4 query y = c_top @ W_q + b_q (the top cell's c)
//   F5 attention, one block per batch row: alpha = masked softmax over
//      v . tanh(hf + y), ctx = alpha @ enc
//   F6 proj = [c_top | ctx] @ W_ap + b_ap
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
//   B4 top decoder cell's backward (dc gets the query's dy @ W_q^T)
//   B5 per layer l from the top down: [din_l | dh_l] = dgates_l @ W_l^T;
//      for l > 0 its epilogue is the backward of cell l-1 (whose h total is
//      its carry + din_l * inter_mask_{l-1}); for l = 0, din_0 is dx_dec
//   B6 [dlm_in | dctx_{t-1}] = dx_dec @ W_ip^T, and the LM-cell backward
//      (with SimpleProjection: B6 gives dlm_sp, and B6b dlm_out = dlm_sp @
//      W_sp^T carries the LM-cell backward)
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
  const float *ewb, *wlmh, *ipw, *ipb, *qw, *qb, *v, *apw, *apb, *opw, *opb,
      *spw, *spb;
  const float *decw[kMaxLayers], *decb[kMaxLayers];
  const float *hf, *enc, *amask, *tlmx, *gum, *flag, *lm_mask, *inter_mask,
      *zeros;
  float *logits, *gates_lm, *hlm, *clm, *lm_out, *lm_sp, *x_dec, *gates_dec,
      *hdec, *cdec, *hdrop, *y, *alpha, *ctx, *proj, *oh;
  int S, B, G, D, M, E, A, V, T, NL;
};

__global__ void __launch_bounds__(kThreads) dec_train_fwd_kernel(FwdArgs p) {
  __shared__ float smem[kSmem];
  __shared__ int sidx[kRows];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, G = p.G, D = p.D, E = p.E, A = p.A, V = p.V, T = p.T;
  const int NL = p.NL;
  const bool sp = p.spw != nullptr;
  const int HID = sp ? D : G;  // the input projection's LM-side rows
  const size_t layer = static_cast<size_t>(p.S) * B * D;  // [S,B,D] stride
  const float* ctop = p.cdec + (NL - 1) * layer;
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
    // F1b: SimpleProjection.
    const float* lm_in = p.lm_out + at(t, 0, B, G);
    if (sp) {
      for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
        dense_tile(lm_in, G, nullptr, 0, p.spw, p.spb, D,
                   p.lm_sp + at(t, 0, B, D), B, tile, smem);
      grid.sync();
      lm_in = p.lm_sp + at(t, 0, B, D);
    }
    // F2: x_dec = [lm_in | ctx_{t-1}] @ W_ip + b_ip.
    for (int tile = blockIdx.x; tile < num_tiles(p.M, B); tile += gridDim.x)
      dense_tile(lm_in, HID, row_prev(p.ctx, t, B, E, p.zeros), E, p.ipw,
                 p.ipb, p.M, p.x_dec + at(t, 0, B, p.M), B, tile, smem);
    grid.sync();
    // F3: the decoder cells, one stage per layer.
    for (int l = 0; l < NL; ++l) {
      const float* in = l == 0 ? p.x_dec + at(t, 0, B, p.M)
                               : p.hdrop + (l - 1) * layer + at(t, 0, B, D);
      float* hl = p.hdec + l * layer;
      float* cl = p.cdec + l * layer;
      float* gl = p.gates_dec + 4 * l * layer;
      const float* bl = p.decb[l];
      const float* mask = p.inter_mask != nullptr && l < NL - 1
                              ? p.inter_mask + l * layer
                              : nullptr;
      float* drop = l < NL - 1 ? p.hdrop + l * layer : nullptr;
      for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
        lstm_tile_ep(
            in, l == 0 ? p.M : D, row_prev(hl, t, B, D, p.zeros), D, D,
            p.decw[l], B, tile, smem,
            [&](int n, int u, float si, float sj, float sf, float so) {
              float s4[4] = {si, sj, sf, so};
              float* gs = gl + at(t, n, B, 4 * D);
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                s4[g] += __ldg(bl + g * D + u);
                gs[g * D + u] = s4[g];
              }
              float c = t > 0 ? __ldcg(cl + at(t - 1, n, B, D) + u) : 0.f;
              const float h = e2e::lstm_cell(s4[0], s4[1], s4[2], s4[3], c);
              const size_t o = at(t, n, B, D) + u;
              cl[o] = c;
              hl[o] = h;
              if (drop != nullptr)
                drop[o] = mask != nullptr ? h * __ldg(mask + o) : h;
            });
      grid.sync();
    }
    // F4: query (the top cell's c).
    for (int tile = blockIdx.x; tile < num_tiles(A, B); tile += gridDim.x)
      dense_tile(ctop + at(t, 0, B, D), D, nullptr, 0, p.qw, p.qb, A,
                 p.y + at(t, 0, B, A), B, tile, smem);
    grid.sync();
    // F5: attention, one block per batch row.
    for (int n = blockIdx.x; n < B; n += gridDim.x)
      attention_row(p.hf, p.enc, p.amask, p.v, p.y, p.alpha, p.ctx, t, n, n,
                    B, T, A, E, smem);
    grid.sync();
    // F6: proj = [c_top | ctx] @ W_ap + b_ap.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile(ctop + at(t, 0, B, D), D, p.ctx + at(t, 0, B, E), E, p.apw,
                 p.apb, D, p.proj + at(t, 0, B, D), B, tile, smem);
    grid.sync();
    // F7: logits.
    for (int tile = blockIdx.x; tile < num_tiles(V, B); tile += gridDim.x)
      dense_tile(p.proj + at(t, 0, B, D), D, nullptr, 0, p.opw, p.opb, V,
                 p.logits + at(t, 0, B, V), B, tile, smem);
    grid.sync();
  }
}

struct BwdArgs {
  const float *opwT, *apwT, *qwT, *ipwT, *wlmhT, *spwT, *v;
  const float* decwT[kMaxLayers];
  const float *hf, *enc, *amask, *flag, *lm_mask, *inter_mask, *zeros;
  const float *gates_lm, *clm, *hlm, *lm_out, *lm_sp, *x_dec, *gates_dec,
      *hdec, *cdec, *hdrop, *y, *alpha, *ctx, *proj, *oh, *dlog;
  float *dproj, *dy, *dgd, *dxdec, *dgl, *dsp;
  float *dtlmx, *dhf, *denc;
  float *s2, *dv_rows, *dh_dec, *dc_dec, *dh_lm, *dc_lm, *dctx;
  WJob jobs[kMaxJobs];
  int n_jobs;
  int S, B, G, D, M, E, A, V, T, NL;
};
static_assert(sizeof(BwdArgs) <= 4096, "kernel parameters exceed 4 KiB");

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
            T = p.T, NL = p.NL;
  const bool sp = p.spwT != nullptr;
  const int HID = sp ? D : G;
  const size_t layer = static_cast<size_t>(p.S) * B * D;  // [S,B,D] stride
  const size_t carry = static_cast<size_t>(B) * D;        // [B,D] stride
  const int top = NL - 1;
  {  // zero the carries and the accumulators
    const size_t tid = blockIdx.x * blockDim.x + threadIdx.x;
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t i = tid; i < static_cast<size_t>(B) * A; i += stride)
      p.dv_rows[i] = 0.f;
    for (size_t i = tid; i < NL * carry; i += stride)
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
    // B4: the top cell's backward; dc_direct += dy @ W_q^T.
    {
      const float* cl = p.cdec + top * layer;
      float* dhc = p.dh_dec + top * carry;
      float* dcc = p.dc_dec + top * carry;
      float* dgl = p.dgd + 4 * top * layer;
      for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
        dense_tile_ep(
            p.dy + at(t, 0, B, A), A, nullptr, 0, p.qwT, D, B, tile, smem,
            [&](int n, int u, float s) {
              const size_t o = static_cast<size_t>(n) * D + u;
              const float dc_direct =
                  __ldcg(p.s2 + static_cast<size_t>(n) * (D + E) + u) + s;
              const float c_prev =
                  t > 0 ? __ldg(cl + at(t - 1, n, B, D) + u) : 0.f;
              float dg[4], dc;
              lstm_cell_bwd(p.gates_dec + 4 * top * layer + at(t, n, B, 4 * D),
                            D, u, c_prev, __ldg(cl + at(t, n, B, D) + u),
                            __ldcg(dhc + o), __ldcg(dcc + o) + dc_direct, dg,
                            dc);
              float* out = dgl + at(t, n, B, 4 * D);
              for (int g = 0; g < 4; ++g) out[g * D + u] = dg[g];
              dcc[o] = dc;
            });
    }
    grid.sync();
    // B5: [din_l | dh_l] = dgates_l @ W_l^T, from the top layer down; below
    // the top, the epilogue on din_l is cell l-1's backward.
    for (int l = top; l >= 0; --l) {
      const int Kin = l == 0 ? M : D;
      float* dhc = p.dh_dec + l * carry;
      // Cell l-1 (when l > 0).
      const int lb = l > 0 ? l - 1 : 0;
      const float* clb = p.cdec + lb * layer;
      const float* mask =
          p.inter_mask != nullptr ? p.inter_mask + lb * layer : nullptr;
      float* dhb = p.dh_dec + lb * carry;
      float* dcb = p.dc_dec + lb * carry;
      float* dgb = p.dgd + 4 * lb * layer;
      for (int tile = blockIdx.x; tile < num_tiles(Kin + D, B);
           tile += gridDim.x)
        dense_tile_ep(
            p.dgd + 4 * l * layer + at(t, 0, B, 4 * D), 4 * D, nullptr, 0,
            p.decwT[l], Kin + D, B, tile, smem, [&](int n, int c, float s) {
              if (c >= Kin) {
                dhc[static_cast<size_t>(n) * D + c - Kin] = s;
              } else if (l == 0) {
                p.dxdec[at(t, n, B, M) + c] = s;
              } else {
                const size_t o = static_cast<size_t>(n) * D + c;
                const size_t ot = at(t, n, B, D) + c;
                const float din = mask != nullptr ? s * __ldg(mask + ot) : s;
                const float c_prev =
                    t > 0 ? __ldg(clb + at(t - 1, n, B, D) + c) : 0.f;
                float dg[4], dc;
                lstm_cell_bwd(p.gates_dec + 4 * lb * layer +
                                  at(t, n, B, 4 * D),
                              D, c, c_prev, __ldg(clb + ot),
                              __ldcg(dhb + o) + din, __ldcg(dcb + o), dg, dc);
                float* out = dgb + at(t, n, B, 4 * D);
                for (int g = 0; g < 4; ++g) out[g * D + c] = dg[g];
                dcb[o] = dc;
              }
            });
      grid.sync();
    }
    // The LM cell's backward for unit c of row n, given d(lm_out).
    auto lm_cell_bwd = [&](int n, int c, float s) {
      const size_t o = static_cast<size_t>(n) * G + c;
      const size_t ot = at(t, n, B, G) + c;
      const float dlm = p.lm_mask != nullptr ? s * __ldg(p.lm_mask + ot) : s;
      const float c_prev = t > 0 ? __ldg(p.clm + at(t - 1, n, B, G) + c) : 0.f;
      float dg[4], dc;
      lstm_cell_bwd(p.gates_lm + at(t, n, B, 4 * G), G, c, c_prev,
                    __ldg(p.clm + ot), dlm + __ldcg(p.dh_lm + o),
                    __ldcg(p.dc_lm + o), dg, dc);
      const float fl =
          p.flag != nullptr ? __ldg(p.flag + static_cast<size_t>(t) * B + n)
                            : 0.f;
      float* out = p.dgl + at(t, n, B, 4 * G);
      float* dt = p.dtlmx + at(t, n, B, 4 * G);
      for (int g = 0; g < 4; ++g) {
        out[g * G + c] = dg[g];
        dt[g * G + c] = (1.f - fl) * dg[g];
      }
      p.dc_lm[o] = dc;
    };
    // B6: [dlm_in | dctx_{t-1}] = dx_dec @ W_ip^T; without SimpleProjection
    // dlm_in is d(lm_out) and the LM-cell backward follows.
    for (int tile = blockIdx.x; tile < num_tiles(HID + E, B);
         tile += gridDim.x)
      dense_tile_ep(p.dxdec + at(t, 0, B, M), M, nullptr, 0, p.ipwT, HID + E,
                    B, tile, smem, [&](int n, int c, float s) {
                      if (c >= HID)
                        p.dctx[static_cast<size_t>(n) * E + c - HID] = s;
                      else if (sp)
                        p.dsp[at(t, n, B, D) + c] = s;
                      else
                        lm_cell_bwd(n, c, s);
                    });
    grid.sync();
    // B6b: d(lm_out) = dlm_sp @ W_sp^T, and the LM-cell backward.
    if (sp) {
      for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x)
        dense_tile_ep(p.dsp + at(t, 0, B, D), D, nullptr, 0, p.spwT, G, B,
                      tile, smem, lm_cell_bwd);
      grid.sync();
    }
    // B7: dh_lm = dgates_lm @ W_lm_h^T.
    for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x)
      dense_tile_ep(p.dgl + at(t, 0, B, 4 * G), 4 * G, nullptr, 0, p.wlmhT, G,
                    B, tile, smem, [&](int n, int c, float s) {
                      p.dh_lm[static_cast<size_t>(n) * G + c] = s;
                    });
    grid.sync();
  }
  // Weight gradients: every tile of every dW, each by one block.
  run_wjobs(p.jobs, p.n_jobs, smem);
}

void read_dims(FwdArgs& p, const int* dims) {
  p.S = dims[0];
  p.B = dims[1];
  p.G = dims[2];
  p.D = dims[3];
  p.M = dims[4];
  p.E = dims[5];
  p.A = dims[6];
  p.V = dims[7];
  p.T = dims[8];
  p.NL = dims[9];
}

}  // namespace

// dims: S, B, G, D, M, E, A, V, T, NL (steps, batch, LM hidden, decoder
// hidden, decoder input, encoder width, attention, vocabulary, encoder
// frames, decoder layers). HID below is D with SimpleProjection, else G.
// ptrs (in order): weights ewb [V,4G], wlmh [G,4G], ipw [HID+E,M], ipb [M],
// decw [M+D,4D], decb [4D], qw [D,A], qb [A], v [A], apw [D+E,D], apb [D],
// opw [D,V], opb [V]; inputs hf [B,T,A], enc [B,T,E], amask [B,T],
// tlmx [S,B,4G], gum [S,B,V]|NULL, flag [S,B]|NULL, lm_mask [S,B,G]|NULL,
// zeros [>= B*max(G,D,E)]; saves (out) logits [S,B,V], gates_lm [S,B,4G],
// hlm, clm, lm_out [S,B,G], x_dec [S,B,M], gates_dec [NL,S,B,4D], hdec, cdec
// [NL,S,B,D], y [S,B,A], alpha [S,B,T], ctx [S,B,E], proj [S,B,D],
// oh [S,B,V] (zero-filled by the caller; NULL without gum); then
// SimpleProjection's spw [G,D], spb [D] and its save lm_sp [S,B,D] (all
// NULL without it), inter_mask [NL-1,S,B,D]|NULL, the save hdrop
// [NL-1,S,B,D] (NULL at NL = 1); then layers 1..NL-1's decw [2D,4D] and
// decb [4D].
E2E_EXPORT int e2e_dec_train_fwd(const void* const* ptrs, int n_ptrs,
                                 const int* dims, cudaStream_t stream) {
  FwdArgs p{};
  read_dims(p, dims);
  if (p.NL < 1 || p.NL > kMaxLayers || n_ptrs != 40 + 2 * (p.NL - 1))
    return cudaErrorInvalidValue;
  const float** in[] = {&p.ewb, &p.wlmh, &p.ipw, &p.ipb, &p.decw[0],
                        &p.decb[0], &p.qw, &p.qb, &p.v, &p.apw, &p.apb,
                        &p.opw, &p.opb, &p.hf, &p.enc, &p.amask, &p.tlmx,
                        &p.gum, &p.flag, &p.lm_mask, &p.zeros};
  float** out[] = {&p.logits, &p.gates_lm, &p.hlm, &p.clm, &p.lm_out,
                   &p.x_dec, &p.gates_dec, &p.hdec, &p.cdec, &p.y,
                   &p.alpha, &p.ctx, &p.proj, &p.oh};
  for (int i = 0; i < 21; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 14; ++i)
    *out[i] = static_cast<float*>(const_cast<void*>(ptrs[21 + i]));
  p.spw = static_cast<const float*>(ptrs[35]);
  p.spb = static_cast<const float*>(ptrs[36]);
  p.lm_sp = static_cast<float*>(const_cast<void*>(ptrs[37]));
  p.inter_mask = static_cast<const float*>(ptrs[38]);
  p.hdrop = static_cast<float*>(const_cast<void*>(ptrs[39]));
  for (int l = 1; l < p.NL; ++l) {
    p.decw[l] = static_cast<const float*>(ptrs[40 + 2 * (l - 1)]);
    p.decb[l] = static_cast<const float*>(ptrs[41 + 2 * (l - 1)]);
  }
  const bool sp = p.spw != nullptr;
  if (p.S < 1 || p.B < 1 || p.A + p.T > kSmem ||
      (p.gum == nullptr) != (p.flag == nullptr) ||
      (p.gum == nullptr) != (p.oh == nullptr) ||
      sp != (p.spb != nullptr) || sp != (p.lm_sp != nullptr) ||
      (p.NL > 1) != (p.hdrop != nullptr) ||
      (p.NL == 1 && p.inter_mask != nullptr))
    return cudaErrorInvalidValue;
  int tiles = max(num_tiles(p.G, p.B), num_tiles(p.M, p.B));
  tiles = max(tiles, num_tiles(p.D, p.B));
  tiles = max(tiles, num_tiles(p.A, p.B));
  tiles = max(tiles, num_tiles(p.V, p.B));
  tiles = max(tiles, p.B);
  return launch_cooperative(dec_train_fwd_kernel, p, tiles, stream);
}

// ptrs (in order): transposed weights opwT [V,D], apwT [D,D+E], qwT [A,D],
// decwT [4D,M+D], ipwT [M,HID+E], wlmhT [4G,G]; v [A]; hf, enc, amask,
// flag|NULL, lm_mask|NULL, zeros (as the forward); the forward's saves
// gates_lm, clm, hlm, lm_out, x_dec, gates_dec, hdec, cdec, y, alpha, ctx,
// proj, oh|NULL; dlogits [S,B,V]; step gradients (scratch) dproj [S,B,D],
// dy [S,B,A], dgd [NL,S,B,4D], dxdec [S,B,M], dgl [S,B,4G]; outputs dtlmx
// [S,B,4G], dhf [B,T,A], denc [B,T,E], then the 13 weight gradients in the
// forward's weight order; scratch s2 [B,D+E], dv_rows [B,A], dh_dec, dc_dec
// [NL,B,D], dh_lm, dc_lm [B,G], dctx [B,E]; then spwT [D,G], the save lm_sp,
// the step gradient dsp [S,B,D] (scratch), inter_mask, the save hdrop,
// dspw [G,D] and dspb [D] (out) (SimpleProjection's all NULL without it;
// inter_mask and hdrop as the forward); then per layer 1..NL-1: decwT
// [4D,2D], and its gradients ddecw [2D,4D] and ddecb [4D] (out). dims as the
// forward.
E2E_EXPORT int e2e_dec_train_bwd(const void* const* ptrs, int n_ptrs,
                                 const int* dims, cudaStream_t stream) {
  FwdArgs d{};
  read_dims(d, dims);
  if (d.NL < 1 || d.NL > kMaxLayers || n_ptrs != 62 + 3 * (d.NL - 1))
    return cudaErrorInvalidValue;
  BwdArgs p{};
  p.S = d.S;
  p.B = d.B;
  p.G = d.G;
  p.D = d.D;
  p.M = d.M;
  p.E = d.E;
  p.A = d.A;
  p.V = d.V;
  p.T = d.T;
  p.NL = d.NL;
  const float** in[] = {&p.opwT, &p.apwT, &p.qwT, &p.decwT[0], &p.ipwT,
                        &p.wlmhT, &p.v, &p.hf, &p.enc, &p.amask, &p.flag,
                        &p.lm_mask, &p.zeros, &p.gates_lm, &p.clm, &p.hlm,
                        &p.lm_out, &p.x_dec, &p.gates_dec, &p.hdec, &p.cdec,
                        &p.y, &p.alpha, &p.ctx, &p.proj, &p.oh, &p.dlog};
  float** out[] = {&p.dproj, &p.dy, &p.dgd, &p.dxdec, &p.dgl, &p.dtlmx,
                   &p.dhf, &p.denc};
  auto w = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[i]));
  };
  for (int i = 0; i < 27; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 8; ++i) *out[i] = w(27 + i);
  float* dw[13];
  for (int i = 0; i < 13; ++i) dw[i] = w(35 + i);
  float** scratch[] = {&p.s2, &p.dv_rows, &p.dh_dec, &p.dc_dec, &p.dh_lm,
                       &p.dc_lm, &p.dctx};
  for (int i = 0; i < 7; ++i) *scratch[i] = w(48 + i);
  p.spwT = w(55);
  p.lm_sp = w(56);
  p.dsp = w(57);
  p.inter_mask = w(58);
  p.hdrop = w(59);
  float *dspw = w(60), *dspb = w(61);
  const int B = p.B, G = p.G, D = p.D, M = p.M, E = p.E, A = p.A, V = p.V;
  const int NL = p.NL;
  const bool sp = p.spwT != nullptr;
  const int HID = sp ? D : G;
  if (p.S < 1 || B < 1 || E + 2 * p.T + 1 > kSmem ||
      sp != (p.lm_sp != nullptr) || sp != (p.dsp != nullptr) ||
      sp != (dspw != nullptr) || sp != (dspb != nullptr) ||
      (NL > 1) != (p.hdrop != nullptr) ||
      (NL == 1 && p.inter_mask != nullptr))
    return cudaErrorInvalidValue;
  const int R = p.S * B;
  const size_t layer = static_cast<size_t>(p.S) * B * D;
  const float* ctop = p.cdec + (NL - 1) * layer;
  const float* lm_in = sp ? p.lm_sp : p.lm_out;
  // X [x1 | x2] (k, row shift), ones, dG, columns, rows, out.
  WJob* j = p.jobs;
  // Without sampling (oh NULL) d(EWb) is zero: a job over no rows.
  const int R_oh = p.oh != nullptr ? R : 0;
  j[0] = {p.oh, V, 0, nullptr, 0, 0, p.dgl, 4 * G, R_oh, dw[0]};
  j[1] = {p.hlm, G, B, nullptr, 0, 0, p.dgl, 4 * G, R, dw[1]};
  j[2] = {lm_in, HID, 0, p.ctx, E, B, p.dxdec, M, R, dw[2]};
  j[3] = {nullptr, 1, 0, nullptr, 0, 0, p.dxdec, M, R, dw[3]};
  j[4] = {p.x_dec, M, 0, p.hdec, D, B, p.dgd, 4 * D, R, dw[4]};
  j[5] = {nullptr, 1, 0, nullptr, 0, 0, p.dgd, 4 * D, R, dw[5]};
  j[6] = {ctop, D, 0, nullptr, 0, 0, p.dy, A, R, dw[6]};
  j[7] = {nullptr, 1, 0, nullptr, 0, 0, p.dy, A, R, dw[7]};
  j[8] = {nullptr, 1, 0, nullptr, 0, 0, p.dv_rows, A, B, dw[8]};
  j[9] = {ctop, D, 0, p.ctx, E, 0, p.dproj, D, R, dw[9]};
  j[10] = {nullptr, 1, 0, nullptr, 0, 0, p.dproj, D, R, dw[10]};
  j[11] = {p.proj, D, 0, nullptr, 0, 0, p.dlog, V, R, dw[11]};
  j[12] = {nullptr, 1, 0, nullptr, 0, 0, p.dlog, V, R, dw[12]};
  int n = 13;
  for (int l = 1; l < NL; ++l) {
    const int base = 62 + 3 * (l - 1);
    p.decwT[l] = static_cast<const float*>(ptrs[base]);
    const float* dgl = p.dgd + 4 * l * layer;
    j[n++] = {p.hdrop + (l - 1) * layer, D, 0, p.hdec + l * layer, D, B,
              dgl, 4 * D, R, w(base + 1)};
    j[n++] = {nullptr, 1, 0, nullptr, 0, 0, dgl, 4 * D, R, w(base + 2)};
  }
  if (sp) {
    j[n++] = {p.lm_out, G, 0, nullptr, 0, 0, p.dsp, D, R, dspw};
    j[n++] = {nullptr, 1, 0, nullptr, 0, 0, p.dsp, D, R, dspb};
  }
  p.n_jobs = n;
  int tiles = max(num_tiles(D + E, B), num_tiles(M + D, B));
  tiles = max(tiles, num_tiles(2 * D, B));
  tiles = max(tiles, num_tiles(HID + E, B));
  tiles = max(tiles, num_tiles(G, B));
  tiles = max(tiles, B);
  return launch_cooperative(dec_train_bwd_kernel, p, tiles, stream);
}
