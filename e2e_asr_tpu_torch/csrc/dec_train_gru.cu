// Kernel #10: the teacher-forced attention decoder with GRU cells over all
// output steps of a training batch, forward and backward.
//
// Replaces e2e_asr_tpu/ops/dec_train_gru_pallas.py _fwd_call (forward with
// scheduled sampling from pre-shifted gumbel noise and dropout, saving
// what the backward needs) and _bwd_call (reverse-time backward giving
// d(tgx), d(tcx), d(every weight), d(hf) and d(enc)). One GRU decoder
// layer, no SimpleProjection; the precomputed products tgx | tcx =
// emb_in @ W_lm_x + b, EWb = E @ W_lm_x + b and hf = enc @ attn_w stay
// outside, so autograd carries their gradients on.
//
// GRU cell (TF-1 GRUCell): r, u = sigmoid(gx + h @ W_gh); c = tanh(cx +
// (r*h) @ W_ch); h' = u*h + (1-u)*c. Its carry is h alone, and the
// attention query is the top cell's h.
//
// Bound: latency, as kernels #8/#9 (dec_train.cu): a step is a chain of
// about ten dependent products of B = 128 rows over about 4 MiB of f32
// weights, each far too small to fill the card, and the steps are serial.
// The same design: ONE persistent cooperative launch per direction, tiles
// of 8 rows x 32 columns from tiles.cuh, grid barriers between the
// dependent stages of a step; the sampling, the attention and its backward
// and the weight-gradient tiles are dec_train.cuh's.
//
// Forward, per step t (B rows):
//   F1 LM gates: input row gx | cx = tgx[t] | tcx[t], or EWb_g | EWb_c of
//      argmax(logits[t-1] + gumbel) when step t-1's coin fired (ties to
//      the lowest index); r, u = sigmoid(gx + h_lm @ W_lm_gh); save r | u,
//      r * h_lm and the row's cx.
//   F2 LM candidate: c = tanh(cx + (r*h_lm) @ W_lm_ch); h_lm' = u h_lm +
//      (1-u) c; lm_out = h_lm' * mask.
//   F3 x_dec = [lm_out | ctx_{t-1}] @ W_ip + b_ip
//   F4 decoder gates [x_dec | h_{t-1}] @ [W_gx; W_gh] + b_g, and beside
//      them cx_dec = x_dec @ W_cx + b_c (no dependency between the two)
//   F5 decoder candidate and new h
//   F6 query y = h @ W_q + b_q
//   F7 attention, one block per batch row
//   F8 proj = [h | ctx] @ W_ap + b_ap
//   F9 logits = proj @ W_out + b_out
// Every intermediate is saved, so the backward recomputes nothing.
//
// Backward, per step t in reverse (transposed weight copies keep the loads
// coalesced):
//   B1 dproj = dlogits @ W_out^T
//   B2 [dq_direct | dctx] = dproj @ W_ap^T
//   B3 attention backward per batch row
//   B4 decoder cell, first half: dh = dh_carry + dq_direct + dy @ W_q^T;
//      du, dcpre = dh (1-u)(1-c^2); the u half of dgates
//   B5 d(rh) = dcpre @ W_ch^T; the r half of dgates; dh_{t-1} part
//   B6 dx_dec = [dgates | dcpre] @ [W_gx | W_cx]^T, and beside it
//      dh_{t-1} += dgates @ W_gh^T
//   B7 [dlm_out | dctx_{t-1}] = dx_dec @ W_ip^T; LM cell, first half
//   B8 LM d(rh) = dcpre_lm @ W_lm_ch^T; r half; the routing of d(tgx),
//      d(tcx) (teacher share 1 - flag) and d(EWb) (sampled share)
//   B9 dh_lm = dh_lm part + dgates_lm @ W_lm_gh^T
// The weight gradients then take the grid's tiles as in dec_train.cu: no
// atomics, a fixed order.
#include "dec_train.cuh"

namespace {

struct FwdArgs {
  const float *ewbg, *ewbc, *wghlm, *wchlm, *ipw, *ipb, *qw, *qb, *v, *apw,
      *apb, *opw, *opb, *wg, *bg, *wcx, *bc, *wch;
  const float *hf, *enc, *amask, *tgx, *tcx, *gum, *flag, *lm_mask, *zeros;
  float *logits, *ru_lm, *rh_lm, *cx_lm, *c_lm, *hlm, *lm_out, *x_dec,
      *ru_dec, *rh_dec, *cx_dec, *c_dec, *hdec, *y, *alpha, *ctx, *proj, *oh;
  int S, B, G, D, M, E, A, V, T;
};

__global__ void __launch_bounds__(kThreads) dec_train_gru_fwd_kernel(
    FwdArgs p) {
  __shared__ float smem[kSmem];
  __shared__ int sidx[kRows];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, G = p.G, D = p.D, M = p.M, E = p.E, A = p.A, V = p.V,
            T = p.T;
  for (int t = 0; t < p.S; ++t) {
    // F1: LM gates.
    const bool samp = p.gum != nullptr && t > 0;
    const int utiles = (G + kCols - 1) / kCols;
    const float* hlm_prev = row_prev(p.hlm, t, B, G, p.zeros);
    for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x) {
      const int n0 = (tile / utiles) * kRows;
      if (samp)
        sample_tile(p.logits, p.gum, p.flag, p.oh, t, n0, B, V,
                    tile % utiles == 0, sidx);
      gru_tile_ep(
          nullptr, 0, hlm_prev, G, G, p.wghlm, B, tile, smem,
          [&](int n, int u, float sr, float su) {
            const size_t o = at(t, n, B, G) + u, o2 = at(t, n, B, 2 * G) + u;
            float gr = __ldg(p.tgx + o2), gu = __ldg(p.tgx + o2 + G);
            float cx = __ldg(p.tcx + o);
            if (samp) {
              const float fl = __ldg(p.flag + static_cast<size_t>(t) * B + n);
              const size_t idx = sidx[n - n0];
              gr = fl * __ldg(p.ewbg + idx * 2 * G + u) + (1.f - fl) * gr;
              gu = fl * __ldg(p.ewbg + idx * 2 * G + G + u) + (1.f - fl) * gu;
              cx = fl * __ldg(p.ewbc + idx * G + u) + (1.f - fl) * cx;
            }
            const float r = e2e::sigmoid(gr + sr), uu = e2e::sigmoid(gu + su);
            p.ru_lm[o2] = r;
            p.ru_lm[o2 + G] = uu;
            p.rh_lm[o] = r * __ldcg(hlm_prev + static_cast<size_t>(n) * G + u);
            p.cx_lm[o] = cx;
          });
    }
    grid.sync();
    // F2: LM candidate and new h.
    for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x)
      dense_tile_ep(
          p.rh_lm + at(t, 0, B, G), G, nullptr, 0, p.wchlm, G, B, tile, smem,
          [&](int n, int u, float s) {
            const size_t o = at(t, n, B, G) + u;
            const float c = tanhf(__ldcg(p.cx_lm + o) + s);
            const float uu = __ldcg(p.ru_lm + at(t, n, B, 2 * G) + G + u);
            const float hp =
                __ldcg(hlm_prev + static_cast<size_t>(n) * G + u);
            const float h = uu * hp + (1.f - uu) * c;
            p.c_lm[o] = c;
            p.hlm[o] = h;
            p.lm_out[o] = p.lm_mask != nullptr ? h * __ldg(p.lm_mask + o) : h;
          });
    grid.sync();
    // F3: x_dec = [lm_out | ctx_{t-1}] @ W_ip + b_ip.
    for (int tile = blockIdx.x; tile < num_tiles(M, B); tile += gridDim.x)
      dense_tile(p.lm_out + at(t, 0, B, G), G,
                 row_prev(p.ctx, t, B, E, p.zeros), E, p.ipw, p.ipb, M,
                 p.x_dec + at(t, 0, B, M), B, tile, smem);
    grid.sync();
    // F4: decoder gates, and the candidate's input contribution beside.
    const float* hd_prev = row_prev(p.hdec, t, B, D, p.zeros);
    const float* xd = p.x_dec + at(t, 0, B, M);
    for (int tile = blockIdx.x; tile < 2 * num_tiles(D, B);
         tile += gridDim.x) {
      if (tile < num_tiles(D, B)) {
        gru_tile_ep(xd, M, hd_prev, D, D, p.wg, B, tile, smem,
                    [&](int n, int u, float sr, float su) {
                      const size_t o2 = at(t, n, B, 2 * D) + u;
                      const float r = e2e::sigmoid(sr + __ldg(p.bg + u));
                      const float uu =
                          e2e::sigmoid(su + __ldg(p.bg + D + u));
                      p.ru_dec[o2] = r;
                      p.ru_dec[o2 + D] = uu;
                      p.rh_dec[at(t, n, B, D) + u] =
                          r * __ldcg(hd_prev + static_cast<size_t>(n) * D +
                                     u);
                    });
      } else {
        dense_tile(xd, M, nullptr, 0, p.wcx, p.bc, D,
                   p.cx_dec + at(t, 0, B, D), B, tile - num_tiles(D, B),
                   smem);
      }
    }
    grid.sync();
    // F5: decoder candidate and new h.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile_ep(
          p.rh_dec + at(t, 0, B, D), D, nullptr, 0, p.wch, D, B, tile, smem,
          [&](int n, int u, float s) {
            const size_t o = at(t, n, B, D) + u;
            const float c = tanhf(__ldcg(p.cx_dec + o) + s);
            const float uu = __ldcg(p.ru_dec + at(t, n, B, 2 * D) + D + u);
            const float hp = __ldcg(hd_prev + static_cast<size_t>(n) * D + u);
            p.c_dec[o] = c;
            p.hdec[o] = uu * hp + (1.f - uu) * c;
          });
    grid.sync();
    // F6: query = the decoder's h.
    for (int tile = blockIdx.x; tile < num_tiles(A, B); tile += gridDim.x)
      dense_tile(p.hdec + at(t, 0, B, D), D, nullptr, 0, p.qw, p.qb, A,
                 p.y + at(t, 0, B, A), B, tile, smem);
    grid.sync();
    // F7: attention, one block per batch row.
    for (int n = blockIdx.x; n < B; n += gridDim.x)
      attention_row(p.hf, p.enc, p.amask, p.v, p.y, p.alpha, p.ctx, t, n, B,
                    T, A, E, smem);
    grid.sync();
    // F8: proj = [h | ctx] @ W_ap + b_ap.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile(p.hdec + at(t, 0, B, D), D, p.ctx + at(t, 0, B, E), E, p.apw,
                 p.apb, D, p.proj + at(t, 0, B, D), B, tile, smem);
    grid.sync();
    // F9: logits.
    for (int tile = blockIdx.x; tile < num_tiles(V, B); tile += gridDim.x)
      dense_tile(p.proj + at(t, 0, B, D), D, nullptr, 0, p.opw, p.opb, V,
                 p.logits + at(t, 0, B, V), B, tile, smem);
    grid.sync();
  }
}

constexpr int kJobs = 18;

struct BwdArgs {
  const float *opwT, *apwT, *qwT, *wchT, *wxT, *wghT, *ipwT, *wchlmT,
      *wghlmT, *v;
  const float *hf, *enc, *flag, *lm_mask, *zeros;
  const float *ru_lm, *rh_lm, *c_lm, *hlm, *lm_out, *x_dec, *ru_dec, *rh_dec,
      *c_dec, *hdec, *y, *alpha, *ctx, *proj, *oh, *dlog;
  float *dproj, *dy, *dgd, *dcd, *dxdec, *dgl, *dcl;
  float *dtgx, *dtcx, *dhf, *denc;
  float *s2, *dv_rows, *dh_dec, *dhp_dec, *dh_lm, *dhp_lm, *dctx;
  WJob jobs[kJobs];
  int S, B, G, D, M, E, A, V, T;
};

__global__ void __launch_bounds__(kThreads) dec_train_gru_bwd_kernel(
    BwdArgs p) {
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
      p.dh_dec[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * G; i += stride)
      p.dh_lm[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * E; i += stride)
      p.dctx[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * T * A; i += stride)
      p.dhf[i] = 0.f;
    for (size_t i = tid; i < static_cast<size_t>(B) * T * E; i += stride)
      p.denc[i] = 0.f;
  }
  grid.sync();
  for (int t = p.S - 1; t >= 0; --t) {
    const float* hd_prev = row_prev(p.hdec, t, B, D, p.zeros);
    const float* hl_prev = row_prev(p.hlm, t, B, G, p.zeros);
    // B1: dproj = dlogits @ W_out^T.
    float* dproj = p.dproj + at(t, 0, B, D);
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile_ep(p.dlog + at(t, 0, B, V), V, nullptr, 0, p.opwT, D, B,
                    tile, smem, [&](int n, int c, float s) {
                      dproj[static_cast<size_t>(n) * D + c] = s;
                    });
    grid.sync();
    // B2: [dq_direct | dctx part] = dproj @ W_ap^T.
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
    // B4: decoder cell, first half; dh = carry + dq_direct + dy @ W_q^T.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile_ep(
          p.dy + at(t, 0, B, A), A, nullptr, 0, p.qwT, D, B, tile, smem,
          [&](int n, int u, float s) {
            const size_t o = static_cast<size_t>(n) * D + u;
            const size_t ot = at(t, n, B, D) + u;
            const float dh = __ldcg(p.dh_dec + o) +
                             __ldcg(p.s2 + static_cast<size_t>(n) * (D + E) +
                                    u) +
                             s;
            const float uu = __ldg(p.ru_dec + at(t, n, B, 2 * D) + D + u);
            const float c = __ldg(p.c_dec + ot);
            const float hp = __ldg(hd_prev + o);
            p.dcd[ot] = dh * (1.f - uu) * (1.f - c * c);
            p.dgd[at(t, n, B, 2 * D) + D + u] =
                dh * (hp - c) * uu * (1.f - uu);
            p.dhp_dec[o] = dh * uu;
          });
    grid.sync();
    // B5: d(rh) = dcpre @ W_ch^T; the r half of dgates.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile_ep(
          p.dcd + at(t, 0, B, D), D, nullptr, 0, p.wchT, D, B, tile, smem,
          [&](int n, int u, float drh) {
            const size_t o = static_cast<size_t>(n) * D + u;
            const float r = __ldg(p.ru_dec + at(t, n, B, 2 * D) + u);
            const float hp = __ldg(hd_prev + o);
            p.dgd[at(t, n, B, 2 * D) + u] = drh * hp * r * (1.f - r);
            p.dhp_dec[o] = __ldcg(p.dhp_dec + o) + drh * r;
          });
    grid.sync();
    // B6: dx_dec = [dgates | dcpre] @ [W_gx | W_cx]^T, and beside it
    // dh_{t-1} = dh part + dgates @ W_gh^T.
    for (int tile = blockIdx.x; tile < num_tiles(M, B) + num_tiles(D, B);
         tile += gridDim.x) {
      if (tile < num_tiles(M, B)) {
        dense_tile_ep(p.dgd + at(t, 0, B, 2 * D), 2 * D,
                      p.dcd + at(t, 0, B, D), D, p.wxT, M, B, tile, smem,
                      [&](int n, int c, float s) {
                        p.dxdec[at(t, n, B, M) + c] = s;
                      });
      } else {
        dense_tile_ep(p.dgd + at(t, 0, B, 2 * D), 2 * D, nullptr, 0, p.wghT,
                      D, B, tile - num_tiles(M, B), smem,
                      [&](int n, int u, float s) {
                        const size_t o = static_cast<size_t>(n) * D + u;
                        p.dh_dec[o] = __ldcg(p.dhp_dec + o) + s;
                      });
      }
    }
    grid.sync();
    // B7: [dlm_out | dctx_{t-1}] = dx_dec @ W_ip^T; LM cell, first half.
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
            const float dh = dlm + __ldcg(p.dh_lm + o);
            const float uu = __ldg(p.ru_lm + at(t, n, B, 2 * G) + G + c);
            const float cl = __ldg(p.c_lm + ot);
            const float hp = __ldg(hl_prev + o);
            const float dcpre = dh * (1.f - uu) * (1.f - cl * cl);
            const float dgu = dh * (hp - cl) * uu * (1.f - uu);
            const float keep =
                p.flag != nullptr
                    ? 1.f - __ldg(p.flag + static_cast<size_t>(t) * B + n)
                    : 1.f;
            p.dcl[ot] = dcpre;
            p.dgl[at(t, n, B, 2 * G) + G + c] = dgu;
            p.dtcx[ot] = keep * dcpre;
            p.dtgx[at(t, n, B, 2 * G) + G + c] = keep * dgu;
            p.dhp_lm[o] = dh * uu;
          });
    grid.sync();
    // B8: LM d(rh) = dcpre_lm @ W_lm_ch^T; the r half of dgates_lm.
    for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x)
      dense_tile_ep(
          p.dcl + at(t, 0, B, G), G, nullptr, 0, p.wchlmT, G, B, tile, smem,
          [&](int n, int c, float drh) {
            const size_t o = static_cast<size_t>(n) * G + c;
            const float r = __ldg(p.ru_lm + at(t, n, B, 2 * G) + c);
            const float dgr = drh * __ldg(hl_prev + o) * r * (1.f - r);
            const float keep =
                p.flag != nullptr
                    ? 1.f - __ldg(p.flag + static_cast<size_t>(t) * B + n)
                    : 1.f;
            p.dgl[at(t, n, B, 2 * G) + c] = dgr;
            p.dtgx[at(t, n, B, 2 * G) + c] = keep * dgr;
            p.dhp_lm[o] = __ldcg(p.dhp_lm + o) + drh * r;
          });
    grid.sync();
    // B9: dh_lm = dh part + dgates_lm @ W_lm_gh^T.
    for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x)
      dense_tile_ep(p.dgl + at(t, 0, B, 2 * G), 2 * G, nullptr, 0, p.wghlmT,
                    G, B, tile, smem, [&](int n, int c, float s) {
                      const size_t o = static_cast<size_t>(n) * G + c;
                      p.dh_lm[o] = __ldcg(p.dhp_lm + o) + s;
                    });
    grid.sync();
  }
  // Weight gradients: every tile of every dW, each by one block.
  run_wjobs(p.jobs, kJobs, smem);
}

void set_dims(int* dst[9], const int* dims) {
  for (int i = 0; i < 9; ++i) *dst[i] = dims[i];
}

}  // namespace

// dims: S, B, G, D, M, E, A, V, T (steps, batch, LM hidden, decoder hidden,
// decoder input, encoder width, attention, vocabulary, encoder frames).
// ptrs (in order): weights ewbg [V,2G], ewbc [V,G], wghlm [G,2G], wchlm
// [G,G], ipw [G+E,M], ipb [M], qw [D,A], qb [A], v [A], apw [D+E,D], apb
// [D], opw [D,V], opb [V], wg [M+D,2D] (W_gx over W_gh), bg [2D], wcx
// [M,D], bc [D], wch [D,D]; inputs hf [B,T,A], enc [B,T,E], amask [B,T],
// tgx [S,B,2G], tcx [S,B,G], gum [S,B,V]|NULL, flag [S,B]|NULL, lm_mask
// [S,B,G]|NULL, zeros [>= B*max(G,D,E)]; saves (out) logits [S,B,V], ru_lm
// [S,B,2G], rh_lm, cx_lm, c_lm, hlm, lm_out [S,B,G], x_dec [S,B,M], ru_dec
// [S,B,2D], rh_dec, cx_dec, c_dec, hdec [S,B,D], y [S,B,A], alpha [S,B,T],
// ctx [S,B,E], proj [S,B,D], oh [S,B,V] (zero-filled by the caller; NULL
// without gum).
E2E_EXPORT int e2e_dec_train_gru_fwd(const void* const* ptrs, int n_ptrs,
                                     const int* dims, cudaStream_t stream) {
  if (n_ptrs != 45) return cudaErrorInvalidValue;
  FwdArgs p{};
  const float** in[] = {&p.ewbg, &p.ewbc, &p.wghlm, &p.wchlm, &p.ipw, &p.ipb,
                        &p.qw, &p.qb, &p.v, &p.apw, &p.apb, &p.opw, &p.opb,
                        &p.wg, &p.bg, &p.wcx, &p.bc, &p.wch, &p.hf, &p.enc,
                        &p.amask, &p.tgx, &p.tcx, &p.gum, &p.flag,
                        &p.lm_mask, &p.zeros};
  float** out[] = {&p.logits, &p.ru_lm, &p.rh_lm, &p.cx_lm, &p.c_lm, &p.hlm,
                   &p.lm_out, &p.x_dec, &p.ru_dec, &p.rh_dec, &p.cx_dec,
                   &p.c_dec, &p.hdec, &p.y, &p.alpha, &p.ctx, &p.proj, &p.oh};
  for (int i = 0; i < 27; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 18; ++i)
    *out[i] = static_cast<float*>(const_cast<void*>(ptrs[27 + i]));
  int* d[] = {&p.S, &p.B, &p.G, &p.D, &p.M, &p.E, &p.A, &p.V, &p.T};
  set_dims(d, dims);
  if (p.S < 1 || p.B < 1 || p.A + p.T > kSmem ||
      (p.gum == nullptr) != (p.flag == nullptr) ||
      (p.gum == nullptr) != (p.oh == nullptr))
    return cudaErrorInvalidValue;
  int tiles = max(num_tiles(p.G, p.B), num_tiles(p.M, p.B));
  tiles = max(tiles, 2 * num_tiles(p.D, p.B));
  tiles = max(tiles, num_tiles(p.A, p.B));
  tiles = max(tiles, num_tiles(p.V, p.B));
  tiles = max(tiles, p.B);
  return launch_cooperative(dec_train_gru_fwd_kernel, p, tiles, stream);
}

// ptrs (in order): transposed weights opwT [V,D], apwT [D,D+E], qwT [A,D],
// wchT [D,D], wxT [3D,M] ([W_gx | W_cx]^T), wghT [2D,D], ipwT [M,G+E],
// wchlmT [G,G], wghlmT [2G,G]; v [A]; hf, enc, flag|NULL, lm_mask|NULL,
// zeros (as the forward); the forward's saves ru_lm, rh_lm, c_lm, hlm,
// lm_out, x_dec, ru_dec, rh_dec, c_dec, hdec, y, alpha, ctx, proj,
// oh|NULL; dlogits [S,B,V]; step gradients (scratch) dproj [S,B,D], dy
// [S,B,A], dgd [S,B,2D], dcd [S,B,D], dxdec [S,B,M], dgl [S,B,2G], dcl
// [S,B,G]; outputs dtgx [S,B,2G], dtcx [S,B,G], dhf [B,T,A], denc [B,T,E],
// then the 18 weight gradients in the forward's weight order; scratch s2
// [B,D+E], dv_rows [B,A], dh_dec, dhp_dec [B,D], dh_lm, dhp_lm [B,G], dctx
// [B,E]. dims as the forward.
E2E_EXPORT int e2e_dec_train_gru_bwd(const void* const* ptrs, int n_ptrs,
                                     const int* dims, cudaStream_t stream) {
  if (n_ptrs != 67) return cudaErrorInvalidValue;
  BwdArgs p{};
  const float** in[] = {&p.opwT, &p.apwT, &p.qwT, &p.wchT, &p.wxT, &p.wghT,
                        &p.ipwT, &p.wchlmT, &p.wghlmT, &p.v, &p.hf, &p.enc,
                        &p.flag, &p.lm_mask, &p.zeros, &p.ru_lm, &p.rh_lm,
                        &p.c_lm, &p.hlm, &p.lm_out, &p.x_dec, &p.ru_dec,
                        &p.rh_dec, &p.c_dec, &p.hdec, &p.y, &p.alpha, &p.ctx,
                        &p.proj, &p.oh, &p.dlog};
  float** out[] = {&p.dproj, &p.dy, &p.dgd, &p.dcd, &p.dxdec, &p.dgl,
                   &p.dcl, &p.dtgx, &p.dtcx, &p.dhf, &p.denc};
  for (int i = 0; i < 31; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 11; ++i)
    *out[i] = static_cast<float*>(const_cast<void*>(ptrs[31 + i]));
  float* dw[kJobs];
  for (int i = 0; i < kJobs; ++i)
    dw[i] = static_cast<float*>(const_cast<void*>(ptrs[42 + i]));
  float** scratch[] = {&p.s2, &p.dv_rows, &p.dh_dec, &p.dhp_dec, &p.dh_lm,
                       &p.dhp_lm, &p.dctx};
  for (int i = 0; i < 7; ++i)
    *scratch[i] = static_cast<float*>(const_cast<void*>(ptrs[60 + i]));
  int* d[] = {&p.S, &p.B, &p.G, &p.D, &p.M, &p.E, &p.A, &p.V, &p.T};
  set_dims(d, dims);
  const int B = p.B, G = p.G, D = p.D, M = p.M, E = p.E, A = p.A, V = p.V;
  if (p.S < 1 || B < 1 || E + 2 * p.T + 1 > kSmem) return cudaErrorInvalidValue;
  const int R = p.S * B;
  // X [x1 | x2] (k, row shift), ones, dG, columns, rows, out.
  p.jobs[0] = {p.oh, V, 0, nullptr, 0, 0, false, p.dgl, 2 * G, R, dw[0]};
  p.jobs[1] = {p.oh, V, 0, nullptr, 0, 0, false, p.dcl, G, R, dw[1]};
  p.jobs[2] = {p.hlm, G, B, nullptr, 0, 0, false, p.dgl, 2 * G, R, dw[2]};
  p.jobs[3] = {p.rh_lm, G, 0, nullptr, 0, 0, false, p.dcl, G, R, dw[3]};
  p.jobs[4] = {p.lm_out, G, 0, p.ctx, E, B, false, p.dxdec, M, R, dw[4]};
  p.jobs[5] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dxdec, M, R, dw[5]};
  p.jobs[6] = {p.hdec, D, 0, nullptr, 0, 0, false, p.dy, A, R, dw[6]};
  p.jobs[7] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dy, A, R, dw[7]};
  p.jobs[8] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dv_rows, A, B, dw[8]};
  p.jobs[9] = {p.hdec, D, 0, p.ctx, E, 0, false, p.dproj, D, R, dw[9]};
  p.jobs[10] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dproj, D, R, dw[10]};
  p.jobs[11] = {p.proj, D, 0, nullptr, 0, 0, false, p.dlog, V, R, dw[11]};
  p.jobs[12] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dlog, V, R, dw[12]};
  p.jobs[13] = {p.x_dec, M, 0, p.hdec, D, B, false, p.dgd, 2 * D, R, dw[13]};
  p.jobs[14] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dgd, 2 * D, R, dw[14]};
  p.jobs[15] = {p.x_dec, M, 0, nullptr, 0, 0, false, p.dcd, D, R, dw[15]};
  p.jobs[16] = {nullptr, 1, 0, nullptr, 0, 0, true, p.dcd, D, R, dw[16]};
  p.jobs[17] = {p.rh_dec, D, 0, nullptr, 0, 0, false, p.dcd, D, R, dw[17]};
  int tiles = max(num_tiles(D + E, B), num_tiles(M, B) + num_tiles(D, B));
  tiles = max(tiles, num_tiles(G + E, B));
  tiles = max(tiles, B);
  return launch_cooperative(dec_train_gru_bwd_kernel, p, tiles, stream);
}
