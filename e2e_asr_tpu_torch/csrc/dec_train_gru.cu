// Kernel #10: the teacher-forced attention decoder with GRU cells over all
// output steps of a training batch, forward and backward.
//
// Replaces e2e_asr_tpu/ops/dec_train_gru_pallas.py _fwd_call (forward with
// scheduled sampling from pre-shifted gumbel noise and dropout, saving
// what the backward needs) and _bwd_call (reverse-time backward giving
// d(tgx), d(tcx), d(every weight), d(hf) and d(enc)). NL stacked GRU
// decoder cells (1..kMaxLayers) with inter-layer dropout masks, and
// SimpleProjection between the LM cell and the InputProjection; the
// precomputed products tgx | tcx = emb_in @ W_lm_x + b, EWb = E @ W_lm_x +
// b and hf = enc @ attn_w stay outside, so autograd carries their
// gradients on.
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
//   F2b with SimpleProjection: lm_sp = lm_out @ W_sp + b_sp
//   F3 x_dec = [lm_in | ctx_{t-1}] @ W_ip + b_ip (lm_in: lm_sp or lm_out)
//   per decoder layer l (in_0 = x_dec, in_l = h_{l-1} * inter_mask_{l-1},
//   saved as hdrop):
//   F4 gates [in_l | h_{t-1}] @ [W_gx; W_gh] + b_g, and beside them cx =
//      in_l @ W_cx + b_c (no dependency between the two)
//   F5 candidate and new h
//   F6 query y = h_top @ W_q + b_q
//   F7 attention, one block per batch row
//   F8 proj = [h_top | ctx] @ W_ap + b_ap
//   F9 logits = proj @ W_out + b_out
// Every intermediate is saved, so the backward recomputes nothing.
//
// Backward, per step t in reverse (transposed weight copies keep the loads
// coalesced):
//   B1 dproj = dlogits @ W_out^T
//   B2 [dq_direct | dctx] = dproj @ W_ap^T
//   B3 attention backward per batch row
//   B4 top cell, first half: dh = dh_carry + dq_direct + dy @ W_q^T;
//      du, dcpre = dh (1-u)(1-c^2); the u half of dgates
//   per layer l from the top down:
//   B5 d(rh) = dcpre @ W_ch^T; the r half of dgates; dh_{t-1} part
//   B6 din_l = [dgates | dcpre] @ [W_gx | W_cx]^T, and beside it
//      dh_{t-1} += dgates @ W_gh^T; for l > 0 the epilogue on din_l is the
//      first half of cell l-1 (dh = its carry + din_l * inter_mask_{l-1});
//      din_0 is dx_dec
//   B7 [dlm_in | dctx_{t-1}] = dx_dec @ W_ip^T; LM cell, first half (with
//      SimpleProjection B7 gives dlm_sp, and B7b dlm_out = dlm_sp @ W_sp^T
//      carries the LM cell's first half)
//   B8 LM d(rh) = dcpre_lm @ W_lm_ch^T; r half; the routing of d(tgx),
//      d(tcx) (teacher share 1 - flag) and d(EWb) (sampled share)
//   B9 dh_lm = dh_lm part + dgates_lm @ W_lm_gh^T
// The weight gradients then take the grid's tiles as in dec_train.cu: no
// atomics, a fixed order.
#include "dec_train.cuh"

namespace {

struct FwdArgs {
  const float *ewbg, *ewbc, *wghlm, *wchlm, *ipw, *ipb, *qw, *qb, *v, *apw,
      *apb, *opw, *opb, *spw, *spb;
  const float *wg[kMaxLayers], *bg[kMaxLayers], *wcx[kMaxLayers],
      *bc[kMaxLayers], *wch[kMaxLayers];
  const float *hf, *enc, *amask, *tgx, *tcx, *gum, *flag, *lm_mask,
      *inter_mask, *zeros;
  float *logits, *ru_lm, *rh_lm, *cx_lm, *c_lm, *hlm, *lm_out, *lm_sp,
      *x_dec, *ru_dec, *rh_dec, *cx_dec, *c_dec, *hdec, *hdrop, *y, *alpha,
      *ctx, *proj, *oh;
  int S, B, G, D, M, E, A, V, T, NL;
};

__global__ void __launch_bounds__(kThreads) dec_train_gru_fwd_kernel(
    FwdArgs p) {
  __shared__ float smem[kSmem];
  __shared__ int sidx[kRows];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, G = p.G, D = p.D, M = p.M, E = p.E, A = p.A, V = p.V,
            T = p.T, NL = p.NL;
  const bool sp = p.spw != nullptr;
  const int HID = sp ? D : G;  // the input projection's LM-side rows
  const size_t layer = static_cast<size_t>(p.S) * B * D;  // [S,B,D] stride
  const float* htop = p.hdec + (NL - 1) * layer;
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
    // F2b: SimpleProjection.
    const float* lm_in = p.lm_out + at(t, 0, B, G);
    if (sp) {
      for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
        dense_tile(lm_in, G, nullptr, 0, p.spw, p.spb, D,
                   p.lm_sp + at(t, 0, B, D), B, tile, smem);
      grid.sync();
      lm_in = p.lm_sp + at(t, 0, B, D);
    }
    // F3: x_dec = [lm_in | ctx_{t-1}] @ W_ip + b_ip.
    for (int tile = blockIdx.x; tile < num_tiles(M, B); tile += gridDim.x)
      dense_tile(lm_in, HID, row_prev(p.ctx, t, B, E, p.zeros), E, p.ipw,
                 p.ipb, M, p.x_dec + at(t, 0, B, M), B, tile, smem);
    grid.sync();
    for (int l = 0; l < NL; ++l) {
      const int Kin = l == 0 ? M : D;
      const float* in = l == 0 ? p.x_dec + at(t, 0, B, M)
                               : p.hdrop + (l - 1) * layer + at(t, 0, B, D);
      float* ru = p.ru_dec + 2 * l * layer;
      float* rh = p.rh_dec + l * layer;
      float* cxd = p.cx_dec + l * layer;
      float* cd = p.c_dec + l * layer;
      float* hd = p.hdec + l * layer;
      const float* hd_prev = row_prev(hd, t, B, D, p.zeros);
      const float *bgl = p.bg[l], *mask = nullptr;
      if (p.inter_mask != nullptr && l < NL - 1)
        mask = p.inter_mask + l * layer;
      float* drop = l < NL - 1 ? p.hdrop + l * layer : nullptr;
      // F4: gates, and the candidate's input contribution beside.
      for (int tile = blockIdx.x; tile < 2 * num_tiles(D, B);
           tile += gridDim.x) {
        if (tile < num_tiles(D, B)) {
          gru_tile_ep(in, Kin, hd_prev, D, D, p.wg[l], B, tile, smem,
                      [&](int n, int u, float sr, float su) {
                        const size_t o2 = at(t, n, B, 2 * D) + u;
                        const float r = e2e::sigmoid(sr + __ldg(bgl + u));
                        const float uu = e2e::sigmoid(su + __ldg(bgl + D + u));
                        ru[o2] = r;
                        ru[o2 + D] = uu;
                        rh[at(t, n, B, D) + u] =
                            r * __ldcg(hd_prev + static_cast<size_t>(n) * D +
                                       u);
                      });
        } else {
          dense_tile(in, Kin, nullptr, 0, p.wcx[l], p.bc[l], D,
                     cxd + at(t, 0, B, D), B, tile - num_tiles(D, B), smem);
        }
      }
      grid.sync();
      // F5: candidate and new h.
      for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
        dense_tile_ep(
            rh + at(t, 0, B, D), D, nullptr, 0, p.wch[l], D, B, tile, smem,
            [&](int n, int u, float s) {
              const size_t o = at(t, n, B, D) + u;
              const float c = tanhf(__ldcg(cxd + o) + s);
              const float uu = __ldcg(ru + at(t, n, B, 2 * D) + D + u);
              const float hp =
                  __ldcg(hd_prev + static_cast<size_t>(n) * D + u);
              const float h = uu * hp + (1.f - uu) * c;
              cd[o] = c;
              hd[o] = h;
              if (drop != nullptr)
                drop[o] = mask != nullptr ? h * __ldg(mask + o) : h;
            });
      grid.sync();
    }
    // F6: query = the top cell's h.
    for (int tile = blockIdx.x; tile < num_tiles(A, B); tile += gridDim.x)
      dense_tile(htop + at(t, 0, B, D), D, nullptr, 0, p.qw, p.qb, A,
                 p.y + at(t, 0, B, A), B, tile, smem);
    grid.sync();
    // F7: attention, one block per batch row.
    for (int n = blockIdx.x; n < B; n += gridDim.x)
      attention_row(p.hf, p.enc, p.amask, p.v, p.y, p.alpha, p.ctx, t, n, n,
                    B, T, A, E, smem);
    grid.sync();
    // F8: proj = [h_top | ctx] @ W_ap + b_ap.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile(htop + at(t, 0, B, D), D, p.ctx + at(t, 0, B, E), E, p.apw,
                 p.apb, D, p.proj + at(t, 0, B, D), B, tile, smem);
    grid.sync();
    // F9: logits.
    for (int tile = blockIdx.x; tile < num_tiles(V, B); tile += gridDim.x)
      dense_tile(p.proj + at(t, 0, B, D), D, nullptr, 0, p.opw, p.opb, V,
                 p.logits + at(t, 0, B, V), B, tile, smem);
    grid.sync();
  }
}

struct BwdArgs {
  const float *opwT, *apwT, *qwT, *ipwT, *wchlmT, *wghlmT, *spwT, *v;
  const float *wchT[kMaxLayers], *wxT[kMaxLayers], *wghT[kMaxLayers];
  const float *hf, *enc, *flag, *lm_mask, *inter_mask, *zeros;
  const float *ru_lm, *rh_lm, *c_lm, *hlm, *lm_out, *lm_sp, *x_dec, *ru_dec,
      *rh_dec, *c_dec, *hdec, *hdrop, *y, *alpha, *ctx, *proj, *oh, *dlog;
  float *dproj, *dy, *dgd, *dcd, *dxdec, *dgl, *dcl, *dsp;
  float *dtgx, *dtcx, *dhf, *denc;
  float *s2, *dv_rows, *dh_dec, *dhp_dec, *dh_lm, *dhp_lm, *dctx;
  WJob jobs[kMaxJobs];
  int n_jobs;
  int S, B, G, D, M, E, A, V, T, NL;
};
static_assert(sizeof(BwdArgs) <= 4096, "kernel parameters exceed 4 KiB");

// The first half of a GRU cell's backward for one unit, from the total
// gradient dh of its new h, its update gate u, candidate c and previous h:
// d(candidate pre-activation), d(u pre-activation), and the share of
// d(h_prev) through u.
__device__ __forceinline__ void gru_first_half(float dh, float uu, float c,
                                               float hp, float& dcpre,
                                               float& dgu, float& dhp) {
  dcpre = dh * (1.f - uu) * (1.f - c * c);
  dgu = dh * (hp - c) * uu * (1.f - uu);
  dhp = dh * uu;
}

__global__ void __launch_bounds__(kThreads) dec_train_gru_bwd_kernel(
    BwdArgs p) {
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
    for (size_t i = tid; i < NL * carry; i += stride) p.dh_dec[i] = 0.f;
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
    const float* hl_prev = row_prev(p.hlm, t, B, G, p.zeros);
    // The first half of cell l's backward for unit u of row n, given its
    // total dh.
    auto dec_first = [&](int l, int n, int u, float dh) {
      const size_t o = static_cast<size_t>(n) * D + u;
      const size_t ot = at(t, n, B, D) + u;
      const float hp =
          t > 0 ? __ldg(p.hdec + l * layer + at(t - 1, n, B, D) + u) : 0.f;
      float dcpre, dgu, dhp;
      gru_first_half(dh, __ldg(p.ru_dec + 2 * l * layer + at(t, n, B, 2 * D) +
                               D + u),
                     __ldg(p.c_dec + l * layer + ot), hp, dcpre, dgu, dhp);
      p.dcd[l * layer + ot] = dcpre;
      p.dgd[2 * l * layer + at(t, n, B, 2 * D) + D + u] = dgu;
      p.dhp_dec[l * carry + o] = dhp;
    };
    // The LM cell's first half for unit c of row n, given d(lm_out).
    auto lm_first = [&](int n, int c, float s) {
      const size_t o = static_cast<size_t>(n) * G + c;
      const size_t ot = at(t, n, B, G) + c;
      const float dlm = p.lm_mask != nullptr ? s * __ldg(p.lm_mask + ot) : s;
      float dcpre, dgu, dhp;
      gru_first_half(dlm + __ldcg(p.dh_lm + o),
                     __ldg(p.ru_lm + at(t, n, B, 2 * G) + G + c),
                     __ldg(p.c_lm + ot), __ldg(hl_prev + o), dcpre, dgu, dhp);
      const float keep =
          p.flag != nullptr
              ? 1.f - __ldg(p.flag + static_cast<size_t>(t) * B + n)
              : 1.f;
      p.dcl[ot] = dcpre;
      p.dgl[at(t, n, B, 2 * G) + G + c] = dgu;
      p.dtcx[ot] = keep * dcpre;
      p.dtgx[at(t, n, B, 2 * G) + G + c] = keep * dgu;
      p.dhp_lm[o] = dhp;
    };
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
    // B4: the top cell's first half; dh = carry + dq_direct + dy @ W_q^T.
    for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
      dense_tile_ep(p.dy + at(t, 0, B, A), A, nullptr, 0, p.qwT, D, B, tile,
                    smem, [&](int n, int u, float s) {
                      const size_t o = static_cast<size_t>(n) * D + u;
                      dec_first(top, n, u,
                                __ldcg(p.dh_dec + top * carry + o) +
                                    __ldcg(p.s2 +
                                           static_cast<size_t>(n) * (D + E) +
                                           u) +
                                    s);
                    });
    grid.sync();
    for (int l = top; l >= 0; --l) {
      const int Kin = l == 0 ? M : D;
      const float* ru = p.ru_dec + 2 * l * layer;
      const float* hd_prev = row_prev(p.hdec + l * layer, t, B, D, p.zeros);
      float* dgd = p.dgd + 2 * l * layer + at(t, 0, B, 2 * D);
      float* dcd = p.dcd + l * layer + at(t, 0, B, D);
      float* dhp = p.dhp_dec + l * carry;
      // B5: d(rh) = dcpre @ W_ch^T; the r half of dgates.
      for (int tile = blockIdx.x; tile < num_tiles(D, B); tile += gridDim.x)
        dense_tile_ep(
            dcd, D, nullptr, 0, p.wchT[l], D, B, tile, smem,
            [&](int n, int u, float drh) {
              const size_t o = static_cast<size_t>(n) * D + u;
              const float r = __ldg(ru + at(t, n, B, 2 * D) + u);
              const float hp = __ldg(hd_prev + o);
              dgd[static_cast<size_t>(n) * 2 * D + u] =
                  drh * hp * r * (1.f - r);
              dhp[o] = __ldcg(dhp + o) + drh * r;
            });
      grid.sync();
      // B6: din = [dgates | dcpre] @ [W_gx | W_cx]^T (dx_dec, or the first
      // half of cell l-1), and beside it dh_{t-1} = dh part + dgates @
      // W_gh^T.
      const float* mask = p.inter_mask != nullptr && l > 0
                              ? p.inter_mask + (l - 1) * layer
                              : nullptr;
      for (int tile = blockIdx.x; tile < num_tiles(Kin, B) + num_tiles(D, B);
           tile += gridDim.x) {
        if (tile < num_tiles(Kin, B)) {
          dense_tile_ep(
              dgd, 2 * D, dcd, D, p.wxT[l], Kin, B, tile, smem,
              [&](int n, int c, float s) {
                if (l == 0) {
                  p.dxdec[at(t, n, B, M) + c] = s;
                  return;
                }
                const float din =
                    mask != nullptr ? s * __ldg(mask + at(t, n, B, D) + c)
                                    : s;
                dec_first(l - 1, n, c,
                          __ldcg(p.dh_dec + (l - 1) * carry +
                                 static_cast<size_t>(n) * D + c) +
                              din);
              });
        } else {
          dense_tile_ep(dgd, 2 * D, nullptr, 0, p.wghT[l], D, B,
                        tile - num_tiles(Kin, B), smem,
                        [&](int n, int u, float s) {
                          const size_t o = static_cast<size_t>(n) * D + u;
                          p.dh_dec[l * carry + o] = __ldcg(dhp + o) + s;
                        });
        }
      }
      grid.sync();
    }
    // B7: [dlm_in | dctx_{t-1}] = dx_dec @ W_ip^T; without SimpleProjection
    // the LM cell's first half follows.
    for (int tile = blockIdx.x; tile < num_tiles(HID + E, B);
         tile += gridDim.x)
      dense_tile_ep(p.dxdec + at(t, 0, B, M), M, nullptr, 0, p.ipwT, HID + E,
                    B, tile, smem, [&](int n, int c, float s) {
                      if (c >= HID)
                        p.dctx[static_cast<size_t>(n) * E + c - HID] = s;
                      else if (sp)
                        p.dsp[at(t, n, B, D) + c] = s;
                      else
                        lm_first(n, c, s);
                    });
    grid.sync();
    // B7b: d(lm_out) = dlm_sp @ W_sp^T, and the LM cell's first half.
    if (sp) {
      for (int tile = blockIdx.x; tile < num_tiles(G, B); tile += gridDim.x)
        dense_tile_ep(p.dsp + at(t, 0, B, D), D, nullptr, 0, p.spwT, G, B,
                      tile, smem, lm_first);
      grid.sync();
    }
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
  run_wjobs(p.jobs, p.n_jobs, smem);
}

void set_dims(int* dst[10], const int* dims) {
  for (int i = 0; i < 10; ++i) *dst[i] = dims[i];
}

}  // namespace

// dims: S, B, G, D, M, E, A, V, T, NL (steps, batch, LM hidden, decoder
// hidden, decoder input, encoder width, attention, vocabulary, encoder
// frames, decoder layers). HID below is D with SimpleProjection, else G.
// ptrs (in order): weights ewbg [V,2G], ewbc [V,G], wghlm [G,2G], wchlm
// [G,G], ipw [HID+E,M], ipb [M], qw [D,A], qb [A], v [A], apw [D+E,D], apb
// [D], opw [D,V], opb [V], then layer 0's wg [M+D,2D] (W_gx over W_gh), bg
// [2D], wcx [M,D], bc [D], wch [D,D]; inputs hf [B,T,A], enc [B,T,E], amask
// [B,T], tgx [S,B,2G], tcx [S,B,G], gum [S,B,V]|NULL, flag [S,B]|NULL,
// lm_mask [S,B,G]|NULL, zeros [>= B*max(G,D,E)]; saves (out) logits
// [S,B,V], ru_lm [S,B,2G], rh_lm, cx_lm, c_lm, hlm, lm_out [S,B,G], x_dec
// [S,B,M], ru_dec [NL,S,B,2D], rh_dec, cx_dec, c_dec, hdec [NL,S,B,D], y
// [S,B,A], alpha [S,B,T], ctx [S,B,E], proj [S,B,D], oh [S,B,V]
// (zero-filled by the caller; NULL without gum); then SimpleProjection's
// spw [G,D], spb [D] and its save lm_sp [S,B,D] (all NULL without it),
// inter_mask [NL-1,S,B,D]|NULL, the save hdrop [NL-1,S,B,D] (NULL at NL =
// 1); then layers 1..NL-1's wg [2D,2D], bg, wcx [D,D], bc, wch.
E2E_EXPORT int e2e_dec_train_gru_fwd(const void* const* ptrs, int n_ptrs,
                                     const int* dims, cudaStream_t stream) {
  FwdArgs p{};
  int* d[] = {&p.S, &p.B, &p.G, &p.D, &p.M, &p.E, &p.A, &p.V, &p.T, &p.NL};
  set_dims(d, dims);
  if (p.NL < 1 || p.NL > kMaxLayers || n_ptrs != 50 + 5 * (p.NL - 1))
    return cudaErrorInvalidValue;
  const float** in[] = {&p.ewbg, &p.ewbc, &p.wghlm, &p.wchlm, &p.ipw, &p.ipb,
                        &p.qw, &p.qb, &p.v, &p.apw, &p.apb, &p.opw, &p.opb,
                        &p.wg[0], &p.bg[0], &p.wcx[0], &p.bc[0], &p.wch[0],
                        &p.hf, &p.enc, &p.amask, &p.tgx, &p.tcx, &p.gum,
                        &p.flag, &p.lm_mask, &p.zeros};
  float** out[] = {&p.logits, &p.ru_lm, &p.rh_lm, &p.cx_lm, &p.c_lm, &p.hlm,
                   &p.lm_out, &p.x_dec, &p.ru_dec, &p.rh_dec, &p.cx_dec,
                   &p.c_dec, &p.hdec, &p.y, &p.alpha, &p.ctx, &p.proj, &p.oh};
  auto w = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[i]));
  };
  for (int i = 0; i < 27; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 18; ++i) *out[i] = w(27 + i);
  p.spw = w(45);
  p.spb = w(46);
  p.lm_sp = w(47);
  p.inter_mask = w(48);
  p.hdrop = w(49);
  for (int l = 1; l < p.NL; ++l) {
    const int base = 50 + 5 * (l - 1);
    p.wg[l] = w(base);
    p.bg[l] = w(base + 1);
    p.wcx[l] = w(base + 2);
    p.bc[l] = w(base + 3);
    p.wch[l] = w(base + 4);
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
  tiles = max(tiles, 2 * num_tiles(p.D, p.B));
  tiles = max(tiles, num_tiles(p.A, p.B));
  tiles = max(tiles, num_tiles(p.V, p.B));
  tiles = max(tiles, p.B);
  return launch_cooperative(dec_train_gru_fwd_kernel, p, tiles, stream);
}

// ptrs (in order): transposed weights opwT [V,D], apwT [D,D+E], qwT [A,D],
// layer 0's wchT [D,D], wxT [3D,M] ([W_gx | W_cx]^T) and wghT [2D,D], ipwT
// [M,HID+E], wchlmT [G,G], wghlmT [2G,G]; v [A]; hf, enc, flag|NULL,
// lm_mask|NULL, zeros (as the forward); the forward's saves ru_lm, rh_lm,
// c_lm, hlm, lm_out, x_dec, ru_dec, rh_dec, c_dec, hdec, y, alpha, ctx,
// proj, oh|NULL; dlogits [S,B,V]; step gradients (scratch) dproj [S,B,D],
// dy [S,B,A], dgd [NL,S,B,2D], dcd [NL,S,B,D], dxdec [S,B,M], dgl [S,B,2G],
// dcl [S,B,G]; outputs dtgx [S,B,2G], dtcx [S,B,G], dhf [B,T,A], denc
// [B,T,E], then the 18 weight gradients of the forward's first 18 weights;
// scratch s2 [B,D+E], dv_rows [B,A], dh_dec, dhp_dec [NL,B,D], dh_lm,
// dhp_lm [B,G], dctx [B,E]; then spwT [D,G], the save lm_sp, the step
// gradient dsp [S,B,D] (scratch), inter_mask, the save hdrop, dspw [G,D]
// and dspb [D] (out) (SimpleProjection's all NULL without it; inter_mask
// and hdrop as the forward); then per layer 1..NL-1: wchT [D,D], wxT
// [3D,D], wghT [2D,D], and the gradients of its wg, bg, wcx, bc, wch (out).
// dims as the forward.
E2E_EXPORT int e2e_dec_train_gru_bwd(const void* const* ptrs, int n_ptrs,
                                     const int* dims, cudaStream_t stream) {
  BwdArgs p{};
  int* d[] = {&p.S, &p.B, &p.G, &p.D, &p.M, &p.E, &p.A, &p.V, &p.T, &p.NL};
  set_dims(d, dims);
  if (p.NL < 1 || p.NL > kMaxLayers || n_ptrs != 74 + 8 * (p.NL - 1))
    return cudaErrorInvalidValue;
  const float** in[] = {&p.opwT, &p.apwT, &p.qwT, &p.wchT[0], &p.wxT[0],
                        &p.wghT[0], &p.ipwT, &p.wchlmT, &p.wghlmT, &p.v,
                        &p.hf, &p.enc, &p.flag, &p.lm_mask, &p.zeros,
                        &p.ru_lm, &p.rh_lm, &p.c_lm, &p.hlm, &p.lm_out,
                        &p.x_dec, &p.ru_dec, &p.rh_dec, &p.c_dec, &p.hdec,
                        &p.y, &p.alpha, &p.ctx, &p.proj, &p.oh, &p.dlog};
  float** out[] = {&p.dproj, &p.dy, &p.dgd, &p.dcd, &p.dxdec, &p.dgl,
                   &p.dcl, &p.dtgx, &p.dtcx, &p.dhf, &p.denc};
  auto w = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[i]));
  };
  for (int i = 0; i < 31; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 11; ++i) *out[i] = w(31 + i);
  float* dw[18];
  for (int i = 0; i < 18; ++i) dw[i] = w(42 + i);
  float** scratch[] = {&p.s2, &p.dv_rows, &p.dh_dec, &p.dhp_dec, &p.dh_lm,
                       &p.dhp_lm, &p.dctx};
  for (int i = 0; i < 7; ++i) *scratch[i] = w(60 + i);
  p.spwT = w(67);
  p.lm_sp = w(68);
  p.dsp = w(69);
  p.inter_mask = w(70);
  p.hdrop = w(71);
  float *dspw = w(72), *dspb = w(73);
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
  const float* htop = p.hdec + (NL - 1) * layer;
  const float* lm_in = sp ? p.lm_sp : p.lm_out;
  // X [x1 | x2] (k, row shift), dG, columns, rows, out; x1 null: ones.
  WJob* j = p.jobs;
  // Without sampling (oh NULL) d(EWb) is zero: jobs over no rows.
  const int R_oh = p.oh != nullptr ? R : 0;
  j[0] = {p.oh, V, 0, nullptr, 0, 0, p.dgl, 2 * G, R_oh, dw[0]};
  j[1] = {p.oh, V, 0, nullptr, 0, 0, p.dcl, G, R_oh, dw[1]};
  j[2] = {p.hlm, G, B, nullptr, 0, 0, p.dgl, 2 * G, R, dw[2]};
  j[3] = {p.rh_lm, G, 0, nullptr, 0, 0, p.dcl, G, R, dw[3]};
  j[4] = {lm_in, HID, 0, p.ctx, E, B, p.dxdec, M, R, dw[4]};
  j[5] = {nullptr, 1, 0, nullptr, 0, 0, p.dxdec, M, R, dw[5]};
  j[6] = {htop, D, 0, nullptr, 0, 0, p.dy, A, R, dw[6]};
  j[7] = {nullptr, 1, 0, nullptr, 0, 0, p.dy, A, R, dw[7]};
  j[8] = {nullptr, 1, 0, nullptr, 0, 0, p.dv_rows, A, B, dw[8]};
  j[9] = {htop, D, 0, p.ctx, E, 0, p.dproj, D, R, dw[9]};
  j[10] = {nullptr, 1, 0, nullptr, 0, 0, p.dproj, D, R, dw[10]};
  j[11] = {p.proj, D, 0, nullptr, 0, 0, p.dlog, V, R, dw[11]};
  j[12] = {nullptr, 1, 0, nullptr, 0, 0, p.dlog, V, R, dw[12]};
  int n = 13;
  for (int l = 0; l < NL; ++l) {
    const int base = 74 + 8 * (l - 1);
    float* g[5];
    if (l == 0) {
      for (int i = 0; i < 5; ++i) g[i] = dw[13 + i];
    } else {
      p.wchT[l] = w(base);
      p.wxT[l] = w(base + 1);
      p.wghT[l] = w(base + 2);
      for (int i = 0; i < 5; ++i) g[i] = w(base + 3 + i);
    }
    const float* x = l == 0 ? p.x_dec : p.hdrop + (l - 1) * layer;
    const int Kin = l == 0 ? M : D;
    const float* dgl = p.dgd + 2 * l * layer;
    const float* dcl = p.dcd + l * layer;
    j[n++] = {x, Kin, 0, p.hdec + l * layer, D, B, dgl, 2 * D, R, g[0]};
    j[n++] = {nullptr, 1, 0, nullptr, 0, 0, dgl, 2 * D, R, g[1]};
    j[n++] = {x, Kin, 0, nullptr, 0, 0, dcl, D, R, g[2]};
    j[n++] = {nullptr, 1, 0, nullptr, 0, 0, dcl, D, R, g[3]};
    j[n++] = {p.rh_dec + l * layer, D, 0, nullptr, 0, 0, dcl, D, R, g[4]};
  }
  if (sp) {
    j[n++] = {p.lm_out, G, 0, nullptr, 0, 0, p.dsp, D, R, dspw};
    j[n++] = {nullptr, 1, 0, nullptr, 0, 0, p.dsp, D, R, dspb};
  }
  p.n_jobs = n;
  int tiles = max(num_tiles(D + E, B), num_tiles(M, B) + num_tiles(D, B));
  tiles = max(tiles, 2 * num_tiles(D, B));
  tiles = max(tiles, num_tiles(HID + E, B));
  tiles = max(tiles, num_tiles(G, B));
  tiles = max(tiles, B);
  return launch_cooperative(dec_train_gru_bwd_kernel, p, tiles, stream);
}
