// Kernel #15: the whole beam search of a small batch in ONE launch.
//
// Replaces e2e_asr_tpu/ops/beam_megakernel.py beam_decode_mega (body
// _mega_kernel): up to S steps of select-expand-finalize, stopping once no
// hypothesis of the batch is live, with the semantics of eval/beam.py:
//   1. decoder-LM LSTM -> [SimpleProjection] -> InputProjection([lm_out,
//      context]) -> L decoder LSTMs; the attention query is the top c;
//   2. additive attention over the precomputed hidden features
//      (s = v . tanh(hf + y), masked to NEG_INF, softmax, context);
//   3. AttnProjection([query, context]) -> OutputProjection -> log_softmax;
//   4. the top k of the candidates score + logp of live parents (ties to
//      the lowest flat index parent*V + token, NaN first as in kernel #14),
//      rank r accepted iff r < k - #finished at the start of the step: an
//      accepted <eos> goes to the k-slot finished buffer, the rest are
//      compacted into live slots in rank order, scores stored as
//      val + word_ins_penalty * (t + 1); parent states, context and
//      sequences gathered, the next input the selected token's embedding;
//   5. after the loop, the best of finished u live (ties to the first,
//      finished before live); live lengths are the step count.
// LSTM cells at any depth (up to kMaxLayers), with or without
// SimpleProjection, float32.
//
// Bound on the H100: the serial chain of small dependent stages, not FLOPs
// or bytes. At B=1, k=4 a step is about 12 MFLOP over 6 MB of weights that
// stay in the 50 MB L2 across steps, and every stage needs the one before.
//
// Design: one cooperative persistent launch; a grid barrier between the
// dependent stages (10 + L a step, one more with SimpleProjection), each
// stage spread over the grid:
//   - the products over the N = B*k rows are the 8-row x 32-column tiles of
//     tiles.cuh (the decoder step's kernels #11/#12 use the same);
//   - attention scores: a warp per (row, encoder frame); the softmax and
//     the context: a warp per (row, 128 context columns), each recomputing
//     its row's softmax from the scores;
//   - the selection: warp 0 of block b for utterance b, its k*V candidates
//     in shared memory (the log-softmax of its k rows taken there), k
//     rounds of a strided scan and a shuffle argmax over the candidates
//     ranked after the previous pick; lane 0 does the finished/live
//     bookkeeping and writes the utterance's live flag;
//   - the gather: every thread, from the step's outputs into the state
//     buffers; the sequences ping-pong between two buffers, so the gather
//     never reads what it overwrites.
// After the barrier that ends a step every block reads the live flags and
// all leave the loop together: no block leaves a cooperative loop alone.
// The grid is at most one block per SM. Activations written inside the
// launch are read with __ldcg (L2), weights and inputs with __ldg.
//
// Limits (the wrapper checks them before the route is chosen): k <= 16,
// k*V <= 8192 (the candidates fill the selection block's 32 KB tile
// buffer), 1 <= L <= 8, B <= 64. An optional trace [S, B, k] receives each
// step's k selection values and (parent, token).
#include "tiles.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxBeam = 16;
constexpr int kMaxBatch = 64;
constexpr int kCtxChunk = 128;  // context columns per warp
constexpr unsigned kFull = 0xffffffffu;

struct MegaArgs {
  // inputs
  const float *enc, *hf, *mask, *emb, *attn_v, *lm_w, *lm_b, *sp_w, *sp_b,
      *ip_w, *ip_b, *q_w, *q_b, *ap_w, *ap_b, *out_w, *out_b;
  const float *dec_w[kMaxLayers], *dec_b[kMaxLayers];
  // outputs; the trace pointers may be null
  long long *tokens, *lens;
  float* best;
  float* tr_vals;
  int *tr_parent, *tr_token;
  // beam state, read by a step and rewritten by its gather
  float *lm_c, *lm_h, *dec_c[kMaxLayers], *dec_h[kMaxLayers], *ctx, *inputs,
      *scores;
  int *alive, *seqs[2];
  // the step's outputs
  float *lm_c_new, *lm_h_new, *sp_out, *x_out, *dec_c_new[kMaxLayers],
      *dec_h_new[kMaxLayers], *y, *att, *ctx_new, *proj, *logits;
  // the selection's results and the finished buffer
  int *slot_parent, *slot_token, *fin_seqs, *fin_lens, *fin_count, *live;
  float* fin_scores;
  int B, k, T, Henc, E, Hl, H, A, V, L, S, eos, go, has_sp;
  double penalty;
};

struct SelectShared {
  int idx[kMaxBeam];
  float val[kMaxBeam];
  int fin_slot[kMaxBeam], fin_src[kMaxBeam], fin_tok[kMaxBeam];
  int nfin, best;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ void init_state(const MegaArgs& p) {
  const int N = p.B * p.k;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  auto zero = [&](float* a, int n) {
    for (int i = tid; i < n; i += nth) a[i] = 0.f;
  };
  zero(p.lm_c, N * p.Hl);
  zero(p.lm_h, N * p.Hl);
  for (int l = 0; l < p.L; ++l) {
    zero(p.dec_c[l], N * p.H);
    zero(p.dec_h[l], N * p.H);
  }
  zero(p.ctx, N * p.Henc);
  for (int i = tid; i < N * p.E; i += nth)
    p.inputs[i] = __ldg(p.emb + static_cast<size_t>(p.go) * p.E + i % p.E);
  for (int i = tid; i < N; i += nth) {
    const bool first = i % p.k == 0;
    p.scores[i] = first ? 0.f : e2e::kNegInf;
    p.alive[i] = first;
    p.fin_scores[i] = e2e::kNegInf;
    p.fin_lens[i] = 0;
  }
  for (int i = tid; i < N * p.S; i += nth) {
    p.seqs[0][i] = 0;
    p.fin_seqs[i] = 0;
  }
  for (int i = tid; i < p.B; i += nth) {
    p.fin_count[i] = 0;
    p.live[i] = 1;
  }
}

// s[n, t] = v . tanh(hf[b, t] + y[n]), NEG_INF where the frame is padding:
// a warp per (row, frame).
__device__ void attn_scores(const MegaArgs& p) {
  const int N = p.B * p.k, lane = threadIdx.x & 31;
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < N * p.T;
       w += gridDim.x * kWarps) {
    const int n = w / p.T, t = w % p.T, b = n / p.k;
    const float* hf = p.hf + (static_cast<size_t>(b) * p.T + t) * p.A;
    const float* y = p.y + static_cast<size_t>(n) * p.A;
    float s = 0.f;
    for (int a = lane; a < p.A; a += 32)
      s += __ldg(p.attn_v + a) * tanhf(__ldg(hf + a) + __ldcg(y + a));
    s = warp_sum(s);
    if (lane == 0)
      p.att[w] = __ldg(p.mask + b * p.T + t) > 0.f ? s : e2e::kNegInf;
  }
}

// context[n, c] = sum_t softmax(s[n])_t enc[b, t, c]: a warp per (row,
// 128 columns), each lane 4 columns; the softmax weights are shuffled from
// the lane that computed them.
__device__ void attn_context(const MegaArgs& p) {
  const int N = p.B * p.k, lane = threadIdx.x & 31;
  const int chunks = (p.Henc + kCtxChunk - 1) / kCtxChunk;
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < N * chunks;
       w += gridDim.x * kWarps) {
    const int n = w / chunks, c0 = (w % chunks) * kCtxChunk, b = n / p.k;
    const float* s = p.att + static_cast<size_t>(n) * p.T;
    float m = -INFINITY;
    for (int t = lane; t < p.T; t += 32) m = fmaxf(m, __ldcg(s + t));
    m = warp_max(m);
    float z = 0.f;
    for (int t = lane; t < p.T; t += 32) z += expf(__ldcg(s + t) - m);
    z = warp_sum(z);
    const float* e = p.enc + static_cast<size_t>(b) * p.T * p.Henc;
    float acc[kCtxChunk / 32] = {};
    for (int t0 = 0; t0 < p.T; t0 += 32) {
      const float mine =
          t0 + lane < p.T ? expf(__ldcg(s + t0 + lane) - m) / z : 0.f;
      const int tn = min(32, p.T - t0);
      for (int j = 0; j < tn; ++j) {
        const float a = __shfl_sync(kFull, mine, j);
        const float* row = e + static_cast<size_t>(t0 + j) * p.Henc;
#pragma unroll
        for (int q = 0; q < kCtxChunk / 32; ++q) {
          const int c = c0 + lane + 32 * q;
          if (c < p.Henc) acc[q] = fmaf(a, __ldg(row + c), acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCtxChunk / 32; ++q) {
      const int c = c0 + lane + 32 * q;
      if (c < p.Henc) p.ctx_new[static_cast<size_t>(n) * p.Henc + c] = acc[q];
    }
  }
}

// Step t's selection and bookkeeping for utterance b = blockIdx.x, on warp
// 0 of that block; cand is the block's tile buffer (k*V floats).
__device__ void select_step(const MegaArgs& p, int t, float* cand,
                            SelectShared& sh) {
  if (blockIdx.x >= p.B || threadIdx.x >= 32) return;
  const int b = blockIdx.x, k = p.k, V = p.V, lane = threadIdx.x;
  const int n0 = b * k, KV = k * V;
  for (int r = 0; r < k; ++r) {  // log_softmax of row r, plus its score
    const float* l = p.logits + static_cast<size_t>(n0 + r) * V;
    float m = -INFINITY;
    for (int v = lane; v < V; v += 32) m = fmaxf(m, __ldcg(l + v));
    m = warp_max(m);
    float s = 0.f;
    for (int v = lane; v < V; v += 32) s += expf(__ldcg(l + v) - m);
    const float z = logf(warp_sum(s));
    const bool alive = __ldcg(p.alive + n0 + r) != 0;
    const float score = __ldcg(p.scores + n0 + r);
    for (int v = lane; v < V; v += 32)
      cand[r * V + v] = alive ? score + (__ldcg(l + v) - m - z)
                              : e2e::kNegInf;
  }
  __syncwarp();
  float prev_v = 0.f;
  int prev_i = -1;
  for (int r = 0; r < k; ++r) {  // the r-th pick ranks after pick r-1
    float best = 0.f;
    int bi = -1;
    for (int i = lane; i < KV; i += 32) {
      const float v = cand[i];
      if (e2e::ranks_before(prev_v, prev_i, v, i) || prev_i < 0) {
        if (e2e::ranks_before(v, i, best, bi)) {
          best = v;
          bi = i;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (e2e::ranks_before(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
    // k <= k*V candidates, so every round finds one: bi >= 0, the same in
    // every lane.
    prev_v = best;
    prev_i = bi;
    if (lane == 0) {
      sh.idx[r] = bi;
      sh.val[r] = best;
    }
  }
  __syncwarp();
  if (lane == 0) {
    const int nf = p.fin_count[b];
    const float add = static_cast<float>(p.penalty * (t + 1));
    int fc = nf, live = 0, nfin = 0;
    for (int r = 0; r < k; ++r) {
      const int parent = sh.idx[r] / V, token = sh.idx[r] % V;
      if (p.tr_vals != nullptr) {
        const size_t o = (static_cast<size_t>(t) * p.B + b) * k + r;
        p.tr_vals[o] = sh.val[r];
        p.tr_parent[o] = parent;
        p.tr_token[o] = token;
      }
      if (r >= k - nf) continue;  // not accepted
      const float stored = sh.val[r] + add;
      if (token == p.eos) {
        p.fin_scores[n0 + fc] = stored;
        p.fin_lens[n0 + fc] = t + 1;
        sh.fin_slot[nfin] = fc++;
        sh.fin_src[nfin] = parent;
        sh.fin_tok[nfin++] = token;
      } else {
        p.slot_parent[n0 + live] = parent;
        p.slot_token[n0 + live] = token;
        p.scores[n0 + live] = stored;
        p.alive[n0 + live++] = 1;
      }
    }
    for (int j = live; j < k; ++j) {
      p.slot_parent[n0 + j] = -1;
      p.slot_token[n0 + j] = 0;
      p.scores[n0 + j] = e2e::kNegInf;
      p.alive[n0 + j] = 0;
    }
    p.fin_count[b] = fc;
    p.live[b] = live > 0;
    sh.nfin = nfin;
  }
  __syncwarp();
  // The finished hypotheses' sequences: the parent's, the token at t.
  const int* cur = p.seqs[t & 1];
  for (int f = 0; f < sh.nfin; ++f) {
    const int* src = cur + static_cast<size_t>(n0 + sh.fin_src[f]) * p.S;
    int* dst = p.fin_seqs + static_cast<size_t>(n0 + sh.fin_slot[f]) * p.S;
    for (int i = lane; i < p.S; i += 32)
      dst[i] = i == t ? sh.fin_tok[f] : __ldcg(src + i);
  }
}

// The live slots' state from their parents' step outputs (zeros for the
// empty slots), the next inputs, and the sequences into the other buffer.
__device__ void gather_state(const MegaArgs& p, int t) {
  const int N = p.B * p.k;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  auto src_row = [&](int n) {
    const int parent = __ldcg(p.slot_parent + n);
    return parent < 0 ? -1 : n / p.k * p.k + parent;
  };
  auto rows = [&](float* dst, const float* src, int w) {
    for (int i = tid; i < N * w; i += nth) {
      const int s = src_row(i / w);
      dst[i] = s < 0 ? 0.f : __ldcg(src + static_cast<size_t>(s) * w + i % w);
    }
  };
  rows(p.lm_c, p.lm_c_new, p.Hl);
  rows(p.lm_h, p.lm_h_new, p.Hl);
  for (int l = 0; l < p.L; ++l) {
    rows(p.dec_c[l], p.dec_c_new[l], p.H);
    rows(p.dec_h[l], p.dec_h_new[l], p.H);
  }
  rows(p.ctx, p.ctx_new, p.Henc);
  for (int i = tid; i < N * p.E; i += nth) {
    const int n = i / p.E;
    const size_t token = __ldcg(p.slot_token + n);
    p.inputs[i] =
        src_row(n) < 0 ? 0.f : __ldg(p.emb + token * p.E + i % p.E);
  }
  const int* cur = p.seqs[t & 1];
  int* next = p.seqs[(t + 1) & 1];
  for (int i = tid; i < N * p.S; i += nth) {
    const int n = i / p.S, pos = i % p.S, s = src_row(n);
    next[i] = s < 0 ? 0
                    : pos == t ? __ldcg(p.slot_token + n)
                               : __ldcg(cur + static_cast<size_t>(s) * p.S +
                                        pos);
  }
}

// The best of finished u live for utterance b = blockIdx.x after `steps`
// steps, on warp 0 of that block.
__device__ void finalize(const MegaArgs& p, int steps, SelectShared& sh) {
  if (blockIdx.x >= p.B || threadIdx.x >= 32) return;
  const int b = blockIdx.x, k = p.k, n0 = b * k, lane = threadIdx.x;
  if (lane == 0) {
    float best = 0.f;
    int bi = -1;
    for (int i = 0; i < 2 * k; ++i) {
      const float v =
          i < k ? __ldcg(p.fin_scores + n0 + i)
                : (__ldcg(p.alive + n0 + i - k) ? __ldcg(p.scores + n0 + i - k)
                                                : e2e::kNegInf);
      if (bi < 0 || v > best) {
        best = v;
        bi = i;
      }
    }
    p.best[b] = best;
    p.lens[b] = bi < k ? __ldcg(p.fin_lens + n0 + bi) : steps;
    sh.best = bi;
  }
  __syncwarp();
  const int bi = sh.best;
  const int* src = bi < k ? p.fin_seqs + static_cast<size_t>(n0 + bi) * p.S
                          : p.seqs[steps & 1] +
                                static_cast<size_t>(n0 + bi - k) * p.S;
  for (int i = lane; i < p.S; i += 32)
    p.tokens[static_cast<size_t>(b) * p.S + i] = __ldcg(src + i);
}

__global__ void __launch_bounds__(kThreads) beam_mega_kernel(MegaArgs p) {
  __shared__ float smem[kSmem];
  __shared__ SelectShared sh;
  cg::grid_group grid = cg::this_grid();
  const int N = p.B * p.k;
  init_state(p);
  grid.sync();
  int t = 0;
  for (; t < p.S; ++t) {
    bool any = false;
    for (int b = 0; b < p.B; ++b) any |= __ldcg(p.live + b) != 0;
    if (!any) break;  // the same flags in every block: all leave together
    for (int i = blockIdx.x; i < num_tiles(p.Hl, N); i += gridDim.x)
      lstm_tile(p.inputs, p.E, p.lm_h, p.lm_c, p.Hl, p.lm_w, p.lm_b,
                p.lm_c_new, p.lm_h_new, N, i, smem);
    grid.sync();
    const float* lm_y = p.lm_h_new;
    if (p.has_sp) {
      for (int i = blockIdx.x; i < num_tiles(p.H, N); i += gridDim.x)
        dense_tile(p.lm_h_new, p.Hl, nullptr, 0, p.sp_w, p.sp_b, p.H,
                   p.sp_out, N, i, smem);
      grid.sync();
      lm_y = p.sp_out;
    }
    for (int i = blockIdx.x; i < num_tiles(p.E, N); i += gridDim.x)
      dense_tile(lm_y, p.H, p.ctx, p.Henc, p.ip_w, p.ip_b, p.E, p.x_out, N,
                 i, smem);
    grid.sync();
    const float* x = p.x_out;
    int Kx = p.E;
    for (int l = 0; l < p.L; ++l) {
      for (int i = blockIdx.x; i < num_tiles(p.H, N); i += gridDim.x)
        lstm_tile(x, Kx, p.dec_h[l], p.dec_c[l], p.H, p.dec_w[l], p.dec_b[l],
                  p.dec_c_new[l], p.dec_h_new[l], N, i, smem);
      grid.sync();
      x = p.dec_h_new[l];
      Kx = p.H;
    }
    const float* query = p.dec_c_new[p.L - 1];
    for (int i = blockIdx.x; i < num_tiles(p.A, N); i += gridDim.x)
      dense_tile(query, p.H, nullptr, 0, p.q_w, p.q_b, p.A, p.y, N, i, smem);
    grid.sync();
    attn_scores(p);
    grid.sync();
    attn_context(p);
    grid.sync();
    for (int i = blockIdx.x; i < num_tiles(p.H, N); i += gridDim.x)
      dense_tile(query, p.H, p.ctx_new, p.Henc, p.ap_w, p.ap_b, p.H, p.proj,
                 N, i, smem);
    grid.sync();
    for (int i = blockIdx.x; i < num_tiles(p.V, N); i += gridDim.x)
      dense_tile(p.proj, p.H, nullptr, 0, p.out_w, p.out_b, p.V, p.logits, N,
                 i, smem);
    grid.sync();
    select_step(p, t, smem, sh);
    grid.sync();
    gather_state(p, t);
    grid.sync();
  }
  finalize(p, t, sh);
}

bool set_dims(MegaArgs& p, const int* dims, int n_dims) {
  if (n_dims != 14) return false;
  p.B = dims[0];
  p.k = dims[1];
  p.T = dims[2];
  p.Henc = dims[3];
  p.E = dims[4];
  p.Hl = dims[5];
  p.H = dims[6];
  p.A = dims[7];
  p.V = dims[8];
  p.L = dims[9];
  p.S = dims[10];
  p.eos = dims[11];
  p.go = dims[12];
  p.has_sp = dims[13];
  return p.B >= 1 && p.B <= kMaxBatch && p.k >= 1 && p.k <= kMaxBeam &&
         p.k * p.V <= kSmem && p.L >= 1 && p.L <= kMaxLayers && p.T >= 1 &&
         p.Henc >= 1 && p.E >= 1 && p.Hl >= 1 && p.H >= 1 && p.A >= 1 &&
         p.V >= 1 && p.S >= 1 && p.eos >= 0 && p.eos < p.V && p.go >= 0 &&
         p.go < p.V && (p.has_sp || p.Hl == p.H);
}

// Carves the scratch buffers out of one float and one int allocation (or,
// with null bases, only counts them).
struct Carver {
  float* f;
  int* i;
  long long nf = 0, ni = 0;
  float* floats(long long n) {
    float* r = f == nullptr ? nullptr : f + nf;
    nf += n;
    return r;
  }
  int* ints(long long n) {
    int* r = i == nullptr ? nullptr : i + ni;
    ni += n;
    return r;
  }
};

void carve(MegaArgs& p, Carver& c) {
  const long long N = static_cast<long long>(p.B) * p.k;
  p.lm_c = c.floats(N * p.Hl);
  p.lm_h = c.floats(N * p.Hl);
  p.lm_c_new = c.floats(N * p.Hl);
  p.lm_h_new = c.floats(N * p.Hl);
  for (int l = 0; l < p.L; ++l) {
    p.dec_c[l] = c.floats(N * p.H);
    p.dec_h[l] = c.floats(N * p.H);
    p.dec_c_new[l] = c.floats(N * p.H);
    p.dec_h_new[l] = c.floats(N * p.H);
  }
  p.ctx = c.floats(N * p.Henc);
  p.ctx_new = c.floats(N * p.Henc);
  p.inputs = c.floats(N * p.E);
  p.x_out = c.floats(N * p.E);
  p.sp_out = c.floats(N * p.H);
  p.proj = c.floats(N * p.H);
  p.y = c.floats(N * p.A);
  p.att = c.floats(N * p.T);
  p.logits = c.floats(N * p.V);
  p.scores = c.floats(N);
  p.fin_scores = c.floats(N);
  p.alive = c.ints(N);
  p.seqs[0] = c.ints(N * p.S);
  p.seqs[1] = c.ints(N * p.S);
  p.fin_seqs = c.ints(N * p.S);
  p.fin_lens = c.ints(N);
  p.slot_parent = c.ints(N);
  p.slot_token = c.ints(N);
  p.fin_count = c.ints(p.B);
  p.live = c.ints(p.B);
}

}  // namespace

// dims: B, k, T, Henc, E, Hl, H, A, V, L, S, eos_id, go_id, has_sp.
// counts <- the floats and ints of scratch that e2e_beam_mega needs.
E2E_EXPORT int e2e_beam_mega_scratch(const int* dims, int n_dims,
                                     long long* counts) {
  MegaArgs p{};
  if (!set_dims(p, dims, n_dims)) return cudaErrorInvalidValue;
  Carver c{nullptr, nullptr};
  carve(p, c);
  counts[0] = c.nf;
  counts[1] = c.ni;
  return cudaSuccess;
}

// ptrs: enc [B,T,Henc], hf [B,T,A], mask [B,T], emb [V,E], attn_v [A],
//   lm_w, lm_b, sp_w|NULL, sp_b|NULL, ip_w, ip_b, q_w, q_b, ap_w, ap_b,
//   out_w, out_b, then per decoder layer its kernel and bias, then tokens
//   [B,S] int64, lens [B] int64, scores [B] f32, trace vals [S,B,k] f32,
//   parent and token [S,B,k] int32 (the three NULL without a trace), and
//   the float and int scratch of e2e_beam_mega_scratch's counts.
// dims: as e2e_beam_mega_scratch. penalty: word_ins_penalty.
E2E_EXPORT int e2e_beam_mega(const void* const* ptrs, int n_ptrs,
                             const int* dims, int n_dims, double penalty,
                             cudaStream_t stream) {
  MegaArgs p{};
  if (!set_dims(p, dims, n_dims) || n_ptrs != 25 + 2 * p.L)
    return cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  p.enc = in(0);
  p.hf = in(1);
  p.mask = in(2);
  p.emb = in(3);
  p.attn_v = in(4);
  p.lm_w = in(5);
  p.lm_b = in(6);
  p.sp_w = in(7);
  p.sp_b = in(8);
  p.ip_w = in(9);
  p.ip_b = in(10);
  p.q_w = in(11);
  p.q_b = in(12);
  p.ap_w = in(13);
  p.ap_b = in(14);
  p.out_w = in(15);
  p.out_b = in(16);
  int at = 17;
  for (int l = 0; l < p.L; ++l) {
    p.dec_w[l] = in(at++);
    p.dec_b[l] = in(at++);
  }
  auto out = [&](int i) { return const_cast<void*>(ptrs[i]); };
  p.tokens = static_cast<long long*>(out(at++));
  p.lens = static_cast<long long*>(out(at++));
  p.best = static_cast<float*>(out(at++));
  p.tr_vals = static_cast<float*>(out(at++));
  p.tr_parent = static_cast<int*>(out(at++));
  p.tr_token = static_cast<int*>(out(at++));
  Carver c{static_cast<float*>(out(at)), static_cast<int*>(out(at + 1))};
  carve(p, c);
  p.penalty = penalty;
  if ((p.sp_w == nullptr) == (p.has_sp != 0)) return cudaErrorInvalidValue;
  if ((p.tr_vals == nullptr) != (p.tr_parent == nullptr) ||
      (p.tr_vals == nullptr) != (p.tr_token == nullptr))
    return cudaErrorInvalidValue;

  const int N = p.B * p.k;
  const int chunks = (p.Henc + kCtxChunk - 1) / kCtxChunk;
  int work = max(num_tiles(p.Hl, N), num_tiles(p.H, N));
  work = max(work, max(num_tiles(p.E, N), num_tiles(p.A, N)));
  work = max(work, num_tiles(p.V, N));
  work = max(work, (N * p.T + kWarps - 1) / kWarps);
  work = max(work, (N * chunks + kWarps - 1) / kWarps);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // At most one block per SM, and one per utterance for the selection.
  const int blocks = max(min(work, sms), p.B);
  if (blocks > sms) return cudaErrorInvalidConfiguration;
  return launch_cooperative(beam_mega_kernel, p, blocks, stream);
}
