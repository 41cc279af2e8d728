// What the decoder's training kernels share: kernels #8/#9 (LSTM cells,
// dec_train.cu) and #10 (GRU cells, dec_train_gru.cu). Scheduled
// sampling, the backward of the additive attention of one batch row
// (attention.cuh has its forward), and the weight-gradient tiles that end
// each backward. Everything runs inside
// one persistent cooperative launch built from tiles.cuh.
#pragma once

#include "attention.cuh"

namespace {

__device__ __forceinline__ const float* row_prev(const float* save, int t,
                                                 int B, int width,
                                                 const float* zeros) {
  return t > 0 ? save + static_cast<size_t>(t - 1) * B * width : zeros;
}

// Sampled index of row n at step t: argmax over v of logits[t-1] + gum[t],
// lowest index on ties (one warp).
__device__ int sample_row(const float* logits, const float* gum, int t,
                          int n, int B, int V) {
  const int lane = threadIdx.x & 31;
  const float* lg = logits + at(t - 1, n, B, V);
  const float* gm = gum + at(t, n, B, V);
  float best = -INFINITY;
  int idx = V;
  for (int v = lane; v < V; v += 32) {
    const float z = __ldcg(lg + v) + __ldg(gm + v);
    if (z > best || (z == best && v < idx)) {
      best = z;
      idx = v;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  return idx < V ? idx : 0;
}

// The sampled tokens of the kRows rows of a tile whose first row is n0, at
// step t > 0: warp r samples row n0 + r into sidx[r]; the tile whose unit
// block is the first (first_unit) also writes that row's flag-weighted
// one-hot to oh [S,B,V] (the input of the embedding table's gradient).
// Ends with __syncthreads, so sidx is seen by the whole block.
__device__ void sample_tile(const float* logits, const float* gum,
                            const float* flag, float* oh, int t, int n0,
                            int B, int V, bool first_unit, int* sidx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kRows && n0 + warp < B) {
    const int n = n0 + warp;
    const int idx = sample_row(logits, gum, t, n, B, V);
    if (lane == 0) sidx[warp] = idx;
    if (first_unit) {
      const float fl = __ldg(flag + static_cast<size_t>(t) * B + n);
      for (int v = lane; v < V; v += 32)
        oh[at(t, n, B, V) + v] = v == idx ? fl : 0.f;
    }
  }
  __syncthreads();
}

// Backward of attention_row for batch row n at step t, given the context's
// total gradient dctx_a + dctx_b [E] (its two shares: from the output
// projections and from the next step's input projection): accumulates
// d(enc[n]), d(hf[n]) and the row's share of d(v) (dv_rows [B,A]), and
// writes dy[t, n] [A]. The block that owns row n is the only writer of its
// accumulators. smem holds at least E + 2T + 1 floats.
__device__ void attention_row_bwd(const float* hf, const float* enc,
                                  const float* v, const float* y,
                                  const float* alpha, const float* ctx,
                                  const float* dctx_a, const float* dctx_b,
                                  float* dhf, float* denc, float* dv_rows,
                                  float* dy,
                                  int t, int n, int B, int T, int A, int E,
                                  float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dct = smem;      // [E] dctx_total
  float* al = dct + E;    // [T] alpha
  float* ds = al + T;     // [T] dalpha, then ds
  float* inner = ds + T;  // [1]
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    dct[e] = __ldcg(dctx_a + e) + __ldcg(dctx_b + e);
  for (int tt = threadIdx.x; tt < T; tt += blockDim.x)
    al[tt] = __ldg(alpha + at(t, n, B, T) + tt);
  __syncthreads();
  float* den = denc + static_cast<size_t>(n) * T * E;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x)
    den[i] += al[i / E] * dct[i % E];
  for (int tt = warp; tt < T; tt += kWarps) {
    const float* en = enc + (static_cast<size_t>(n) * T + tt) * E;
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s += dct[e] * __ldg(en + e);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) ds[tt] = s;
  }
  if (warp == kWarps - 1) {
    const float* cx = ctx + at(t, n, B, E);
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s += dct[e] * __ldg(cx + e);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) inner[0] = s;
  }
  __syncthreads();
  for (int tt = threadIdx.x; tt < T; tt += blockDim.x)
    ds[tt] = al[tt] * (ds[tt] - inner[0]);
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const float ya = __ldg(y + at(t, n, B, A) + a);
    const float va = __ldg(v + a);
    float dv = 0.f, dya = 0.f;
    for (int tt = 0; tt < T; ++tt) {
      const size_t o = (static_cast<size_t>(n) * T + tt) * A + a;
      const float th = tanhf(__ldg(hf + o) + ya);
      const float dpre = ds[tt] * (va * (1.f - th * th));
      dv += ds[tt] * th;
      dhf[o] += dpre;
      dya += dpre;
    }
    dv_rows[static_cast<size_t>(n) * A + a] += dv;
    dy[at(t, n, B, A) + a] = dya;
  }
  __syncthreads();
}

// One weight gradient dW[k, c] = sum over rows r of X[r, k] * dG[r, c],
// X = [x1 | x2] (k1 + k2 columns; x of row r is row r - shift, zero before
// the first), or a column of ones (bias gradients; x1 null, k1 = 1).
struct WJob {
  const float* x1;
  int k1, shift1;
  const float* x2;
  int k2, shift2;
  const float* g;
  int n, rows;
  float* out;
};

constexpr int kWT = 64, kWD = 16;

// Stacked decoder cells a training kernel takes (the inference kernels'
// cap, dec_step.cu), and the most weight-gradient jobs of a backward: 13
// fixed, 5 a GRU layer (2 an LSTM layer above the first), 2 for
// SimpleProjection.
constexpr int kMaxLayers = 8;
constexpr int kMaxJobs = 13 + 5 * kMaxLayers + 2;

__device__ __forceinline__ float wjob_x(const WJob& j, int r, int k) {
  if (k < j.k1) {
    if (j.x1 == nullptr) return 1.f;
    if (r < j.shift1) return 0.f;
    return __ldcg(j.x1 + static_cast<size_t>(r - j.shift1) * j.k1 + k);
  }
  if (r < j.shift2) return 0.f;
  return __ldcg(j.x2 + static_cast<size_t>(r - j.shift2) * j.k2 + k - j.k1);
}

__device__ __forceinline__ int wjob_tiles(const WJob& j) {
  return (j.k1 + j.k2 + kWT - 1) / kWT * ((j.n + kWT - 1) / kWT);
}

__device__ void wjob_tile(const WJob& j, int tile, float* smem) {
  float* xs = smem;              // [kWD][kWT]
  float* gs = smem + kWD * kWT;  // [kWD][kWT]
  const int K = j.k1 + j.k2, ntiles = (j.n + kWT - 1) / kWT;
  const int m0 = (tile / ntiles) * kWT, c0 = (tile % ntiles) * kWT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int rb = 0; rb < j.rows; rb += kWD) {
    for (int i = threadIdx.x; i < kWD * kWT; i += blockDim.x) {
      const int rr = i / kWT, col = i % kWT, r = rb + rr;
      const bool in = r < j.rows;
      xs[i] = in && m0 + col < K ? wjob_x(j, r, m0 + col) : 0.f;
      gs[i] = in && c0 + col < j.n
                  ? __ldcg(j.g + static_cast<size_t>(r) * j.n + c0 + col)
                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kWD; ++rr) {
      float x[4], g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = xs[rr * kWT + ty + 16 * q];
        g[q] = gs[rr * kWT + tx + 16 * q];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], g[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx + 16 * b;
      if (m < K && c < j.n) j.out[static_cast<size_t>(m) * j.n + c] = acc[a][b];
    }
  }
}

// Every tile of every job, each by one block of the grid: no atomics, a
// fixed order.
__device__ void run_wjobs(const WJob* jobs, int n_jobs, float* smem) {
  int total = 0;
  for (int i = 0; i < n_jobs; ++i) total += wjob_tiles(jobs[i]);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int i = 0, rest = tile;
    while (rest >= wjob_tiles(jobs[i])) rest -= wjob_tiles(jobs[i++]);
    wjob_tile(jobs[i], rest, smem);
  }
}

}  // namespace
