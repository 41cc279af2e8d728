// Kernel A (#1): forward of both directions of one bidirectional LSTM layer.
//
// Replaces e2e_asr_tpu/ops/lstm_pallas.py _fwd_bidir (lstm_seq_bidir's
// forward, no dropout) and, as e2e_lstm_bidir_fwd_train, its
// residual-saving training form _lstm_seq_bidir_fwd, which also writes the
// cell state c of every step for the backward (csrc/lstm_bidir_bwd.cu).
// Inputs are the precomputed input projections x@W_x + b of both
// directions (the backward one of the time-flipped sequence), the
// recurrent kernels W_h [H,4H] and the validity mask of the flipped
// sequence, whose zero steps carry the backward direction's (c, h) through.
//
// Bound on the H100: the recurrence. Each step needs the whole h_{t-1}, a
// [rows x H] x [H x 4H] product (67 MFLOP a direction at layer 1's B =
// 128, H = 256) behind the step before. One block a (row, direction)
// chain, as this kernel first was, reread all of W_h (1 MiB at H = 256)
// from L2 every step for a matrix-vector product: no weight was reused
// across batch rows, 132 MiB of L2 reads a step in one wave, 30.7 us a
// step at layer 1.
//
// Design: a cluster of NC blocks walks a group of Rg batch rows of one
// direction. Block j owns units [jU, jU + U), U = ceil(H / NC), i.e. their
// 4U gate columns of W_h over the whole depth. On the "resident" route
// (H <= 320: 128 KiB at H = 256) it keeps them in shared memory for the
// whole walk; wider, on the "streamed" route, it brings them in every step
// by cp.async, kCD depths a chunk, double buffered. A step:
// 1. h_{t-1} of all NC * U units for the Rg rows: every block's [U x Rg]
//    slice, read from its shared memory through distributed shared memory;
// 2. the product: lane (row group, unit) sums RL rows x the unit's 4 gates
//    over the depth (RL = 4, or 1 where a lane a row fits the block, as at
//    the serving shape), S threads a lane each over a slice of it, their
//    partial sums met in shared memory and added in slice order: the
//    slices and the order of the one-block chain this walk replaced
//    (lstm_fwd.cuh, which kernel #3 keeps), so the walk gives its bits;
// 3. the cells, the lane's RL rows shared by its first min(S, RL)
//    threads, with c in registers and the inputs (x_proj and the carry
//    mask) in shared memory, copied there by cp.async a step ahead;
// 4. the block's [U x Rg] slice of h_t published into a double-buffered
//    slot of its shared memory, and one cluster barrier, split: after its
//    arrive the block writes h (and c in the training form) out, then
//    waits. The slot written at step t + 2 was last read by the peers at
//    step t + 1, before that step's arrive.
// No grid barrier, no atomics: each gate's sum runs over the depth in a
// fixed order, so two calls give the same bits. Rg is the fewest rows (a
// multiple of 4) that put every cluster of the launch in one wave: the
// H100 holds 15 clusters of 8 such blocks, so layer 1's 2 x 128 chains walk
// 20 rows a cluster. NC is 16 where 4 rows a cluster already put the
// launch in one wave (the serving shape's 2 x 8 chains: 4 clusters of 16),
// else 8. choose_fwd picks the route, NC and Rg; e2e_lstm_bidir_fwd_plan
// hands them to the wrapper (kernels/lstm_bidir.fwd_plan), which counts the
// routes and passes the cluster size and rows back to the launch.
// What bounds a step now: at layer 1 the product's shared-memory reads (two
// 16-byte loads, eight wavefronts, a warp and depth for 16 FMA) take most
// of it; at the serving shape the serial parts (the gather, the cell, the
// barrier) do.
#include <cooperative_groups.h>

#include <cstddef>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThr = 640;       // threads a block, at most
constexpr int kCD = 16;            // depths a streamed chunk of W_h
constexpr int kRouteRows = 4;      // rows at which the route is decided
constexpr int kSmemMax = 232448;

// The walk's partition for NC blocks a cluster and Rg rows a cluster.
struct Plan {
  int NC;    // blocks a cluster
  int U;     // units a block: block j owns [jU, jU + U)
  int Hp;    // NC * U: the product's depth (H and zero rows past it)
  int Rg;    // batch rows a cluster walks (a multiple of 4)
  int RL;    // rows a lane: 4, or 1 where a lane a row fits the block
  int L;     // product lanes: Rg / RL row groups x U units
  int S;     // threads a lane, each over a slice of the depth
  int thr;   // threads a block
  size_t smem;
};

// W_h's columns, h_{t-1} [Hp][Rg], the two slots [U][Rg], the slices'
// partial sums [S][4 RL][L] (none at S = 1) and two steps' cell inputs
// [2][5 RL][L] (L * RL = Rg * U).
size_t smem_bytes(int Hp, int U, int Rg, int S, bool resident) {
  const size_t w = resident ? static_cast<size_t>(Hp) * 4 * U
                            : static_cast<size_t>(2) * kCD * 4 * U;
  const size_t cells = static_cast<size_t>(Rg) * U;
  return (w + static_cast<size_t>(Hp) * Rg + 2 * cells +
          (S > 1 ? S * 4 * cells : 0) + 10 * cells) *
         sizeof(float);
}

// S: the depth slices of the chain this walk replaced (lstm_fwd.cuh's
// fwd_slices: 4 up to H = 256, fewer wider), so that each gate's sum runs
// in that chain's order and the walk gives its bits. RL: one row a lane
// where that fits kMaxThr threads (the serving shape's few rows: more
// threads, shorter chains of FMA a thread), else 4.
Plan make_plan(int H, int NC, int Rg, bool resident) {
  Plan p;
  p.NC = NC;
  p.U = (H + NC - 1) / NC;
  p.Hp = NC * p.U;
  p.Rg = Rg;
  p.S = max(1, min(4, 1024 / ((H + 31) / 32 * 32)));
  p.RL = (p.S * Rg * p.U + 31) / 32 * 32 <= kMaxThr ? 1 : 4;
  p.L = Rg / p.RL * p.U;
  p.thr = (p.S * p.L + 31) / 32 * 32;
  p.smem = smem_bytes(p.Hp, p.U, Rg, p.S, resident);
  return p;
}

bool fits(const Plan& p) {
  return p.smem <= static_cast<size_t>(kSmemMax) && p.thr <= kMaxThr;
}

// The route, by H alone: resident where a block's columns of W_h fit its
// shared memory beside kRouteRows rows in clusters of 8 (H <= 320).
bool resident_route(int H) { return fits(make_plan(H, 8, kRouteRows, true)); }

// The cluster barrier in its two halves: arrive (releasing this thread's
// writes, the published slot among them) and wait (acquiring the peers').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct FwdDir {
  const float *xp, *w, *mask;  // mask null: every step valid
  float *h, *c;                // c null: the inference form
};

struct FwdArgs {
  FwdDir dir[2];
  int T, B, H;
  Plan pl;
};

// RES: the resident route; RL: rows a lane (pl.RL). grid (NC * row groups,
// 2 directions), clusters of NC blocks along x, pl.thr threads.
template <bool RES, int RL>
__global__ void __launch_bounds__(kMaxThr, 1)
    lstm_bidir_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const Plan pl = a.pl;
  const int NC = pl.NC, U = pl.U, U4 = 4 * pl.U, Hp = pl.Hp, Rg = pl.Rg;
  const int L = pl.L, S = pl.S;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * a.H;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const FwdDir d = blockIdx.y ? a.dir[1] : a.dir[0];
  const int j = static_cast<int>(cluster.block_rank());
  const int r0 = static_cast<int>(blockIdx.x) / NC * Rg;
  // W_h's own columns, [depth][U][4 gates]: the depths below H (RES) or two
  // chunks of kCD depths.
  float* w = sm;
  float* hb = w + (RES ? static_cast<size_t>(Hp) * U4
                       : static_cast<size_t>(2) * kCD * U4);  // [Hp][Rg]
  float* slot = hb + static_cast<size_t>(Hp) * Rg;  // 2 x [U][Rg]: h_t
  float* part = slot + 2 * U * Rg;                  // [S][4 RL][L]
  float* xs = part + (S > 1 ? S : 0) * 4 * RL * L;  // [2][5 RL][L]

  // Depths [k0, k0 + n) of this block's columns into `to`, zero past H;
  // consecutive threads on consecutive units of a gate.
  auto stage = [&](float* to, int k0, int n) {
    for (int e = tid; e < n * U4; e += nthr) {
      const int u = e % U, g = e / U % 4, kk = e / U4;
      const int k = k0 + kk, uu = j * U + u;
      const bool in = k < H && uu < H;
      e2e::copy_async4(to + (kk * U + u) * 4 + g,
                       in ? d.w + static_cast<size_t>(k) * H4 + g * H + uu
                          : d.w,
                       in);
    }
    e2e::commit_async();
  };

  // This thread's lane (RL rows RL rq.. x unit u, 4 gates each) and its
  // slice s of the depth. The first R slices of a lane run its cells:
  // slice s the rows s, s + R, ..., with their c and h in registers.
  const int s = tid / L, lane = tid - s * L;
  const int R = min(S, RL);
  const bool active = s < S, cell = s < R;
  const int u = lane % U, rq = lane / U, uu = j * U + u;
  const int per = (H + S - 1) / S;  // depths past H are zero: not summed
  const int kb = min(H, s * per), ke = min(H, kb + per);

  float c[RL], h[RL];
#pragma unroll
  for (int k = 0; k < RL; ++k) c[k] = h[k] = 0.f;
  // The cell's inputs of step t into xs[t & 1] by cp.async (a cell thread
  // reads only what it copied): x_proj of its rows x 4 gates, zero past B
  // and H, then the rows' mask, zero past B.
  auto fetch = [&](int t) {
    float* to = xs + (t & 1) * 5 * RL * L + lane;
#pragma unroll
    for (int k = 0; k < RL; ++k) {
      const int i = s + k * R;
      if (i >= RL) break;
      const int b = r0 + RL * rq + i;
      const size_t at = static_cast<size_t>(t) * B + b;
      const bool in = b < B && uu < H;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        e2e::copy_async4(to + (4 * i + g) * L,
                         in ? d.xp + at * H4 + g * H + uu : d.xp, in);
      if (d.mask != nullptr)
        e2e::copy_async4(to + (4 * RL + i) * L, b < B ? d.mask + at : d.mask,
                         b < B);
    }
    e2e::commit_async();
  };

  if (RES) stage(w, 0, H);
  for (int e = tid; e < Hp * Rg; e += nthr) hb[e] = 0.f;  // h_{-1} = 0
  if (cell) fetch(0);
  if (RES) e2e::wait_async<0>();
  __syncthreads();

  const int n4 = U * Rg / 4;  // float4s of a block's slot
  for (int t = 0; t < T; ++t) {
    if (cell && t + 1 < T) fetch(t + 1);  // a step ahead
    if (!RES) stage(w, 0, min(kCD, H));  // the first chunk, in flight early
    if (t > 0) {
      // 1. h_{t-1}: block q's slot lands at hb[qU * Rg ..]; four reads
      // through distributed shared memory in flight a thread.
      const float* from = slot + ((t - 1) & 1) * U * Rg;
      for (int e0 = tid; e0 < NC * n4; e0 += 4 * nthr) {
        float4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = e0 + q * nthr, peer = e / n4;
          if (e < NC * n4)
            v[q] = reinterpret_cast<const float4*>(
                cluster.map_shared_rank(from, peer))[e - peer * n4];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (e0 + q * nthr < NC * n4)
            reinterpret_cast<float4*>(hb)[e0 + q * nthr] = v[q];
      }
      __syncthreads();
    }

    // 2. acc[i][g] = sum over this slice's depths k of h_{t-1}[row RL rq
    // + i, k] * W_h[k, g * H + uu], in depth order, eight depths' loads
    // ahead of their FMA.
    float acc[RL][4];
#pragma unroll
    for (int i = 0; i < RL; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
    // depths [k, kend) from W_h's rows at wrows (depth koff first)
    auto depths = [&](const float* wrows, int koff, int k, int kend) {
      const float* hp = hb + RL * rq;
      const float* wp = wrows + 4 * u;
      auto load = [&](int kk, float (&hr)[RL], float4& wv) {
        if constexpr (RL == 4) {
          const float4 v = *reinterpret_cast<const float4*>(hp + kk * Rg);
          hr[0] = v.x;
          hr[1] = v.y;
          hr[2] = v.z;
          hr[3] = v.w;
        } else {
          hr[0] = hp[kk * Rg];
        }
        wv = *reinterpret_cast<const float4*>(wp + (kk - koff) * U4);
      };
      auto fma_depth = [&](const float (&hr)[RL], const float4& wv) {
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          acc[i][0] = fmaf(hr[i], wv.x, acc[i][0]);
          acc[i][1] = fmaf(hr[i], wv.y, acc[i][1]);
          acc[i][2] = fmaf(hr[i], wv.z, acc[i][2]);
          acc[i][3] = fmaf(hr[i], wv.w, acc[i][3]);
        }
      };
      for (; k + 8 <= kend; k += 8) {
        float hv[8][RL];
        float4 wv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) load(k + q, hv[q], wv[q]);
#pragma unroll
        for (int q = 0; q < 8; ++q) fma_depth(hv[q], wv[q]);
      }
      for (; k < kend; ++k) {
        float hv[RL];
        float4 wv;
        load(k, hv, wv);
        fma_depth(hv, wv);
      }
    };
    if constexpr (RES) {
      if (active) depths(w, 0, kb, ke);
    } else {  // each slice over its part of every chunk
      const int nch = (H + kCD - 1) / kCD;
      for (int q = 0; q < nch; ++q) {
        e2e::wait_async<0>();
        __syncthreads();  // chunk q landed; chunk q - 1's buffer is free
        if (q + 1 < nch)
          stage(w + ((q + 1) & 1) * kCD * U4, (q + 1) * kCD,
                min(kCD, H - (q + 1) * kCD));
        const int lo = max(kb, q * kCD), hi = min(ke, (q + 1) * kCD);
        if (active && lo < hi) depths(w + (q & 1) * kCD * U4, q * kCD, lo, hi);
      }
    }
    if (S > 1) {  // every slice's sums to shared memory
      if (active) {
#pragma unroll
        for (int e = 0; e < 4 * RL; ++e)
          part[(s * 4 * RL + e) * L + lane] = acc[e / 4][e % 4];
      }
      __syncthreads();
    }

    // 3. and 4. The cells of this thread's rows, h_t published; then the
    // barrier's arrive, h (and c) written out while the peers arrive.
    if (cell) {
      if (t + 1 < T)  // this step's inputs landed (the next step's may not)
        e2e::wait_async<1>();
      else
        e2e::wait_async<0>();
      const float* x = xs + (t & 1) * 5 * RL * L + lane;
#pragma unroll
      for (int k = 0; k < RL; ++k) {
        const int i = s + k * R;
        if (i >= RL) break;
        float gate[4];  // the slices' sums, added in slice order
        if (S == 1) {
#pragma unroll
          for (int g = 0; g < 4; ++g) gate[g] = acc[k][g];  // i == k
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g) gate[g] = 0.f;
#pragma unroll 4
          for (int q = 0; q < S; ++q) {  // four loads in flight a slice
            const float* p = part + (q * 4 * RL + 4 * i) * L + lane;
#pragma unroll
            for (int g = 0; g < 4; ++g) gate[g] += p[g * L];
          }
        }
        float nc = c[k];
        float nh = e2e::lstm_cell(x[4 * i * L] + gate[0],
                                  x[(4 * i + 1) * L] + gate[1],
                                  x[(4 * i + 2) * L] + gate[2],
                                  x[(4 * i + 3) * L] + gate[3], nc);
        if (d.mask != nullptr) {  // carry the state through invalid steps
          const float v = x[(4 * RL + i) * L];
          nc = v * nc + (1.f - v) * c[k];
          nh = v * nh + (1.f - v) * h[k];
        }
        c[k] = nc;
        h[k] = nh;
        slot[(t & 1) * U * Rg + u * Rg + RL * rq + i] = nh;
      }
    }
    cluster_arrive();
    if (cell) {
#pragma unroll
      for (int k = 0; k < RL; ++k) {
        const int i = s + k * R, b = r0 + RL * rq + i;
        if (i >= RL) break;
        if (b < B && uu < H) {
          const size_t at = (static_cast<size_t>(t) * B + b) * H + uu;
          d.h[at] = h[k];
          if (d.c != nullptr) d.c[at] = c[k];
        }
      }
    }
    cluster_wait();  // every block's slice of h_t is published
  }
}

using FwdKernel = void (*)(FwdArgs);

FwdKernel fwd_kernel(const Plan& pl, bool resident) {
  if (pl.RL == 1)
    return resident ? lstm_bidir_fwd_kernel<true, 1>
                    : lstm_bidir_fwd_kernel<false, 1>;
  return resident ? lstm_bidir_fwd_kernel<true, 4>
                  : lstm_bidir_fwd_kernel<false, 4>;
}

// A launch of `groups` row groups for the plan; attr: the cluster's
// dimension, kept by the caller.
cudaLaunchConfig_t fwd_config(const Plan& pl, int groups,
                              cudaLaunchAttribute* attr,
                              cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.NC * groups, 2, 1);
  cfg.blockDim = dim3(pl.thr, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t prepare(FwdKernel kernel, const Plan& pl) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.smem));
  if (e == cudaSuccess && pl.NC > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// The clusters of this plan the current device holds at once.
cudaError_t held(const Plan& pl, bool resident, int* clusters) {
  const FwdKernel kernel = fwd_kernel(pl, resident);
  cudaError_t e = prepare(kernel, pl);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = fwd_config(pl, 1, attr, nullptr);
  cfg.gridDim = dim3(pl.NC, 1, 1);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

bool valid_shape(int T, int B, int H) {
  return H >= 1 && H <= 1024 && B >= 1 && B <= 65535 && T >= 1;
}

// The walk's route and partition at width H for B rows of both directions
// on the current device: clusters of 16 blocks at 4 rows a cluster where
// that puts every cluster of the launch on the card at once (the serving
// shape's short, latency-bound steps, where half the units a block shorten
// each step); else clusters of 8 at the fewest rows (a multiple of 4) that
// put the launch's 2 * ceil(B / Rg) clusters within what the card holds at
// once (up to 32, within the shared memory and kMaxThr threads; no more
// than B needs).
cudaError_t choose_fwd(int H, int B, bool* resident, Plan* pl,
                       int* clusters) {
  *resident = resident_route(H);
  const Plan p16 = make_plan(H, 16, 4, *resident);
  if (fits(p16)) {
    int n = 0;
    const cudaError_t e = held(p16, *resident, &n);
    if (e != cudaSuccess) return e;
    if (2 * ((B + 3) / 4) <= n) {
      *pl = p16;
      *clusters = n;
      return cudaSuccess;
    }
  }
  bool found = false;
  for (int rg = 4; rg <= 32; rg += 4) {
    const Plan p = make_plan(H, 8, rg, *resident);
    if (!fits(p)) break;  // more rows only need more
    int n = 0;
    const cudaError_t e = held(p, *resident, &n);
    if (e != cudaSuccess) return e;
    *pl = p;
    *clusters = n;
    found = true;
    if (2 * ((B + rg - 1) / rg) <= n || rg >= B) break;
  }
  return found ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_fwd(const float* xp_fw, const float* xp_bw,
                       const float* w_fw, const float* w_bw,
                       const float* mask_bw, float* h_fw, float* h_bw,
                       float* c_fw, float* c_bw, int T, int B, int H,
                       int cluster, int rows, cudaStream_t stream) {
  if (!valid_shape(T, B, H) || (cluster != 8 && cluster != 16) ||
      rows < 4 || rows % 4)
    return cudaErrorInvalidValue;
  const bool resident = resident_route(H);
  const Plan pl = make_plan(H, cluster, rows, resident);
  if (!fits(pl)) return cudaErrorInvalidValue;
  const FwdKernel kernel = fwd_kernel(pl, resident);
  cudaError_t e = prepare(kernel, pl);
  if (e != cudaSuccess) return e;
  FwdArgs a{};
  // Padding leads in the flipped sequence: the bw chain carries its state
  // through it.
  a.dir[0] = {xp_fw, w_fw, nullptr, h_fw, c_fw};
  a.dir[1] = {xp_bw, w_bw, mask_bw, h_bw, c_bw};
  a.T = T;
  a.B = B;
  a.H = H;
  a.pl = pl;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      fwd_config(pl, (B + rows - 1) / rows, attr, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The walk's plan at width H for B rows of both directions on the current
// device, as choose_fwd picks it (kernels/lstm_bidir.fwd_plan reads it and
// hands the cluster size and rows back to the launch): out = {1 if
// resident else 0, rows a cluster (Rg), row groups, units a block (U),
// threads a lane (S), threads a block, shared memory a block in bytes,
// clusters of the plan the card holds at once, blocks a cluster, rows a
// lane}.
E2E_EXPORT int e2e_lstm_bidir_fwd_plan(int H, int B, int* out) {
  if (!valid_shape(1, B, H) || out == nullptr) return cudaErrorInvalidValue;
  bool resident = false;
  Plan pl;
  int clusters = 0;
  const cudaError_t e = choose_fwd(H, B, &resident, &pl, &clusters);
  if (e != cudaSuccess) return e;
  const int v[10] = {resident ? 1 : 0, pl.Rg, (B + pl.Rg - 1) / pl.Rg,
                     pl.U, pl.S, pl.thr, static_cast<int>(pl.smem),
                     clusters, pl.NC, pl.RL};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return cudaSuccess;
}

// x_proj_fw/bw [T,B,4H], w_h_fw/bw [H,4H], mask_bw [T,B] -> h_fw, h_bw
// [T,B,H]; cluster (8 or 16) and rows as e2e_lstm_bidir_fwd_plan gave them.
E2E_EXPORT int e2e_lstm_bidir_fwd(const float* xp_fw, const float* xp_bw,
                                  const float* w_fw, const float* w_bw,
                                  const float* mask_bw, float* h_fw,
                                  float* h_bw, int T, int B, int H,
                                  int cluster, int rows,
                                  cudaStream_t stream) {
  return launch_fwd(xp_fw, xp_bw, w_fw, w_bw, mask_bw, h_fw, h_bw, nullptr,
                    nullptr, T, B, H, cluster, rows, stream);
}

// The training form: as e2e_lstm_bidir_fwd, and also c_fw, c_bw [T,B,H].
E2E_EXPORT int e2e_lstm_bidir_fwd_train(const float* xp_fw, const float* xp_bw,
                                        const float* w_fw, const float* w_bw,
                                        const float* mask_bw, float* h_fw,
                                        float* h_bw, float* c_fw, float* c_bw,
                                        int T, int B, int H, int cluster,
                                        int rows, cudaStream_t stream) {
  if (c_fw == nullptr || c_bw == nullptr) return cudaErrorInvalidValue;
  return launch_fwd(xp_fw, xp_bw, w_fw, w_bw, mask_bw, h_fw, h_bw, c_fw,
                    c_bw, T, B, H, cluster, rows, stream);
}
