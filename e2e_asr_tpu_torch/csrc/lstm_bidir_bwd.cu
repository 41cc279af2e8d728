// Backward of kernel A: the gradients of one bidirectional LSTM layer.
//
// Replaces e2e_asr_tpu/ops/lstm_pallas.py _bwd_seq_bidir (both directions in
// one launch, e2e_lstm_bwd with n_dirs = 2; body _bwd_kernel_bidir) and
// _bwd_seq (one direction with an optional carry mask, n_dirs = 1): from the
// saved h and c of the training forward (csrc/lstm_bidir.cu) and the output
// gradient g, they give dx_proj [T,B,4H] (= dgates) and dW_h [H,4H] of each
// direction.
//
// Bound on the H100: the reverse-time recurrence. Each step needs the whole
// dh of the step after it, dh_{t-1} = dgates_t . W_h^T, a [B, 4H] x [4H, H]
// product (67 MFLOP a direction at B = 128, H = 256) behind the step
// before; the float32 FMA of all of them (and of the gate recompute and
// dW_h, three such products a row-step) bounds the kernel at 2.3 ms at
// layer 1. One block a (row, direction) chain, as this kernel first was,
// reread W_h (1 MiB at H = 256) from L2 twice a step for a matrix-vector
// product: no W_h element was reused across batch rows, and the grid
// pulled 512 MiB from L2 a step (70 us a step).
//
// Design, in four steps:
// 1. The gate pre-activations x_proj + h_{t-1} . W_h of every step, both
//    directions, in one tiled product over all T*B rows, written into dx
//    (nothing in it waits on the recurrence); the walk reads them there and
//    overwrites them with dgates. dw.cuh's tile_product: 128 x 128 tiles,
//    8 x 8 outputs a thread, stages of 16 depths filled by 4-byte cp.async
//    (the h operand lands transposed), double-buffered; the row tiles on
//    the grid's x, so any T*B.
// 2. W_h's columns re-laid by owner block (a small gather).
// 3. The walk: a cluster of 8 blocks walks a group of Rg batch rows of one
//    direction. Block j owns units [jU, jU + U), U = ceil(H / 8), i.e.
//    4U gate columns. A step: each block runs the cell backward of its
//    (row, unit) pairs, with dc and dh in registers and the step's inputs
//    prefetched a step ahead, writes dgates to dx and keeps its [4U x Rg]
//    slice in shared memory; it multiplies that slice by its own 4U
//    columns of W_h into a share of dh_{t-1} for all 8U units [Rg x 8U]
//    (lanes of 4 rows x 4 units; on the resident route two threads a lane,
//    each over half the depth); one cluster barrier; then each block sums
//    the 8 shares of its own units, in block order, reading its peers'
//    through distributed shared memory (Rg x U floats each, a quarter of
//    what exchanging dgates would move). One cluster barrier a step, no
//    grid barrier; W_h never travels through L2 on the "resident" route,
//    where a block keeps its columns in shared memory for the whole walk
//    (H <= 296: 128 KB at H = 256); wider, the "streamed" route brings them
//    from the re-laid copy every step, 8 depths a chunk by cp.async. Rg is
//    the fewest rows (a multiple of 4) that put every cluster of the launch
//    in one wave: the H100 holds 15 clusters of 8 such blocks at once, so
//    layer 1's two directions of 128 rows walk 20 rows a cluster. The
//    route and Rg are chosen here (choose_walk); e2e_lstm_bwd_plan hands
//    them to the wrapper (kernels/lstm_bidir.bwd_plan), which counts the
//    routes and passes them back to the launch.
// 4. dW_h = sum over the T*B rows of h_{t-1}^T dgates: dw.cuh's partial
//    sums, the same tiled product with its rows split into one wave of
//    blocks, then the partials summed in split order: no atomics, the same
//    bits every run.
// A step whose mask is 0 (leading padding of the flipped sequence) passes
// dh and dc through and gives zero dgates, as the reference's carry-through
// does (lstm_pallas.py:765-766).
#include <cooperative_groups.h>

#include <cstddef>
#include <type_traits>

#include "dw.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;     // blocks a cluster: one direction's W_h
constexpr int kMaxThr = 512;    // threads a block of the walk, at most
constexpr int kSplitThr = 640;  // ... when two threads split a lane's depth
constexpr int kCD = 8;          // depths a streamed chunk of W_h
constexpr int kSmemMax = 232448;

// The walk's partition of H for Rg rows a cluster (choose_walk picks Rg).
struct Plan {
  int U;     // units a block: block j owns [jU, jU + U)
  int D;     // 4U: the depth of a block's product (its own gate columns)
  int K8;    // 8U: the product's width (every unit of the direction)
  int Rg;    // batch rows a cluster walks (a multiple of 4)
  int P;     // lanes of the product: (Rg / 4) row quads x (K8 / 4)
  int S;     // threads a lane (2: each sums half the depth; resident only)
  int thr;   // threads a block
  size_t smem;
};

__host__ __device__ inline Plan make_plan(int H, int Rg, bool resident) {
  Plan p;
  p.U = (H + kCluster - 1) / kCluster;
  p.D = 4 * p.U;
  p.K8 = 8 * p.U;
  p.Rg = Rg;
  p.P = Rg / 4 * (p.K8 / 4);
  p.S = resident && 2 * p.P <= kSplitThr ? 2 : 1;
  p.thr = p.S == 2 ? (2 * p.P + 31) / 32 * 32
                   : min(kMaxThr, max(128, (p.P + 31) / 32 * 32));
  const size_t w = resident ? static_cast<size_t>(p.D) * p.K8
                            : static_cast<size_t>(2) * kCD * p.K8;
  p.smem = (w + static_cast<size_t>(p.D) * Rg +
            static_cast<size_t>(2) * p.K8 * Rg) *
           sizeof(float);
  return p;
}

// ---- 1. the gate pre-activations over all T*B rows -------------------------

struct GateJob {
  const float *h, *w, *x;  // h [R,K] (row r read from r - shift), w [K,N]
  float* out;              // x_proj [R,N] plus the product
};

struct GateArgs {
  GateJob job[2];
  int R, K, N, shift;
};

// out[r, n] = x[r, n] + sum over k < K of h[r - shift, k] * w[k, n] (h's
// row r - shift is zero for r < shift: h_{-1} = 0), one fixed-order sum
// an output; grid (R / 128, N / 128, jobs): the row tiles on x, which
// takes any T*B.
__global__ void __launch_bounds__(256, 2) lstm_bwd_gates_kernel(GateArgs a) {
  __shared__ __align__(16) e2e::RowTile s;
  const GateJob jb = blockIdx.z ? a.job[1] : a.job[0];
  const int m0 = blockIdx.x * e2e::kTM, n0 = blockIdx.y * e2e::kTN;
  const int tid = threadIdx.x, hr = m0 + tid / e2e::kTK;
  const int wn = n0 + tid % e2e::kTN;
  float acc[8][8] = {};
  // Thread tid copies, for q < 8: h's row hr + 16q at depth k0 + tid % 16
  // (landing transposed) and w's row k0 + tid / 128 + 2q at column wn.
  auto stage_in = [&](int k0, int buf) {
    const int k = k0 + tid % e2e::kTK;
    const float* hp = jb.h + (static_cast<ptrdiff_t>(hr) - a.shift) * a.K + k;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int m = hr + 16 * q;
      const bool in = m < a.R && m >= a.shift && k < a.K;
      e2e::copy_async4(&s.a[buf][tid % e2e::kTK][tid / e2e::kTK + 16 * q],
                       in ? hp + static_cast<size_t>(16 * q) * a.K : jb.h,
                       in);
    }
    const int wk = k0 + tid / e2e::kTN;
    const float* wp = jb.w + static_cast<size_t>(wk) * a.N + wn;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool in = wk + 2 * q < a.K && wn < a.N;
      e2e::copy_async4(&s.b[buf][tid / e2e::kTN + 2 * q][tid % e2e::kTN],
                       in ? wp + static_cast<size_t>(2 * q) * a.N : jb.w, in);
    }
    e2e::commit_async();
  };
  e2e::tile_product(s, 0, (a.K + e2e::kTK - 1) / e2e::kTK, stage_in, acc);
  e2e::tile_store(m0, n0, a.R, a.N, acc, [&](int row, int col, float v) {
    const size_t o = static_cast<size_t>(row) * a.N + col;
    jb.out[o] = v + __ldg(jb.x + o);
  });
}

// ---- 2 and 3. the walk -----------------------------------------------------

// Block j's own gate columns of W_h, transposed: wt[j][c][k] = W_h[k, col]
// for c = g * U + u (col = g * H + jU + u), k < 8U; zero past H.
// grid (., n_dirs).
__global__ void lstm_bwd_layout_kernel(const float* w0, const float* w1,
                                       float* wt0, float* wt1, int H,
                                       Plan pl) {
  const float* w = blockIdx.y ? w1 : w0;
  float* wt = blockIdx.y ? wt1 : wt0;
  const int U = pl.U, D = pl.D, K8 = pl.K8;
  const size_t n = static_cast<size_t>(kCluster) * D * K8;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e % K8);
    const size_t rest = e / K8;
    const int c = static_cast<int>(rest % D), j = static_cast<int>(rest / D);
    const int u = j * U + c % U;
    wt[e] = k < H && u < H
                ? w[static_cast<size_t>(k) * 4 * H + (c / U) * H + u]
                : 0.f;
  }
}

struct WalkDir {
  const float *wt, *c, *g, *mask;  // mask may be null (all valid)
  float* dx;                       // in: gate pre-activations; out: dgates
};

struct WalkArgs {
  WalkDir dir[2];
  int T, B, H;
  Plan pl;
};

// S: threads a product lane (2: each sums half the depth); a thread runs
// the cell backward of 2 / S (row, unit) pairs (Rg * U = 2P). RES: the
// resident route. grid (8 * row groups, n_dirs), clusters of 8 along x,
// pl.thr >= S * P threads.
template <int S, bool RES>
__global__ void __launch_bounds__(S == 2 ? kSplitThr : kMaxThr, 1)
    lstm_bwd_walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int PP = 2 / S;
  cg::cluster_group cluster = cg::this_cluster();
  const Plan pl = a.pl;
  const int U = pl.U, D = pl.D, K8 = pl.K8, Rg = pl.Rg, P = pl.P;
  const int H = a.H, H4 = 4 * H, B = a.B, tid = threadIdx.x;
  const int nthr = blockDim.x;
  const WalkDir d = blockIdx.y ? a.dir[1] : a.dir[0];
  const int j = static_cast<int>(cluster.block_rank());
  const int r0 = static_cast<int>(blockIdx.x / kCluster) * Rg;
  float* w = sm;  // RES: [D][K8]; streamed: 2 x [kCD][K8]
  float* dgs = w + (RES ? static_cast<size_t>(D) * K8
                        : static_cast<size_t>(2) * kCD * K8);  // [D][Rg]
  float* part = dgs + static_cast<size_t>(D) * Rg;            // 2 x [Rg][K8]
  const float* wt = d.wt + static_cast<size_t>(j) * D * K8;
  if (RES) {
    const int n4 = D * K8 / 4;
    for (int i = tid; i < n4; i += nthr)
      reinterpret_cast<float4*>(w)[i] =
          __ldg(reinterpret_cast<const float4*>(wt) + i);
  }

  // The (row, unit) pairs of this thread: p = tid + i * nthr, unit p % U,
  // row p / U (consecutive threads move consecutive floats of dx, c, g).
  float dc[PP], dhc[PP], dht[PP], vld[PP];
  float pre[PP][4], ct[PP], cprev[PP], gt[PP], mk[PP];
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    dc[i] = 0.f;
    dhc[i] = 0.f;
    dht[i] = 0.f;
    vld[i] = 1.f;
  }
  auto pair = [&](int i, int& b, int& uu, int& r, int& u) {
    const int p = tid + i * nthr;
    u = p % U;
    r = p / U;
    b = r0 + r;
    uu = j * U + u;
    return p < Rg * U && b < B && uu < H;
  };
  auto fetch_cell = [&](int t) {  // the cell backward's inputs of step t
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      int b, uu, r, u;
      if (!pair(i, b, uu, r, u)) continue;
      const size_t row = static_cast<size_t>(t) * B + b;
      const float* x = d.dx + row * H4 + uu;
#pragma unroll
      for (int q = 0; q < 4; ++q) pre[i][q] = __ldcg(x + q * H);
      ct[i] = __ldg(d.c + row * H + uu);
      cprev[i] = t > 0 ? __ldg(d.c + (row - B) * H + uu) : 0.f;
      gt[i] = __ldg(d.g + row * H + uu);
      mk[i] = d.mask != nullptr ? __ldg(d.mask + row) : 1.f;
    }
  };

  fetch_cell(a.T - 1);
  __syncthreads();
  for (int t = a.T - 1;; --t) {
    // Cell backward of step t: dgates into dx and this block's dgs.
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      int b, uu, r, u;
      const bool ok = pair(i, b, uu, r, u);
      if (tid + i * nthr >= Rg * U) continue;
      if (!ok) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dgs[(q * U + u) * Rg + r] = 0.f;
        continue;
      }
      const float ig = e2e::sigmoid(pre[i][0]), jg = tanhf(pre[i][1]);
      const float fg = e2e::sigmoid(pre[i][2] + 1.f);
      const float og = e2e::sigmoid(pre[i][3]);
      const float tanh_c = tanhf(ct[i]);
      const float v = mk[i];
      const float dh_total = gt[i] * v + dhc[i];
      const float dct = dh_total * og * (1.f - tanh_c * tanh_c) + dc[i];
      const float dg[4] = {dct * jg * ig * (1.f - ig) * v,
                           dct * ig * (1.f - jg * jg) * v,
                           dct * cprev[i] * fg * (1.f - fg) * v,
                           dh_total * tanh_c * og * (1.f - og) * v};
      float* out = d.dx + (static_cast<size_t>(t) * B + b) * H4 + uu;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[q * H] = dg[q];
        dgs[(q * U + u) * Rg + r] = dg[q];
      }
      dht[i] = dh_total;
      vld[i] = v;
      dc[i] = v * (dct * fg) + (1.f - v) * dc[i];
    }
    if (t == 0) break;
    fetch_cell(t - 1);
    __syncthreads();  // dgs complete

    // This block's share of dh_{t-1} for every unit of the direction:
    // part[row][k] = sum over its own columns c of dgates_t[row, c] W_h[k,
    // c]; lane (rq, kq) sums rows 4rq.. x units 4kq.., four depths' loads
    // ahead of their FMA.
    float* pt = part + (t & 1) * K8 * Rg;
    const int nrq = Rg / 4;
    const int slice = S == 2 ? tid / P : 0, pos = tid - slice * P;
    const bool lane = slice < S && pos < P;
    const int rq = pos % nrq, kq = pos / nrq;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
    // depths [c0, c0 + n) from W_h's rows at wrow (stride K8)
    auto depths = [&](const float* wrow, int c0, int n) {
      const float* dp = dgs + c0 * Rg + rq * 4;
      const float* wp = wrow + kq * 4;
      auto run = [&](auto depth, int c) {  // `depth` depths from c
        constexpr int nd = decltype(depth)::value;
        float4 dv[nd], wv[nd];
#pragma unroll
        for (int q = 0; q < nd; ++q) {
          dv[q] = *reinterpret_cast<const float4*>(dp + (c + q) * Rg);
          wv[q] = *reinterpret_cast<const float4*>(
              wp + static_cast<size_t>(c + q) * K8);
        }
#pragma unroll
        for (int q = 0; q < nd; ++q) {
          const float dr[4] = {dv[q].x, dv[q].y, dv[q].z, dv[q].w};
          const float wk[4] = {wv[q].x, wv[q].y, wv[q].z, wv[q].w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y)
              acc[x][y] = fmaf(dr[x], wk[y], acc[x][y]);
        }
      };
      int c = 0;
      for (; c + 8 <= n; c += 8) run(std::integral_constant<int, 8>{}, c);
      if (c < n) run(std::integral_constant<int, 4>{}, c);
    };
    if constexpr (RES) {  // with S = 2, slice 0 takes depths [0, half)
      const int half = S == 2 ? D / 8 * 4 : D, c0 = slice == 0 ? 0 : half;
      if (lane)
        depths(w + static_cast<size_t>(c0) * K8, c0,
               slice == 0 ? half : D - half);
    } else {
      // W_h's own columns from device memory, kCD depths a chunk, through
      // a double buffer filled by cp.async.
      const int nch = (D + kCD - 1) / kCD;
      auto stage_in = [&](int q) {
        const int n4 = min(kCD, D - q * kCD) * K8 / 4;
        const float* from = wt + static_cast<size_t>(q) * kCD * K8;
        float* to = w + (q & 1) * kCD * K8;
        for (int e = tid; e < n4; e += nthr)
          e2e::copy_async16(to + 4 * e, from + 4 * e);
        e2e::commit_async();
      };
      stage_in(0);
      for (int q = 0; q < nch; ++q) {
        e2e::wait_async<0>();
        __syncthreads();  // chunk q landed; chunk q - 1's buffer is free
        if (q + 1 < nch) stage_in(q + 1);
        if (lane)
          depths(w + (q & 1) * kCD * K8, q * kCD, min(kCD, D - q * kCD));
      }
    }
    float4* at = reinterpret_cast<float4*>(pt + rq * 4 * K8 + kq * 4);
    if (lane && !(S == 2 && slice == 0)) {  // with S = 2: second halves
#pragma unroll
      for (int x = 0; x < 4; ++x)
        at[x * K8 / 4] =
            make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    }
    if constexpr (S == 2) {  // then the first halves add theirs
      __syncthreads();
      if (lane && slice == 0) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float4 o = at[x * K8 / 4];
          at[x * K8 / 4] = make_float4(o.x + acc[x][0], o.y + acc[x][1],
                                       o.z + acc[x][2], o.w + acc[x][3]);
        }
      }
    }
    cluster.sync();  // every block's share of step t is written

    // dh carried into step t-1 for this block's pairs: the eight shares,
    // summed in block order, where step t was valid; the passed-through
    // dh_total where it was not.
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      int b, uu, r, u;
      if (!pair(i, b, uu, r, u)) continue;
      float share[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        share[q] = cluster.map_shared_rank(pt, q)[r * K8 + j * U + u];
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) sum += share[q];
      dhc[i] = vld[i] * sum + (1.f - vld[i]) * dht[i];
    }
  }
  cluster.sync();  // no block leaves while a peer may read its shares
}

// The walk's kernel for a plan.
using WalkKernel = void (*)(WalkArgs);

WalkKernel walk_kernel(const Plan& pl, bool resident) {
  if (pl.S == 2) return lstm_bwd_walk_kernel<2, true>;
  return resident ? lstm_bwd_walk_kernel<1, true>
                  : lstm_bwd_walk_kernel<1, false>;
}

cudaError_t launch_walk(const WalkArgs& wa, bool resident, int groups,
                        int n_dirs, cudaStream_t stream) {
  const WalkKernel kernel = walk_kernel(wa.pl, resident);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(wa.pl.smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * groups, n_dirs, 1);
  cfg.blockDim = dim3(wa.pl.thr, 1, 1);
  cfg.dynamicSmemBytes = wa.pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, wa);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The walk's route and rows at width H for B rows of n_dirs directions on
// the current device. The route, by H alone: resident where a block's own
// columns of W_h fit its shared memory at 16 rows a cluster, else
// streamed. The rows a cluster walks: the fewest (a multiple of 4) that
// put n_dirs * ceil(B / Rg) clusters within what the card holds at once,
// within the route's shared memory and one product lane a thread.
cudaError_t choose_walk(int H, int B, int n_dirs, bool* resident, Plan* pl,
                        int* clusters) {
  *resident = make_plan(H, 16, true).smem <= static_cast<size_t>(kSmemMax);
  int cap = 4;
  for (int rg = 8; rg <= 32; rg += 4) {
    const Plan p = make_plan(H, rg, *resident);
    if (p.smem <= static_cast<size_t>(kSmemMax) && p.P <= kMaxThr) cap = rg;
  }
  const Plan p16 = make_plan(H, 16, *resident);
  const WalkKernel kernel = walk_kernel(p16, *resident);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p16.smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(p16.thr, 1, 1);
  cfg.dynamicSmemBytes = p16.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  const int want = (n_dirs * B + max(1, *clusters) - 1) / max(1, *clusters);
  const int rg = min(cap, min((want + 3) / 4 * 4, (B + 3) / 4 * 4));
  *pl = make_plan(H, rg, *resident);
  return cudaSuccess;
}

}  // namespace

// The backward walk's plan at width H for B rows of n_dirs directions on
// the current device, as choose_walk picks it (kernels/lstm_bidir.bwd_plan
// reads it and hands the route and rows back to e2e_lstm_bwd): out = {1 if
// resident else 0, rows a cluster (Rg), row groups, units a block (U),
// threads a product lane (S), threads a block, shared memory a block in
// bytes, clusters the card holds at once at 16 rows}.
E2E_EXPORT int e2e_lstm_bwd_plan(int H, int B, int n_dirs, int* out) {
  if (H < 1 || H > 1024 || B < 1 || B > 65535 || n_dirs < 1 || n_dirs > 2 ||
      out == nullptr)
    return cudaErrorInvalidValue;
  bool resident = false;
  Plan pl;
  int clusters = 0;
  const cudaError_t e = choose_walk(H, B, n_dirs, &resident, &pl, &clusters);
  if (e != cudaSuccess) return e;
  const int v[8] = {resident ? 1 : 0, pl.Rg, (B + pl.Rg - 1) / pl.Rg,
                    pl.U, pl.S, pl.thr, static_cast<int>(pl.smem), clusters};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}

// ptrs: per direction (n_dirs of them) w [H,4H], h [T,B,H], c [T,B,H],
// x_proj [T,B,4H], g [T,B,H], mask [T,B] or NULL, dx [T,B,4H] (out),
// dw [H,4H] (out), part [splits,H,4H] (scratch), wt [8, 4U, 8U] (scratch:
// W_h in the walk's layout). resident (1: W_h kept in shared memory; 0:
// streamed) and rows (a multiple of 4) as e2e_lstm_bwd_plan gave them.
E2E_EXPORT int e2e_lstm_bwd(const void* const* ptrs, int n_dirs, int T, int B,
                            int H, int splits, int resident, int rows,
                            cudaStream_t stream) {
  if (n_dirs < 1 || n_dirs > 2 || H < 1 || H > 1024 || B < 1 ||
      B > 65535 || T < 1 || splits < 1 || splits > 65535 || rows < 4 ||
      rows % 4)
    return cudaErrorInvalidValue;
  const Plan pl = make_plan(H, rows, resident != 0);
  if (pl.smem > static_cast<size_t>(kSmemMax) || pl.S * pl.P > pl.thr)
    return cudaErrorInvalidValue;
  auto in = [&](int d, int i) {
    return static_cast<const float*>(ptrs[10 * d + i]);
  };
  auto out = [&](int d, int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[10 * d + i]));
  };
  const int R = T * B, H4 = 4 * H;
  // 1. Gate pre-activations into dx.
  GateArgs ga{};
  for (int d = 0; d < n_dirs; ++d)
    ga.job[d] = {in(d, 1), in(d, 0), in(d, 3), out(d, 6)};
  ga.R = R;
  ga.K = H;
  ga.N = H4;
  ga.shift = B;
  lstm_bwd_gates_kernel<<<dim3((R + e2e::kTM - 1) / e2e::kTM,
                               (H4 + e2e::kTN - 1) / e2e::kTN, n_dirs),
                          256, 0, stream>>>(ga);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // 2 and 3. W_h in the walk's layout, then the walk.
  lstm_bwd_layout_kernel<<<dim3(128, n_dirs), 256, 0, stream>>>(
      in(0, 0), in(n_dirs - 1, 0), out(0, 9), out(n_dirs - 1, 9), H, pl);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  WalkArgs wa{};
  for (int d = 0; d < n_dirs; ++d)
    wa.dir[d] = {in(d, 9), in(d, 2), in(d, 4), in(d, 5), out(d, 6)};
  wa.T = T;
  wa.B = B;
  wa.H = H;
  wa.pl = pl;
  e = launch_walk(wa, resident != 0, (B + rows - 1) / rows, n_dirs, stream);
  if (e != cudaSuccess) return e;
  // 4. dW_h = sum over rows of h_{t-1}^T dgates (h shifted by one step):
  // dw.cuh's partial sums over `splits` row ranges, summed in split order.
  e2e::DwJobs da{};
  for (int d = 0; d < n_dirs; ++d)
    da.job[d] = {in(d, 1), out(d, 6), B, H, H4, out(d, 8), out(d, 7)};
  da.n = n_dirs;
  da.R = R;
  da.splits = splits;
  return e2e::launch_dw(da, stream);
}
