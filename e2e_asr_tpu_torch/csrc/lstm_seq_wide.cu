// Kernel #4 and the wide form of kernel #5: a unidirectional LSTM wider
// than kernels #3 and #5 take (H > 1024), forward and backward.
//
// #4 replaces e2e_asr_tpu/ops/lstm_pallas.py _fwd_seq_chunked (body
// _fwd_kernel_chunked), which _fwd_seq takes when W_h cannot stay resident
// in VMEM and streams it from HBM in [C, 4H] tiles. It has the three forms
// of that call: inference (h), masked carry-through (a [T,B] validity mask
// whose zero steps keep c and h) and training (h and c of every step, for
// the backward).
// #5's wide form replaces _bwd_seq with emit_dw=False (lstm_pallas.py:841,
// call :975): a reverse-time kernel that emits dgates [T,B,4H] (which is
// dx_proj) with the mask's carry-through of _bwd_step; dW_h = sum over t
// of h_{t-1}^T dgates_t is one matmul outside the kernel, as the JAX
// package does after its Pallas call (:985-1000).
//
// Bound: at H = 1280 a step is [B, 1280] x [1280, 5120] (2 * 128 * 1280 *
// 5120 = 1.7 GFLOP at B = 128, 25 us of float32 FMA at the card's peak)
// and W_h is 26.2 MB of f32, more than one SM's shared memory but less than
// the grid's (132 x 227 KB); the steps are serial.
//
// #4, the "resident" route (H * 160 + 24 KB of shared memory a block fits,
// and ceil(H / 10) blocks fit the card: 1056 <= H <= 1280): ONE persistent
// cooperative launch whose block b keeps W_h's 40 columns of units [10b,
// 10b + 10) in shared memory for the whole sequence (204,800 B at H =
// 1280, 128 blocks: one balanced wave), so no step reads W_h. Each step
// brings h_{t-1} in through cp.async rings of 8-depth chunks, overlapped
// with the FMA on the chunk before; h is kept a second time, transposed
// ([unit][row], two step parities), so that a chunk is one contiguous 4 KB
// copy. The 8 warps split 128 rows x 10 units x the depth two ways each:
// the two depth halves (every other 8 depths) run a 3-stage ring each,
// under a named barrier of 4 warps, and a thread sums 4 rows x 5 units x 4
// gates (80 FMA for 6 16-byte shared loads a depth) over every other depth
// of its half's chunks. The halves meet by a warp shuffle and through
// shared memory, where the gate sums are laid out so that 256 threads
// update the cells with x_proj, h and c read and written in runs of 10
// units of a row, h's transposed copy through shared memory. One grid
// barrier a step. Rows past 128 take further row tiles within the step.
// #4, the "streamed" route (any other H, e.g. 2048, whose W_h exceeds the
// grid's shared memory): ONE persistent cooperative launch, a grid barrier
// between steps. The tile is 8 hidden units x all four of their gate
// columns (32 columns of W_h) x 128 batch rows, so the cell update of a
// unit stays in the thread that summed its four gates. Each step the block
// streams its W_h columns and the rows of h_{t-1} through shared memory in
// chunks of 32 depths, double-buffered: the next chunk's global loads are
// in flight while the current one is multiplied. Each thread accumulates 4
// rows x 4 columns from two 16-byte shared-memory loads a depth (h stored
// depth-major, W_h unit-major).
// #5's wide form, two launches. (1) The gate pre-activations x_proj +
// h_{t-1} W_h of every step, in one tiled product over all T*B rows into
// dx (nothing in it waits on the recurrence): dw.cuh's
// lstm_bwd_gates_kernel, 128 x 128 tiles by cp.async, as #2's pre-pass.
// (2) The reverse walk, dh_{t-1} = dgates_t W_h^T behind each step's cell
// backward (a [B, 4H] x [4H, H] product, 0.84 GFMA at B = 128, H = 1280: 25
// us of float32 FMA a step at the card's peak), by one of two routes that
// this file chooses by H and the card (walk_fits):
// "resident" (H <= 1280 on the H100): clusters of 2 blocks. Cluster i
// owns units [20i, 20i + 20); its block j keeps W_h's rows of those units
// over the gate columns [2jH, 2jH + 2H) in shared memory for the whole walk
// (204,800 B at H = 1280), computes the partial dh of the cluster's units
// over its half of the depth from dgates_t, and the cluster adds the two
// partials of each unit through distributed shared memory. Reckoned a step
// at B = 128, H = 1280: each of the 128 blocks reads its B x 2H floats of
// dgates_t from L2, 168 MB in all (clusters of 4 would read 84 MB, but the
// H100 holds 30 clusters of 4 such blocks, not the 32 that 1280 units
// need; every block reading all of dgates_t, 335 MB); a block that kept
// the gate columns of its own units instead would leave partial sums of B
// x H floats to be reduced over all 128 blocks (84 MB written and read a
// step without clusters, about 5 MB with clusters of 16 but chunked
// through the 22 KB of shared memory its W_h slice leaves).
// "streamed" (wider): one cooperative launch on tiles of 32 units x 128
// rows, W_h streamed from L2 every step, the depth split four ways by gate
// into partial sums and two grid barriers a step.
// Both walks sum in a fixed order (no atomics: the same bits every run).
// H must be a multiple of 8 in the streamed forward, of 16 in the resident
// one and of 32 in the backward (16-byte loads of whole unit groups; whole
// tiles of 32 units), as the JAX package's chunk rule wants H to split into
// tiles of 8 or more (_chunk_size); the wrapper asks 32 of all. The routes
// are chosen here by H (resident_fits, walk_fits);
// e2e_lstm_wide_fwd_plan and e2e_lstm_wide_bwd_plan hand them to the
// wrapper (kernels/lstm_seq.wide_fwd_plan, wide_bwd_plan), which counts
// them.
#include "dw.cuh"
#include "tiles.cuh"

namespace {

constexpr int kUL = 8;                  // unit lanes of a tile
constexpr int kRG = kThreads / kUL;     // 32 row groups
constexpr int kRPT = 4;                 // rows per thread
constexpr int kTR = kRG * kRPT;         // 128 rows a tile
constexpr int kKC = 32;                 // depths a chunk
constexpr int kAS = kTR + 4;            // stride of a depth's rows in smem
constexpr int kWC = 4 * kUL;            // 32 columns a tile

struct alignas(16) TileSmem {
  float a[2][kKC * kAS];  // [depth][row]: 4 rows in one 16-byte load
  float w[2][kKC * kWC];  // [depth][unit lane][group]: 4 groups likewise
};

// One tile of an [rows, K] x [K, 32] product: thread (ux, ry) sums, for its
// rows r = r0 + 4 ry + i (i < 4) and its column groups g (g < 4),
// acc[i][g] = sum over k < K of A(r, k) * W(k, c0 + g * cstride + ux), and
// hands them to ep(row, ux, acc[i]) for each row < rows. A(r, k) is
// A[(r - shift) * lda + k] (zero for r < shift; A null: all zero); W(k, c)
// is W[k * ldw + c], or W[c * ldw + k] when WT. K is a multiple of 4 and
// c0, cstride of 8.
template <bool WT, typename Ep>
__device__ void wide_tile(const float* A, int lda, int K, int shift,
                          int rows, int r0, const float* __restrict__ W,
                          int ldw, int c0, int cstride, TileSmem& sm, Ep ep) {
  const int tid = threadIdx.x, ux = tid % kUL, ry = tid / kUL;
  float acc[kRPT][4];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
  if (A != nullptr) {
    float4 ra[kTR * kKC / 4 / kThreads], rw;
    auto load = [&](int k0) {  // this thread's share of a chunk, to registers
#pragma unroll
      for (int q = 0; q < kTR * kKC / 4 / kThreads; ++q) {
        const int idx = tid + q * kThreads, r = idx / 8, k = k0 + idx % 8 * 4;
        const int row = r0 + r;
        ra[q] = row >= shift && row < rows && k < K
                    ? __ldcg(reinterpret_cast<const float4*>(
                          A + static_cast<size_t>(row - shift) * lda + k))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (WT) {  // a unit's run of 4 depths
        const int j = tid / 8, k = k0 + tid % 8 * 4;
        const int col = c0 + (j / kUL) * cstride + j % kUL;
        rw = k < K ? __ldg(reinterpret_cast<const float4*>(
                         W + static_cast<size_t>(col) * ldw + k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {   // 4 unit lanes of one group at one depth
        const int kk = tid / 8, g = tid / 2 % 4, k = k0 + kk;
        const int col = c0 + g * cstride + tid % 2 * 4;
        rw = k < K ? __ldg(reinterpret_cast<const float4*>(
                         W + static_cast<size_t>(k) * ldw + col))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto store = [&](int b) {  // the registers into buffer b
#pragma unroll
      for (int q = 0; q < kTR * kKC / 4 / kThreads; ++q) {
        const int idx = tid + q * kThreads, r = idx / 8, kk = idx % 8 * 4;
        float* a = sm.a[b] + kk * kAS + r;
        a[0] = ra[q].x;
        a[kAS] = ra[q].y;
        a[2 * kAS] = ra[q].z;
        a[3 * kAS] = ra[q].w;
      }
      const float v[4] = {rw.x, rw.y, rw.z, rw.w};
      if (WT) {
        const int j = tid / 8, kk = tid % 8 * 4;
        float* w = sm.w[b] + (j % kUL) * 4 + j / kUL;
#pragma unroll
        for (int m = 0; m < 4; ++m) w[(kk + m) * kWC] = v[m];
      } else {
        const int kk = tid / 8, g = tid / 2 % 4, u = tid % 2 * 4;
        float* w = sm.w[b] + kk * kWC + g;
#pragma unroll
        for (int m = 0; m < 4; ++m) w[(u + m) * 4] = v[m];
      }
    };
    const int chunks = (K + kKC - 1) / kKC;
    load(0);
    store(0);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) load((c + 1) * kKC);
      const float* a = sm.a[c % 2] + ry * kRPT;
      const float* w = sm.w[c % 2] + ux * 4;
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(a + kk * kAS);
        const float4 w4 = *reinterpret_cast<const float4*>(w + kk * kWC);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < kRPT; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[i][g] = fmaf(av[i], wv[g], acc[i][g]);
      }
      if (c + 1 < chunks) store((c + 1) % 2);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int row = r0 + ry * kRPT + i;
    if (row < rows) ep(row, ux, acc[i]);
  }
}

struct FwdArgs {
  const float *xp, *w, *mask;
  float *h, *c;
  int T, B, H;
  size_t cstep;  // c's stride per step: B*H (training form) or 0 (scratch)
};

__global__ void __launch_bounds__(kThreads) lstm_wide_fwd_kernel(FwdArgs p) {
  __shared__ TileSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, H = p.H, H4 = 4 * H;
  const int utiles = H / kUL;
  const int tiles = utiles * ((B + kTR - 1) / kTR);
  for (int t = 0; t < p.T; ++t) {
    const float* hprev =
        t > 0 ? p.h + static_cast<size_t>(t - 1) * B * H : nullptr;
    const float* cprev = p.c + (t > 0 ? (t - 1) * p.cstep : 0);
    float* cout = p.c + t * p.cstep;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int u0 = (tile % utiles) * kUL, r0 = (tile / utiles) * kTR;
      wide_tile<false>(
          hprev, H, H, 0, B, r0, p.w, H4, u0, H, sm,
          [&](int n, int ux, const float (&s)[4]) {
            const int u = u0 + ux;
            const size_t o = static_cast<size_t>(n) * H + u;
            const float* x = p.xp + (static_cast<size_t>(t) * B + n) * H4 + u;
            const float c0 = t > 0 ? __ldcg(cprev + o) : 0.f;
            const float h0 = t > 0 ? __ldcg(hprev + o) : 0.f;
            float c = c0;
            float h = e2e::lstm_cell(s[0] + __ldg(x), s[1] + __ldg(x + H),
                                     s[2] + __ldg(x + 2 * H),
                                     s[3] + __ldg(x + 3 * H), c);
            if (p.mask != nullptr) {  // carry the state through invalid steps
              const float v = __ldg(p.mask + static_cast<size_t>(t) * B + n);
              c = v * c + (1.f - v) * c0;
              h = v * h + (1.f - v) * h0;
            }
            p.h[static_cast<size_t>(t) * B * H + o] = h;
            cout[o] = c;
          });
    }
    grid.sync();
  }
}

// ---- #4's resident route ----------------------------------------------------

constexpr int kRU = 10;                 // units a block keeps resident
constexpr int kRC = 4 * kRU;            // their 40 columns of W_h
constexpr int kRK = 16;                 // depths of a chunk pair of h_{t-1}
constexpr int kGC = kRK / 2;            // depths a chunk of one half's ring
constexpr int kRS = 3;                  // stages of a ring
constexpr int kRT = 128;                // rows a row tile
constexpr int kGStage = kGC * kRT;      // floats a stage (4 KB)
constexpr int kRStage = 2 * kGStage;    // floats a stage of both rings
constexpr int kGS = kRT + 2;            // row stride of the gate sums
constexpr int kSmemMax = 232448;

__host__ __device__ inline size_t resident_smem(int H) {
  return (static_cast<size_t>(H) * kRC + kRS * kRStage) * sizeof(float);
}

struct ResArgs {
  const float *xp, *w, *mask;
  float *h, *c, *ht;  // ht: h transposed, [2 parities][row tiles][H][128]
  int T, B, H;
  size_t cstep;
};

__global__ void __launch_bounds__(kThreads, 1)
    lstm_wide_fwd_resident_kernel(ResArgs p) {
  extern __shared__ __align__(16) float rsm[];
  cg::grid_group grid = cg::this_grid();
  const int H = p.H, H4 = 4 * H, B = p.B, tid = threadIdx.x;
  float* ws = rsm;                                 // [H][40]
  float* hs = rsm + static_cast<size_t>(H) * kRC;  // ring; then reduction
  const int u0 = blockIdx.x * kRU, nu = min(kRU, H - u0);
  for (int e = tid; e < H * kRC; e += kThreads) {
    const int k = e / kRC, slot = e % kRC / 4, g = e % 4;
    ws[e] = slot < nu ? __ldg(p.w + static_cast<size_t>(k) * H4 + g * H +
                              u0 + slot)
                      : 0.f;
  }
  __syncthreads();
  // Warp (rh, uh, ks): rows 64 rh.., units 5 uh.., depths 8 ks.. of
  // every 16; lane (half, r4): rows 4 r4.. of those, depths of parity half.
  const int warp = tid >> 5, lane = tid & 31;
  const int rh = warp & 1, uh = (warp >> 1) & 1, ks = warp >> 2;
  const int half = lane >> 4, r4 = lane & 15;
  const int rtiles = (B + kRT - 1) / kRT, nch = H / kRK;
  const size_t par_n = static_cast<size_t>(rtiles) * H * kRT;
  for (int t = 0; t < p.T; ++t) {
    const float* hsrc = p.ht + ((t + 1) & 1) * par_n;  // h_{t-1}, step t-1
    float* hdst = p.ht + (t & 1) * par_n;
    for (int tile = 0; tile < rtiles; ++tile) {
      for (int e = tid; e < kRT * 4; e += kThreads) {  // this step's x_proj
        const int n = tile * kRT + e / 4;
        if (n < B)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              p.xp + (static_cast<size_t>(t) * B + n) * H4 + e % 4 * H + u0));
      }
      float acc[4][5][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[i][j][g] = 0.f;
      if (t > 0) {
        // The two depth halves ks run rings of their own (8 depths a
        // chunk: depths 16c + 8ks..), each of 4 warps under a named barrier
        // of its own, so neither waits on the other's chunks.
        const float* src = hsrc + static_cast<size_t>(tile) * H * kRT +
                           ks * kGStage;
        float* ring = hs + ks * kRS * kGStage;
        const int gt = tid & 127;  // thread of the half
        auto stage_in = [&](int c) {
          float* dst = ring + (c % kRS) * kGStage;
          const float* from = src + static_cast<size_t>(c) * kRStage;
          for (int e = gt; e < kGStage / 4; e += 128)
            e2e::copy_async16(dst + 4 * e, from + 4 * e);
        };
#pragma unroll
        for (int c = 0; c < kRS - 1; ++c) {
          if (c < nch) stage_in(c);
          e2e::commit_async();
        }
        for (int c = 0; c < nch; ++c) {
          e2e::wait_async<kRS - 2>();
          // chunk c landed; chunk c - 1's stage is free (4 warps)
          asm volatile("bar.sync %0, 128;" ::"r"(1 + ks) : "memory");
          if (c + kRS - 1 < nch) stage_in(c + kRS - 1);
          e2e::commit_async();
          const float* hb = ring + (c % kRS) * kGStage + rh * 64 + r4 * 4;
          const float* wb = ws + static_cast<size_t>(c * kRK + ks * kGC) * kRC +
                            uh * 20;
#pragma unroll
          for (int kk = 0; kk < kGC / 2; ++kk) {
            const int kl = kk * 2 + half;
            const float4 hv = *reinterpret_cast<const float4*>(hb + kl * kRT);
            const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int j = 0; j < 5; ++j) {
              const float4 wv =
                  *reinterpret_cast<const float4*>(wb + kl * kRC + j * 4);
              const float wg[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int g = 0; g < 4; ++g)
                  acc[i][j][g] = fmaf(hr[i], wg[g], acc[i][j][g]);
            }
          }
        }
        __syncthreads();  // the ring becomes the reduction buffer
      }
      // The two depth halves of a warp meet: half 0 keeps rows 0-1 of its
      // four, half 1 rows 2-3.
      float sum[2][5][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 5; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float mine = half ? acc[2 + r][j][g] : acc[r][j][g];
            const float other = half ? acc[r][j][g] : acc[2 + r][j][g];
            sum[r][j][g] =
                mine + __shfl_xor_sync(0xffffffffu, other, 16);
          }
      // The gate sums of the tile, gs[slot][gate][row] (row stride kGS),
      // in the ring's space: the depth parity ks = 1 writes, ks = 0 adds.
      float* gs = hs;
      if (ks == 1) {
#pragma unroll
        for (int j = 0; j < 5; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<float2*>(
                gs + ((uh * 5 + j) * 4 + g) * kGS + rh * 64 + r4 * 4 +
                2 * half) = make_float2(sum[0][j][g], sum[1][j][g]);
      }
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int j = 0; j < 5; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float2* at = reinterpret_cast<float2*>(
                gs + ((uh * 5 + j) * 4 + g) * kGS + rh * 64 + r4 * 4 +
                2 * half);
            const float2 o = *at;
            *at = make_float2(o.x + sum[0][j][g], o.y + sum[1][j][g]);
          }
      }
      __syncthreads();
      // The cell updates, thread e of (row e / 10, unit slot e % 10) so that
      // the row-major x_proj, h and c move in runs of 10 units: every input
      // first, then the updates and their stores.
      constexpr int kCells = kRT * kRU / kThreads;
      float sg[kCells][4], xin[kCells][4], c0[kCells], h0[kCells],
          vld[kCells];
#pragma unroll
      for (int i = 0; i < kCells; ++i) {
        const int e = tid + i * kThreads, rr = e / kRU, slot = e % kRU;
        const int n = tile * kRT + rr, u = u0 + slot;
        const bool in = slot < nu && n < B;
        const size_t o = static_cast<size_t>(n) * H + u;
        const float* x = p.xp + (static_cast<size_t>(t) * B + n) * H4 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          sg[i][g] = gs[(slot * 4 + g) * kGS + rr];
          xin[i][g] = in ? __ldg(x + g * H) : 0.f;
        }
        c0[i] = in && t > 0 ? p.c[(t - 1) * p.cstep + o] : 0.f;
        h0[i] = in && t > 0 && p.mask != nullptr
                    ? p.h[static_cast<size_t>(t - 1) * B * H + o]
                    : 0.f;
        vld[i] = in && p.mask != nullptr
                     ? __ldg(p.mask + static_cast<size_t>(t) * B + n)
                     : 1.f;
      }
      __syncthreads();  // gs is read; its space takes h transposed
      float* hts = hs;  // [slot][row], row stride kRT + 1
#pragma unroll
      for (int i = 0; i < kCells; ++i) {
        const int e = tid + i * kThreads, rr = e / kRU, slot = e % kRU;
        const int n = tile * kRT + rr;
        float hn = 0.f;
        if (slot < nu && n < B) {
          const size_t o = static_cast<size_t>(n) * H + u0 + slot;
          float c = c0[i];
          hn = e2e::lstm_cell(sg[i][0] + xin[i][0], sg[i][1] + xin[i][1],
                              sg[i][2] + xin[i][2], sg[i][3] + xin[i][3], c);
          const float v = vld[i];  // carry the state through
          c = v * c + (1.f - v) * c0[i];
          hn = v * hn + (1.f - v) * h0[i];
          p.h[static_cast<size_t>(t) * B * H + o] = hn;
          p.c[t * p.cstep + o] = c;
        }
        hts[slot * (kRT + 1) + rr] = hn;
      }
      __syncthreads();
      for (int e = tid; e < nu * kRT; e += kThreads)
        hdst[(static_cast<size_t>(tile) * H + u0 + e / kRT) * kRT + e % kRT] =
            hts[e / kRT * (kRT + 1) + e % kRT];
      __syncthreads();  // the reduction buffer becomes the next tile's ring
    }
    grid.sync();
  }
}

// ---- #5's wide form ---------------------------------------------------------

struct BwdArgs {
  const float *w, *h, *c, *g, *mask;
  float *dx, *dc, *dht;
  float* scratch;  // streamed: part [4,B,H]; resident: dgt [2][tiles][4H][128]
  int T, B, H;
};

// The cell backward's inputs of step t for (row n, unit u): the gate
// pre-activations (in dx until the step's dgates replace them), c_{t-1},
// c_t, the output gradient, the mask, and the carries the step after left
// (dc, and dht, that step's d(h) total, which an invalid step passes on).
struct CellIn {
  float pre[4], c_prev, c_t, g, valid, dc, dht_next, valid_next;
};

__device__ __forceinline__ void cell_in(const BwdArgs& p, int t, int n, int u,
                                        CellIn& in) {
  const int B = p.B, H = p.H;
  const size_t r = static_cast<size_t>(t) * B + n;
  const size_t o = static_cast<size_t>(n) * H + u;
  const float* pre = p.dx + r * 4 * H + u;
#pragma unroll
  for (int q = 0; q < 4; ++q) in.pre[q] = __ldcg(pre + q * H);
  in.c_prev = t > 0 ? __ldg(p.c + (r - B) * H + u) : 0.f;
  in.c_t = __ldg(p.c + r * H + u);
  in.g = __ldg(p.g + r * H + u);
  in.valid = p.mask != nullptr ? __ldg(p.mask + r) : 1.f;
  const bool last = t == p.T - 1;
  in.dc = last ? 0.f : __ldcg(p.dc + o);
  in.dht_next = last ? 0.f : __ldcg(p.dht + o);
  in.valid_next =
      last || p.mask == nullptr ? 1.f : __ldg(p.mask + r + B);
}

// The cell backward of step t for (row n, unit u) from its inputs and dh,
// the product dgates_{t+1} W_h^T at (n, u) (0 at the last step): the
// carried d(h_t) is dh where step t+1 was valid and the passed-through
// total where it was not. Writes dgates * valid to dg and dx[t] (dx_proj)
// and the carries dc and dht.
__device__ __forceinline__ void cell_bwd(const BwdArgs& p, int t, int n,
                                         int u, const CellIn& in, float dh,
                                         float (&dg)[4]) {
  const int B = p.B, H = p.H;
  const size_t o = static_cast<size_t>(n) * H + u;
  const float dh_carry = in.valid_next * dh + (1.f - in.valid_next) *
                                                  in.dht_next;
  const float i = e2e::sigmoid(in.pre[0]), j = tanhf(in.pre[1]);
  const float f = e2e::sigmoid(in.pre[2] + 1.f);
  const float og = e2e::sigmoid(in.pre[3]);
  const float tanh_c = tanhf(in.c_t);
  const float valid = in.valid;
  const float dh_total = in.g * valid + dh_carry;
  const float dc_total =
      dh_total * og * (1.f - tanh_c * tanh_c) + in.dc;
  dg[0] = dc_total * j * i * (1.f - i) * valid;
  dg[1] = dc_total * i * (1.f - j * j) * valid;
  dg[2] = dc_total * in.c_prev * f * (1.f - f) * valid;
  dg[3] = dh_total * tanh_c * og * (1.f - og) * valid;
  float* out = p.dx + (static_cast<size_t>(t) * B + n) * 4 * H + u;
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q * H] = dg[q];
  p.dc[o] = valid * (dc_total * f) + (1.f - valid) * in.dc;
  p.dht[o] = dh_total;
}

// The "streamed" walk (any H, a multiple of 32): dh_{t-1} = dgates_t
// W_h^T on tiles of 32 units x 128 rows, its depth split four ways by gate
// (part[s] = dgates_t[:, sH:(s+1)H] W_h[:, sH:(s+1)H]^T, W_h read along
// its rows); after a grid barrier, one thread a (row, unit) adds the four
// partials in gate order and runs step t-1's cell backward: two grid
// barriers a step.
__global__ void __launch_bounds__(kThreads) lstm_wide_bwd_kernel(BwdArgs p) {
  __shared__ TileSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, H = p.H, H4 = 4 * H;
  const size_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t BH = static_cast<size_t>(B) * H;
  float dg[4];
  CellIn in;
  // The last step's cell backward (no carry).
  for (size_t i = tid; i < BH; i += stride) {
    const int n = static_cast<int>(i / H), u = static_cast<int>(i % H);
    cell_in(p, p.T - 1, n, u, in);
    cell_bwd(p, p.T - 1, n, u, in, 0.f, dg);
  }
  grid.sync();
  const int utiles = H / kWC;
  const int rtiles = (B + kTR - 1) / kTR;
  const int tiles = 4 * utiles * rtiles;
  for (int t = p.T - 1; t >= 1; --t) {
    const float* dgt = p.dx + static_cast<size_t>(t) * B * H4;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int s = tile % 4, rest = tile / 4;
      const int u0 = (rest % utiles) * kWC, r0 = (rest / utiles) * kTR;
      float* part = p.scratch + s * BH;
      wide_tile<true>(
          dgt + s * H, H4, H, 0, B, r0, p.w + s * H, H4, u0, kUL, sm,
          [&](int n, int ux, const float (&acc)[4]) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              part[static_cast<size_t>(n) * H + u0 + g * kUL + ux] = acc[g];
          });
    }
    grid.sync();
    for (size_t i = tid; i < BH; i += stride) {
      const int n = static_cast<int>(i / H), u = static_cast<int>(i % H);
      cell_in(p, t - 1, n, u, in);
      const float dh = __ldcg(p.scratch + i) + __ldcg(p.scratch + BH + i) +
                       __ldcg(p.scratch + 2 * BH + i) +
                       __ldcg(p.scratch + 3 * BH + i);
      cell_bwd(p, t - 1, n, u, in, dh, dg);
    }
    grid.sync();
  }
}

// The "resident" walk: a cooperative launch of clusters of kQ = 2 blocks.
// Cluster i owns the 20 units K_i = [20i, 20i + 20); its block j keeps
// W_h[K_i, jD:(j+1)D] in shared memory for the whole walk (D = 2H gate
// columns; 40H floats, 204,800 B at H = 1280), so no step reads W_h. A
// step t: block j multiplies dgates_t[:, jD:(j+1)D] (its depth, read
// through two cp.async rings from a transposed copy, so that 8 depths x
// 128 rows are one contiguous 4 KB copy) by its slice into a partial
// dh_{t-1} for the cluster's 20 units x 128 rows, on #4's partition (the 8
// warps split rows, outputs and depth two ways each; a thread sums 4 rows
// x 10 outputs from one float4 of dgates and 5 float2 of W_h a depth);
// after a cluster barrier each block adds the two partials of its own 10
// units in rank order through distributed shared memory and runs their
// cell backward (10 units x 128 rows, whose inputs were loaded during the
// product), writing dgates to dx and, transposed, to the copy the next
// step reads. Two cluster barriers (the partials are in; no peer reads
// them any more) and one grid barrier a step; no atomics: the same bits
// every run. Rows past 128 take further row tiles within the step.
constexpr int kWU = 10;                        // units a block owns
constexpr int kQ = 2;                          // blocks a cluster
constexpr int kCells = kRT * kWU / kThreads;   // (row, unit) pairs a thread

__host__ __device__ inline size_t walk_smem(int H) {
  return (static_cast<size_t>(H) * 4 * kWU + kRS * kRStage) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1)
    lstm_wide_bwd_walk_kernel(BwdArgs p) {
  extern __shared__ __align__(16) float rsm[];
  constexpr int NO = kWU * kQ;  // the cluster's units: its product's outputs
  constexpr int NT = NO / 2;   // outputs a thread
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int H = p.H, H4 = 4 * H, B = p.B, tid = threadIdx.x;
  const int j = static_cast<int>(cluster.block_rank());
  const int k0 = static_cast<int>(blockIdx.x) / kQ * NO;  // first unit
  const int nk = min(NO, H - k0);
  const int D = H4 / kQ, c0 = j * D;  // this block's gate columns
  const int u0 = k0 + j * kWU;       // its own units (none past H)
  float* ws = rsm;                   // [D][NO]: W_h[k0 + o, c0 + c]
  float* hs = rsm + static_cast<size_t>(D) * NO;  // rings; partials; dgates
  for (int e = tid; e < NO * D; e += kThreads) {
    const int o = e / D, c = e % D;  // along W_h's rows: coalesced
    ws[c * NO + o] =
        o < nk ? __ldg(p.w + static_cast<size_t>(k0 + o) * H4 + c0 + c) : 0.f;
  }
  // Warp (rh, uh, ks): rows 64 rh.., outputs NT uh.., depths 8 ks.. of
  // every 16; lane (half, r4): rows 4 r4.. of those, depths of parity half.
  const int warp = tid >> 5, lane = tid & 31;
  const int rh = warp & 1, uh = (warp >> 1) & 1, ks = warp >> 2;
  const int half = lane >> 4, r4 = lane & 15;
  const int rtiles = (B + kRT - 1) / kRT, nch = D / kRK;
  const size_t par_n = static_cast<size_t>(rtiles) * H4 * kRT;
  CellIn in[kCells];
  // The cell backward of step t for this block's pairs of row tile `tile`
  // (pair e = tid + i * 256: row e / 10, unit slot e % 10), from `in` and
  // dh, then its dgates transposed into the copy of step t's parity.
  auto cells = [&](int t, int tile, const float (&dh)[kCells]) {
    float* dts = hs;  // [gate * 10 + slot][row], row stride kRT + 1
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int e = tid + i * kThreads, rr = e / kWU, slot = e % kWU;
      const int n = tile * kRT + rr, u = u0 + slot;
      float dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (u < H && n < B) cell_bwd(p, t, n, u, in[i], dh[i], dg);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        dts[(g * kWU + slot) * (kRT + 1) + rr] = dg[g];
    }
    __syncthreads();
    float* dst = p.scratch + (t & 1) * par_n +
                 static_cast<size_t>(tile) * H4 * kRT;
    const int nu = max(0, min(kWU, H - u0));
    for (int e = tid; e < 4 * kWU * kRT; e += kThreads) {
      const int gs = e / kRT, rr = e % kRT, g = gs / kWU, slot = gs % kWU;
      if (slot < nu)
        dst[(static_cast<size_t>(g) * H + u0 + slot) * kRT + rr] =
            dts[gs * (kRT + 1) + rr];
    }
    __syncthreads();  // dts's space becomes the next tile's rings
  };
  auto fetch = [&](int t, int tile) {
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int e = tid + i * kThreads;
      const int n = tile * kRT + e / kWU, u = u0 + e % kWU;
      if (u < H && n < B) cell_in(p, t, n, u, in[i]);
    }
  };

  __syncthreads();  // W_h's slice is in
  const float zero[kCells] = {};
  for (int tile = 0; tile < rtiles; ++tile) {
    fetch(p.T - 1, tile);
    cells(p.T - 1, tile, zero);
  }
  grid.sync();
  for (int t = p.T - 1; t >= 1; --t) {
    const float* src_t = p.scratch + (t & 1) * par_n;
    for (int tile = 0; tile < rtiles; ++tile) {
      fetch(t - 1, tile);  // in flight during the product
      float acc[4][NT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 0; o < NT; ++o) acc[i][o] = 0.f;
      {
        // Depth half ks runs a ring of its own (8 depths a chunk: depths
        // 16c + 8ks.. of the block's D), 4 warps under a named barrier.
        const float* src = src_t + static_cast<size_t>(tile) * H4 * kRT +
                           (static_cast<size_t>(c0) + ks * kGC) * kRT;
        float* ring = hs + ks * kRS * kGStage;
        const int gt = tid & 127;
        auto stage_in = [&](int c) {
          float* dst = ring + (c % kRS) * kGStage;
          const float* from = src + static_cast<size_t>(c) * kRStage;
          for (int e = gt; e < kGStage / 4; e += 128)
            e2e::copy_async16(dst + 4 * e, from + 4 * e);
        };
#pragma unroll
        for (int c = 0; c < kRS - 1; ++c) {
          if (c < nch) stage_in(c);
          e2e::commit_async();
        }
        for (int c = 0; c < nch; ++c) {
          e2e::wait_async<kRS - 2>();
          asm volatile("bar.sync %0, 128;" ::"r"(1 + ks) : "memory");
          if (c + kRS - 1 < nch) stage_in(c + kRS - 1);
          e2e::commit_async();
          const float* hb = ring + (c % kRS) * kGStage + rh * 64 + r4 * 4;
          const float* wb =
              ws + static_cast<size_t>(c * kRK + ks * kGC) * NO + uh * NT;
#pragma unroll
          for (int kk = 0; kk < kGC / 2; ++kk) {
            const int kl = kk * 2 + half;
            const float4 av = *reinterpret_cast<const float4*>(hb + kl * kRT);
            const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int o = 0; o < NT; o += 2) {
              const float2 wv =
                  *reinterpret_cast<const float2*>(wb + kl * NO + o);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[i][o] = fmaf(ar[i], wv.x, acc[i][o]);
                acc[i][o + 1] = fmaf(ar[i], wv.y, acc[i][o + 1]);
              }
            }
          }
        }
        __syncthreads();  // the rings become the partial sums
      }
      // The depth parities of a warp meet (half 0 keeps rows 0-1 of its
      // four, half 1 rows 2-3), then the depth halves ks in shared memory:
      // ps[output][row] (row stride kGS), ks = 1 writes, ks = 0 adds.
      float sum[2][NT];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int o = 0; o < NT; ++o) {
          const float mine = half ? acc[2 + r][o] : acc[r][o];
          const float other = half ? acc[r][o] : acc[2 + r][o];
          sum[r][o] = mine + __shfl_xor_sync(0xffffffffu, other, 16);
        }
      float* ps = hs;
      float2* at = reinterpret_cast<float2*>(ps + rh * 64 + r4 * 4 + 2 * half);
      if (ks == 1) {
#pragma unroll
        for (int o = 0; o < NT; ++o)
          at[(uh * NT + o) * kGS / 2] = make_float2(sum[0][o], sum[1][o]);
      }
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int o = 0; o < NT; ++o) {
          const float2 v = at[(uh * NT + o) * kGS / 2];
          at[(uh * NT + o) * kGS / 2] =
              make_float2(v.x + sum[0][o], v.y + sum[1][o]);
        }
      }
      cluster.sync();  // every block's partials of the tile are in
      float dh[kCells];
#pragma unroll
      for (int i = 0; i < kCells; ++i) {
        const int e = tid + i * kThreads, rr = e / kWU, slot = e % kWU;
        const int at_o = (j * kWU + slot) * kGS + rr;
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < kQ; ++r) s += cluster.map_shared_rank(ps, r)[at_o];
        dh[i] = s;
      }
      cluster.sync();  // no peer reads this block's partials any more
      cells(t - 1, tile, dh);
    }
    grid.sync();
  }
}

// Whether #4's resident route takes width H on the current device: H a
// multiple of 16, W_h's columns of 10 units and the rings within a block's
// shared memory, and ceil(H / 10) such blocks in one wave. *blocks: that
// count.
cudaError_t resident_fits(int H, bool* fits, int* blocks) {
  const size_t smem = resident_smem(H);
  *blocks = (H + kRU - 1) / kRU;
  *fits = false;
  if (H % kRK || smem > static_cast<size_t>(kSmemMax)) return cudaSuccess;
  const auto kernel = lstm_wide_fwd_resident_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  *fits = e == cudaSuccess && *blocks <= per_sm * sms;
  return e;
}

// The resident walk's launch configuration at width H: grid 2 * ceil(H /
// 20), clusters of 2, cooperative (a grid barrier a step).
struct WalkLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
};

cudaError_t walk_launch(int H, WalkLaunch& wl) {
  const size_t smem = walk_smem(H);
  const cudaError_t e = cudaFuncSetAttribute(
      lstm_wide_bwd_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  wl.cfg = {};
  wl.cfg.gridDim = dim3(kQ * ((H + kWU * kQ - 1) / (kWU * kQ)), 1, 1);
  wl.cfg.blockDim = dim3(kThreads, 1, 1);
  wl.cfg.dynamicSmemBytes = smem;
  wl.attr[0].id = cudaLaunchAttributeClusterDimension;
  wl.attr[0].val.clusterDim.x = kQ;
  wl.attr[0].val.clusterDim.y = 1;
  wl.attr[0].val.clusterDim.z = 1;
  wl.attr[1].id = cudaLaunchAttributeCooperative;
  wl.attr[1].val.cooperative = 1;
  wl.cfg.attrs = wl.attr;
  wl.cfg.numAttrs = 2;
  return cudaSuccess;
}

// Whether #5-wide's resident walk takes width H on the current device:
// W_h's slice and the rings within a block's shared memory, and all
// ceil(H / 20) clusters at once. *held: the clusters the card holds at
// once.
cudaError_t walk_fits(int H, bool* fits, int* held) {
  *fits = false;
  *held = 0;
  if (H % kWC || walk_smem(H) > static_cast<size_t>(kSmemMax))
    return cudaSuccess;
  WalkLaunch wl;
  cudaError_t e = walk_launch(H, wl);
  if (e != cudaSuccess) return e;
  wl.cfg.numAttrs = 1;  // the occupancy query takes the cluster shape
  e = cudaOccupancyMaxActiveClusters(held, lstm_wide_bwd_walk_kernel,
                                     &wl.cfg);
  *fits = e == cudaSuccess &&
          wl.cfg.gridDim.x / kQ <= static_cast<unsigned>(*held);
  return e;
}

}  // namespace

// #4's route at width H on the current device (kernels/lstm_seq.
// wide_fwd_plan reads it and hands it back to e2e_lstm_wide_fwd): out =
// {1 if resident else 0, the resident route's blocks, units a block, its
// shared memory a block in bytes}.
E2E_EXPORT int e2e_lstm_wide_fwd_plan(int H, int* out) {
  if (H < kUL || H % kUL || out == nullptr) return cudaErrorInvalidValue;
  bool fits = false;
  int blocks = 0;
  const cudaError_t e = resident_fits(H, &fits, &blocks);
  if (e != cudaSuccess) return e;
  out[0] = fits ? 1 : 0;
  out[1] = blocks;
  out[2] = kRU;
  out[3] = static_cast<int>(resident_smem(H));
  return cudaSuccess;
}

// Kernel #4. x_proj [T,B,4H], w_h [H,4H], mask [T,B] or NULL -> h [T,B,H];
// c: [T,B,H] when save_c (the training form), else a [B,H] scratch.
// resident: the route as e2e_lstm_wide_fwd_plan gave it (1: W_h kept in
// shared memory, ht a [2, ceil(B/128), H, 128] scratch; 0: streamed, H a
// multiple of 8, ht unused).
E2E_EXPORT int e2e_lstm_wide_fwd(const float* xp, const float* w,
                                 const float* mask, float* h, float* c,
                                 int save_c, int T, int B, int H,
                                 int resident, float* ht,
                                 cudaStream_t stream) {
  if (H < kUL || H % kUL || B < 1 || T < 1 || c == nullptr)
    return cudaErrorInvalidValue;
  const size_t cstep = save_c ? static_cast<size_t>(B) * H : 0;
  if (!resident) {
    FwdArgs p{xp, w, mask, h, c, T, B, H, cstep};
    const int tiles = H / kUL * ((B + kTR - 1) / kTR);
    return launch_cooperative(lstm_wide_fwd_kernel, p, tiles, stream);
  }
  bool fits = false;
  int blocks = 0;
  cudaError_t e = resident_fits(H, &fits, &blocks);
  if (e != cudaSuccess) return e;
  if (!fits || ht == nullptr) return cudaErrorInvalidValue;
  ResArgs p{xp, w, mask, h, c, ht, T, B, H, cstep};
  void* kargs[] = {&p};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_wide_fwd_resident_kernel),
      dim3(blocks), dim3(kThreads), kargs, resident_smem(H), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// #5's wide walk at width H on the current device (kernels/lstm_seq.
// wide_bwd_plan reads it and hands the route back to e2e_lstm_wide_bwd):
// out = {1 if resident else 0, blocks a cluster, clusters, units a block,
// shared memory a block in bytes, clusters the card holds at once}.
E2E_EXPORT int e2e_lstm_wide_bwd_plan(int H, int* out) {
  if (H < kWC || H % kWC || out == nullptr) return cudaErrorInvalidValue;
  bool fits = false;
  int held = 0;
  const cudaError_t e = walk_fits(H, &fits, &held);
  if (e != cudaSuccess) return e;
  out[0] = fits ? 1 : 0;
  out[1] = kQ;
  out[2] = (H + kWU * kQ - 1) / (kWU * kQ);
  out[3] = kWU;
  out[4] = static_cast<int>(walk_smem(H));
  out[5] = held;
  return cudaSuccess;
}

// #5's wide form. w_h [H,4H], the forward's h and c [T,B,H], x_proj
// [T,B,4H], the output gradient g [T,B,H], mask [T,B] or NULL -> dx
// [T,B,4H] (dgates); scratch dc, dht [B,H]. H is a multiple of 32.
// resident: the route as e2e_lstm_wide_bwd_plan gave it (1: scratch a [2,
// ceil(B/128), 4H, 128] copy of dgates; 0: streamed, scratch [4,B,H]
// partial sums). Two launches: the gate pre-activations (dw.cuh's tiled
// product over all T*B rows, into dx), then the walk.
E2E_EXPORT int e2e_lstm_wide_bwd(const float* w, const float* h,
                                 const float* c, const float* xp,
                                 const float* g, const float* mask, float* dx,
                                 float* dc, float* dht, float* scratch, int T,
                                 int B, int H, int resident,
                                 cudaStream_t stream) {
  if (H < kWC || H % kWC || B < 1 || T < 1 || B > 65535 ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  e2e::GateArgs ga{};
  ga.job[0] = {h, w, xp, dx};
  ga.R = T * B;
  ga.K = H;
  ga.N = 4 * H;
  ga.shift = B;
  e2e::lstm_bwd_gates_kernel<<<dim3((ga.R + e2e::kTM - 1) / e2e::kTM,
                                    (ga.N + e2e::kTN - 1) / e2e::kTN, 1),
                               256, 0, stream>>>(ga);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  BwdArgs p{w, h, c, g, mask, dx, dc, dht, scratch, T, B, H};
  if (!resident)
    return launch_cooperative(lstm_wide_bwd_kernel, p,
                              4 * (H / kWC) * ((B + kTR - 1) / kTR), stream);
  if (walk_smem(H) > static_cast<size_t>(kSmemMax))
    return cudaErrorInvalidValue;
  WalkLaunch wl;
  e = walk_launch(H, wl);
  if (e != cudaSuccess) return e;
  wl.cfg.stream = stream;
  e = cudaLaunchKernelEx(&wl.cfg, lstm_wide_bwd_walk_kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
