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
// grid's shared memory) and #5's wide form: ONE persistent cooperative
// launch per direction, grid barriers between the dependent stages. The
// forward's tile is 8 hidden units x all four of their gate columns (32
// columns of W_h) x 128 batch rows, so the cell update of a unit stays in
// the thread that summed its four gates. Each step the block streams its
// W_h columns and the rows of h_{t-1} through shared memory in chunks of 32
// depths, double-buffered: the next chunk's global loads are in flight
// while the current one is multiplied. Each thread accumulates 4 rows x 4
// columns from two 16-byte shared-memory loads a depth (h stored
// depth-major, W_h unit-major).
// The backward first recomputes every step's gate pre-activations
// x_proj + h_{t-1} W_h in one pass over all T*B rows (nothing in it waits
// on the recurrence), then walks time in reverse. A step is dh_{t-1} =
// dgates_t W_h^T on the same tiles, split four ways along its depth 4H by
// gate (32 units x 128 rows a tile, W_h read along its rows), into partial
// sums; after a barrier, one thread a (row, unit) adds the four partials
// and runs the cell backward of step t-1: two grid barriers a step.
// H must be a multiple of 8 in the streamed forward, of 16 in the resident
// one and of 32 in the backward (16-byte loads of whole unit groups; whole
// tiles of 32 units), as the JAX package's chunk rule wants H to split into
// tiles of 8 or more (_chunk_size); the wrapper asks 32 of all. The route
// is chosen here by H (resident_fits); e2e_lstm_wide_fwd_plan hands it to
// the wrapper (kernels/lstm_seq.wide_fwd_plan), which counts it.
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

struct BwdArgs {
  const float *w, *h, *c, *xp, *g, *mask;
  float *dx, *dc, *dht, *part;
  int T, B, H;
};

// The cell backward of step t for (row n, unit u), given the carried
// d(h_t) from step t+1: reads the gate pre-activations in dx[t], writes
// dgates * valid there (dx_proj), and updates the carries dc and dht (this
// step's d(h) total, which an invalid step t+1 passed through).
__device__ void wide_cell_bwd(const BwdArgs& p, int t, int n, int u,
                              float dh_carry) {
  const int B = p.B, H = p.H;
  const size_t r = static_cast<size_t>(t) * B + n;
  const size_t o = static_cast<size_t>(n) * H + u;
  float* pre = p.dx + r * 4 * H + u;
  const float i = e2e::sigmoid(__ldcg(pre)), j = tanhf(__ldcg(pre + H));
  const float f = e2e::sigmoid(__ldcg(pre + 2 * H) + 1.f);
  const float og = e2e::sigmoid(__ldcg(pre + 3 * H));
  const float c_prev = t > 0 ? __ldg(p.c + (r - B) * H + u) : 0.f;
  const float tanh_c = tanhf(__ldg(p.c + r * H + u));
  const float valid = p.mask != nullptr ? __ldg(p.mask + r) : 1.f;
  const float dc_carry = t < p.T - 1 ? __ldcg(p.dc + o) : 0.f;
  const float dh_total = __ldg(p.g + r * H + u) * valid + dh_carry;
  const float dc_total =
      dh_total * og * (1.f - tanh_c * tanh_c) + dc_carry;
  pre[0] = dc_total * j * i * (1.f - i) * valid;
  pre[H] = dc_total * i * (1.f - j * j) * valid;
  pre[2 * H] = dc_total * c_prev * f * (1.f - f) * valid;
  pre[3 * H] = dh_total * tanh_c * og * (1.f - og) * valid;
  p.dc[o] = valid * (dc_total * f) + (1.f - valid) * dc_carry;
  p.dht[o] = dh_total;
}

__global__ void __launch_bounds__(kThreads) lstm_wide_bwd_kernel(BwdArgs p) {
  __shared__ TileSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, H = p.H, H4 = 4 * H, R = p.T * B;
  const size_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t BH = static_cast<size_t>(B) * H;
  // 1. The gate pre-activations of every step into dx: x_proj + h_{t-1}
  // W_h over all T*B rows (h_{-1} = 0: row r reads h's row r - B).
  {
    const int utiles = H / kUL;
    const int tiles = utiles * ((R + kTR - 1) / kTR);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int u0 = (tile % utiles) * kUL, r0 = (tile / utiles) * kTR;
      wide_tile<false>(
          p.h, H, H, B, R, r0, p.w, H4, u0, H, sm,
          [&](int r, int ux, const float (&s)[4]) {
            const size_t o = static_cast<size_t>(r) * H4 + u0 + ux;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              p.dx[o + g * H] = s[g] + __ldg(p.xp + o + g * H);
          });
    }
  }
  grid.sync();
  // 2. The last step's cell backward (no carry).
  for (size_t i = tid; i < BH; i += stride)
    wide_cell_bwd(p, p.T - 1, static_cast<int>(i / H),
                  static_cast<int>(i % H), 0.f);
  grid.sync();
  // 3. Reverse time. dh_{t-1} = dgates_t W_h^T, its depth split by gate s:
  // part[s] = dgates_t[:, sH:(s+1)H] W_h[:, sH:(s+1)H]^T on tiles of 32
  // units x 128 rows; then per (row, unit) the sum and step t-1's cell
  // backward.
  const int utiles = H / kWC;
  const int rtiles = (B + kTR - 1) / kTR;
  const int tiles = 4 * utiles * rtiles;
  for (int t = p.T - 1; t >= 1; --t) {
    const float* dg = p.dx + static_cast<size_t>(t) * B * H4;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int s = tile % 4, rest = tile / 4;
      const int u0 = (rest % utiles) * kWC, r0 = (rest / utiles) * kTR;
      float* part = p.part + s * BH;
      wide_tile<true>(
          dg + s * H, H4, H, 0, B, r0, p.w + s * H, H4, u0, kUL, sm,
          [&](int n, int ux, const float (&acc)[4]) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              part[static_cast<size_t>(n) * H + u0 + g * kUL + ux] = acc[g];
          });
    }
    grid.sync();
    for (size_t i = tid; i < BH; i += stride) {
      const int n = static_cast<int>(i / H), u = static_cast<int>(i % H);
      const float valid =
          p.mask != nullptr ? __ldg(p.mask + static_cast<size_t>(t) * B + n)
                            : 1.f;
      const float dh = __ldcg(p.part + i) + __ldcg(p.part + BH + i) +
                       __ldcg(p.part + 2 * BH + i) +
                       __ldcg(p.part + 3 * BH + i);
      wide_cell_bwd(p, t - 1, n, u,
                    valid * dh + (1.f - valid) * __ldcg(p.dht + i));
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

// #5's wide form. w_h [H,4H], the forward's h and c [T,B,H], x_proj
// [T,B,4H], the output gradient g [T,B,H], mask [T,B] or NULL -> dx
// [T,B,4H] (dgates); scratch dc, dht [B,H] and part [4,B,H]. H is a
// multiple of 32.
E2E_EXPORT int e2e_lstm_wide_bwd(const float* w, const float* h,
                                 const float* c, const float* xp,
                                 const float* g, const float* mask, float* dx,
                                 float* dc, float* dht, float* part, int T,
                                 int B, int H, cudaStream_t stream) {
  if (H < kWC || H % kWC || B < 1 || T < 1) return cudaErrorInvalidValue;
  BwdArgs p{w, h, c, xp, g, mask, dx, dc, dht, part, T, B, H};
  const int tiles = max(H / kUL * ((T * B + kTR - 1) / kTR),
                        4 * (H / kWC) * ((B + kTR - 1) / kTR));
  return launch_cooperative(lstm_wide_bwd_kernel, p, tiles, stream);
}
