// Kernels B and C: one attention-decoder inference step around the additive
// attention (which stays in PyTorch, as the reference leaves it to XLA).
//
// B replaces e2e_asr_tpu/ops/dec_step_pallas.py cells_fused: decoder-LM LSTM
// -> [SimpleProjection] -> InputProjection([lm_out, ctx_prev]) -> L stacked
// decoder LSTMs -> attention query y = c_top @ W_q + b_q, over N = B*k rows.
// C replaces dec_step_pallas.py output_fused: AttnProjection([query,
// context]) -> OutputProjection -> log_softmax. No vocabulary padding (the
// 128-lane padding was a TPU layout artifact).
//
// Both are chains of small dependent products (N = 32 rows), so both are ONE
// cooperative launch each: a grid of at most one block per output tile (and
// no more than the card holds at once) with a grid-wide barrier between the
// stages. A tile is 8 rows x 32 output columns (or 32 LSTM units, i.e. their
// 4 x 32 gate columns). The 8 warps of a block split the reduction depth K;
// each warp stages its rows' activations for its share of K in shared
// memory (coalesced), then its 32 lanes read 32 neighbouring columns of W
// (128-byte loads) and take the activations as shared-memory broadcasts.
// The warps' partial sums meet in shared memory, where one thread per (row,
// column) adds them up and applies the bias, the LSTM cell or nothing.
// Splitting K keeps each thread's chain of dependent loads short: the step
// is bound by load latency, not by FLOPs or bandwidth. Activations written
// inside the kernel are read with __ldcg (L2, never the non-coherent L1
// path) after a grid barrier.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;   // rows per tile
constexpr int kCols = 32;  // columns (or LSTM units) per tile
constexpr int kMaxLayers = 8;

struct CellsArgs {
  const float *x_emb, *ctx, *lm_c, *lm_h, *lm_w, *lm_b, *sp_w, *sp_b, *ip_w,
      *ip_b, *q_w, *q_b;
  float *lm_c_out, *lm_h_out, *sp_out, *x_out, *y_out;
  const float *dec_c[kMaxLayers], *dec_h[kMaxLayers], *dec_w[kMaxLayers],
      *dec_b[kMaxLayers];
  float *dec_c_out[kMaxLayers], *dec_h_out[kMaxLayers];
  int N, E, Henc, Hl, H, A, L;
};

struct OutputArgs {
  const float *q, *ctx, *ap_w, *ap_b, *out_w, *out_b;
  float *proj, *logp;
  int N, H, Henc, V;
};

__host__ __device__ int num_tiles(int cols, int N) {
  return (cols + kCols - 1) / kCols * ((N + kRows - 1) / kRows);
}

// Each warp owns kStage floats of the block's shared buffer: first as the
// staging area of its activations (kRows rows x kSub depths at a time), then
// for its partial sums.
constexpr int kStage = kRows * 4 * kCols;
constexpr int kSub = kStage / kRows;

// Partial products of one tile over the two input segments [a | a2]
// (W rows [0, Ka) then [Ka, Ka+Kb)) on this warp's share of the depth: lane
// l accumulates G gate columns col + g * gstride for the tile's rows, then
// leaves acc[g][r] at region[(r * G + g) * kCols + l].
template <int G>
__device__ void tile_partials(const float* a, int Ka, const float* a2, int Kb,
                              const float* __restrict__ W, int C, int col,
                              bool col_ok, int gstride, int n0, int rows,
                              float* smem) {
  const int lane = threadIdx.x & 31;
  float* region = smem + (threadIdx.x >> 5) * kStage;
  float acc[G][kRows];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.f;
  const int K = Ka + Kb, chunk = (K + kWarps - 1) / kWarps;
  const int k0 = min(K, (threadIdx.x >> 5) * chunk), k1 = min(K, k0 + chunk);
  for (int kb = k0; kb < k1; kb += kSub) {
    const int ke = min(k1, kb + kSub);
    for (int i = lane; i < kRows * kSub; i += 32) {  // coalesced row reads
      const int r = i / kSub, k = kb + i % kSub;
      float v = 0.f;
      if (r < rows && k < ke)
        v = k < Ka ? __ldcg(a + static_cast<size_t>(n0 + r) * Ka + k)
                   : __ldcg(a2 + static_cast<size_t>(n0 + r) * Kb + k - Ka);
      region[i] = v;
    }
    __syncwarp();
    if (col_ok) {
#pragma unroll 4
      for (int k = kb; k < ke; ++k) {
        float w[G];
        const float* wk = W + static_cast<size_t>(k) * C + col;
#pragma unroll
        for (int g = 0; g < G; ++g) w[g] = __ldg(wk + g * gstride);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const float v = region[r * kSub + k - kb];
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g][r] = fmaf(v, w[g], acc[g][r]);
          }
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) region[(r * G + g) * kCols + lane] = acc[g][r];
}

// Sum of the warps' partials for (row r, gate g, column l) of the tile.
template <int G>
__device__ __forceinline__ float tile_sum(const float* smem, int r, int g,
                                          int l) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += smem[w * kStage + (r * G + g) * kCols + l];
  return s;
}

// out[n, c] = [a | a2][n, :] . W[:, c] + bias[c] for one 8 x 32 tile.
__device__ void dense_tile(const float* a, int Ka, const float* a2, int Kb,
                           const float* __restrict__ W,
                           const float* __restrict__ bias, int C, float* out,
                           int N, int tile, float* smem) {
  const int ctiles = (C + kCols - 1) / kCols;
  const int c0 = (tile % ctiles) * kCols, n0 = (tile / ctiles) * kRows;
  const int rows = min(kRows, N - n0);
  const int col = c0 + (threadIdx.x & 31);
  tile_partials<1>(a, Ka, a2, Kb, W, C, col, col < C, 0, n0, rows, smem);
  __syncthreads();
  const int r = threadIdx.x / kCols, l = threadIdx.x % kCols;
  if (r < rows && c0 + l < C)
    out[static_cast<size_t>(n0 + r) * C + c0 + l] =
        tile_sum<1>(smem, r, 0, l) + __ldg(bias + c0 + l);
  __syncthreads();  // smem is reused by the next tile
}

// LSTM cell for one tile of 8 rows x 32 units: gates = [x | h] @ W + bias,
// W [Kx+Hc, 4Hc] with gate order i, j, f, o.
__device__ void lstm_tile(const float* x, int Kx, const float* h,
                          const float* c_in, int Hc,
                          const float* __restrict__ W,
                          const float* __restrict__ bias, float* c_out,
                          float* h_out, int N, int tile, float* smem) {
  const int utiles = (Hc + kCols - 1) / kCols;
  const int u0 = (tile % utiles) * kCols, n0 = (tile / utiles) * kRows;
  const int rows = min(kRows, N - n0);
  const int u = u0 + (threadIdx.x & 31);
  tile_partials<4>(x, Kx, h, Hc, W, 4 * Hc, u, u < Hc, Hc, n0, rows, smem);
  __syncthreads();
  const int r = threadIdx.x / kCols, l = threadIdx.x % kCols;
  if (r < rows && u0 + l < Hc) {
    const int uu = u0 + l;
    const size_t at = static_cast<size_t>(n0 + r) * Hc + uu;
    float c = __ldcg(c_in + at);
    const float nh = e2e::lstm_cell(
        tile_sum<4>(smem, r, 0, l) + __ldg(bias + uu),
        tile_sum<4>(smem, r, 1, l) + __ldg(bias + Hc + uu),
        tile_sum<4>(smem, r, 2, l) + __ldg(bias + 2 * Hc + uu),
        tile_sum<4>(smem, r, 3, l) + __ldg(bias + 3 * Hc + uu), c);
    c_out[at] = c;
    h_out[at] = nh;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) cells_fused_kernel(CellsArgs p) {
  __shared__ float smem[kWarps * kStage];
  cg::grid_group grid = cg::this_grid();
  for (int t = blockIdx.x; t < num_tiles(p.Hl, p.N); t += gridDim.x)
    lstm_tile(p.x_emb, p.E, p.lm_h, p.lm_c, p.Hl, p.lm_w, p.lm_b, p.lm_c_out,
              p.lm_h_out, p.N, t, smem);
  grid.sync();
  const float* lm_y = p.lm_h_out;
  if (p.sp_w != nullptr) {
    for (int t = blockIdx.x; t < num_tiles(p.H, p.N); t += gridDim.x)
      dense_tile(p.lm_h_out, p.Hl, nullptr, 0, p.sp_w, p.sp_b, p.H, p.sp_out,
                 p.N, t, smem);
    grid.sync();
    lm_y = p.sp_out;
  }
  for (int t = blockIdx.x; t < num_tiles(p.E, p.N); t += gridDim.x)
    dense_tile(lm_y, p.H, p.ctx, p.Henc, p.ip_w, p.ip_b, p.E, p.x_out, p.N, t,
               smem);
  grid.sync();
  const float* x = p.x_out;
  int Kx = p.E;
  for (int l = 0; l < p.L; ++l) {
    for (int t = blockIdx.x; t < num_tiles(p.H, p.N); t += gridDim.x)
      lstm_tile(x, Kx, p.dec_h[l], p.dec_c[l], p.H, p.dec_w[l], p.dec_b[l],
                p.dec_c_out[l], p.dec_h_out[l], p.N, t, smem);
    grid.sync();
    x = p.dec_h_out[l];
    Kx = p.H;
  }
  for (int t = blockIdx.x; t < num_tiles(p.A, p.N); t += gridDim.x)
    dense_tile(p.dec_c_out[p.L - 1], p.H, nullptr, 0, p.q_w, p.q_b, p.A,
               p.y_out, p.N, t, smem);
}

__global__ void __launch_bounds__(kThreads) output_fused_kernel(OutputArgs p) {
  __shared__ float smem[kWarps * kStage];
  cg::grid_group grid = cg::this_grid();
  for (int t = blockIdx.x; t < num_tiles(p.H, p.N); t += gridDim.x)
    dense_tile(p.q, p.H, p.ctx, p.Henc, p.ap_w, p.ap_b, p.H, p.proj, p.N, t,
               smem);
  grid.sync();
  for (int t = blockIdx.x; t < num_tiles(p.V, p.N); t += gridDim.x)
    dense_tile(p.proj, p.H, nullptr, 0, p.out_w, p.out_b, p.V, p.logp, p.N, t,
               smem);
  grid.sync();
  // log_softmax in place, one warp per row.
  const int lane = threadIdx.x & 31;
  for (int n = blockIdx.x * kWarps + (threadIdx.x >> 5); n < p.N;
       n += gridDim.x * kWarps) {
    float* l = p.logp + static_cast<size_t>(n) * p.V;
    float m = -INFINITY;
    for (int v = lane; v < p.V; v += 32) m = fmaxf(m, __ldcg(l + v));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int v = lane; v < p.V; v += 32) s += expf(__ldcg(l + v) - m);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float z = logf(s);
    for (int v = lane; v < p.V; v += 32) l[v] = __ldcg(l + v) - m - z;
  }
}

// One cooperative launch of `kernel` with a grid of min(tiles, resident).
template <typename Args>
cudaError_t launch_cooperative(void (*kernel)(Args), Args& args, int tiles,
                               cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  const int grid = min(tiles, per_sm * sms);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kThreads), kargs, 0,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// ptrs: x_emb, ctx_prev, lm_c, lm_h, lm_w, lm_b, sp_w|NULL, sp_b|NULL, ip_w,
//   ip_b, q_w, q_b, lm_c_out, lm_h_out, sp_out|NULL, x_out (scratch [N,E]),
//   y_out, then per decoder layer: c, h, w, b, c_out, h_out.
// dims: N, E, Henc, Hl, H, A, L.
E2E_EXPORT int e2e_cells_fused(const void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims,
                               cudaStream_t stream) {
  if (n_dims != 7) return cudaErrorInvalidValue;
  CellsArgs p{};
  p.N = dims[0];
  p.E = dims[1];
  p.Henc = dims[2];
  p.Hl = dims[3];
  p.H = dims[4];
  p.A = dims[5];
  p.L = dims[6];
  if (p.L < 1 || p.L > kMaxLayers || n_ptrs != 17 + 6 * p.L || p.N < 1)
    return cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[i]));
  };
  p.x_emb = in(0);
  p.ctx = in(1);
  p.lm_c = in(2);
  p.lm_h = in(3);
  p.lm_w = in(4);
  p.lm_b = in(5);
  p.sp_w = in(6);
  p.sp_b = in(7);
  p.ip_w = in(8);
  p.ip_b = in(9);
  p.q_w = in(10);
  p.q_b = in(11);
  p.lm_c_out = out(12);
  p.lm_h_out = out(13);
  p.sp_out = out(14);
  p.x_out = out(15);
  p.y_out = out(16);
  for (int l = 0; l < p.L; ++l) {
    const int b = 17 + 6 * l;
    p.dec_c[l] = in(b);
    p.dec_h[l] = in(b + 1);
    p.dec_w[l] = in(b + 2);
    p.dec_b[l] = in(b + 3);
    p.dec_c_out[l] = out(b + 4);
    p.dec_h_out[l] = out(b + 5);
  }
  int tiles = num_tiles(p.Hl, p.N);
  tiles = max(tiles, num_tiles(p.H, p.N));
  tiles = max(tiles, num_tiles(p.E, p.N));
  tiles = max(tiles, num_tiles(p.A, p.N));
  return launch_cooperative(cells_fused_kernel, p, tiles, stream);
}

// query [N,H], context [N,Henc], w_ap [H+Henc,H], b_ap [H], w_out [H,V],
// b_out [V], proj (scratch [N,H]) -> logp [N,V]
E2E_EXPORT int e2e_output_fused(const float* q, const float* ctx,
                                const float* w_ap, const float* b_ap,
                                const float* w_out, const float* b_out,
                                float* proj, float* logp, int N, int H,
                                int Henc, int V, cudaStream_t stream) {
  if (N < 1 || H < 1 || V < 1 || Henc < 0) return cudaErrorInvalidValue;
  OutputArgs p{q, ctx, w_ap, b_ap, w_out, b_out, proj, logp, N, H, Henc, V};
  const int tiles = max(max(num_tiles(H, N), num_tiles(V, N)),
                        (N + kWarps - 1) / kWarps);
  return launch_cooperative(output_fused_kernel, p, tiles, stream);
}
