// Tiles of small dependent products inside one cooperative launch, shared
// by the decoder kernels (dec_step.cu, attn_output.cu, beam_mega.cu,
// dec_train.cu, dec_train_gru.cu).
//
// A tile is 8 rows x 32 output columns (or 32 LSTM or GRU units, i.e. their
// 4 x 32 or 2 x 32 gate columns). The 8 warps of a block split the
// reduction depth K; each warp stages its rows' activations for its share
// of K in shared memory (coalesced), then its 32 lanes read 32
// neighbouring columns of W (128-byte loads) and take the activations as
// shared-memory broadcasts.
// The warps' partial sums meet in shared memory, where one thread per (row,
// column) adds them up and hands the sum to an epilogue (bias, LSTM cell,
// store). Activations are read with __ldcg (L2, never the non-coherent L1
// path), so values another block wrote before a grid barrier are seen.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;   // rows per tile
constexpr int kCols = 32;  // columns (or LSTM units) per tile

// Each warp owns kStage floats of the block's shared buffer: first as the
// staging area of its activations (kRows rows x kSub depths at a time), then
// for its partial sums.
constexpr int kStage = kRows * 4 * kCols;
constexpr int kSub = kStage / kRows;
constexpr int kSmem = kWarps * kStage;  // floats of a block's tile buffer

__host__ __device__ inline int num_tiles(int cols, int N) {
  return (cols + kCols - 1) / kCols * ((N + kRows - 1) / kRows);
}

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

// sum[n, c] = [a | a2][n, :] . W[:, c] for one 8 x 32 tile of an [N, C]
// output; ep(n, c, sum) for each of its (row, column).
template <typename Ep>
__device__ void dense_tile_ep(const float* a, int Ka, const float* a2, int Kb,
                              const float* __restrict__ W, int C, int N,
                              int tile, float* smem, Ep ep) {
  const int ctiles = (C + kCols - 1) / kCols;
  const int c0 = (tile % ctiles) * kCols, n0 = (tile / ctiles) * kRows;
  const int rows = min(kRows, N - n0);
  const int col = c0 + (threadIdx.x & 31);
  tile_partials<1>(a, Ka, a2, Kb, W, C, col, col < C, 0, n0, rows, smem);
  __syncthreads();
  const int r = threadIdx.x / kCols, l = threadIdx.x % kCols;
  if (r < rows && c0 + l < C) ep(n0 + r, c0 + l, tile_sum<1>(smem, r, 0, l));
  __syncthreads();  // smem is reused by the next tile
}

// out[n, c] = [a | a2][n, :] . W[:, c] + bias[c] for one 8 x 32 tile.
__device__ inline void dense_tile(const float* a, int Ka, const float* a2,
                                  int Kb, const float* __restrict__ W,
                                  const float* __restrict__ bias, int C,
                                  float* out, int N, int tile, float* smem) {
  dense_tile_ep(a, Ka, a2, Kb, W, C, N, tile, smem,
                [&](int n, int c, float s) {
                  out[static_cast<size_t>(n) * C + c] = s + __ldg(bias + c);
                });
}

// Gate sums [x | h][n, :] . W[:, g*Hc + u] (g = i, j, f, o) for one tile of
// 8 rows x 32 units, W [Kx+Kh, 4Hc]; ep(n, u, si, sj, sf, so).
template <typename Ep>
__device__ void lstm_tile_ep(const float* x, int Kx, const float* h, int Kh,
                             int Hc, const float* __restrict__ W, int N,
                             int tile, float* smem, Ep ep) {
  const int utiles = (Hc + kCols - 1) / kCols;
  const int u0 = (tile % utiles) * kCols, n0 = (tile / utiles) * kRows;
  const int rows = min(kRows, N - n0);
  const int u = u0 + (threadIdx.x & 31);
  tile_partials<4>(x, Kx, h, Kh, W, 4 * Hc, u, u < Hc, Hc, n0, rows, smem);
  __syncthreads();
  const int r = threadIdx.x / kCols, l = threadIdx.x % kCols;
  if (r < rows && u0 + l < Hc)
    ep(n0 + r, u0 + l, tile_sum<4>(smem, r, 0, l), tile_sum<4>(smem, r, 1, l),
       tile_sum<4>(smem, r, 2, l), tile_sum<4>(smem, r, 3, l));
  __syncthreads();
}

// LSTM cell for one tile of 8 rows x 32 units: gates = [x | h] @ W + bias,
// W [Kx+Hc, 4Hc] with gate order i, j, f, o.
__device__ inline void lstm_tile(const float* x, int Kx, const float* h,
                                 const float* c_in, int Hc,
                                 const float* __restrict__ W,
                                 const float* __restrict__ bias, float* c_out,
                                 float* h_out, int N, int tile, float* smem) {
  lstm_tile_ep(x, Kx, h, Hc, Hc, W, N, tile, smem,
               [&](int n, int u, float si, float sj, float sf, float so) {
                 const size_t at = static_cast<size_t>(n) * Hc + u;
                 float c = __ldcg(c_in + at);
                 const float nh = e2e::lstm_cell(
                     si + __ldg(bias + u), sj + __ldg(bias + Hc + u),
                     sf + __ldg(bias + 2 * Hc + u),
                     so + __ldg(bias + 3 * Hc + u), c);
                 c_out[at] = c;
                 h_out[at] = nh;
               });
}

// Gate sums [x | h][n, :] . W[:, g*Hc + u] (g = r, u) for one tile of 8
// rows x 32 GRU units, W [Kx+Kh, 2Hc]; ep(n, u, sr, su).
template <typename Ep>
__device__ void gru_tile_ep(const float* x, int Kx, const float* h, int Kh,
                            int Hc, const float* __restrict__ W, int N,
                            int tile, float* smem, Ep ep) {
  const int utiles = (Hc + kCols - 1) / kCols;
  const int u0 = (tile % utiles) * kCols, n0 = (tile / utiles) * kRows;
  const int rows = min(kRows, N - n0);
  const int u = u0 + (threadIdx.x & 31);
  tile_partials<2>(x, Kx, h, Kh, W, 2 * Hc, u, u < Hc, Hc, n0, rows, smem);
  __syncthreads();
  const int r = threadIdx.x / kCols, l = threadIdx.x % kCols;
  if (r < rows && u0 + l < Hc)
    ep(n0 + r, u0 + l, tile_sum<2>(smem, r, 0, l),
       tile_sum<2>(smem, r, 1, l));
  __syncthreads();
}

// One recurrent cell of a decoder step over N rows: an LSTM (w [Kx+Hc,
// 4Hc] and b, gate order i, j, f, o; state c, h) or a TF-1 GRU (w | b the
// gates [Kx+Hc, 2Hc] split r | u, wc | bc the candidate [Kx+Hc, Hc]; state
// h alone, c and c_out null). No constant is added to a GRU gate.
struct Cell {
  const float *c, *h, *w, *b, *wc, *bc;
  float *c_out, *h_out;
};

// The cell over all its tiles, input x [N, Kx]. An LSTM is one stage. A GRU
// is two, with a grid barrier between them, because the candidate's
// recurrent product needs all of r*h: first r, u = sigmoid([x | h] @ w + b)
// into the scratch rh = r*h and ug = u ([N, Hc] each), then c = tanh([x |
// rh] @ wc + bc) and h' = u*h + (1-u)*c. The caller syncs the grid after.
__device__ inline void cell_stages(const Cell& cell, const float* x, int Kx,
                                   int Hc, int N, float* rh, float* ug,
                                   float* smem, cg::grid_group& grid) {
  const int tiles = num_tiles(Hc, N);
  if (cell.wc == nullptr) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      lstm_tile(x, Kx, cell.h, cell.c, Hc, cell.w, cell.b, cell.c_out,
                cell.h_out, N, t, smem);
    return;
  }
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gru_tile_ep(x, Kx, cell.h, Hc, Hc, cell.w, N, t, smem,
                [&](int n, int u, float sr, float su) {
                  const size_t at = static_cast<size_t>(n) * Hc + u;
                  const float r = e2e::sigmoid(sr + __ldg(cell.b + u));
                  ug[at] = e2e::sigmoid(su + __ldg(cell.b + Hc + u));
                  rh[at] = r * __ldcg(cell.h + at);
                });
  grid.sync();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    dense_tile_ep(x, Kx, rh, Hc, cell.wc, Hc, N, t, smem,
                  [&](int n, int u, float s) {
                    const size_t at = static_cast<size_t>(n) * Hc + u;
                    const float c = tanhf(s + __ldg(cell.bc + u));
                    const float uu = __ldcg(ug + at);
                    cell.h_out[at] =
                        uu * __ldcg(cell.h + at) + (1.f - uu) * c;
                  });
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
