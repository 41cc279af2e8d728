// Weight gradients of the recurrent backward kernels (lstm_bidir_bwd.cu,
// gru_bwd.cu): dW[k, n] = sum over rows r of X[r, k] * G[r, n], X [R, K]
// and G [R, N] row-major over the R = T*B rows of a sequence, X's row r
// read from row r - shift (zero for r < shift: h_{t-1} of the first step).
//
// A tiled reduction without atomics: 64 x 64 output tiles, 4 x 4 outputs a
// thread, 16 rows a stage in shared memory; the rows are split over
// `splits` blocks into a partial buffer [splits, K, N] that a second kernel
// sums in a fixed order, so every run gives the same bits.
#pragma once

#include "common.cuh"

namespace e2e {
namespace {  // internal linkage: each source that includes this has its own

struct DwJob {
  const float *x, *g;
  int shift, K, N;
  float *part, *out;  // part [splits, K, N] (scratch), out [K, N]
};

constexpr int kMaxDwJobs = 4;

struct DwJobs {
  DwJob job[kMaxDwJobs];
  int n, R, splits;
};

constexpr int kDwTile = 64, kDwDepth = 16;

__host__ __device__ inline int dw_tiles(int K, int N) {
  return (K + kDwTile - 1) / kDwTile * ((N + kDwTile - 1) / kDwTile);
}

// grid (max tiles of a job, splits, jobs), 256 threads.
__global__ void __launch_bounds__(256) dw_partial_kernel(DwJobs a) {
  __shared__ float xs[kDwDepth][kDwTile];
  __shared__ float gs[kDwDepth][kDwTile];
  const DwJob d = a.job[blockIdx.z];
  if (static_cast<int>(blockIdx.x) >= dw_tiles(d.K, d.N)) return;
  const int split = blockIdx.y;
  const int ntiles = (d.N + kDwTile - 1) / kDwTile;
  const int m0 = (blockIdx.x / ntiles) * kDwTile;
  const int n0 = (blockIdx.x % ntiles) * kDwTile;
  const int per = (a.R + a.splits - 1) / a.splits;
  const int r0 = split * per, r1 = min(a.R, r0 + per);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int rb = r0; rb < r1; rb += kDwDepth) {
    for (int i = threadIdx.x; i < kDwDepth * kDwTile; i += blockDim.x) {
      const int rr = i / kDwTile, col = i % kDwTile, r = rb + rr;
      const bool in = r < r1;
      xs[rr][col] = in && r >= d.shift && m0 + col < d.K
                        ? d.x[static_cast<size_t>(r - d.shift) * d.K + m0 +
                              col]
                        : 0.f;
      gs[rr][col] = in && n0 + col < d.N
                        ? d.g[static_cast<size_t>(r) * d.N + n0 + col]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kDwDepth; ++rr) {
      float x[4], g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = xs[rr][ty + 16 * q];
        g[q] = gs[rr][tx + 16 * q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(x[p], g[q], acc[p][q]);
    }
    __syncthreads();
  }
  float* out = d.part + static_cast<size_t>(split) * d.K * d.N;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 16 * q;
      if (m < d.K && n < d.N) out[static_cast<size_t>(m) * d.N + n] = acc[p][q];
    }
  }
}

// out[i] = sum over s of part[s][i], in order; grid (., jobs).
__global__ void dw_sum_kernel(DwJobs a) {
  const DwJob d = a.job[blockIdx.y];
  const int size = d.K * d.N;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < a.splits; ++q)
      s += d.part[static_cast<size_t>(q) * size + i];
    d.out[i] = s;
  }
}

// Both passes of the jobs' weight gradients on `stream`.
inline cudaError_t launch_dw(const DwJobs& a, cudaStream_t stream) {
  if (a.n < 1 || a.n > kMaxDwJobs || a.splits < 1 || a.splits > 65535)
    return cudaErrorInvalidValue;
  int tiles = 0, size = 0;
  for (int i = 0; i < a.n; ++i) {
    tiles = max(tiles, dw_tiles(a.job[i].K, a.job[i].N));
    size = max(size, a.job[i].K * a.job[i].N);
  }
  dw_partial_kernel<<<dim3(tiles, a.splits, a.n), 256, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dw_sum_kernel<<<dim3((size + 255) / 256, a.n), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace e2e
