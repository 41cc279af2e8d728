// Tiled products over the R = T*B rows of a recurrent layer's sequence,
// for the backward kernels (lstm_bidir_bwd.cu, lstm_seq_wide.cu,
// gru_bwd.cu). Above all the weight gradients: dW[k, n] = sum over rows r
// of X[r, k] * G[r, n], X [R, K] and G [R, N] row-major, X's row r read
// from row r - shift (zero for r < shift: h_{t-1} of the first step); and
// the LSTM backward's gate pre-activations x_proj + h_{t-1} W_h over every
// row (lstm_bwd_gates_kernel).
//
// 128 x 128 output tiles, 8 x 8 outputs a thread of 256, stages of 16
// summed depths filled by 4-byte cp.async (any alignment, zero past the
// edges) and double-buffered: tile_product. dW's rows are split over
// `splits` blocks into a partial buffer [splits, K, N] that a second
// kernel sums in a fixed order: no atomics, the same bits every run.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace e2e {
namespace {  // internal linkage: each source that includes this has its own

constexpr int kTM = 128, kTN = 128, kTK = 16, kTA = kTM + 4;

// Two stages of a tile's operands: a [depth][output row], b [depth][output
// column].
struct RowTile {
  float a[2][kTK][kTA];
  float b[2][kTK][kTN];
};

// acc += the product of nk stages from depth d0; stage_in(k0, buf) issues
// and commits the copies of the stage at depth k0 into buffer buf. Thread
// (tx, ty) = (tid % 16, tid / 16) holds output rows ty*4.. and 64 + ty*4..
// and columns tx*4.. and 64 + tx*4.. (tile_store's order).
template <class Stage>
__device__ __forceinline__ void tile_product(RowTile& s, int d0, int nk,
                                             Stage stage_in,
                                             float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (nk > 0) stage_in(d0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    wait_async<0>();
    __syncthreads();  // stage kt landed; stage kt - 1's buffer is free
    if (kt + 1 < nk) stage_in(d0 + (kt + 1) * kTK, buf ^ 1);
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.b[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// store(row, col, acc[i][j]) for the outputs of the tile at (m0, n0) that
// lie within M rows and N columns.
template <class Store>
__device__ __forceinline__ void tile_store(int m0, int n0, int M, int N,
                                           const float (&acc)[8][8],
                                           Store store) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) store(row, col, acc[i][j]);
    }
  }
}

// ---- the gate pre-activations over all T*B rows ----------------------------

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
  __shared__ __align__(16) RowTile s;
  const GateJob jb = blockIdx.z ? a.job[1] : a.job[0];
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int tid = threadIdx.x, hr = m0 + tid / kTK;
  const int wn = n0 + tid % kTN;
  float acc[8][8] = {};
  // Thread tid copies, for q < 8: h's row hr + 16q at depth k0 + tid % 16
  // (landing transposed) and w's row k0 + tid / 128 + 2q at column wn.
  auto stage_in = [&](int k0, int buf) {
    const int k = k0 + tid % kTK;
    const float* hp = jb.h + (static_cast<ptrdiff_t>(hr) - a.shift) * a.K + k;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int m = hr + 16 * q;
      const bool in = m < a.R && m >= a.shift && k < a.K;
      copy_async4(&s.a[buf][tid % kTK][tid / kTK + 16 * q],
                  in ? hp + static_cast<size_t>(16 * q) * a.K : jb.h, in);
    }
    const int wk = k0 + tid / kTN;
    const float* wp = jb.w + static_cast<size_t>(wk) * a.N + wn;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool in = wk + 2 * q < a.K && wn < a.N;
      copy_async4(&s.b[buf][tid / kTN + 2 * q][tid % kTN],
                  in ? wp + static_cast<size_t>(2 * q) * a.N : jb.w, in);
    }
    commit_async();
  };
  tile_product(s, 0, (a.K + kTK - 1) / kTK, stage_in, acc);
  tile_store(m0, n0, a.R, a.N, acc, [&](int row, int col, float v) {
    const size_t o = static_cast<size_t>(row) * a.N + col;
    jb.out[o] = v + __ldg(jb.x + o);
  });
}

// ---- dW ---------------------------------------------------------------------

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

__host__ __device__ inline int dw_tiles(int K, int N) {
  return (K + kTM - 1) / kTM * ((N + kTN - 1) / kTN);
}

// The partial sum of split blockIdx.y's rows for one 128 x 128 tile of a
// job's dW; grid (tiles of the largest job, splits, jobs), 256 threads.
__global__ void __launch_bounds__(256, 2) dw_partial_kernel(DwJobs a) {
  __shared__ __align__(16) RowTile s;
  const DwJob d = a.job[blockIdx.z];
  if (static_cast<int>(blockIdx.x) >= dw_tiles(d.K, d.N)) return;
  const int ntile = (d.N + kTN - 1) / kTN;
  const int m0 = blockIdx.x / ntile * kTM, n0 = blockIdx.x % ntile * kTN;
  const int per = (a.R + a.splits - 1) / a.splits;
  const int r0 = min(a.R, static_cast<int>(blockIdx.y) * per);
  const int r1 = min(a.R, r0 + per);
  const int tid = threadIdx.x, xk = m0 + tid % kTM, gn = n0 + tid % kTN;
  float acc[8][8] = {};
  // Thread tid copies, for q < 8, the summed row k0 + tid / 128 + 2q: X's
  // column xk and G's column gn.
  auto stage_in = [&](int k0, int buf) {
    const int r = k0 + tid / kTM;
    const float* xp = d.x + (static_cast<ptrdiff_t>(r) - d.shift) * d.K + xk;
    const float* gp = d.g + static_cast<size_t>(r) * d.N + gn;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int rq = r + 2 * q;
      const bool xin = rq < r1 && rq >= d.shift && xk < d.K;
      copy_async4(&s.a[buf][tid / kTM + 2 * q][tid % kTM],
                  xin ? xp + static_cast<size_t>(2 * q) * d.K : d.x, xin);
      const bool gin = rq < r1 && gn < d.N;
      copy_async4(&s.b[buf][tid / kTN + 2 * q][tid % kTN],
                  gin ? gp + static_cast<size_t>(2 * q) * d.N : d.g, gin);
    }
    commit_async();
  };
  tile_product(s, r0, (r1 - r0 + kTK - 1) / kTK, stage_in, acc);
  float* out = d.part + static_cast<size_t>(blockIdx.y) * d.K * d.N;
  tile_store(m0, n0, d.K, d.N, acc, [&](int row, int col, float v) {
    out[static_cast<size_t>(row) * d.N + col] = v;
  });
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
