// Kernel #18: the transformer encoder's self-attention core.
//
// Replaces e2e_asr_tpu/ops/mhsa_pallas.py _fwd (body _fwd_kernel). For q, k,
// v [B, nh, T, hd], pad_bias [B, T] and relmat [nh, T, T] (all float32):
//   s[b,h,i,j] = (q_i . k_j) * (1/sqrt(hd)) + relmat[h,i,j] + pad_bias[b,j]
//   probs      = softmax over j, the row max subtracted first (a row whose
//                keys all carry -1e30 comes out uniform, as jax.nn.softmax)
//   out[b,h,i] = sum_j probs[b,h,i,j] v_j
// writing probs [B, nh, T, T] (the backward's residual) and out. The sums
// are float32 (the build sets no fast math; expf and IEEE division); the
// scale is 1/sqrt(hd) taken in double and rounded, as the TPU kernel's.
//
// Bound on the H100: latency. At the serving shape (B=8, nh=4, T=64,
// hd=128) the function moves about 4.8 MB and does 67 MFLOP: about 1.4 us
// of bytes, far below a launch.
//
// Design (the TPU kernel runs one grid step per batch item with every head
// inside; here blocks run in parallel): one block of 8 warps per (tile of
// 32 query rows, head, batch item), each warp owning 4 rows. The tile's
// queries sit in shared memory; K and then V are staged through a shared
// buffer in chunks of 32 keys with 16-byte loads, rows padded by 4 floats so
// that the quarter-warps' 16-byte reads of 8 different rows hit distinct
// banks.
//   1. scores: lane j of a warp takes key j of the chunk for the warp's 4
//      rows (q broadcast from shared memory), adds the biases, writes the
//      raw score into probs (which stays in L2 at these sizes) and keeps
//      its rows' running maxima;
//   2. softmax: the row max by warp shuffles, then each lane turns its own
//      keys' scores into exp(s - max) and sums them, a warp sum, and a
//      second pass divides by it (each lane rereads only what it wrote);
//   3. probs . V: lane j holds p[row][key j] of the chunk in registers and
//      the warp broadcasts them by shuffles; each lane accumulates 4 rows x
//      4 (or 8) columns of out in registers from V's rows in shared memory.
// Any T: the chunks loop over the keys and the grid over the query tiles.
// Head widths: multiples of 4 up to 256 (one or two 128-wide column groups
// a lane). wgmma, TMA and a flash-style online softmax are later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows a block
constexpr int kKeys = 32;                     // keys a chunk
constexpr int kPad = 4;                       // floats of row padding
constexpr int kMaxHd = 256;

// Copies rows [r0, r0 + n) of a [T, hd] matrix into `dst` (row stride
// hd + kPad), zeros past T; hd is a multiple of 4.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int r0, int n, int T, int hd) {
  const int vecs = hd / 4;
  for (int i = threadIdx.x; i < n * vecs; i += blockDim.x) {
    const int r = i / vecs, c = i - r * vecs;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T)
      val = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * hd)
                  + c);
    *reinterpret_cast<float4*>(dst + r * (hd + kPad) + 4 * c) = val;
  }
}

template <int kGroups>  // 128-wide column groups of out a lane covers
__global__ void __launch_bounds__(kWarps * 32) mhsa_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ pad_bias,
    const float* __restrict__ relmat, float* __restrict__ out,
    float* __restrict__ probs, int nh, int T, int hd, float scale) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows, hd + kPad]
  float* skv = sq + kRows * (hd + kPad);         // [kKeys, hd + kPad]
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRows;
  const size_t bh = (size_t)b * nh + h;
  const float* qb = q + bh * T * hd;
  const float* kb = k + bh * T * hd;
  const float* vb = v + bh * T * hd;
  const float* pb = pad_bias + (size_t)b * T;
  const float* rel = relmat + (size_t)h * T * T;
  float* pr = probs + bh * T * T;
  const int stride = hd + kPad;
  const int row0 = warp * kRowsPerWarp;  // the warp's first row in the tile

  stage(sq, qb, q0, kRows, T, hd);

  // 1. raw scores and running row maxima.
  float m[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) m[r] = -INFINITY;
  for (int kc = 0; kc < T; kc += kKeys) {
    __syncthreads();
    stage(skv, kb, kc, kKeys, T, hd);
    __syncthreads();
    float acc[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = skv + lane * stride;
    for (int d = 0; d < hd; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sq + (row0 + r) * stride + d);
        acc[r] = fmaf(qv.x, kv.x, acc[r]);
        acc[r] = fmaf(qv.y, kv.y, acc[r]);
        acc[r] = fmaf(qv.z, kv.z, acc[r]);
        acc[r] = fmaf(qv.w, kv.w, acc[r]);
      }
    }
    const int key = kc + lane;
    if (key < T) {
      const float bias = __ldg(pb + key);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = q0 + row0 + r;
        if (i < T) {
          const float s =
              (acc[r] * scale + __ldg(rel + (size_t)i * T + key)) + bias;
          pr[(size_t)i * T + key] = s;
          m[r] = fmaxf(m[r], s);
        }
      }
    }
  }

  // 2. softmax of the warp's rows, in place.
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + row0 + r;
    if (i >= T) continue;  // uniform across the warp
    float mr = m[r];
    for (int o = 16; o > 0; o >>= 1)
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, o));
    float* row = pr + (size_t)i * T;
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(row[j] - mr);
      row[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < T; j += 32) row[j] = row[j] / sum;
  }

  // 3. out = probs . V.
  float4 acc[kRowsPerWarp][kGroups];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int g = 0; g < kGroups; ++g) acc[r][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kc = 0; kc < T; kc += kKeys) {
    __syncthreads();
    stage(skv, vb, kc, kKeys, T, hd);
    __syncthreads();
    const int key = kc + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = q0 + row0 + r;
      p[r] = (key < T && i < T) ? pr[(size_t)i * T + key] : 0.f;
    }
    const int n = min(kKeys, T - kc);
    for (int kk = 0; kk < n; ++kk) {
      float pk[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pk[r] = __shfl_sync(0xffffffffu, p[r], kk);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int c = 4 * (g * 32 + lane);
        if (c < hd) {
          const float4 vv = *reinterpret_cast<const float4*>(
              skv + kk * stride + c);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            acc[r][g].x = fmaf(pk[r], vv.x, acc[r][g].x);
            acc[r][g].y = fmaf(pk[r], vv.y, acc[r][g].y);
            acc[r][g].z = fmaf(pk[r], vv.z, acc[r][g].z);
            acc[r][g].w = fmaf(pk[r], vv.w, acc[r][g].w);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + row0 + r;
    if (i >= T) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int c = 4 * (g * 32 + lane);
      if (c < hd)
        *reinterpret_cast<float4*>(out + (bh * T + i) * hd + c) = acc[r][g];
    }
  }
}

template <int kGroups>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* pad_bias, const float* relmat, float* out,
                   float* probs, int B, int nh, int T, int hd,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(kRows + kKeys) * (hd + kPad) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mhsa_fwd_kernel<kGroups>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + kRows - 1) / kRows, nh, B);
  mhsa_fwd_kernel<kGroups><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, pad_bias, relmat, out, probs, nh, T, hd,
      (float)(1.0 / sqrt((double)hd)));
  return cudaGetLastError();
}

}  // namespace

E2E_EXPORT int e2e_mhsa_fwd(const float* q, const float* k, const float* v,
                            const float* pad_bias, const float* relmat,
                            float* out, float* probs, int B, int nh, int T,
                            int hd, cudaStream_t stream) {
  if (B < 1 || B > 65535 || nh < 1 || nh > 65535 || T < 1 || hd < 4 ||
      hd % 4 || hd > kMaxHd)
    return cudaErrorInvalidValue;
  if (hd <= 128)
    return launch<1>(q, k, v, pad_bias, relmat, out, probs, B, nh, T, hd,
                     stream);
  return launch<2>(q, k, v, pad_bias, relmat, out, probs, B, nh, T, hd,
                   stream);
}
