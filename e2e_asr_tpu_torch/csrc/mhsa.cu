// Kernel #18: the transformer encoder's self-attention core.
//
// Replaces e2e_asr_tpu/ops/mhsa_pallas.py _fwd (body _fwd_kernel). For q, k,
// v [B, nh, T, hd], pad_bias [B, T] and relmat [nh, T, T] (all float32):
//   s[b,h,i,j] = (q_i . k_j) * (1/sqrt(hd)) + relmat[h,i,j] + pad_bias[b,j]
//   probs      = softmax over j, the row max subtracted first (a row whose
//                keys all carry -1e30 comes out uniform, as jax.nn.softmax)
//   out[b,h,i] = sum_j probs[b,h,i,j] v_j
// It has two forms from one source: the out-only form (probs NULL), which
// inference runs (the encoder drops the probs, as the JAX `attend` drops
// _fwd's), and the probs form, which also writes probs [B, nh, T, T] (the
// backward's residual, and what return_probs hands back). The sums are
// float32 (the build sets no fast math; expf and IEEE division; the score's
// products and sums rounded one by one, so both forms give out the same
// bits); the scale is 1/sqrt(hd) taken in double and rounded, as the TPU
// kernel's.
//
// Bound on the H100: latency. At the serving shape (B=8, nh=4, T=64,
// hd=128) the function moves about 4.2 MB (4.7 with probs) and does 67
// MFLOP: about 1.4 us of bytes, below a launch.
//
// Two routes, chosen here by B, nh and T (e2e_mhsa_plan):
// "onchip" (T <= kKeys = 64): one block of 8 warps per (tile of 8 RW query
// rows, head, batch item). RW = 8 (one tile a head: K and V read once)
// where B * nh such blocks fill the card's SMs and T > 32 (at least half
// the tile's rows real), else 2 (up to 4 times the blocks). At the serving
// shape (B=8, nh=4, T=64) that is 16 rows: 128 blocks, about one a SM of
// the 132, 80 KB of shared memory each (hd=128); at `-test`'s B=64, T=48,
// 64 rows: 256 blocks, two a SM at 99 KB. The tile's queries and the
// head's K and V are staged at once by 16-byte cp.async, V in a second
// group that stays in flight while the scores are computed. Lane l of a
// warp keeps the scores of keys l and l + 32 of the warp's RW rows in
// registers (2 RW a lane), adds the biases (read into registers while the
// copies fly), takes each row's max and sum by warp shuffles and divides;
// the probs form writes probs once from there. The probs go to shared
// memory for the warp's own rows, where out = P V reads them as broadcast
// float4s (4 keys) beside V's rows: each lane sums its RW rows x 4 (or 8)
// columns. Float32 FMA, not TF32 tensor cores: TF32's 10-bit mantissa
// would miss the 1e-5 tolerance against the plain chain, and at these
// sizes the kernel waits on latency, not on the FMA units.
// "chunked" (any wider T): one block of 8 warps per (tile of 32 query rows,
// head, batch item), K and then V staged through a shared buffer in chunks
// of 32 keys; the raw scores go through probs (the output in the probs
// form, a scratch the wrapper hands in the out-only form), the softmax runs
// in place and a third pass forms out from them.
// Head widths: multiples of 4 up to 256 (one or two 128-wide column groups
// a lane). wgmma, TMA and a flash-style online softmax are later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kPad = 4;    // floats of row padding: 16-byte rows on 8 banks
constexpr int kMaxHd = 256;

// ---- the on-chip route ------------------------------------------------------

constexpr int kKeys = 64;  // the widest T kept on chip: 2 keys a lane

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of a block of `rows` query rows.
__host__ __device__ inline size_t onchip_smem(int rows, int T, int hd) {
  return ((static_cast<size_t>(rows) + 2 * round4(T)) * (hd + kPad) +
          static_cast<size_t>(rows) * kKeys) *
         sizeof(float);
}

template <int kRW, int kGroups, bool kProbs>  // kRW query rows a warp
__global__ void __launch_bounds__(kWarps * 32) mhsa_onchip_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ pad_bias,
    const float* __restrict__ relmat, float* __restrict__ out,
    float* __restrict__ probs, int nh, int T, int hd, float scale) {
  constexpr int kOnRows = kRW * kWarps;
  extern __shared__ float4 smem4[];
  const int stride = hd + kPad, T4 = round4(T);
  float* sq = reinterpret_cast<float*>(smem4);  // [kOnRows][stride]
  float* sk = sq + kOnRows * stride;             // [T4][stride]
  float* sv = sk + T4 * stride;                  // [T4][stride]
  float* sp = sv + T4 * stride;                  // [kOnRows][kKeys]
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kOnRows;
  const size_t bh = static_cast<size_t>(b) * nh + h;
  const float* qb = q + bh * T * hd;
  const float* kb = k + bh * T * hd;
  const float* vb = v + bh * T * hd;
  const int vecs = hd / 4;

  // Q's tile and K (group 0), then V (group 1); rows past T are zeros.
  for (int e = tid; e < kOnRows * vecs; e += blockDim.x) {
    const int r = e / vecs, c = e - r * vecs;
    float* dst = sq + r * stride + 4 * c;
    if (q0 + r < T)
      e2e::copy_async16(dst, qb + static_cast<size_t>(q0 + r) * hd + 4 * c);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int e = tid; e < T * vecs; e += blockDim.x) {
    const int r = e / vecs, c = e - r * vecs;
    e2e::copy_async16(sk + r * stride + 4 * c,
                      kb + static_cast<size_t>(r) * hd + 4 * c);
  }
  e2e::commit_async();
  for (int e = tid; e < T * vecs; e += blockDim.x) {
    const int r = e / vecs, c = e - r * vecs;
    e2e::copy_async16(sv + r * stride + 4 * c,
                      vb + static_cast<size_t>(r) * hd + 4 * c);
  }
  e2e::commit_async();
  for (int e = tid; e < (T4 - T) * vecs; e += blockDim.x) {
    const int r = T + e / vecs, c = e % vecs;
    *reinterpret_cast<float4*>(sv + r * stride + 4 * c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // This lane's keys (lane, lane + 32) and the warp's rows i0.. i0 + kRW:
  // their biases while the copies fly.
  const int i0 = q0 + kRW * warp;
  const float* rel = relmat + static_cast<size_t>(h) * T * T;
  float bias[2], rl[kRW][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int key = lane + 32 * kk;
    bias[kk] = key < T ? __ldg(pad_bias + static_cast<size_t>(b) * T + key)
                       : 0.f;
#pragma unroll
    for (int r = 0; r < kRW; ++r)
      rl[r][kk] = key < T && i0 + r < T
                      ? __ldg(rel + static_cast<size_t>(i0 + r) * T + key)
                      : 0.f;
  }
  e2e::wait_async<1>();
  __syncthreads();  // Q and K landed

  // The scores of the warp's rows against keys lane, lane + 32 (clamped to
  // T - 1 for the reads; the extra ones are dropped below).
  float acc[kRW][2];
#pragma unroll
  for (int r = 0; r < kRW; ++r) acc[r][0] = acc[r][1] = 0.f;
  const float* qr = sq + kRW * warp * stride;
  const float* k0 = sk + min(lane, T - 1) * stride;
  const float* k1 = sk + min(lane + 32, T - 1) * stride;
  auto scores = [&](auto two) {
    constexpr bool kTwo = decltype(two)::value;
#pragma unroll 2
    for (int d = 0; d < hd; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(k0 + d);
      float4 y = x;
      if (kTwo) y = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(qr + r * stride + d);
        acc[r][0] = fmaf(a.x, x.x, acc[r][0]);
        acc[r][0] = fmaf(a.y, x.y, acc[r][0]);
        acc[r][0] = fmaf(a.z, x.z, acc[r][0]);
        acc[r][0] = fmaf(a.w, x.w, acc[r][0]);
        if (kTwo) {
          acc[r][1] = fmaf(a.x, y.x, acc[r][1]);
          acc[r][1] = fmaf(a.y, y.y, acc[r][1]);
          acc[r][1] = fmaf(a.z, y.z, acc[r][1]);
          acc[r][1] = fmaf(a.w, y.w, acc[r][1]);
        }
      }
    }
  };
  if (T > 32)
    scores(std::true_type{});
  else
    scores(std::false_type{});

  // The softmax of each row over its T keys, in registers.
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    float s[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      s[kk] = lane + 32 * kk < T
                  ? __fadd_rn(__fadd_rn(__fmul_rn(acc[r][kk], scale),
                                        rl[r][kk]),
                              bias[kk])
                  : -INFINITY;
    float m = fmaxf(s[0], s[1]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = expf(s[0] - m), e1 = expf(s[1] - m);
    float sum = e0 + e1;
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float p[2] = {e0 / sum, e1 / sum};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int key = lane + 32 * kk;
      sp[(kRW * warp + r) * kKeys + key] = p[kk];  // 0 past T
      if (kProbs && key < T && i0 + r < T)
        probs[(bh * T + i0 + r) * T + key] = p[kk];
    }
  }
  e2e::wait_async<0>();
  __syncthreads();  // V landed; the warps' probs are in sp

  // out = P V for the warp's rows: lane l takes columns 4 (g * 32 + l)..
  float4 o[kRW][kGroups];
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      o[r][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p0 = sp + kRW * warp * kKeys;
  for (int j = 0; j < T4; j += 4) {
    float w[kRW][4];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(p0 + r * kKeys + j);
      w[r][0] = pv.x;
      w[r][1] = pv.y;
      w[r][2] = pv.z;
      w[r][3] = pv.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int c = 4 * (g * 32 + lane);
        if (c < hd) {
          const float4 x =
              *reinterpret_cast<const float4*>(sv + (j + jj) * stride + c);
#pragma unroll
          for (int r = 0; r < kRW; ++r) {
            o[r][g].x = fmaf(w[r][jj], x.x, o[r][g].x);
            o[r][g].y = fmaf(w[r][jj], x.y, o[r][g].y);
            o[r][g].z = fmaf(w[r][jj], x.z, o[r][g].z);
            o[r][g].w = fmaf(w[r][jj], x.w, o[r][g].w);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    if (i0 + r >= T) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int c = 4 * (g * 32 + lane);
      if (c < hd)
        *reinterpret_cast<float4*>(out + (bh * T + i0 + r) * hd + c) = o[r][g];
    }
  }
}

// ---- the chunked route ------------------------------------------------------

constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows a block
constexpr int kChunk = 32;                    // keys a chunk

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

// One block of 8 warps per (tile of 32 query rows, head, batch item), each
// warp owning 4 rows; K and then V staged in chunks of 32 keys, rows padded
// by 4 floats so that the quarter-warps' 16-byte reads of 8 different rows
// hit distinct banks.
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
template <int kGroups>  // 128-wide column groups of out a lane covers
__global__ void __launch_bounds__(kWarps * 32) mhsa_chunked_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ pad_bias,
    const float* __restrict__ relmat, float* __restrict__ out,
    float* __restrict__ probs, int nh, int T, int hd, float scale) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows, hd + kPad]
  float* skv = sq + kRows * (hd + kPad);         // [kChunk, hd + kPad]
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
  for (int kc = 0; kc < T; kc += kChunk) {
    __syncthreads();
    stage(skv, kb, kc, kChunk, T, hd);
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
          const float s = __fadd_rn(
              __fadd_rn(__fmul_rn(acc[r], scale),
                        __ldg(rel + (size_t)i * T + key)),
              bias);
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
  for (int kc = 0; kc < T; kc += kChunk) {
    __syncthreads();
    stage(skv, vb, kc, kChunk, T, hd);
    __syncthreads();
    const int key = kc + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = q0 + row0 + r;
      p[r] = (key < T && i < T) ? pr[(size_t)i * T + key] : 0.f;
    }
    const int n = min(kChunk, T - kc);
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

// Shared memory a block of the chunked route takes.
size_t chunked_smem(int hd) {
  return static_cast<size_t>(kRows + kChunk) * (hd + kPad) * sizeof(float);
}

// The route and the query rows a warp at B, nh, T (hd aside): on chip up
// to kKeys keys, 8 rows a warp (64 a block: one tile a head, K and V read
// once) where B * nh such blocks fill the card's SMs and T > 32, else 2
// (16 a block: up to 4 times the blocks).
cudaError_t choose(int B, int nh, int T, int* rw) {
  *rw = 0;
  if (T > kKeys) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *rw = static_cast<long>(B) * nh >= sms && T > 32 ? 8 : 2;
  return cudaSuccess;
}

// Launches kKernel on grid (tiles of `rows` query rows, nh, B) with `smem`
// bytes, its shared-memory cap raised once (one flag an instantiation) to
// `cap`, what the widest head and T of its route take.
template <auto kKernel>
cudaError_t launch(int rows, size_t smem, size_t cap, const float* q,
                   const float* k, const float* v, const float* pad_bias,
                   const float* relmat, float* out, float* probs, int B,
                   int nh, int T, int hd, cudaStream_t stream) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cap));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const dim3 grid((T + rows - 1) / rows, nh, B);
  kKernel<<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, pad_bias, relmat, out, probs, nh, T, hd,
      static_cast<float>(1.0 / sqrt(static_cast<double>(hd))));
  return cudaGetLastError();
}

template <int kRW, int kGroups>
cudaError_t launch_onchip(const float* q, const float* k, const float* v,
                          const float* pad_bias, const float* relmat,
                          float* out, float* probs, int B, int nh, int T,
                          int hd, cudaStream_t stream) {
  const int rows = kRW * kWarps;
  const size_t smem = onchip_smem(rows, T, hd);
  const size_t cap = onchip_smem(rows, kKeys, kMaxHd);
  return probs == nullptr
             ? launch<mhsa_onchip_kernel<kRW, kGroups, false>>(
                   rows, smem, cap, q, k, v, pad_bias, relmat, out, probs, B,
                   nh, T, hd, stream)
             : launch<mhsa_onchip_kernel<kRW, kGroups, true>>(
                   rows, smem, cap, q, k, v, pad_bias, relmat, out, probs, B,
                   nh, T, hd, stream);
}

}  // namespace

// The route at B, nh, T and head width hd on the current device
// (kernels/mhsa.plan reads it): out = {1 if "onchip" else 0 ("chunked"),
// query rows a block, the widest T kept on chip, shared memory a block in
// bytes}.
E2E_EXPORT int e2e_mhsa_plan(int B, int nh, int T, int hd, int* out) {
  if (B < 1 || nh < 1 || T < 1 || hd < 4 || hd % 4 || hd > kMaxHd ||
      out == nullptr)
    return cudaErrorInvalidValue;
  int rw = 0;
  const cudaError_t e = choose(B, nh, T, &rw);
  if (e != cudaSuccess) return e;
  out[0] = rw > 0 ? 1 : 0;
  out[1] = rw > 0 ? rw * kWarps : kRows;
  out[2] = kKeys;
  out[3] = static_cast<int>(rw > 0 ? onchip_smem(rw * kWarps, T, hd)
                                   : chunked_smem(hd));
  return cudaSuccess;
}

// probs: [B, nh, T, T], written in the probs form; NULL asks for the
// out-only form, which the chunked route (T > 64) does not have: there the
// caller hands in a scratch of that shape. rows: the query rows a block as
// e2e_mhsa_plan gave them (16 or 64 on chip; 32 chunked).
E2E_EXPORT int e2e_mhsa_fwd(const float* q, const float* k, const float* v,
                            const float* pad_bias, const float* relmat,
                            float* out, float* probs, int B, int nh, int T,
                            int hd, int rows, cudaStream_t stream) {
  if (B < 1 || B > 65535 || nh < 1 || nh > 65535 || T < 1 || hd < 4 ||
      hd % 4 || hd > kMaxHd)
    return cudaErrorInvalidValue;
  const bool wide = hd > 128;
#define E2E_MHSA_ARGS \
  q, k, v, pad_bias, relmat, out, probs, B, nh, T, hd, stream
  if (T <= kKeys) {
    switch (rows) {
      case 2 * kWarps:
        return wide ? launch_onchip<2, 2>(E2E_MHSA_ARGS)
                    : launch_onchip<2, 1>(E2E_MHSA_ARGS);
      case 8 * kWarps:
        return wide ? launch_onchip<8, 2>(E2E_MHSA_ARGS)
                    : launch_onchip<8, 1>(E2E_MHSA_ARGS);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (probs == nullptr || rows != kRows) return cudaErrorInvalidValue;
  const size_t smem = chunked_smem(hd), cap = chunked_smem(kMaxHd);
  return wide ? launch<mhsa_chunked_kernel<2>>(kRows, smem, cap,
                                               E2E_MHSA_ARGS)
              : launch<mhsa_chunked_kernel<1>>(kRows, smem, cap,
                                               E2E_MHSA_ARGS);
#undef E2E_MHSA_ARGS
}
