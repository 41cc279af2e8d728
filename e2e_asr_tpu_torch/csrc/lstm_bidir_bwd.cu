// Backward of kernel A: the gradients of one bidirectional LSTM layer.
//
// Replaces e2e_asr_tpu/ops/lstm_pallas.py _bwd_seq_bidir (both directions in
// one launch, e2e_lstm_bwd with n_dirs = 2) and _bwd_seq (one direction with
// an optional carry mask, n_dirs = 1): from the saved h and c of the
// training forward (csrc/lstm_bidir.cu) and the output gradient g, they
// give dx_proj [T,B,4H] (= dgates) and dW_h [H,4H] of each direction.
//
// Bound: like the forward, the reverse-time recurrence. Each step needs the
// whole previous dh, so a chain is serial, and each step reads W_h (1 MiB at
// H=256) twice from L2: once to recompute the gates from the saved h_{t-1}
// (as _bwd_seq_xla does, lstm_pallas.py:731-775), once for
// dh_{t-1} = dgates . W_h^T. dW_h = sum over t, b of h_{t-1}^T dgates_t is
// a product over T*B rows that nothing in the recurrence waits for.
//
// Design: (1) the chain kernel, one block per chain (batch row b, direction
// d), walks time in reverse with dh in shared memory and dc in registers.
// The gate recompute reuses the forward's depth-slice layout (thread (s, u)
// owns unit u's four gate columns over the s-th slice of the depth); the
// cell backward runs on one thread per unit; dh_{t-1} takes one warp per
// row k of W_h (its 4H columns are contiguous, 128-byte loads) and a warp
// shuffle sum. Steps where the backward direction is invalid (its mask is
// 0: leading padding of the flipped sequence) pass dh and dc through and
// give zero dgates, as the reference's carry-through does (:765-766). The
// chain writes dgates, which is dx_proj. (2) dW_h, the tiled reduction of
// csrc/dw.cuh over the T*B rows of h_{t-1} and dgates, split over `splits`
// blocks and summed in a fixed order: no atomics, the same result every
// run.
#include "dw.cuh"

namespace {

struct ChainDir {
  const float *w, *h, *c, *xp, *g, *mask;  // mask may be null (all valid)
  float* dx;
};

struct ChainArgs {
  ChainDir dir[2];
  int T, B, H, S;
};

__global__ void __launch_bounds__(1024) lstm_bwd_chain_kernel(ChainArgs a) {
  extern __shared__ float sm[];
  const int H = a.H, H4 = 4 * H, B = a.B, S = a.S;
  float* hprev = sm;            // [H] h_{t-1}
  float* part = hprev + H;      // [S][4][H] partial gate sums
  float* dg = part + S * 4 * H; // [4H] dgates of this step
  float* dht = dg + H4;         // [H] dh_total of this step
  float* dh = dht + H;          // [H] carried dh
  const int b = blockIdx.x;
  const ChainDir d = a.dir[blockIdx.y];
  const int Hp = blockDim.x / S;
  const int u = threadIdx.x % Hp, s = threadIdx.x / Hp;
  const int chunk = (H + S - 1) / S;
  const int k0 = min(H, s * chunk), k1 = min(H, k0 + chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < H; i += blockDim.x) dh[i] = 0.f;
  float dc = 0.f;

  for (int t = a.T - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    for (int i = threadIdx.x; i < H; i += blockDim.x)
      hprev[i] = t > 0 ? d.h[(row - B) * H + i] : 0.f;
    __syncthreads();
    if (u < H) {  // gate recompute: partial sums of h_{t-1} . W_h
      float ai = 0.f, aj = 0.f, af = 0.f, ao = 0.f;
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float hk = hprev[k];
        const float* wk = d.w + static_cast<size_t>(k) * H4 + u;
        ai = fmaf(hk, __ldg(wk), ai);
        aj = fmaf(hk, __ldg(wk + H), aj);
        af = fmaf(hk, __ldg(wk + 2 * H), af);
        ao = fmaf(hk, __ldg(wk + 3 * H), ao);
      }
      float* p = part + (s * 4) * H + u;
      p[0] = ai;
      p[H] = aj;
      p[2 * H] = af;
      p[3 * H] = ao;
    }
    __syncthreads();
    const float valid = d.mask != nullptr ? d.mask[row] : 1.f;
    if (s == 0 && u < H) {  // cell backward of unit u
      const float* x = d.xp + row * H4 + u;
      float gi = x[0], gj = x[H], gf = x[2 * H], go = x[3 * H];
      for (int q = 0; q < S; ++q) {
        const float* p = part + (q * 4) * H + u;
        gi += p[0];
        gj += p[H];
        gf += p[2 * H];
        go += p[3 * H];
      }
      const float i = e2e::sigmoid(gi), j = tanhf(gj);
      const float f = e2e::sigmoid(gf + 1.f), o = e2e::sigmoid(go);
      const float c_prev = t > 0 ? d.c[(row - B) * H + u] : 0.f;
      const float tanh_c = tanhf(d.c[row * H + u]);
      const float dh_total = d.g[row * H + u] * valid + dh[u];
      const float dO = dh_total * tanh_c * o * (1.f - o);
      const float dc_total = dh_total * o * (1.f - tanh_c * tanh_c) + dc;
      const float dF = dc_total * c_prev * f * (1.f - f);
      const float dI = dc_total * j * i * (1.f - i);
      const float dJ = dc_total * i * (1.f - j * j);
      float* out = d.dx + row * H4 + u;
      dg[u] = out[0] = dI * valid;
      dg[H + u] = out[H] = dJ * valid;
      dg[2 * H + u] = out[2 * H] = dF * valid;
      dg[3 * H + u] = out[3 * H] = dO * valid;
      dht[u] = dh_total;
      dc = valid * (dc_total * f) + (1.f - valid) * dc;
    }
    __syncthreads();
    for (int k = warp; k < H; k += nwarps) {  // dh_{t-1} = dgates . W_h^T
      const float* wk = d.w + static_cast<size_t>(k) * H4;
      float acc = 0.f;
#pragma unroll 8
      for (int col = lane; col < H4; col += 32)
        acc = fmaf(__ldg(wk + col), dg[col], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dh[k] = valid * acc + (1.f - valid) * dht[k];
    }
    __syncthreads();
  }
}

int chain_slices(int H) {
  const int Hp = (H + 31) / 32 * 32;
  return max(1, min(4, 1024 / Hp));
}

size_t chain_smem(int H) {
  return static_cast<size_t>(H) * (1 + 4 * chain_slices(H) + 4 + 2) *
         sizeof(float);
}

}  // namespace

// ptrs: per direction (n_dirs of them) w [H,4H], h [T,B,H], c [T,B,H],
// x_proj [T,B,4H], g [T,B,H], mask [T,B] or NULL, dx [T,B,4H] (out),
// dw [H,4H] (out), part [splits,H,4H] (scratch).
E2E_EXPORT int e2e_lstm_bwd(const void* const* ptrs, int n_dirs, int T, int B,
                            int H, int splits, cudaStream_t stream) {
  if (n_dirs < 1 || n_dirs > 2 || H < 1 || H > 1024 || B < 1 ||
      B > 65535 || T < 1 || splits < 1 || splits > 65535 / n_dirs)
    return cudaErrorInvalidValue;
  auto in = [&](int d, int i) {
    return static_cast<const float*>(ptrs[9 * d + i]);
  };
  auto out = [&](int d, int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[9 * d + i]));
  };
  ChainArgs ca{};
  e2e::DwJobs da{};
  for (int d = 0; d < n_dirs; ++d) {
    ca.dir[d] = {in(d, 0), in(d, 1), in(d, 2), in(d, 3), in(d, 4), in(d, 5),
                 out(d, 6)};
    // dW_h = sum over rows of h_{t-1}^T dgates: h shifted by one step.
    da.job[d] = {in(d, 1), out(d, 6), B, H, 4 * H, out(d, 8), out(d, 7)};
  }
  ca.T = T;
  ca.B = B;
  ca.H = H;
  ca.S = chain_slices(H);
  const size_t smem = chain_smem(H);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int Hp = (H + 31) / 32 * 32;
  lstm_bwd_chain_kernel<<<dim3(B, n_dirs), Hp * ca.S, smem, stream>>>(ca);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  da.n = n_dirs;
  da.R = T * B;
  da.splits = splits;
  return e2e::launch_dw(da, stream);
}
