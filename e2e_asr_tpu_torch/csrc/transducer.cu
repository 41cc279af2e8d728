// Kernel #17: the transducer (RNN-T) lattice loss, forward and backward.
//
// Replaces e2e_asr_tpu/ops/transducer_pallas.py: the forward _fwd_call
// (body _fwd_kernel) and the backward _bwd_call (body _bwd_kernel), under
// the custom VJP transducer_loss_pallas. Graves 2012 on the [T, U+1]
// lattice of each example:
//   alpha[0,0] = 0, alpha[0,u] = sum_{j<u} label[0,j],
//   alpha[t,u] = logaddexp(alpha[t-1,u] + blank[t-1,u],
//                          alpha[t,u-1] + label[t,u-1]),
//   loss_b = -(alpha[t_b-1,u_b] + blank[t_b-1,u_b]);
// the backward walks the beta recurrence in reverse from the virtual exit
// row beta[t_b, u] = (u == u_b ? 0 : log 0) and writes the occupancy
// gradients as it goes (beta itself is never stored):
//   gblank[t,u] = -g_b exp(alpha[t,u] + blank[t,u] + beta[t+1,u] - logZ_b),
//   glabel[t,u] = -g_b exp(alpha[t,u] + label[t,u] + beta[t,u+1] - logZ_b),
// with logZ_b = -loss_b. Lengths are clamped (t_b to [1, T], u_b to
// [0, U]). A cell outside an example's lattice (t >= t_b or u > u_b, and
// labels at u >= u_b) feeds nothing into its loss, so its gradient is
// written as an exact zero; labels at u >= u_b are never read, which is
// the reference's mask to log 0 (-1e30). Ragged lengths run in one launch.
//
// Bound on the H100: latency. At the bench's lattice (B=128, T'=48, U=47)
// the forward moves about 3.5 MB (1.1 us at 3.35 TB/s) and the backward
// about 5.9 MB (1.8 us), but each is a chain of T+U-1 = 94 dependent
// steps per example, and every step waits on its predecessor's values.
//
// Design: one block per example (grid B; 128 blocks are one wave on the
// 132 SMs), the threads over u. A cell depends only on the two cells of
// the previous anti-diagonal t+u = d-1 (forward) or of the next one
// (backward), so the block walks the t_b + u_b - 1 diagonals of its own
// lattice: each step reads the neighbouring diagonal from shared memory
// (double-buffered, so one __syncthreads a step suffices), computes its
// cells and writes alpha (forward) or the two gradients (backward) to
// device memory. No scan over u is needed, unlike the TPU kernel's
// Hillis-Steele rows. logaddexp is jnp.logaddexp's formula:
// max + log1p(exp(-|a - b|)).
#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;  // the reference's log 0 (finite)

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ void lengths(const int* tl, const int* ul, int b,
                                        int T, int U, int& t_b, int& u_b) {
  t_b = min(max(tl[b], 1), T);
  u_b = min(max(ul[b], 0), U);
}

// blank [B,T,U1], label [B,T,U1-1], t_lens/u_lens [B] -> loss [B] and
// alpha [B,T,U1] (written for t < t_b, u <= u_b; the rest is not read).
__global__ void transducer_fwd_kernel(
    const float* __restrict__ blank, const float* __restrict__ label,
    const int* __restrict__ tl, const int* __restrict__ ul,
    float* __restrict__ loss, float* __restrict__ alpha, int T, int U1) {
  extern __shared__ float diag[];  // [2][U1]
  const int b = blockIdx.x, U = U1 - 1;
  int t_b, u_b;
  lengths(tl, ul, b, T, U, t_b, u_b);
  const float* bl = blank + (size_t)b * T * U1;
  const float* lb = label + (size_t)b * T * U;
  float* al = alpha + (size_t)b * T * U1;
  for (int d = 0; d < t_b + u_b; ++d) {
    const float* prev = diag + ((d + 1) & 1) * U1;
    float* cur = diag + (d & 1) * U1;
    for (int u = threadIdx.x; u <= u_b; u += blockDim.x) {
      const int t = d - u;
      if (t < 0 || t >= t_b) continue;
      float a;
      if (t == 0 && u == 0) {
        a = 0.f;
      } else if (t == 0) {
        a = prev[u - 1] + lb[u - 1];
      } else if (u == 0) {
        a = prev[0] + bl[(size_t)(t - 1) * U1];
      } else {
        a = logaddexp(prev[u] + bl[(size_t)(t - 1) * U1 + u],
                      prev[u - 1] + lb[(size_t)t * U + u - 1]);
      }
      cur[u] = a;
      al[(size_t)t * U1 + u] = a;
      if (t == t_b - 1 && u == u_b)
        loss[b] = -(a + bl[(size_t)t * U1 + u]);
    }
    __syncthreads();
  }
}

// The backward: the same inputs, alpha and loss from the forward, g [B] ->
// gblank [B,T,U1], glabel [B,T,U1-1], every element written.
__global__ void transducer_bwd_kernel(
    const float* __restrict__ blank, const float* __restrict__ label,
    const int* __restrict__ tl, const int* __restrict__ ul,
    const float* __restrict__ alpha, const float* __restrict__ loss,
    const float* __restrict__ g, float* __restrict__ gblank,
    float* __restrict__ glabel, int T, int U1) {
  extern __shared__ float diag[];  // [2][U1]
  const int b = blockIdx.x, U = U1 - 1;
  int t_b, u_b;
  lengths(tl, ul, b, T, U, t_b, u_b);
  const float* bl = blank + (size_t)b * T * U1;
  const float* lb = label + (size_t)b * T * U;
  const float* al = alpha + (size_t)b * T * U1;
  float* gb = gblank + (size_t)b * T * U1;
  float* gl = glabel + (size_t)b * T * U;
  // Outside the lattice: exact zeros.
  for (int i = threadIdx.x; i < T * U1; i += blockDim.x) {
    const int t = i / U1, u = i - t * U1;
    if (t >= t_b || u > u_b) gb[i] = 0.f;
  }
  for (int i = threadIdx.x; i < T * U; i += blockDim.x) {
    const int t = i / U, u = i - t * U;
    if (t >= t_b || u >= u_b) gl[i] = 0.f;
  }
  const float logz = -loss[b], scale = -g[b];
  for (int d = t_b + u_b - 1; d >= 0; --d) {
    const float* next = diag + ((d + 1) & 1) * U1;
    float* cur = diag + (d & 1) * U1;
    for (int u = threadIdx.x; u <= u_b; u += blockDim.x) {
      const int t = d - u;
      if (t < 0 || t >= t_b) continue;
      const size_t i = (size_t)t * U1 + u;
      // beta[t+1, u]: the virtual exit row past the last frame.
      const float down =
          t + 1 == t_b ? (u == u_b ? 0.f : kNeg) : next[u];
      const float a = al[i], blank_lp = bl[i];
      gb[i] = expf(a + blank_lp + down - logz) * scale;
      float beta = blank_lp + down;
      if (u < u_b) {
        const float label_lp = lb[(size_t)t * U + u];
        const float right = next[u + 1];  // beta[t, u+1]
        gl[(size_t)t * U + u] = expf(a + label_lp + right - logz) * scale;
        beta = logaddexp(beta, label_lp + right);
      }
      cur[u] = beta;
    }
    __syncthreads();
  }
}

int block_threads(int U1) {
  const int n = ((U1 + 31) / 32) * 32;
  return n > 1024 ? 1024 : n;
}

bool valid_shape(int B, int T, int U1) {
  return B >= 1 && T >= 1 && U1 >= 1 &&
         (size_t)2 * U1 * sizeof(float) <= 48 * 1024 &&
         (size_t)T * U1 < (size_t)1 << 31;
}

}  // namespace

// blank [B,T,U1], label [B,T,U1-1], t_lens/u_lens [B] int32 -> loss [B],
// alpha [B,T,U1].
E2E_EXPORT int e2e_transducer_fwd(const float* blank, const float* label,
                                  const int* tl, const int* ul, float* loss,
                                  float* alpha, int B, int T, int U1,
                                  cudaStream_t stream) {
  if (!valid_shape(B, T, U1)) return cudaErrorInvalidValue;
  transducer_fwd_kernel<<<B, block_threads(U1), 2 * U1 * sizeof(float),
                          stream>>>(blank, label, tl, ul, loss, alpha, T, U1);
  return cudaGetLastError();
}

// The same inputs, the forward's alpha and loss, g [B] -> gblank
// [B,T,U1], glabel [B,T,U1-1].
E2E_EXPORT int e2e_transducer_bwd(const float* blank, const float* label,
                                  const int* tl, const int* ul,
                                  const float* alpha, const float* loss,
                                  const float* g, float* gblank,
                                  float* glabel, int B, int T, int U1,
                                  cudaStream_t stream) {
  if (!valid_shape(B, T, U1)) return cudaErrorInvalidValue;
  transducer_bwd_kernel<<<B, block_threads(U1), 2 * U1 * sizeof(float),
                          stream>>>(blank, label, tl, ul, alpha, loss, g,
                                    gblank, glabel, T, U1);
  return cudaGetLastError();
}
