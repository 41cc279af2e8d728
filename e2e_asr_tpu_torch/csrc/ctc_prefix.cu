// Kernel #16: the CTC prefix-score frame scan of one joint CTC/attention
// beam step.
//
// Replaces e2e_asr_tpu/ops/ctc_prefix_pallas.py prefix_scan (body _kernel).
// For each row bk (a hypothesis of the beam) and candidate p (a token that
// may extend it), four carries start at rn = rb = psi = NEG_INF and
// phi = phi0[bk, p], and each frame t applies (Watanabe/Hori joint
// decoding):
//   rn_t  = lse(rn, phi) + xc[t, bk, p]
//   rb_t  = lse(rb, rn) + xb[t, bk]
//   psi   = lse(psi, phi + xc[t, bk, p])
//   phi   = lse(rb_par[t, bk], rn_par[t, bk] + allow_neg[bk, p])
// writing rn_t and rb_t for every frame and psi once after the last. rn and
// psi read the previous frame's phi; the new phi reads the parent's
// rn_par / rb_par of the same frame. lse is the reference's exact form,
// m = max(max(a, b), NEG_INF); m + log(exp(a - m) + exp(b - m)), with
// NEG_INF = -1e30, in expf / logf (the build sets no fast math).
//
// Bound on the H100: latency. At the serving shape (B=8, k=4, so BK=32;
// P = V = 40; T = 64 frames) the scan moves about 3 * T * BK * P * 4 B =
// 0.98 MB (0.29 us at 3.35 TB/s) and its arithmetic is negligible, but
// every chain is 64 dependent steps of an lse.
//
// Design: the BK * P chains are independent and each is sequential in t,
// so one thread runs one chain with its carries in registers; a block
// covers 64 consecutive chains (whole rows where P divides 64, else rows
// split across blocks; no row needs its block). Per frame the threads read
// xc coalesced over p and the row's three values through the read-only
// cache, and write rn_t and rb_t coalesced. The next frame's inputs are
// loaded before the current frame is computed, so the loads overlap the
// chain. T is taken as it comes (the TPU kernel pads it to a multiple of 8
// only for its grid).
#include "common.cuh"

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), e2e::kNegInf);
  return m + logf(expf(a - m) + expf(b - m));
}

// xc [T, BK, P]; xb, rn_par, rb_par [T, BK]; allow_neg, phi0 [BK, P] ->
// psi [BK, P], rn, rb [T, BK, P].
__global__ void __launch_bounds__(kThreads) ctc_prefix_kernel(
    const float* __restrict__ xc, const float* __restrict__ xb,
    const float* __restrict__ rn_par, const float* __restrict__ rb_par,
    const float* __restrict__ allow_neg, const float* __restrict__ phi0,
    float* __restrict__ psi_out, float* __restrict__ rn_out,
    float* __restrict__ rb_out, int T, int BK, int P) {
  const int chains = BK * P;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= chains) return;
  const int bk = i / P;
  const float allow = allow_neg[i];
  float rn = e2e::kNegInf, rb = e2e::kNegInf, psi = e2e::kNegInf;
  float phi = phi0[i];
  // Frame 0's inputs; each iteration loads frame t + 1's before it
  // computes frame t.
  float x = xc[i], xbt = __ldg(xb + bk), rnp = __ldg(rn_par + bk),
        rbp = __ldg(rb_par + bk);
  for (int t = 0; t < T; ++t) {
    float x_n = 0.f, xb_n = 0.f, rnp_n = 0.f, rbp_n = 0.f;
    if (t + 1 < T) {
      const size_t row = (size_t)(t + 1) * BK + bk;
      x_n = xc[(size_t)(t + 1) * chains + i];
      xb_n = __ldg(xb + row);
      rnp_n = __ldg(rn_par + row);
      rbp_n = __ldg(rb_par + row);
    }
    const float rn_t = lse(rn, phi) + x;
    const float rb_t = lse(rb, rn) + xbt;
    psi = lse(psi, phi + x);
    phi = lse(rbp, rnp + allow);
    rn = rn_t;
    rb = rb_t;
    const size_t o = (size_t)t * chains + i;
    rn_out[o] = rn_t;
    rb_out[o] = rb_t;
    x = x_n;
    xbt = xb_n;
    rnp = rnp_n;
    rbp = rbp_n;
  }
  psi_out[i] = psi;
}

}  // namespace

E2E_EXPORT int e2e_ctc_prefix_scan(const float* xc, const float* xb,
                                   const float* rn_par, const float* rb_par,
                                   const float* allow_neg, const float* phi0,
                                   float* psi, float* rn, float* rb, int T,
                                   int BK, int P, cudaStream_t stream) {
  if (T < 1 || BK < 1 || P < 1) return cudaErrorInvalidValue;
  const long long chains = (long long)BK * P;
  if (chains > (1LL << 30) || chains * T > (1LL << 40))
    return cudaErrorInvalidValue;
  const int blocks = (int)((chains + kThreads - 1) / kThreads);
  ctc_prefix_kernel<<<blocks, kThreads, 0, stream>>>(
      xc, xb, rn_par, rb_par, allow_neg, phi0, psi, rn, rb, T, BK, P);
  return cudaGetLastError();
}
