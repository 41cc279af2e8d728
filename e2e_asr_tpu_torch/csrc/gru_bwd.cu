// Kernel #7: backward of a GRU layer over a sequence (kernel #6), one
// direction or both directions of a bidirectional layer in one launch.
//
// Replaces e2e_asr_tpu/ops/gru_pallas.py _bwd_seq: from the output
// gradient g [T,B,H] it gives dgates_x [T,B,2H], dcand_x [T,B,H], dW_gh
// [H,2H] and dW_ch [H,H], with the optional carry mask of the backward
// direction (invalid steps pass dh through and give zero gradients).
//
// Per step, in reverse (the cell backward of _gru_cell_bwd):
//   dh_t = g_t + dh;  du = dh_t (h_{t-1} - c);  dcpre = dh_t (1-u)(1-c^2)
//   d(rh) = dcpre @ W_ch^T;  dr = d(rh) h_{t-1}
//   dgates = [dr r(1-r), du u(1-u)]
//   dh_{t-1} = dh_t u + d(rh) r + dgates @ W_gh^T
// Two dependent products a step again. The JAX kernel recomputes r, u and
// c from the saved h rows, two more dependent products a step; here the
// training forward saved r | u and c (3H floats a row and step more: 151
// MiB a direction at T=384, B=128, H=256), so the chain reads them.
//
// Design: (1) the chain kernel, one block per chain (batch row b,
// direction d), the thread layout of the forward (csrc/gru_fwd.cuh: thread
// (u, s) owns unit u over a slice of the depth, the slices meet by warp
// shuffles), dh carried in registers; the two products read transposed
// copies of the weights (W_ch^T [H,H], W_gh^T [2H,H]) so that a thread's
// column stays its own unit and a warp's loads stay on neighbouring
// columns. Two __syncthreads a step: after dcpre and after dgates are
// published to shared memory. The chain also writes r * h_{t-1}, the input
// of dW_ch. (2) dW_gh = sum h_{t-1}^T dgates and dW_ch = sum (r h_{t-1})^T
// dcpre, the tiled reduction of csrc/dw.cuh over the T*B rows: no atomics,
// a fixed order.
#include "dw.cuh"
#include "gru_fwd.cuh"

namespace {

struct Dir {
  const float *wgT, *wcT, *h, *ru, *c, *g, *mask;
  float *dgx, *dcx, *rh;
};

struct Args {
  Dir dir[2];
  int T, B, H, S;
};

__global__ void __launch_bounds__(1024) gru_bwd_chain_kernel(Args a) {
  extern __shared__ float sm[];
  const int H = a.H, H2 = 2 * H, B = a.B, S = a.S;
  float* dcp = sm;       // [H] dcpre of this step
  float* dg = sm + H;    // [2H] dgates of this step
  const Dir d = a.dir[blockIdx.y];
  const int b = blockIdx.x;
  const int u = threadIdx.x / S, s = threadIdx.x % S;
  const bool unit = u < H;
  const int chunk = (H + S - 1) / S, chunk2 = (H2 + S - 1) / S;
  const int k0 = min(H, s * chunk), k1 = min(H, k0 + chunk);
  const int j0 = min(H2, s * chunk2), j1 = min(H2, j0 + chunk2);
  float dh = 0.f;

  for (int t = a.T - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    const float valid = d.mask != nullptr ? d.mask[row] : 1.f;
    float hp = 0.f, r = 0.f, uu = 0.f, dht = 0.f, du = 0.f, dcpre = 0.f;
    if (unit) {
      hp = t > 0 ? d.h[(row - B) * H + u] : 0.f;
      r = d.ru[row * H2 + u];
      uu = d.ru[row * H2 + H + u];
      const float c = d.c[row * H + u];
      dht = d.g[row * H + u] + dh;
      du = dht * (hp - c);
      dcpre = dht * (1.f - uu) * (1.f - c * c) * valid;
    }
    if (unit && s == 0) dcp[u] = dcpre;
    __syncthreads();
    float drh = 0.f;
    if (unit) {
#pragma unroll 8
      for (int k = k0; k < k1; ++k)
        drh = fmaf(dcp[k], __ldg(d.wcT + static_cast<size_t>(k) * H + u),
                   drh);
    }
    drh = e2e::unit_sum(drh, S);
    const float dgr = drh * hp * r * (1.f - r) * valid;
    const float dgu = du * uu * (1.f - uu) * valid;
    if (unit && s == 0) {
      dg[u] = dgr;
      dg[H + u] = dgu;
      d.dgx[row * H2 + u] = dgr;
      d.dgx[row * H2 + H + u] = dgu;
      d.dcx[row * H + u] = dcpre;
      d.rh[row * H + u] = r * hp;
    }
    __syncthreads();
    float acc = 0.f;
    if (unit) {
#pragma unroll 8
      for (int j = j0; j < j1; ++j)
        acc = fmaf(dg[j], __ldg(d.wgT + static_cast<size_t>(j) * H + u),
                   acc);
    }
    acc = e2e::unit_sum(acc, S);
    dh = valid * (dht * uu + drh * r + acc) + (1.f - valid) * dht;
  }
}

}  // namespace

// ptrs: per direction (n_dirs of them) w_gh^T [2H,H], w_ch^T [H,H], the
// forward's h [T,B,H], ru [T,B,2H] and c [T,B,H], g [T,B,H], mask [T,B] or
// NULL; outputs dgates_x [T,B,2H], dcand_x [T,B,H], dW_gh [H,2H], dW_ch
// [H,H]; scratch rh [T,B,H], part_g [splits,H,2H], part_c [splits,H,H].
E2E_EXPORT int e2e_gru_bwd(const void* const* ptrs, int n_dirs, int T, int B,
                           int H, int splits, cudaStream_t stream) {
  if (n_dirs < 1 || n_dirs > 2 || H < 1 || H > 1024 || B < 1 ||
      B > 65535 || T < 1 || splits < 1)
    return cudaErrorInvalidValue;
  Args a{};
  e2e::DwJobs dw{};
  for (int d = 0; d < n_dirs; ++d) {
    const void* const* p = ptrs + 14 * d;
    auto in = [&](int i) { return static_cast<const float*>(p[i]); };
    auto out = [&](int i) {
      return static_cast<float*>(const_cast<void*>(p[i]));
    };
    a.dir[d] = {in(0), in(1), in(2), in(3), in(4), in(5), in(6),
                out(7), out(8), out(11)};
    // dW_gh = sum h_{t-1}^T dgates (h shifted one step), dW_ch = sum
    // (r h_{t-1})^T dcpre.
    dw.job[2 * d] = {in(2), out(7), B, H, 2 * H, out(12), out(9)};
    dw.job[2 * d + 1] = {out(11), out(8), 0, H, H, out(13), out(10)};
  }
  a.T = T;
  a.B = B;
  a.H = H;
  a.S = e2e::gru_slices(H);
  const size_t smem = 3 * static_cast<size_t>(H) * sizeof(float);
  gru_bwd_chain_kernel<<<dim3(B, n_dirs), e2e::gru_threads(H), smem,
                         stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dw.n = 2 * n_dirs;
  dw.R = T * B;
  dw.splits = splits;
  return e2e::launch_dw(dw, stream);
}
