// Kernel D: one beam-search selection step.
//
// Replaces e2e_asr_tpu/ops/beam_select_pallas.py beam_select. Per batch row:
// top-k over the k*V candidates scores[p] + logp[p, v] of live parents (dead
// parents score exactly NEG_INF = -1e30), ties to the lowest flat index as
// lax.top_k; accept rank r iff r < k - num_finished; accepted <eos> goes to
// finished-buffer slot num_finished + (its rank among this step's
// finishes), anything else to slot k (dropped); then the stable live-first
// compaction order.
//
// Layout: one warp per batch row. The candidates sit in shared memory (640
// bytes at k=4, V=40) with a taken flag each; each of the k rounds is a
// strided scan plus a 5-step shuffle argmax over the untaken candidates, so
// every round picks a valid index whatever the values (-inf and NaN
// included). The order is that of the plain version's stable descending
// sort: NaN above everything, then by value, ties to the lowest flat index
// (as lax.top_k). Lane 0 then does the O(k) integer bookkeeping. The work
// is a few hundred instructions; the launch itself is the cost.
#include "common.cuh"

namespace {

// Whether candidate (v, i) ranks before (bv, bi); index -1 is "none".
__device__ __forceinline__ bool ranks_before(float v, int i, float bv,
                                             int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

__global__ void beam_select_kernel(
    const float* __restrict__ scores, const float* __restrict__ logp,
    const bool* __restrict__ alive, const int* __restrict__ num_finished,
    int k, int V, int eos_id, float* __restrict__ vals,
    int* __restrict__ parent, int* __restrict__ token,
    float* __restrict__ accept, float* __restrict__ fin_sel,
    int* __restrict__ fin_dest, int* __restrict__ order,
    float* __restrict__ slot_valid) {
  // Shared: float cand[k*V], int sel[k], bool taken[k*V].
  extern __shared__ float cand[];
  const int KV = k * V;
  int* sel = reinterpret_cast<int*>(cand + KV);
  bool* taken = reinterpret_cast<bool*>(sel + k);
  const int b = blockIdx.x, lane = threadIdx.x;
  const float* lp = logp + static_cast<size_t>(b) * KV;

  for (int i = lane; i < KV; i += 32) {
    const int p = i / V;
    cand[i] = alive[b * k + p] ? scores[b * k + p] + lp[i] : e2e::kNegInf;
    taken[i] = false;
  }
  __syncwarp();

  for (int r = 0; r < k; ++r) {
    float best = 0.f;
    int bi = -1;
    for (int i = lane; i < KV; i += 32) {
      if (!taken[i] && ranks_before(cand[i], i, best, bi)) {
        best = cand[i];
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ranks_before(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
    // k <= k*V candidates, so every round finds an untaken one: bi >= 0.
    if (lane == 0) {
      sel[r] = bi;
      vals[b * k + r] = best;
      taken[bi] = true;
    }
    __syncwarp();
  }

  if (lane != 0) return;
  const int nf = num_finished[b];
  int fin_rank = 0, live = 0;
  for (int r = 0; r < k; ++r) {
    const int p = sel[r] / V, t = sel[r] % V;
    const bool acc = r < k - nf;
    const bool fin = acc && t == eos_id;
    const bool lsel = acc && t != eos_id;
    const int o = b * k + r;
    parent[o] = p;
    token[o] = t;
    accept[o] = acc ? 1.f : 0.f;
    fin_sel[o] = fin ? 1.f : 0.f;
    fin_dest[o] = fin ? nf + fin_rank : k;
    fin_rank += fin;
    live += lsel;
    sel[r] = lsel;
  }
  int next_live = 0, next_dead = live;
  for (int r = 0; r < k; ++r) {
    const int slot = b * k + (sel[r] ? next_live++ : next_dead++);
    order[slot] = r;
    slot_valid[slot] = sel[r] ? 1.f : 0.f;
  }
}

}  // namespace

// scores [B,k] f32, logp [B,k,V] f32, alive [B,k] bool, num_finished [B]
// int32 -> vals, accept, fin_sel, slot_valid [B,k] f32; parent, token,
// fin_dest, order [B,k] int32.
E2E_EXPORT int e2e_beam_select(const float* scores, const float* logp,
                               const bool* alive, const int* num_finished,
                               int B, int k, int V, int eos_id, float* vals,
                               int* parent, int* token, float* accept,
                               float* fin_sel, int* fin_dest, int* order,
                               float* slot_valid, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * V * (sizeof(float) + 1) +
                      static_cast<size_t>(k) * sizeof(int);
  if (B < 1 || k < 1 || V < 1 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  beam_select_kernel<<<B, 32, smem, stream>>>(
      scores, logp, alive, num_finished, k, V, eos_id, vals, parent, token,
      accept, fin_sel, fin_dest, order, slot_valid);
  return cudaGetLastError();
}
