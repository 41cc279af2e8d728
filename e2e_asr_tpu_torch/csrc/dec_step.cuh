// The output stages of a decoder step, shared by kernel C (output_fused,
// dec_step.cu) and kernel #13 (attn_output_fused, attn_output.cu):
// AttnProjection([query, context]) -> OutputProjection -> log_softmax, over
// N rows inside one cooperative launch built from tiles.cuh. No vocabulary
// padding (the 128-lane padding was a TPU layout artifact).
#pragma once

#include "tiles.cuh"

namespace {

struct OutputArgs {
  const float *q, *ctx, *ap_w, *ap_b, *out_w, *out_b;
  float *proj, *logp;
  int N, H, Henc, V;
};

// The work items of output_stages' widest stage, for the grid's size.
inline int output_work(const OutputArgs& p) {
  return max(max(num_tiles(p.H, p.N), num_tiles(p.V, p.N)),
             (p.N + kWarps - 1) / kWarps);
}

// proj = [q | ctx] @ ap_w + ap_b into the scratch proj [N, H], then the
// logits into logp [N, V], then their log_softmax in place, one warp per
// row; a grid barrier between the stages.
__device__ void output_stages(const OutputArgs& p, float* smem,
                              cg::grid_group& grid) {
  for (int t = blockIdx.x; t < num_tiles(p.H, p.N); t += gridDim.x)
    dense_tile(p.q, p.H, p.ctx, p.Henc, p.ap_w, p.ap_b, p.H, p.proj, p.N, t,
               smem);
  grid.sync();
  for (int t = blockIdx.x; t < num_tiles(p.V, p.N); t += gridDim.x)
    dense_tile(p.proj, p.H, nullptr, 0, p.out_w, p.out_b, p.V, p.logp, p.N, t,
               smem);
  grid.sync();
  const int lane = threadIdx.x & 31;
  for (int n = blockIdx.x * kWarps + (threadIdx.x >> 5); n < p.N;
       n += gridDim.x * kWarps) {
    float* l = p.logp + static_cast<size_t>(n) * p.V;
    float m = -INFINITY;
    for (int v = lane; v < p.V; v += 32) m = fmaxf(m, __ldcg(l + v));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int v = lane; v < p.V; v += 32) s += expf(__ldcg(l + v) - m);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float z = logf(s);
    for (int v = lane; v < p.V; v += 32) l[v] = __ldcg(l + v) - m - z;
  }
}

}  // namespace
