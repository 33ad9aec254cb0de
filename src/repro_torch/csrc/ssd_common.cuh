// What the chunked SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu) share: the chunk's cumulative sum of the decays, formed
// by both with the same roundings, so that the backward's decays equal the
// forward's bit for bit.
#pragma once
#include "common.cuh"

namespace repro {

// dt of G heads' chunk rows into dts[g][qp] and their cumulative sums of
// a_g dt into dac[g][qp], warp g for head h0 + g (zeros past q).  One warp
// scan: 4 rows a lane in order, then a shuffle scan over the lanes, every
// rounding pinned (no contraction), so the forward's launches 1 and 3 and
// the backward's launches 1 and 3 get the same bits.
__device__ inline void chunk_cumsum(const float* dt, const float* a_log, long row0, int H,
                                    int h0, int G, int q, int qp, float* dts, float* dac) {
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  if (g >= G) return;
  float* ts = dts + g * qp;
  float* ds = dac + g * qp;
  const int h = h0 + g;
  for (int j = lane; j < qp; j += 32) ts[j] = j < q ? dt[(row0 + j) * H + h] : 0.f;
  __syncwarp();
  const float a = -expf(a_log[h]);
  float v[4], run = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = lane * 4 + t;
    run = __fadd_rn(run, j < q ? __fmul_rn(a, ts[j]) : 0.f);
    v[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, o);
  }
  const float excl = __fsub_rn(incl, run);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = lane * 4 + t;
    if (j < qp) ds[j] = j < q ? __fadd_rn(excl, v[t]) : 0.f;
  }
}

}  // namespace repro
