// Flash decode attention over a paged KV cache, for Hopper: one query token
// per slot, grouped-query heads, online softmax in f32.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:_flash_jit
// / _flash_kernel.  There the grid is (slot, kv_head, page) with the page axis
// innermost and sequential, the running max / normalizer / accumulator live
// in VMEM scratch across grid steps, and the KV index map clamps each slot's
// logical page at its last valid one so Mosaic skips the fetch for pages the
// slot does not own.
//
// Design.  One block of 128 threads per (slot, kv_head) loops over its own
// slot's ceil(length / page_size) pages, so the trip count comes from
// `lengths` and no clamp is needed; page ids come from the slot's table row
// (an unmapped -1 reads page 0, as the reference's index map does).  Per page
// the block stages the K and V rows of its head in shared memory once and all
// G query heads of the group use them: scores (scaled, optional tanh softcap,
// plus the f32 additive bias), the online-softmax update (f32 running max and
// normalizer per head), and the weighted V sum into per-thread f32
// accumulators.  A slot of length 0 writes zeros (the _TINY guard).
//
// What bounds it.  Decode attention is memory bound: the least work is one
// read of the slot's K and V pages, q, the bias row, and one write of the
// output.  At serving batch sizes the grid is small (B * KV blocks), so each
// block's serial page loop and its four barriers per page, not the bytes,
// set the time; splitting a slot's pages across blocks (split-K with a
// combine pass) is the next step.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int FT = 128;   // threads per block
constexpr int MAXR = 16;  // accumulator registers per thread: G * Dh <= FT * MAXR

template <typename T>
__global__ void __launch_bounds__(FT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ table, const int* __restrict__ lengths,
                    const float* __restrict__ bias, T* __restrict__ out, int KV, int G, int Dh,
                    int P, int ps, int MP, float scale, float softcap) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int ldk = Dh + 1;  // odd row stride: conflict-free score dot products
  const int GD = G * Dh;
  float* qs = sm;               // [G][Dh]
  float* ks = qs + GD;          // [ps][Dh + 1]
  float* vs = ks + ps * ldk;    // [ps][Dh]
  float* sc = vs + ps * Dh;     // [G][ps]: scores, then softmax weights
  float* alpha = sc + G * ps;   // [G]
  float* mrun = alpha + G;      // [G]
  float* lrun = mrun + G;       // [G]

  const long qoff = ((long)b * KV + h) * GD;
  for (int e = tid; e < GD; e += FT) qs[e] = repro::ld(q, qoff + e);
  if (tid < G) {
    mrun[tid] = -INFINITY;
    lrun[tid] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  const int npages = min((max(lengths[b], 0) + ps - 1) / ps, MP);
  const float* brow = bias + (long)b * MP * ps;
  __syncthreads();

  for (int p = 0; p < npages; ++p) {
    const long phys = min(max(table[(long)b * MP + p], 0), P - 1);
    for (int e = tid; e < ps * Dh; e += FT) {
      const int t = e / Dh, d = e % Dh;
      const long off = ((phys * ps + t) * KV + h) * Dh + d;
      ks[t * ldk + d] = repro::ld(kp, off);
      vs[t * Dh + d] = repro::ld(vp, off);
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += FT) {
      const int g = e / ps, t = e % ps;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s += qs[g * Dh + d] * ks[t * ldk + d];
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sc[e] = s + brow[p * ps + t];
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      const float mprev = mrun[g];
      float mcur = mprev;
      for (int t = 0; t < ps; ++t) mcur = fmaxf(mcur, sc[g * ps + t]);
      float lsum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float w = expf(sc[g * ps + t] - mcur);
        sc[g * ps + t] = w;
        lsum += w;
      }
      const float a = expf(mprev - mcur);
      lrun[g] = lrun[g] * a + lsum;
      mrun[g] = mcur;
      alpha[g] = a;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int e = tid + r * FT;
      if (e < GD) {
        const int g = e / Dh, d = e % Dh;
        float v = acc[r] * alpha[g];
        for (int t = 0; t < ps; ++t) v += sc[g * ps + t] * vs[t * Dh + d];
        acc[r] = v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int e = tid + r * FT;
    if (e < GD) repro::st(out, qoff + e, acc[r] / fmaxf(lrun[e / Dh], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table, const int* lengths,
           const float* bias, void* out, int B, int KV, int G, int Dh, int P, int ps, int MP,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)G * Dh + (size_t)ps * (Dh + 1) + (size_t)ps * Dh + (size_t)G * ps + 3 * G);
  cudaError_t err = repro::allow_smem(flash_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KV);
  flash_decode_kernel<T><<<grid, FT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      lengths, bias, static_cast<T*>(out), KV, G, Dh, P, ps, MP, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, KV, G, Dh); k_pages / v_pages (P, ps, KV, Dh); table (B, MP) int32
// (-1 = unmapped; ids are clamped into [0, P), as the reference's gather clamps);
// lengths (B,) int32; bias (B, MP * ps) float32; out like q.
// dtype: 0 = float32, 1 = bfloat16 (q, pages and out alike).  softcap <= 0: none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* lengths, const void* bias,
                                      void* out, int B, int KV, int G, int Dh, int P, int ps,
                                      int MP, float scale, float softcap, int dtype,
                                      void* stream) {
  if (G * Dh > FT * MAXR) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kp, vp, tb, ln, bs, out, B, KV, G, Dh, P, ps, MP, scale, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, tb, ln, bs, out, B, KV, G, Dh, P, ps, MP, scale,
                                 softcap, st);
  return (int)cudaErrorInvalidValue;
}
