// Flash decode attention over a paged KV cache, for Hopper: one query token
// per slot, grouped-query heads, online softmax in f32, each slot's pages
// split over several blocks (split-K) and the splits combined in a second
// pass.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:_flash_jit
// / _flash_kernel.  There the grid is (slot, kv_head, page) with the page axis
// innermost and sequential, the running max / normalizer / accumulator live
// in VMEM scratch across grid steps, and the KV index map clamps each slot's
// logical page at its last valid one so Mosaic skips the fetch for pages the
// slot does not own.  Hopper runs blocks in parallel and in no order, so the
// sequential page axis becomes a loop inside a block, and the pages are cut
// into S contiguous ranges, one block each, so that B * KV * S blocks fill
// the card (kernels/decode_attention.py:_flash_plan).
//
// Design.  split_kernel: one block of 128 threads per (slot, kv head, split)
// owns the slot's pages [floor(s * np / S), floor((s + 1) * np / S)), np =
// ceil(length / page_size), so the trip count comes from `lengths` and no
// clamp is needed; page ids come from the slot's table row (an unmapped -1
// reads page 0, as the reference's index map does).  It walks its keys in
// tiles of kt <= 32 (whole pages or parts of them):
//   - the tile's K and V rows are copied to shared memory in 16-byte cp.async
//     chunks (element loads where a row is not whole chunks; rows past the
//     range zero-filled), double-buffered: the next tile's copy is issued as
//     soon as the block is done with the buffer;
//   - scores: a group of LK lanes owns one key's Dh (8 lanes at Dh = 64 in
//     bf16), each lane a dot product over its 16-byte chunks, the group's
//     parts added by warp shuffles; then scale, optional tanh softcap and the
//     f32 additive bias;
//   - softmax: one warp per query head, one key a lane; max and sum by warp
//     shuffles, the running max / normalizer updated by lane 0;
//   - the weighted V sum into per-thread f32 accumulators (G * Dh <= 2048).
// Three barriers a tile of up to 32 keys.  Each split writes its (m, l,
// acc[G * Dh]) in f32 to the workspace; combine_kernel rescales and sums the
// splits in split order (no atomics: two launches give the same bits) and
// divides once.  A split that owns no page contributes m = -inf, l = 0; a
// slot of length 0 writes zeros (the _TINY guard).  With S = 1 the split
// kernel writes the output itself.  Where the caller passes `ml`, the pass
// that writes the output also writes each head's softmax statistics (m, l)
// in f32 (m = 0 where the head saw no key), so that outputs over disjoint key
// sets merge: a pool whose in-page positions are spread over a mesh.
//
// What bounds it.  Decode attention is memory bound: the least work is one
// read of the slot's K and V pages, q, the bias row, and one write of the
// output (bert-base, 8 slots of 144 keys: 3.6 MB, ~1 us at 3.35 TB/s).  At
// that size a launch is far from the bound: each block's chain of copies
// and barriers, and the second launch, set the time.
//
// serial_kernel is the previous design (one block per (slot, kv head) walking
// every page, four barriers a page), reached by no path: chip_smoke.py times
// it beside split_kernel as the yardstick.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int FT = 128;   // threads per block
constexpr int MAXR = 16;  // accumulator registers per thread: G * Dh <= FT * MAXR
constexpr int KT = 32;    // most keys a tile (one a lane in the softmax)
constexpr float TINY = 1e-30f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

// q . k over one chunk of CE elements: q in f32, k in T
template <typename T, int CE>
__device__ __forceinline__ float dot_chunk(const float* qp, const T* kp) {
  float s = 0.f;
  if constexpr (CE == 1) {
    s = qp[0] * repro::ld(kp, 0);
  } else if constexpr (sizeof(T) == 2) {          // 8 bf16
    const uint4 raw = *reinterpret_cast<const uint4*>(kp);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 k2 = __bfloat1622float2(h[e]);
      const float2 q2 = *reinterpret_cast<const float2*>(qp + 2 * e);
      s = fmaf(q2.x, k2.x, s);
      s = fmaf(q2.y, k2.y, s);
    }
  } else {                                        // 4 floats
    const float4 k4 = *reinterpret_cast<const float4*>(kp);
    const float4 q4 = *reinterpret_cast<const float4*>(qp);
    s = q4.x * k4.x;
    s = fmaf(q4.y, k4.y, s);
    s = fmaf(q4.z, k4.z, s);
    s = fmaf(q4.w, k4.w, s);
  }
  return s;
}

// Shared memory of split_kernel, in bytes (kernels/decode_attention.py:
// _flash_smem mirrors it): K and V tiles, two buffers, in T; q in f32; the
// scores; the running max, normalizer and rescale factor of each head.
__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }
inline size_t split_smem(int G, int Dh, int kt, int esize) {
  return round16((size_t)2 * 2 * kt * Dh * esize) + sizeof(float) * ((size_t)G * Dh + (size_t)G * kt + 3 * G);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(FT)
split_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
             const int* __restrict__ table, const int* __restrict__ lengths,
             const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ ws,
             float* __restrict__ ml, int KV, int G, int Dh, int P, int ps, int MP, int S,
             int kt, float scale, float softcap) {
  constexpr int CE = VEC ? 16 / (int)sizeof(T) : 1;   // elements a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / KV, h = bh % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * Dh;
  T* kvs = reinterpret_cast<T*>(smem);                        // [2][K, V][kt][Dh]
  float* qs = reinterpret_cast<float*>(smem + round16((size_t)2 * 2 * kt * Dh * sizeof(T)));
  float* sc = qs + GD;          // [G][kt]: scores, then softmax weights
  float* mrun = sc + G * kt;    // [G]
  float* lrun = mrun + G;       // [G]
  float* alpha = lrun + G;      // [G]

  const long qoff = (long)bh * GD;
  for (int e = tid; e < GD; e += FT) qs[e] = repro::ld(q, qoff + e);
  for (int g = tid; g < G; g += FT) {
    mrun[g] = -INFINITY;
    lrun[g] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  const int np = min((max(lengths[b], 0) + ps - 1) / ps, MP);
  const int k0 = (int)((long)split * np / S) * ps;
  const int k1 = (int)((long)(split + 1) * np / S) * ps;
  const int ntile = (k1 - k0 + kt - 1) / kt;
  const int* trow = table + (long)b * MP;
  const float* brow = bias + (long)b * MP * ps;
  const int nch = Dh / CE;                      // chunks a key row
  int LK = 1;                                   // lanes a key's dot product
  while (LK < 32 && 2 * LK <= nch) LK *= 2;
  const int grp = tid / LK, sub = tid % LK, KP = FT / LK;

  // the K and V rows of keys [k0 + tile * kt, + kt) into buffer buf
  auto stage = [&](int tile, int buf) {
    T* ks = kvs + (long)buf * 2 * kt * Dh;
    T* vs = ks + kt * Dh;
    for (int e = tid; e < kt * nch; e += FT) {
      const int kk = e / nch, c = e % nch;
      const int key = k0 + tile * kt + kk;
      const bool ok = key < k1;
      long off = 0;
      if (ok) {
        const long phys = min(max(trow[key / ps], 0), P - 1);
        off = ((phys * ps + key % ps) * KV + h) * Dh + (long)c * CE;
      }
      if constexpr (VEC) {
        cp_async16(ks + kk * Dh + c * CE, kp + off, ok ? 16 : 0);
        cp_async16(vs + kk * Dh + c * CE, vp + off, ok ? 16 : 0);
      } else {
        repro::st(ks, kk * Dh + c, ok ? repro::ld(kp, off) : 0.f);
        repro::st(vs, kk * Dh + c, ok ? repro::ld(vp, off) : 0.f);
      }
    }
    if constexpr (VEC) cp_async_commit();
  };

  if (ntile > 0) stage(0, 0);
  __syncthreads();      // q and the running statistics are set
  for (int tile = 0; tile < ntile; ++tile) {
    const int buf = tile & 1;
    if constexpr (VEC) cp_async_wait0();
    __syncthreads();    // this tile has landed; every thread is done with the last one
    if (tile + 1 < ntile) stage(tile + 1, buf ^ 1);
    const T* ks = kvs + (long)buf * 2 * kt * Dh;
    const T* vs = ks + kt * Dh;
    // scores: LK lanes a key, their parts added by shuffles
    for (int kk0 = 0; kk0 < kt; kk0 += KP) {
      const int kk = kk0 + grp;
      const int key = k0 + tile * kt + kk;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        if (kk < kt)
          for (int c = sub; c < nch; c += LK)
            part += dot_chunk<T, CE>(qs + g * Dh + c * CE, ks + kk * Dh + c * CE);
        for (int o = LK / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (kk < kt && sub == 0) {
          float s = -INFINITY;
          if (key < k1) {
            s = part * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            s += brow[key];
          }
          sc[g * kt + kk] = s;
        }
      }
    }
    __syncthreads();
    // online softmax: a warp a head, a key a lane
    for (int g = warp; g < G; g += FT / 32) {
      const float s = lane < kt ? sc[g * kt + lane] : -INFINITY;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mold = mrun[g];
      const float mnew = fmaxf(mold, mx);
      const float w = mnew == -INFINITY ? 0.f : expf(s - mnew);
      float sum = w;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < kt) sc[g * kt + lane] = w;
      if (lane == 0) {
        const float a = mnew == -INFINITY ? 1.f : expf(mold - mnew);
        alpha[g] = a;
        lrun[g] = lrun[g] * a + sum;
        mrun[g] = mnew;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int e = tid + r * FT;
      if (e < GD) {
        const int g = e / Dh, d = e % Dh;
        float v = acc[r] * alpha[g];
        for (int t = 0; t < kt; ++t) v = fmaf(sc[g * kt + t], repro::ld(vs, t * Dh + d), v);
        acc[r] = v;
      }
    }
  }

  if (S == 1) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int e = tid + r * FT;
      if (e < GD) repro::st(out, qoff + e, acc[r] / fmaxf(lrun[e / Dh], TINY));
    }
    if (ml != nullptr)
      for (int g = tid; g < G; g += FT) {
        ml[((long)bh * G + g) * 2] = mrun[g] == -INFINITY ? 0.f : mrun[g];
        ml[((long)bh * G + g) * 2 + 1] = lrun[g];
      }
    return;
  }
  float* wb = ws + ((long)bh * S + split) * (2 * G + GD);   // m[G], l[G], acc[G * Dh]
  for (int g = tid; g < G; g += FT) {
    wb[g] = mrun[g];
    wb[G + g] = lrun[g];
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int e = tid + r * FT;
    if (e < GD) wb[2 * G + e] = acc[r];
  }
}

// out = (sum over splits of acc_s e^(m_s - M)) / (sum of l_s e^(m_s - M)), M
// the largest m_s, summed in split order; zeros where no split saw a key.
// The splits' maxima go through shared memory first, so the sums over splits
// issue their loads together.
template <typename T>
__global__ void __launch_bounds__(FT)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out, float* __restrict__ ml,
               int G, int Dh, int S) {
  extern __shared__ float cs[];
  float* wgt = cs;              // [S][G]: m_s, then e^(m_s - M)
  float* lsum = cs + S * G;     // [G]
  const int GD = G * Dh;
  const long stride = 2 * G + GD;
  const float* wb = ws + (long)blockIdx.x * S * stride;
  for (int i = threadIdx.x; i < S * G; i += FT) wgt[i] = wb[(i / G) * stride + i % G];
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += FT) {
    float M = -INFINITY;
    for (int s = 0; s < S; ++s) M = fmaxf(M, wgt[s * G + g]);
    float L = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const float f = M == -INFINITY ? 0.f : expf(wgt[s * G + g] - M);
      wgt[s * G + g] = f;
      L = fmaf(wb[s * stride + G + g], f, L);
    }
    lsum[g] = L;
    if (ml != nullptr) {
      ml[((long)blockIdx.x * G + g) * 2] = M == -INFINITY ? 0.f : M;
      ml[((long)blockIdx.x * G + g) * 2 + 1] = L;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GD; e += FT) {
    const int g = e / Dh;
    float O = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) O = fmaf(wb[s * stride + 2 * G + e], wgt[s * G + g], O);
    repro::st(out, (long)blockIdx.x * GD + e, O / fmaxf(lsum[g], TINY));
  }
}

template <typename T, bool VEC>
int launch_split(const void* q, const void* kp, const void* vp, const int* table,
                 const int* lengths, const float* bias, void* out, float* ws, float* ml,
                 int B, int KV, int G, int Dh, int P, int ps, int MP, int S, int kt,
                 float scale, float softcap, cudaStream_t stream) {
  const size_t smem = split_smem(G, Dh, kt, sizeof(T));
  cudaError_t err = repro::allow_smem(split_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  split_kernel<T, VEC><<<dim3(B * KV, S), FT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      lengths, bias, static_cast<T*>(out), ws, ml, KV, G, Dh, P, ps, MP, S, kt, scale, softcap);
  int rc = (int)cudaGetLastError();
  if (rc || S == 1) return rc;
  const size_t csmem = sizeof(float) * ((size_t)S * G + G);
  err = repro::allow_smem(combine_kernel<T>, csmem);
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<B * KV, FT, csmem, stream>>>(ws, static_cast<T*>(out), ml, G, Dh, S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table, const int* lengths,
           const float* bias, void* out, float* ws, float* ml, int B, int KV, int G, int Dh,
           int P, int ps, int MP, int S, int kt, float scale, float softcap,
           cudaStream_t stream) {
  // 16-byte chunks: whole chunks a row, aligned pages
  const bool vec = (Dh * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) & 15) == 0;
  if (vec)
    return launch_split<T, true>(q, kp, vp, table, lengths, bias, out, ws, ml, B, KV, G, Dh, P,
                                 ps, MP, S, kt, scale, softcap, stream);
  return launch_split<T, false>(q, kp, vp, table, lengths, bias, out, ws, ml, B, KV, G, Dh, P,
                                ps, MP, S, kt, scale, softcap, stream);
}

template <typename T>
__global__ void __launch_bounds__(FT)
serial_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
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
int launch_serial(const void* q, const void* kp, const void* vp, const int* table, const int* lengths,
           const float* bias, void* out, int B, int KV, int G, int Dh, int P, int ps, int MP,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)G * Dh + (size_t)ps * (Dh + 1) + (size_t)ps * Dh + (size_t)G * ps + 3 * G);
  cudaError_t err = repro::allow_smem(serial_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KV);
  serial_kernel<T><<<grid, FT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      lengths, bias, static_cast<T*>(out), KV, G, Dh, P, ps, MP, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, KV, G, Dh); k_pages / v_pages (P, ps, KV, Dh); table (B, MP) int32
// (-1 = unmapped; ids are clamped into [0, P), as the reference's gather clamps);
// lengths (B,) int32; bias (B, MP * ps) float32; out like q.
// dtype: 0 = float32, 1 = bfloat16 (q, pages and out alike).  softcap <= 0: none.

// S splits of each slot's pages, kt keys a tile; ws: S > 1 needs
// B * KV * S * (2 * G + G * Dh) floats; ml: null, or (B, KV, G, 2) floats that
// receive each head's (m, l).  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int flash_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* lengths, const void* bias,
                                      void* out, void* ws, void* ml, int B, int KV, int G,
                                      int Dh, int P, int ps, int MP, int S, int kt, float scale,
                                      float softcap, int dtype, void* stream) {
  if (G * Dh > FT * MAXR || S < 1 || kt < 1 || kt > KT || B * KV < 1)
    return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  const float* bs = static_cast<const float*>(bias);
  float* w = static_cast<float*>(ws);
  float* st_ml = static_cast<float*>(ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kp, vp, tb, ln, bs, out, w, st_ml, B, KV, G, Dh, P, ps, MP, S, kt,
                         scale, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, tb, ln, bs, out, w, st_ml, B, KV, G, Dh, P, ps, MP,
                                 S, kt, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

// The previous kernel (serial_kernel), the same arguments without the split:
// the timed yardstick.
extern "C" int flash_decode_attention_serial(const void* q, const void* kp, const void* vp,
                                             const void* table, const void* lengths,
                                             const void* bias, void* out, int B, int KV, int G,
                                             int Dh, int P, int ps, int MP, float scale,
                                             float softcap, int dtype, void* stream) {
  if (G * Dh > FT * MAXR) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_serial<float>(q, kp, vp, tb, ln, bs, out, B, KV, G, Dh, P, ps, MP, scale,
                                softcap, st);
  if (dtype == 1)
    return launch_serial<__nv_bfloat16>(q, kp, vp, tb, ln, bs, out, B, KV, G, Dh, P, ps, MP,
                                        scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}
