// Chunked Mamba2 SSD scan (state-space duality) for Hopper: the SSM family's
// prefill.  y (B, S, H, P) in x's dtype and the final state (B, H, N, P) in
// f32, the function of the reference's ssd_chunked.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:ssd_scan / _kernel.
// There the grid is (batch, head, chunk) with the chunk axis sequential and a
// VMEM scratch carries the (N, P) state from one chunk to the next.  Here the
// chunks run in parallel: Mamba2's four-step form, in three launches a call.
//
//   1. states_kernel, one block per (batch, chunk, group of G heads): stages
//      the chunk's B (q x N) once; per head, S = B^T (x o s) on the tensor
//      cores, s_j = dt_j exp(dac_last - dac_j), written to an f32 scratch
//      (B, NC, H, N, P), and the chunk's decay exp(dac_last) to (B, NC, H).
//   2. pass_kernel, four state elements of (batch, head) a thread, serial
//      over the chunks: writes the state carried into each chunk over that
//      chunk's S (prev_c, in place) and folds S in, run = run exp(dac_last_c)
//      + S_c; the last chunk's run is the final state.
//   3. outputs_kernel, one block per (batch, chunk, group): stages C and B
//      once and forms the causal C B^T once on the tensor cores, shared by
//      the group's heads, each warp its 16 rows and only the 16-column blocks
//      on or below the diagonal (bf16: parked in shared memory in fragment
//      order, C's fragments kept in registers; float32: kept in registers);
//      per head, forms G'_ij = (C B^T)_ij exp(dac_i - dac_j) dt_j (j <= i) as
//      the A fragments of G' x, then y = exp(dac_i) (C prev) + G' x + D x,
//      rounded once to x's dtype.  Chunk 0 carries no state and skips C prev.
//
// dac is the chunk's cumulative sum of -exp(a_log) dt, one warp scan
// (chunk_cumsum, ssd_common.cuh) with its roundings pinned, called by
// launches 1 and 3 alike and by the backward (ssd_scan_bwd.cu), so their
// decays agree bit for bit.  Every decay is exp of a difference of
// it, never exp(dac_i) exp(-dac_j): dac reaches -200 within a chunk and
// exp(200) overflows f32.
//
// Operands.  mma.sync.m16n8k16 takes bf16 and sums in f32.  In bfloat16, x, B
// and C are bf16 values already; each f32-valued operand (x o s, G', prev)
// enters as the exact pair bf16(v) + bf16(v - bf16(v)), two products.  In
// float32 every operand enters as three bf16 terms (float32's ~24 bits) and
// the six products whose size reaches 2^-24 of the leading one are taken,
// smallest first.  Sums run in a fixed order and there are no atomics: two
// launches give the same bits.  Ragged q, N and P are zero-padded to 16 in
// shared memory.
//
// What bounds it on this card.  At 8 x 512 tokens (24 heads of 64, state 128,
// chunk 128, bf16) the least work is ~34 MB of inputs and outputs (10 us at
// 3.35 TB/s) against ~9 GFLOP on the tensor cores with the bf16 pairs (9 us
// at the bf16 peak).  The chunk states cost bytes on top: 25.2 MB of f32
// written by launch 1, read and written by launch 2, read by launch 3, and x
// and B read twice, ~142 MB a call in all (42 us): once the products are on
// the tensor cores, the scratch traffic bounds it.  What the launches reach
// is set by latency more than by bytes: each block stages a head's operands,
// waits, then multiplies, with two blocks an SM (PERF.md).  Fusing launch 2
// into launch 1 (a decoupled look-back) would save half of the scratch
// traffic; staging the next head while this one multiplies would hide the
// waits.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "ssd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::chunk_cumsum;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

constexpr int THREADS = 256;                 // launches 1 and 3: 8 warps
constexpr int QMAX = 128, NMAX = 128, PMAX = 64;
constexpr int GMAX = 8;                      // most heads a block of launches 1 and 3
constexpr int PASS = 256;                    // state elements a block of launch 2
constexpr int PASS_DEPTH = 8;                // chunks launch 2 loads ahead

__host__ __device__ constexpr int rup16(int v) { return (v + 15) / 16 * 16; }

// padded extents (multiples of 16) and bf16 row pitches (+8 elements: rows
// 16 bytes apart modulo 128, so ldmatrix's eight rows hit distinct banks)
struct Geo {
  int qp, np, pp, ldn, ldp;
};
__host__ __device__ inline Geo geo(int q, int n, int p) {
  Geo g;
  g.qp = rup16(q);
  g.np = rup16(n);
  g.pp = rup16(p);
  g.ldn = g.np + 8;
  g.ldp = g.pp + 8;
  return g;
}

// bf16 terms of an input value (x, B, C) and of an f32-valued operand
template <typename T>
constexpr int kInTerms = sizeof(T) == 4 ? 3 : 1;
template <typename T>
constexpr int kValTerms = sizeof(T) == 4 ? 3 : 2;
// the term pairs taken: each product of terms ta, tb at least 2^-24 of the
// leading one (bf16: the one input term against both terms of the pair)
__host__ __device__ constexpr bool keep(int ta, int tb) { return ta + tb <= 2; }
// launch 3 in bf16 keeps C B^T in shared memory (its registers at 128, two
// blocks an SM); float32, whose C takes three terms, in registers (one)
template <typename T>
constexpr bool kCbShared = sizeof(T) == 2;
template <typename T>
constexpr int kOutBlocks = kCbShared<T> ? 2 : 1;

// dt and dac of the block's G heads, then the bf16 tiles
__host__ __device__ inline size_t floats_bytes(const Geo& g, int G) {
  return 4 * 2 * (size_t)G * g.qp;
}

__host__ __device__ inline size_t smem_states(const Geo& g, int G, int nt, int wt) {
  return floats_bytes(g, G) + 2 * ((size_t)nt * g.qp * g.ldn + (size_t)wt * g.qp * g.ldp);
}
// launch 3: C's and B's terms, whose space a head's x and carried-state terms
// reuse (bf16: both tiles'; float32: B's), then in bf16 the warps' C B^T
// blocks on or below the diagonal, 16 x 16 f32 each
__host__ __device__ inline size_t outputs_cb_offset(const Geo& g, int G, int nt, int wt) {
  const size_t cs = (size_t)nt * g.qp * g.ldn;
  const size_t head = (size_t)nt * g.qp * g.ldp + (size_t)wt * g.np * g.ldp;
  const size_t keep_c = nt == 1 ? 0 : cs;
  const size_t reuse = cs + (nt == 1 ? cs : 0);
  return floats_bytes(g, G) + 2 * (keep_c + (reuse > head ? reuse : head));
}
__host__ __device__ inline size_t smem_outputs(const Geo& g, int G, int nt, int wt) {
  const size_t nq = g.qp / 16;
  return outputs_cb_offset(g, G, nt, wt) + (nt == 1 ? 4 * 256 * nq * (nq + 1) / 2 : 0);
}

// Stage a rows x cols row-major tile (row r at src + r * lds) into NT bf16
// term tiles (term t at dst + t * tstride, row pitch ld), each value first
// multiplied by scale(r) when SCALED; zeros up to prows x pcols.  Raw bf16
// tiles go by cp.async in 16-byte chunks where aligned (vec); the rest
// through registers, 8 columns a task, BATCH tasks' loads in flight before
// their values are split and stored.  The caller commits, waits and syncs.
template <int NT, bool SCALED, typename T, typename F>
__device__ inline void stage_tile(bf16* dst, int ld, int tstride, const T* src, long lds,
                                  int rows, int cols, int prows, int pcols, bool vec, F scale) {
  constexpr int BATCH = 4;
  const int groups = pcols / 8, tasks = prows * groups;
  if constexpr (NT == 1 && !SCALED && sizeof(T) == 2) {
    if (vec) {
      for (int e = threadIdx.x; e < tasks; e += THREADS) {
        const int r = e / groups, c0 = (e - r * groups) * 8;
        const bool in = r < rows && c0 < cols;   // vec: cols is whole 8-column groups
        cp_async16(dst + r * ld + c0, src + (in ? r * lds + c0 : 0), in ? 16 : 0);
      }
      return;
    }
  }
  for (int e0 = threadIdx.x; e0 < tasks; e0 += BATCH * THREADS) {
    float v[BATCH][8];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / groups, c0 = (e - r * groups) * 8;
      if (e < tasks && vec && r < rows && c0 + 8 <= cols) {
        if constexpr (sizeof(T) == 2) {
          const uint4 w = *reinterpret_cast<const uint4*>(src + r * lds + c0);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(h[k]);
            v[u][2 * k] = f.x;
            v[u][2 * k + 1] = f.y;
          }
        } else {
          const float4 a = *reinterpret_cast<const float4*>(src + r * lds + c0);
          const float4 b = *reinterpret_cast<const float4*>(src + r * lds + c0 + 4);
          v[u][0] = a.x, v[u][1] = a.y, v[u][2] = a.z, v[u][3] = a.w;
          v[u][4] = b.x, v[u][5] = b.y, v[u][6] = b.z, v[u][7] = b.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[u][k] = e < tasks && r < rows && c0 + k < cols ? repro::ld(src, r * lds + c0 + k)
                                                           : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * THREADS;
      if (e >= tasks) break;
      const int r = e / groups, c0 = (e - r * groups) * 8;
      if constexpr (SCALED) {
        const float sc = r < rows ? scale(r) : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) v[u][k] *= sc;
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        __nv_bfloat162 h[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          h[k] = __floats2bfloat162_rn(v[u][2 * k], v[u][2 * k + 1]);
          const float2 b = __bfloat1622float2(h[k]);
          v[u][2 * k] -= b.x;
          v[u][2 * k + 1] -= b.y;
        }
        *reinterpret_cast<uint4*>(dst + r * ld + c0 + t * tstride) =
            *reinterpret_cast<const uint4*>(h);
      }
    }
  }
}

// four bf16 terms of a pair as the A fragment of one 16 x 16 tile: v[0..1]
// row g, k 2c..2c+1; v[2..3] row g + 8; v[4..7] the same at k + 8
template <int NT>
__device__ inline void split_frag(float (&v)[8], uint32_t (&a)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      const float2 b = __bfloat1622float2(h);
      v[2 * k] -= b.x;
      v[2 * k + 1] -= b.y;
      a[t][k] = *reinterpret_cast<const uint32_t*>(&h);
    }
}

// two neighbouring values of a row (the second only when two), as one
// store where the address allows
__device__ inline void st2(float* p, float a, float b, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}
__device__ inline void st2(bf16* p, float a, float b, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (two) p[1] = __float2bfloat16(b);
  }
}

struct Dims {
  int S, H, P, N, q, G, nc;
  bool vec_x, vec_bc, vec_st;   // 16-byte rows: cp.async / vector loads
};

// ---- launch 1: chunk states -------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a_log, const T* __restrict__ bmat,
              float* __restrict__ st, float* __restrict__ decay, Dims d) {
  constexpr int NT = kInTerms<T>, WT = kValTerms<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo g = geo(d.q, d.N, d.P);
  float* dts = reinterpret_cast<float*>(smem);
  float* dac = dts + d.G * g.qp;
  bf16* Bs = reinterpret_cast<bf16*>(dac + d.G * g.qp);    // NT x [qp][ldn]
  bf16* Xs = Bs + NT * g.qp * g.ldn;                        // WT x [qp][ldp]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = d.H / d.G;
  const int bc = blockIdx.x / groups, h0 = (blockIdx.x - bc * groups) * d.G;
  const int bi = bc / d.nc, ci = bc - bi * d.nc;
  const long row0 = (long)bi * d.S + (long)ci * d.q;

  stage_tile<NT, false>(Bs, g.ldn, g.qp * g.ldn, bmat + row0 * d.N, d.N, d.q, d.N, g.qp, g.np,
                        d.vec_bc, [](int) { return 1.f; });
  cp_async_commit();
  chunk_cumsum(dt, a_log, row0, d.H, h0, d.G, d.q, g.qp, dts, dac);
  cp_async_wait<0>();
  __syncthreads();
  // s_j = dt_j exp(dac_last - dac_j), over dt (zero past q)
  for (int e = threadIdx.x; e < d.G * g.qp; e += THREADS)
    dts[e] *= expf(dac[e / g.qp * g.qp + d.q - 1] - dac[e]);
  __syncthreads();

  const int m0 = 16 * warp;   // this warp's 16 state rows n
  for (int hh = 0; hh < d.G; ++hh) {
    const int h = h0 + hh;
    const float* sh = dts + hh * g.qp;
    const float last = dac[hh * g.qp + d.q - 1];
    // x_h o s as WT bf16 terms
    stage_tile<WT, true>(Xs, g.ldp, g.qp * g.ldp, x + (row0 * d.H + h) * d.P, (long)d.H * d.P,
                         d.q, d.P, g.qp, g.pp, d.vec_x, [&](int j) { return sh[j]; });
    __syncthreads();
    if (m0 < g.np) {
      float acc[PMAX / 8][4];
#pragma unroll
      for (int i = 0; i < PMAX / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      for (int k0 = 0; k0 < g.qp; k0 += 16) {
#pragma unroll
        for (int tb = NT - 1; tb >= 0; --tb) {
          uint32_t a[4];   // B^T: rows n, k = j (B stored [j][n])
          ldmatrix_x4_trans(a, Bs + tb * g.qp * g.ldn +
                                   (k0 + (lane & 7) + (lane >> 4) * 8) * g.ldn + m0 +
                                   ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int tx = WT - 1; tx >= 0; --tx) {
            if (!keep(tb, tx)) continue;
#pragma unroll
            for (int np2 = 0; np2 < PMAX / 16; ++np2) {
              if (np2 * 16 >= g.pp) break;
              uint32_t b[4];
              ldmatrix_x4_trans(b, Xs + tx * g.qp * g.ldp +
                                       (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * g.ldp +
                                       np2 * 16 + (lane >> 4) * 8);
              mma_bf16(acc[2 * np2], a, b[0], b[1]);
              mma_bf16(acc[2 * np2 + 1], a, b[2], b[3]);
            }
          }
        }
      }
      float* out = st + ((long)bc * d.H + h) * d.N * d.P;
#pragma unroll
      for (int nt = 0; nt < PMAX / 8; ++nt) {
        const int p = nt * 8 + 2 * (lane & 3);
        if (p >= d.P) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = m0 + (lane >> 2) + 8 * hf;
          if (n < d.N)
            st2(out + (long)n * d.P + p, acc[nt][2 * hf], acc[nt][2 * hf + 1], p + 1 < d.P);
        }
      }
    }
    if (threadIdx.x == 0) decay[(long)bc * d.H + h] = expf(last);
    __syncthreads();   // Xs is restaged for the next head
  }
}

// ---- launch 2: state passing ------------------------------------------------
// VEC consecutive elements of one (batch, head) a thread: over the chunks in
// order, writes the carried state over S_c and folds S_c in, PASS_DEPTH
// chunks' loads in flight.
template <int VEC>
__global__ void __launch_bounds__(PASS)
pass_kernel(float* __restrict__ st, const float* __restrict__ decay,
            float* __restrict__ final_state, int H, int NP, int nc) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const int slices = (NP + PASS * VEC - 1) / (PASS * VEC);
  const int bh = blockIdx.x / slices;
  const int e = ((blockIdx.x - bh * slices) * PASS + threadIdx.x) * VEC;
  if (e >= NP) return;
  const int bi = bh / H, h = bh - bi * H;
  const long cstride = (long)H * NP / VEC;
  V* p = reinterpret_cast<V*>(st + ((long)bi * nc * H + h) * NP + e);
  const float* dec = decay + (long)bi * nc * H + h;
  float run[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) run[i] = 0.f;
  const auto pack = [&]() {
    if constexpr (VEC == 4) return make_float4(run[0], run[1], run[2], run[3]);
    else return run[0];
  };
  for (int c0 = 0; c0 < nc; c0 += PASS_DEPTH) {
    V s[PASS_DEPTH];
    float f[PASS_DEPTH];
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (c0 + k < nc) {
        s[k] = p[(c0 + k) * cstride];
        f[k] = dec[(long)(c0 + k) * H];
      }
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (c0 + k < nc) {
        p[(c0 + k) * cstride] = pack();
        float sv[VEC];
        if constexpr (VEC == 4) {
          sv[0] = s[k].x, sv[1] = s[k].y, sv[2] = s[k].z, sv[3] = s[k].w;
        } else {
          sv[0] = s[k];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) run[i] = __fadd_rn(__fmul_rn(run[i], f[k]), sv[i]);
      }
  }
  *reinterpret_cast<V*>(final_state + (long)bh * NP + e) = pack();
}

// body(ks) for each k-step of C (16 of its N columns), unrolled when C's
// fragments sit in registers, whose index must then be a constant
template <bool UNROLL, typename F>
__device__ __forceinline__ void for_ksteps(int np, F&& body) {
  if constexpr (UNROLL) {
#pragma unroll
    for (int ks = 0; ks < NMAX / 16; ++ks)
      if (ks * 16 < np) body(ks);
  } else {
    for (int ks = 0; ks < np / 16; ++ks) body(ks);
  }
}

// ---- launch 3: chunk outputs ------------------------------------------------
// bf16 (kCbShared): each warp keeps C's A fragments for its 16 rows in
// registers and parks its C B^T blocks in shared memory, in fragment order, so
// the head loop holds 128 registers and two blocks share an SM; float32 (C in
// three terms) keeps C in shared memory and C B^T in registers, one block an SM.
template <typename T>
__global__ void __launch_bounds__(THREADS, kOutBlocks<T>)
outputs_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const T* __restrict__ bmat,
               const T* __restrict__ cmat, const float* __restrict__ d_skip,
               const float* __restrict__ prev, T* __restrict__ y, Dims d) {
  constexpr int NT = kInTerms<T>, WT = kValTerms<T>;
  constexpr bool CBS = kCbShared<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo g = geo(d.q, d.N, d.P);
  float* dts = reinterpret_cast<float*>(smem);
  float* dac = dts + d.G * g.qp;
  bf16* Cs = reinterpret_cast<bf16*>(dac + d.G * g.qp);     // NT x [qp][ldn]
  bf16* Bs = Cs + NT * g.qp * g.ldn;                         // NT x [qp][ldn], then:
  bf16* Xs = CBS ? Cs : Bs;                                  // NT x [qp][ldp]
  bf16* Ps = Xs + NT * g.qp * g.ldp;                         // WT x [np][ldp]
  float* CBm = reinterpret_cast<float*>(smem + outputs_cb_offset(g, d.G, NT, WT));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = d.H / d.G;
  const int bc = blockIdx.x / groups, h0 = (blockIdx.x - bc * groups) * d.G;
  const int bi = bc / d.nc, ci = bc - bi * d.nc;
  const long row0 = (long)bi * d.S + (long)ci * d.q;
  const auto one = [](int) { return 1.f; };

  stage_tile<NT, false>(Cs, g.ldn, g.qp * g.ldn, cmat + row0 * d.N, d.N, d.q, d.N, g.qp, g.np,
                        d.vec_bc, one);
  stage_tile<NT, false>(Bs, g.ldn, g.qp * g.ldn, bmat + row0 * d.N, d.N, d.q, d.N, g.qp, g.np,
                        d.vec_bc, one);
  cp_async_commit();
  chunk_cumsum(dt, a_log, row0, d.H, h0, d.G, d.q, g.qp, dts, dac);
  cp_async_wait<0>();
  __syncthreads();

  // C's A fragment of k-step ks, term tc, for this warp's 16 rows
  const int m0 = 16 * warp;
  const bool active = m0 < d.q;
  uint32_t creg[CBS ? NMAX / 16 : 1][4];
  auto c_frag = [&](uint32_t (&a)[4], int tc, int ks) {
    if constexpr (CBS) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = creg[ks][r];
    } else {
      ldmatrix_x4(a, Cs + tc * g.qp * g.ldn + (m0 + (lane & 15)) * g.ldn + ks * 16 +
                         (lane >> 4) * 8);
    }
  };
  if constexpr (CBS) {
#pragma unroll
    for (int ks = 0; ks < NMAX / 16; ++ks)
      if (active && ks * 16 < g.np)
        ldmatrix_x4(creg[ks], Cs + (m0 + (lane & 15)) * g.ldn + ks * 16 + (lane >> 4) * 8);
  }

  // C B^T for this warp's 16 rows i, the 16-column blocks kb <= warp only
  float cb[QMAX / 8][4];
#pragma unroll
  for (int i = 0; i < QMAX / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[i][e] = 0.f;
  if (active) {
    for_ksteps<CBS>(g.np, [&](int ks) {
#pragma unroll
      for (int tc = NT - 1; tc >= 0; --tc) {
        uint32_t a[4];
        c_frag(a, tc, ks);
#pragma unroll
        for (int tb = NT - 1; tb >= 0; --tb) {
          if (!keep(tc, tb)) continue;
#pragma unroll
          for (int kb = 0; kb < QMAX / 16; ++kb) {
            if (kb > warp) break;
            uint32_t b[4];   // B^T: k = n, columns j (B stored [j][n])
            ldmatrix_x4(b, Bs + tb * g.qp * g.ldn +
                               (kb * 16 + (lane & 7) + (lane >> 4) * 8) * g.ldn + ks * 16 +
                               ((lane >> 3) & 1) * 8);
            mma_bf16(cb[2 * kb], a, b[0], b[1]);
            mma_bf16(cb[2 * kb + 1], a, b[2], b[3]);
          }
        }
      }
    });
  }
  // kCbShared: block kb of warp w at CBm + (w (w + 1) / 2 + kb) * 256, 8 floats a lane
  float* mine = CBm + (warp * (warp + 1) / 2) * 256 + lane * 8;
  if constexpr (CBS) {
    if (active) {
#pragma unroll
      for (int kb = 0; kb < QMAX / 16; ++kb) {
        if (kb > warp) break;
        *reinterpret_cast<float4*>(mine + kb * 256) =
            make_float4(cb[2 * kb][0], cb[2 * kb][1], cb[2 * kb][2], cb[2 * kb][3]);
        *reinterpret_cast<float4*>(mine + kb * 256 + 4) =
            make_float4(cb[2 * kb + 1][0], cb[2 * kb + 1][1], cb[2 * kb + 1][2], cb[2 * kb + 1][3]);
      }
    }
  }
  __syncthreads();   // C's and B's space takes x_h and prev_h from here

  const int i0 = m0 + (lane >> 2), i1 = i0 + 8, c2 = 2 * (lane & 3);
  for (int hh = 0; hh < d.G; ++hh) {
    const int h = h0 + hh;
    stage_tile<NT, false>(Xs, g.ldp, g.qp * g.ldp, x + (row0 * d.H + h) * d.P, (long)d.H * d.P,
                          d.q, d.P, g.qp, g.pp, d.vec_x, one);
    if (ci > 0)
      stage_tile<WT, false>(Ps, g.ldp, g.np * g.ldp, prev + ((long)bc * d.H + h) * d.N * d.P,
                            (long)d.P, d.N, d.P, g.np, g.pp, d.vec_st, one);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      const float* th = dts + hh * g.qp;
      const float* dh = dac + hh * g.qp;
      float acc[PMAX / 8][4];
#pragma unroll
      for (int i = 0; i < PMAX / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      if (ci > 0) {   // exp(dac_i) (C prev)
        for_ksteps<CBS>(g.np, [&](int ks) {
#pragma unroll
          for (int tc = NT - 1; tc >= 0; --tc) {
            uint32_t a[4];
            c_frag(a, tc, ks);
#pragma unroll
            for (int tp = WT - 1; tp >= 0; --tp) {
              if (!keep(tc, tp)) continue;
#pragma unroll
              for (int np2 = 0; np2 < PMAX / 16; ++np2) {
                if (np2 * 16 >= g.pp) break;
                uint32_t b[4];
                ldmatrix_x4_trans(b, Ps + tp * g.np * g.ldp +
                                         (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * g.ldp +
                                         np2 * 16 + (lane >> 4) * 8);
                mma_bf16(acc[2 * np2], a, b[0], b[1]);
                mma_bf16(acc[2 * np2 + 1], a, b[2], b[3]);
              }
            }
          }
        });
        const float e0 = expf(dh[i0]), e1 = expf(dh[i1]);
#pragma unroll
        for (int nt = 0; nt < PMAX / 8; ++nt) {
          acc[nt][0] *= e0;
          acc[nt][1] *= e0;
          acc[nt][2] *= e1;
          acc[nt][3] *= e1;
        }
      }
      // + G' x, G' formed from C B^T one 16-column block at a time
      const float di0 = dh[i0], di1 = dh[i1];
#pragma unroll
      for (int kb = 0; kb < QMAX / 16; ++kb) {
        if (kb > warp) break;
        float c8[8];   // C B^T at (i0 | i1, the block's columns of this lane)
        if constexpr (CBS) {
          const float4 u0 = *reinterpret_cast<const float4*>(mine + kb * 256);
          const float4 u1 = *reinterpret_cast<const float4*>(mine + kb * 256 + 4);
          c8[0] = u0.x, c8[1] = u0.y, c8[2] = u0.z, c8[3] = u0.w;
          c8[4] = u1.x, c8[5] = u1.y, c8[6] = u1.z, c8[7] = u1.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c8[e] = cb[2 * kb][e];
            c8[4 + e] = cb[2 * kb + 1][e];
          }
        }
        float v[8];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = kb * 16 + hf * 8 + c2 + e;
            const bool in = j < d.q;
            const float w = in ? th[j] : 0.f, dj = in ? dh[j] : 0.f;
            v[4 * hf + e] = in && j <= i0 ? c8[4 * hf + e] * (expf(di0 - dj) * w) : 0.f;
            v[4 * hf + 2 + e] = in && j <= i1 ? c8[4 * hf + 2 + e] * (expf(di1 - dj) * w) : 0.f;
          }
        uint32_t af[WT][4];
        split_frag<WT>(v, af);
#pragma unroll
        for (int tg = WT - 1; tg >= 0; --tg) {
#pragma unroll
          for (int tx = NT - 1; tx >= 0; --tx) {
            if (!keep(tg, tx)) continue;
#pragma unroll
            for (int np2 = 0; np2 < PMAX / 16; ++np2) {
              if (np2 * 16 >= g.pp) break;
              uint32_t b[4];
              ldmatrix_x4_trans(b, Xs + tx * g.qp * g.ldp +
                                       (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * g.ldp +
                                       np2 * 16 + (lane >> 4) * 8);
              mma_bf16(acc[2 * np2], af[tg], b[0], b[1]);
              mma_bf16(acc[2 * np2 + 1], af[tg], b[2], b[3]);
            }
          }
        }
      }
      // + D x (x from its staged terms: their sum is x), one rounding to y's dtype
      const float dsk = d_skip[h];
      T* yh = y + (row0 * d.H + h) * d.P;
#pragma unroll
      for (int nt = 0; nt < PMAX / 8; ++nt) {
        const int p = nt * 8 + c2;
        if (p >= d.P) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = hf ? i1 : i0;
          if (i >= d.q) continue;
          float2 xv = make_float2(0.f, 0.f);
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const float2 u = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(Xs + t * g.qp * g.ldp + i * g.ldp + p));
            xv.x += u.x;
            xv.y += u.y;
          }
          st2(yh + (long)i * d.H * d.P + p, acc[nt][2 * hf] + xv.x * dsk,
              acc[nt][2 * hf + 1] + xv.y * dsk, p + 1 < d.P);
        }
      }
    }
    __syncthreads();   // Xs and Ps are restaged for the next head
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* b, const void* c,
           const float* d_skip, void* y, float* state, float* ws, int B, int S, int H, int P,
           int N, int q, int G, int phases, cudaStream_t stream) {
  constexpr int NT = kInTerms<T>, WT = kValTerms<T>;
  const int nc = S / q;
  Dims d{S, H, P, N, q, G, nc,
         aligned16(x) && (P * (int)sizeof(T)) % 16 == 0,
         aligned16(b) && aligned16(c) && (N * (int)sizeof(T)) % 16 == 0,
         aligned16(ws) && P % 4 == 0};
  const Geo g = geo(q, N, P);
  float* st = ws;
  float* decay = ws + (size_t)B * nc * H * N * P;
  const T* xt = static_cast<const T*>(x);
  const long blocks = (long)B * nc * (H / G);
  cudaError_t err;
  if (phases & 1) {
    const size_t smem = smem_states(g, G, NT, WT);
    if ((err = repro::allow_smem(states_kernel<T>, smem)) != cudaSuccess) return (int)err;
    states_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
        xt, dt, a_log, static_cast<const T*>(b), st, decay, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    const int np_ = N * P;
    if (np_ % 4 == 0 && aligned16(state) && aligned16(ws))
      pass_kernel<4><<<(unsigned)((long)B * H * ((np_ + 4 * PASS - 1) / (4 * PASS))), PASS, 0,
                       stream>>>(st, decay, state, H, np_, nc);
    else
      pass_kernel<1><<<(unsigned)((long)B * H * ((np_ + PASS - 1) / PASS)), PASS, 0, stream>>>(
          st, decay, state, H, np_, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & 4) {
    const size_t smem = smem_outputs(g, G, NT, WT);
    if ((err = repro::allow_smem(outputs_kernel<T>, smem)) != cudaSuccess) return (int)err;
    outputs_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
        xt, dt, a_log, static_cast<const T*>(b), static_cast<const T*>(c), d_skip, st,
        static_cast<T*>(y), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

bool takes(int q, int N, int P) {
  return q > 0 && q <= QMAX && N > 0 && N <= NMAX && P > 0 && P <= PMAX;
}

}  // namespace

// Dynamic shared memory of launch 1, 2 or 3 in bytes at a head group of
// `group` (kernels/ssd_scan.py:_ssd_plan computes the same); -1 for what the
// kernel does not take.
extern "C" long long ssd_scan_smem(int launch, int q, int N, int P, int group, int dtype) {
  if (!takes(q, N, P) || (dtype != 0 && dtype != 1) || launch < 1 || launch > 3 || group < 1 ||
      group > GMAX)
    return -1;
  const int nt = dtype == 0 ? 3 : 1, wt = dtype == 0 ? 3 : 2;
  const Geo g = geo(q, N, P);
  return launch == 1 ? (long long)smem_states(g, group, nt, wt)
                     : launch == 2 ? 0 : (long long)smem_outputs(g, group, nt, wt);
}

// Scratch bytes: the f32 chunk states (B, NC, H, N, P), then the chunk
// decays (B, NC, H).
extern "C" long long ssd_scan_workspace(int B, int S, int H, int P, int N, int q) {
  if (q <= 0 || S % q != 0) return -1;
  const long long units = (long long)B * (S / q) * H;
  return 4 * (units * N * P + units);
}

namespace {

// One whole call (phases 7) or, bit k of phases set alone, launch k + 1 on
// whatever the scratch holds.
int dispatch(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
             const void* d_skip, void* y, void* state, void* ws, int B, int S, int H, int P,
             int N, int q, int group, int dtype, int phases, void* stream) {
  if (!takes(q, N, P) || S % q != 0 || group < 1 || group > GMAX || H % group != 0)
    return (int)cudaErrorInvalidValue;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a_log);
  const float* f_d = static_cast<const float*>(d_skip);
  float* f_st = static_cast<float*>(state);
  float* f_ws = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, f_dt, f_a, b, c, f_d, y, f_st, f_ws, B, S, H, P, N, q, group,
                         phases, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f_dt, f_a, b, c, f_d, y, f_st, f_ws, B, S, H, P, N, q,
                                 group, phases, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int outputs_resident(const Geo& g, int G) {
  const size_t smem = smem_outputs(g, G, kInTerms<T>, kValTerms<T>);
  int blocks = 0;
  if (repro::allow_smem(outputs_kernel<T>, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, outputs_kernel<T>, THREADS, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// Blocks of launch 3 (chunk outputs) one SM holds at once at a head group of
// `group`, from its registers and shared memory (kernels/ssd_scan.py:
// _ssd_resident models the same); -1 for what the kernel does not take.
extern "C" int ssd_scan_resident(int q, int N, int P, int group, int dtype) {
  if (!takes(q, N, P) || group < 1 || group > GMAX) return -1;
  const Geo g = geo(q, N, P);
  return dtype == 0 ? outputs_resident<float>(g, group)
                    : dtype == 1 ? outputs_resident<__nv_bfloat16>(g, group) : -1;
}

// x (B, S, H, P); dt (B, S, H) float32; a_log, d_skip (H,) float32; b, c (B, S, N)
// in x's dtype; y like x; state (B, H, N, P) float32; ws: ssd_scan_workspace
// bytes.  q: chunk length, 1..128, dividing S; N <= 128; P <= 64; group: heads
// a block of launches 1 and 3, dividing H, at most 8.  dtype: 0 = float32,
// 1 = bfloat16 (x, b, c and y alike).  Runs the three launches of one call.
// Returns 0 when every launch was accepted, else the CUDA error.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log, const void* b,
                            const void* c, const void* d_skip, void* y, void* state, void* ws,
                            int B, int S, int H, int P, int N, int q, int group, int dtype,
                            void* stream) {
  return dispatch(x, dt, a_log, b, c, d_skip, y, state, ws, B, S, H, P, N, q, group, dtype, 7,
                  stream);
}

// For timing only: launch k (1 chunk states, 2 state passing, 3 chunk
// outputs) alone, with ssd_scan_fwd's arguments.  It reads the scratch as a
// whole call leaves it and gives no result of its own: y and state are right
// only after launches 1, 2 and 3 of the same inputs in order.
extern "C" int ssd_scan_launch(int k, const void* x, const void* dt, const void* a_log,
                               const void* b, const void* c, const void* d_skip, void* y,
                               void* state, void* ws, int B, int S, int H, int P, int N, int q,
                               int group, int dtype, void* stream) {
  if (k < 1 || k > 3) return (int)cudaErrorInvalidValue;
  return dispatch(x, dt, a_log, b, c, d_skip, y, state, ws, B, S, H, P, N, q, group, dtype,
                  1 << (k - 1), stream);
}
