// Backward of the chunked Mamba2 SSD scan (ssd_scan.cu) for Hopper: the
// gradients of y (B, S, H, P) and of the final state (B, H, N, P) with
// respect to x, dt, a_log, B, C and D, the SSM family's fine-tuning.
//
// Replaces no TPU kernel: the reference has no Pallas backward and trains
// mamba by jax.grad of its plain ssd_chunked (repro/models/mamba.py:37).  On
// the card the plain version may not stand in for a kernel, so the port's
// fine-tuning of the ssm family needs this one.
//
// Per (batch, chunk, head), positions i, j of the chunk: dac the chunk's
// cumulative sum of da = -exp(a_log) dt, xw = x dt, L_ij = exp(dac_i - dac_j)
// (j <= i), M = (C B^T) o L, s_j = exp(dac_last - dac_j), e_c = exp(dac_last)
// and prev_c the state carried into the chunk, which the forward's launch 2
// leaves in its scratch with e_c.  Four launches a call:
//
//   1. dprev_kernel, one block per (batch, chunk, group of G heads): per
//      head dprev_c = C^T diag(exp(dac)) dy on the tensor cores (N x P).
//   2. rpass_kernel, the state's gradient over the chunks in reverse, four
//      elements of (batch, head) a thread: from G = d(final state),
//      dS_c = G, then G = G e_c + dprev_c, written over dprev_c in place.
//   3. roles_kernel, two blocks per (batch, chunk, group), one for each side
//      of the diagonal.  Both form their warps' 16 x 16 blocks of C B^T (the
//      "i" block, rows i) or B C^T (the "j" block, rows j) once and park them
//      in shared memory; per head they form dM = dy xw^T (or its transpose)
//      block by block on the tensor cores, and T = dM o M and dM o L
//      elementwise, never exp(dac_i) exp(-dac_j): dac reaches -200 in a
//      chunk.  The i block sums dC = (dM o L) B + exp(dac) o (dy prev_c^T)
//      over the group's heads and d(dac)_i's terms Σ_j T_ij and
//      <dy_i, exp(dac_i) C_i prev_c>; the j block sums dB = (dM o L)^T C +
//      s o (xw dS_c^T), forms dxw = M^T dy + s o (B dS_c), dx = dxw dt + D dy,
//      <dxw, x> and <dy, x> a position, and d(dac)_j's terms -Σ_i T_ij and
//      -s_j <B_j dS_c, xw_j>, with the last position's Σ_j s_j <B_j dS_c, xw_j>
//      + e_c <dS_c, prev_c>.  Each block writes its group's dB or dC.
//   4. finish_kernel: one block a head reverses the cumulative sum of
//      d(dac) within each chunk, dda, writes ddt = <dxw, x> - exp(a_log) dda
//      and sums da_log = Σ dda da and dD = Σ <dy, x>; the other blocks sum
//      dB and dC over the head groups.  Every sum across blocks runs here, in
//      a fixed order: there are no atomics, and two launches give the same
//      bits.
//
// Operands.  Tiles in shared memory hold values (x's dtype for x, B, C and
// dy; f32 for xw, the states and their gradients), split into bf16 terms as
// each fragment loads: in bfloat16 an input is one term and an f32-valued
// operand the pair bf16(v) + bf16(v - bf16(v)); in float32 every operand
// three terms, the products with ta + tb <= 2 taken (ssd_scan.cu).  Ragged q,
// N and P are zero-padded to 16 in shared memory.
//
// What bounds it on this card.  At mamba2-130m's training shape (4 x 512,
// 24 heads of 64, state 128, chunk 128, bf16) the least work is ~21 MB of
// inputs and outputs (6 us at 3.35 TB/s) against ~6 GFLOP on the tensor
// cores with the bf16 pairs (6 us at the bf16 peak).  The kernel moves more:
// the f32 states' gradient (12.6 MB) written and read three times, the
// carried states read twice, the groups' dB and dC partials; and it forms
// C B^T and dM twice (once a side).  A simple kernel first: fragments load
// from shared memory with scalar loads, one block an SM in launch 3, no
// overlap of a head's staging with its products.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "ssd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::chunk_cumsum;
using repro::mma_bf16;

constexpr int THREADS = 256;                 // launches 1 and 3: 8 warps
constexpr int QMAX = 128, NMAX = 128, PMAX = 64;
constexpr int GMAX = 8;                      // most heads a block of launches 1 and 3
constexpr int PASS = 256;                    // state elements a block of launch 2
constexpr int PASS_DEPTH = 8;                // chunks launch 2 loads ahead
constexpr int FIN = 256;                     // threads a block of launch 4

__host__ __device__ constexpr int rup16(int v) { return (v + 15) / 16 * 16; }

// bf16 terms of an input value (x, B, C, dy) and of an f32-valued operand
template <typename T>
constexpr int kInTerms = sizeof(T) == 4 ? 3 : 1;
template <typename T>
constexpr int kValTerms = sizeof(T) == 4 ? 3 : 2;
__host__ __device__ constexpr bool keep(int ta, int tb) { return ta + tb <= 2; }

// padded extents (multiples of 16) and row pitches (+8 elements)
struct Geo {
  int qp, np, pp, ldn, ldp, nq;
};
__host__ __device__ inline Geo geo(int q, int n, int p) {
  Geo g;
  g.qp = rup16(q);
  g.np = rup16(n);
  g.pp = rup16(p);
  g.ldn = g.np + 8;
  g.ldp = g.pp + 8;
  g.nq = g.qp / 16;
  return g;
}

// shared memory, bytes (kernels/ssd_scan.py:_ssd_bwd_smem computes the same)
__host__ __device__ inline size_t floats_bytes(const Geo& g, int G) {
  return 4 * 2 * (size_t)G * g.qp;
}
__host__ __device__ inline size_t cn_bytes(const Geo& g, int isz) {
  return (size_t)isz * g.qp * g.ldn;
}
__host__ __device__ inline size_t head_bytes(const Geo& g, int isz) {
  return (size_t)isz * g.qp * g.ldp + 4 * (size_t)g.qp * g.ldp + 4 * (size_t)g.np * g.ldp;
}
__host__ __device__ inline size_t park_bytes(const Geo& g) {
  return 4 * 256 * (size_t)g.nq * (g.nq + 1) / 2;
}
__host__ __device__ inline size_t smem_dprev(const Geo& g, int G, int isz) {
  return floats_bytes(g, G) + cn_bytes(g, isz) + 4 * (size_t)g.qp * g.ldp;
}
__host__ __device__ inline size_t smem_roles(const Geo& g, int G, int isz) {
  const size_t cn = cn_bytes(g, isz), head = head_bytes(g, isz);
  return floats_bytes(g, G) + cn + (cn > head ? cn : head) + park_bytes(g) + 4 * 16;
}

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// ---- fragments of mma.m16n8k16 (lane: g = lane / 4, c = lane % 4) ----
// A (16 x 16): v[0..1] row g, k 2c..2c+1; v[2..3] row g + 8; v[4..7] the
// same at k + 8.  B (16 x 8): v[0..1] k 2c..2c+1, column g; v[2..3] k + 8.
// The accumulator (16 x 8): [0..1] row g, columns 2c..2c+1; [2..3] row g + 8.

// A from a row-major tile X[m][k]
template <typename U>
__device__ __forceinline__ void frag_a(float (&v)[8], const U* X, int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const U* r0 = X + (m0 + g) * ld + k0 + 2 * c;
  const U* r1 = r0 + 8 * ld;
  v[0] = tof(r0[0]), v[1] = tof(r0[1]), v[2] = tof(r1[0]), v[3] = tof(r1[1]);
  v[4] = tof(r0[8]), v[5] = tof(r0[9]), v[6] = tof(r1[8]), v[7] = tof(r1[9]);
}
// A from a tile stored transposed, X[k][m]
template <typename U>
__device__ __forceinline__ void frag_at(float (&v)[8], const U* X, int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const U* p = X + (k0 + 2 * c) * ld + m0 + g;
  v[0] = tof(p[0]), v[1] = tof(p[ld]), v[2] = tof(p[8]), v[3] = tof(p[ld + 8]);
  v[4] = tof(p[8 * ld]), v[5] = tof(p[9 * ld]), v[6] = tof(p[8 * ld + 8]);
  v[7] = tof(p[9 * ld + 8]);
}
// A from a row-major matrix in device memory, rows x cols, zeros past them
template <typename U>
__device__ __forceinline__ void frag_a_dev(float (&v)[8], const U* X, long ld, int rows, int cols,
                                           int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = m0 + g + 8 * ((e >> 1) & 1), k = k0 + 2 * c + (e & 1) + 8 * (e >> 2);
    v[e] = r < rows && k < cols ? repro::ld(X, r * ld + k) : 0.f;
  }
}
// B from a tile stored [k][n]
template <typename U>
__device__ __forceinline__ void frag_b_kn(float (&v)[4], const U* X, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const U* p = X + (k0 + 2 * c) * ld + n0 + g;
  v[0] = tof(p[0]), v[1] = tof(p[ld]), v[2] = tof(p[8 * ld]), v[3] = tof(p[9 * ld]);
}
// B from a tile stored [n][k]
template <typename U>
__device__ __forceinline__ void frag_b_nk(float (&v)[4], const U* X, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const U* p = X + (n0 + g) * ld + k0 + 2 * c;
  v[0] = tof(p[0]), v[1] = tof(p[1]), v[2] = tof(p[8]), v[3] = tof(p[9]);
}

// K values as NT bf16 terms, two a register, each bf16 of what the terms
// before it leave
template <int NT, int K>
__device__ __forceinline__ void split(float (&v)[K], uint32_t (&r)[NT][K / 2]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int k = 0; k < K / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      const float2 b = __bfloat1622float2(h);
      v[2 * k] -= b.x;
      v[2 * k + 1] -= b.y;
      r[t][k] = *reinterpret_cast<const uint32_t*>(&h);
    }
}
// acc += a . b over the term pairs taken, smallest first
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float (&acc)[4], const uint32_t (&a)[TA][4],
                                          const uint32_t (&b)[TB][2]) {
#pragma unroll
  for (int ta = TA - 1; ta >= 0; --ta)
#pragma unroll
    for (int tb = TB - 1; tb >= 0; --tb)
      if (keep(ta, tb)) mma_bf16(acc, a[ta], b[tb][0], b[tb][1]);
}
// one B fragment loaded and split, then multiplied
template <int TA, int TB, bool KN, typename U>
__device__ __forceinline__ void mma_tile(float (&acc)[4], const uint32_t (&a)[TA][4], const U* X,
                                         int ld, int k0, int n0) {
  float bv[4];
  if constexpr (KN) frag_b_kn(bv, X, ld, k0, n0);
  else frag_b_nk(bv, X, ld, k0, n0);
  uint32_t b[TB][2];
  split<TB>(bv, b);
  mma_terms<TA, TB>(acc, a, b);
}

// rows x cols of src (row r at src + r * lds) times scale(r) into the tile
// dst (pitch ld), zeros up to prows x pcols.  The caller syncs.
template <typename U, typename S, typename F>
__device__ inline void stage(U* dst, int ld, const S* src, long lds, int rows, int cols, int prows,
                             int pcols, F scale) {
  for (int e = threadIdx.x; e < prows * pcols; e += THREADS) {
    const int r = e / pcols, k = e - r * pcols;
    put(dst + r * ld + k, r < rows && k < cols ? repro::ld(src, r * lds + k) * scale(r) : 0.f);
  }
}

// sum over the four lanes of an accumulator row (lanes c = 0..3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Dims {
  int B, S, H, P, N, q, G, nc, groups;
};

// the call's pointers: the forward's inputs and scratch, the gradients,
// and the backward's scratch regions
template <typename T>
struct Ptrs {
  const T *x, *b, *c, *dy;
  const float *dt, *a_log, *d_skip, *d_final, *prev, *decay;
  T *dx, *db, *dc;
  float *ddt, *da_log, *dd;
  float *dstate, *ddac_i, *ddac_j, *lastx, *dyx, *pdc, *pdb;
};

// ---- launch 1: the carried states' local gradients --------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
dprev_kernel(Ptrs<T> a, Dims d) {
  constexpr int NT = kInTerms<T>, WT = kValTerms<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo g = geo(d.q, d.N, d.P);
  const int bc = blockIdx.x / d.groups, h0 = (blockIdx.x - bc * d.groups) * d.G;
  const int bi = bc / d.nc, ci = bc - bi * d.nc;
  if (ci == 0) return;   // chunk 0 carries no state: its gradient is not read
  float* dts = reinterpret_cast<float*>(smem);
  float* dac = dts + d.G * g.qp;
  T* Cs = reinterpret_cast<T*>(dac + d.G * g.qp);                            // [qp][ldn]
  float* Es = reinterpret_cast<float*>(smem + floats_bytes(g, d.G) + cn_bytes(g, sizeof(T)));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c2 = 2 * (lane & 3), r0 = lane >> 2;
  const long row0 = (long)bi * d.S + (long)ci * d.q;
  const auto one = [](int) { return 1.f; };

  stage(Cs, g.ldn, a.c + row0 * d.N, d.N, d.q, d.N, g.qp, g.np, one);
  chunk_cumsum(a.dt, a.a_log, row0, d.H, h0, d.G, d.q, g.qp, dts, dac);
  __syncthreads();
  const int m0 = 16 * warp;   // this warp's 16 state rows n
  for (int hh = 0; hh < d.G; ++hh) {
    const int h = h0 + hh;
    const float* dh = dac + hh * g.qp;
    stage(Es, g.ldp, a.dy + (row0 * d.H + h) * d.P, (long)d.H * d.P, d.q, d.P, g.qp, g.pp,
          [&](int i) { return expf(dh[i]); });
    __syncthreads();
    if (m0 < d.N) {
      float acc[PMAX / 8][4];
#pragma unroll
      for (int i = 0; i < PMAX / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      for (int k0 = 0; k0 < g.qp; k0 += 16) {
        float av[8];
        frag_at(av, Cs, g.ldn, m0, k0);   // C^T: rows n, k = i
        uint32_t af[NT][4];
        split<NT>(av, af);
#pragma unroll
        for (int nt = 0; nt < PMAX / 8; ++nt) {
          if (nt * 8 >= g.pp) break;
          mma_tile<NT, WT, true>(acc[nt], af, Es, g.ldp, k0, nt * 8);
        }
      }
      float* out = a.dstate + ((long)bc * d.H + h) * d.N * d.P;
#pragma unroll
      for (int nt = 0; nt < PMAX / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = m0 + r0 + 8 * (e >> 1), p = nt * 8 + c2 + (e & 1);
          if (n < d.N && p < d.P) out[(long)n * d.P + p] = acc[nt][e];
        }
    }
    __syncthreads();   // Es is restaged for the next head
  }
}

// ---- launch 2: the state's gradient over the chunks in reverse --------------
// VEC consecutive elements of one (batch, head) a thread: from the last chunk
// to the first, writes dS_c over dprev_c and folds dprev_c in, PASS_DEPTH
// chunks' loads in flight.
template <int VEC>
__global__ void __launch_bounds__(PASS)
rpass_kernel(float* __restrict__ st, const float* __restrict__ decay,
             const float* __restrict__ d_final, int H, int NP, int nc) {
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
  for (int i = 0; i < VEC; ++i) run[i] = d_final ? d_final[(long)bh * NP + e + i] : 0.f;
  const auto pack = [&]() {
    if constexpr (VEC == 4) return make_float4(run[0], run[1], run[2], run[3]);
    else return run[0];
  };
  for (int c0 = nc - 1; c0 >= 0; c0 -= PASS_DEPTH) {
    V s[PASS_DEPTH];
    float f[PASS_DEPTH];
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (c0 - k >= 1) {
        s[k] = p[(c0 - k) * cstride];
        f[k] = dec[(long)(c0 - k) * H];
      }
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k) {
      const int c = c0 - k;
      if (c < 0) break;
      p[c * cstride] = pack();
      if (c == 0) break;
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
}

// ---- launch 3: the chunk's gradients, one side of the diagonal a block ------
// J false: the "i" block, rows i; true: the "j" block, rows j.  Each warp owns
// 16 rows; its parked blocks kb run over kb <= warp (i) or kb >= warp (j).
__device__ __forceinline__ int park_index(bool J, int w, int kb, int nq) {
  return J ? w * nq - w * (w - 1) / 2 + (kb - w) : w * (w + 1) / 2 + kb;
}

template <typename T, bool J>
__device__ __forceinline__ void roles_body(const Ptrs<T>& a, const Dims& d, int blk,
                                           unsigned char* smem) {
  constexpr int NT = kInTerms<T>, WT = kValTerms<T>;
  const Geo g = geo(d.q, d.N, d.P);
  const int grp = blk % d.groups, bc = blk / d.groups, h0 = grp * d.G;
  const int bi = bc / d.nc, ci = bc - bi * d.nc;
  const long row0 = (long)bi * d.S + (long)ci * d.q;
  float* dts = reinterpret_cast<float*>(smem);
  float* dac = dts + d.G * g.qp;
  unsigned char* base = smem + floats_bytes(g, d.G);
  // Ys: the tile kept throughout (i: B; j: C); Xs: the tile the parked
  // blocks are formed from (i: C; j: B), whose space a head's tiles reuse
  T* Ys = reinterpret_cast<T*>(base);
  unsigned char* reuse = base + cn_bytes(g, sizeof(T));
  T* Xs = reinterpret_cast<T*>(reuse);
  T* Dys = reinterpret_cast<T*>(reuse);                                       // dy [qp][ldp]
  float* Xws = reinterpret_cast<float*>(reuse + sizeof(T) * g.qp * g.ldp);    // xw [qp][ldp]
  float* Sts = Xws + g.qp * g.ldp;                    // i: prev_c, j: dS_c [np][ldp]
  const size_t cn = cn_bytes(g, sizeof(T)), hb = head_bytes(g, sizeof(T));
  float* park = reinterpret_cast<float*>(reuse + (cn > hb ? cn : hb));
  float* red = park + 256 * g.nq * (g.nq + 1) / 2;    // 16 floats of block sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = lane >> 2, c2 = 2 * (lane & 3);
  const int m0 = 16 * warp;
  const bool active = m0 < d.q;
  const auto one = [](int) { return 1.f; };
  const T* ymat = J ? a.c : a.b;
  const T* xmat = J ? a.b : a.c;

  stage(Ys, g.ldn, ymat + row0 * d.N, d.N, d.q, d.N, g.qp, g.np, one);
  stage(Xs, g.ldn, xmat + row0 * d.N, d.N, d.q, d.N, g.qp, g.np, one);
  chunk_cumsum(a.dt, a.a_log, row0, d.H, h0, d.G, d.q, g.qp, dts, dac);
  __syncthreads();

  // the parked blocks: X_rows . Y_kb^T (i: C B^T at kb <= warp; j: B C^T at kb >= warp)
  {
    float pk[QMAX / 8][4];
#pragma unroll
    for (int i = 0; i < QMAX / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pk[i][e] = 0.f;
    if (active) {
      for (int k0 = 0; k0 < g.np; k0 += 16) {
        float av[8];
        frag_a(av, Xs, g.ldn, m0, k0);
        uint32_t af[NT][4];
        split<NT>(av, af);
#pragma unroll
        for (int kb = 0; kb < QMAX / 16; ++kb) {
          if (kb >= g.nq) break;
          if (J ? kb < warp : kb > warp) continue;
          mma_tile<NT, NT, false>(pk[2 * kb], af, Ys, g.ldn, k0, kb * 16);
          mma_tile<NT, NT, false>(pk[2 * kb + 1], af, Ys, g.ldn, k0, kb * 16 + 8);
        }
      }
#pragma unroll
      for (int kb = 0; kb < QMAX / 16; ++kb) {
        if (kb >= g.nq) break;
        if (J ? kb < warp : kb > warp) continue;
        float* dst = park + park_index(J, warp, kb, g.nq) * 256 + lane * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[e] = pk[2 * kb][e];
          dst[4 + e] = pk[2 * kb + 1][e];
        }
      }
    }
  }
  __syncthreads();   // Xs's space takes the heads' tiles from here

  // the group's sum over heads: i, dC rows i; j, dB rows j (16 x N a warp)
  float acc[NMAX / 8][4];
#pragma unroll
  for (int i = 0; i < NMAX / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int rowa = m0 + r0, rowb = rowa + 8;

  for (int hh = 0; hh < d.G; ++hh) {
    const int h = h0 + hh;
    const float* dh = dac + hh * g.qp;
    const float* th = dts + hh * g.qp;
    const float last = dh[d.q - 1];
    const long sbase = ((long)bc * d.H + h) * d.N * d.P;
    const bool carry = ci > 0;   // chunk 0 carries no state
    stage(Dys, g.ldp, a.dy + (row0 * d.H + h) * d.P, (long)d.H * d.P, d.q, d.P, g.qp, g.pp, one);
    stage(Xws, g.ldp, a.x + (row0 * d.H + h) * d.P, (long)d.H * d.P, d.q, d.P, g.qp, g.pp,
          [&](int j) { return th[j]; });
    if (J) {
      stage(Sts, g.ldp, a.dstate + sbase, d.P, d.N, d.P, g.np, g.pp, one);
    } else if (carry) {
      stage(Sts, g.ldp, a.prev + sbase, d.P, d.N, d.P, g.np, g.pp, one);
    }
    __syncthreads();

    float rowsum[2] = {0.f, 0.f};   // this lane's part of d(dac) at rows rowa, rowb
    float scale[2];                 // i: exp(dac_i); j: s_j
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? rowb : rowa;
      scale[r] = row < d.q ? expf(J ? last - dh[row] : dh[row]) : 0.f;
    }
    float dxw[PMAX / 8][4];         // j: dxw rows j
#pragma unroll
    for (int i = 0; i < PMAX / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxw[i][e] = 0.f;
    float vdot[2] = {0.f, 0.f};     // j: this lane's part of <B_j dS_c, xw_j>

    if (active) {
      if (J) {
        // V = B_rows dS_c, then dxw = s o V
        for (int k0 = 0; k0 < g.np; k0 += 16) {
          float av[8];
          frag_a_dev(av, a.b + row0 * d.N, d.N, d.q, d.N, m0, k0);
          uint32_t af[NT][4];
          split<NT>(av, af);
#pragma unroll
          for (int pt = 0; pt < PMAX / 8; ++pt) {
            if (pt * 8 >= g.pp) break;
            mma_tile<NT, WT, true>(dxw[pt], af, Sts, g.ldp, k0, pt * 8);
          }
        }
#pragma unroll
        for (int pt = 0; pt < PMAX / 8; ++pt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, row = r ? rowb : rowa, p = pt * 8 + c2 + (e & 1);
            if (row < d.q && p < d.P) vdot[r] += dxw[pt][e] * Xws[row * g.ldp + p];
            dxw[pt][e] *= scale[r];
          }
      }
      // the carried state's term, 16 columns of N at a time: i, R = dy prev_c^T
      // into dC with exp(dac_i) and <C_i, R_i> into d(dac)_i; j, U = xw dS_c^T
      // into dB with s_j
      if (J || carry) {
        const T* pmat = J ? a.b : a.c;
        float pdot[2] = {0.f, 0.f};
#pragma unroll
        for (int nb = 0; nb < NMAX / 16; ++nb) {
          if (nb * 16 >= g.np) break;
          float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int k0 = 0; k0 < g.pp; k0 += 16) {
            float av[8];
            if (J) {
              frag_a(av, Xws, g.ldp, m0, k0);
              uint32_t af[WT][4];
              split<WT>(av, af);
              mma_tile<WT, WT, false>(tmp[0], af, Sts, g.ldp, k0, nb * 16);
              mma_tile<WT, WT, false>(tmp[1], af, Sts, g.ldp, k0, nb * 16 + 8);
            } else {
              frag_a(av, Dys, g.ldp, m0, k0);
              uint32_t af[NT][4];
              split<NT>(av, af);
              mma_tile<NT, WT, false>(tmp[0], af, Sts, g.ldp, k0, nb * 16);
              mma_tile<NT, WT, false>(tmp[1], af, Sts, g.ldp, k0, nb * 16 + 8);
            }
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, row = r ? rowb : rowa, n = nb * 16 + hf * 8 + c2 + (e & 1);
              acc[2 * nb + hf][e] += scale[r] * tmp[hf][e];
              if (!J && row < d.q && n < d.N)
                pdot[r] += repro::ld(pmat, (row0 + row) * d.N + n) * tmp[hf][e];
            }
        }
        if (!J) {
          rowsum[0] += scale[0] * pdot[0];
          rowsum[1] += scale[1] * pdot[1];
        }
      }
      // the blocks of the chunk: i, dM = dy_rows xw_kb^T at kb <= warp; j,
      // dM^T = xw_rows dy_kb^T at kb >= warp
#pragma unroll 1
      for (int kb = 0; kb < g.nq; ++kb) {
        if (J ? kb < warp : kb > warp) continue;
        float dm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int k0 = 0; k0 < g.pp; k0 += 16) {
          float av[8];
          if (J) {
            frag_a(av, Xws, g.ldp, m0, k0);
            uint32_t af[WT][4];
            split<WT>(av, af);
            mma_tile<WT, NT, false>(dm[0], af, Dys, g.ldp, k0, kb * 16);
            mma_tile<WT, NT, false>(dm[1], af, Dys, g.ldp, k0, kb * 16 + 8);
          } else {
            frag_a(av, Dys, g.ldp, m0, k0);
            uint32_t af[NT][4];
            split<NT>(av, af);
            mma_tile<NT, WT, false>(dm[0], af, Xws, g.ldp, k0, kb * 16);
            mma_tile<NT, WT, false>(dm[1], af, Xws, g.ldp, k0, kb * 16 + 8);
          }
        }
        const float* pb = park + park_index(J, warp, kb, g.nq) * 256 + lane * 8;
        float dl[8], mm[8];   // dM o L and M, in A-fragment order
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, row = r ? rowb : rowa;
            const int col = kb * 16 + hf * 8 + c2 + (e & 1);
            // i: L_{row,col}, col <= row; j: L_{col,row}, col >= row
            const bool ok = row < d.q && col < d.q && (J ? col >= row : col <= row);
            const float l = ok ? expf(J ? dh[col] - dh[row] : dh[row] - dh[col]) : 0.f;
            const float m = pb[hf * 4 + e] * l, dmv = dm[hf][e];
            rowsum[r] += J ? -(dmv * m) : dmv * m;
            dl[hf * 4 + e] = dmv * l;
            mm[hf * 4 + e] = m;
          }
        {
          uint32_t af[WT][4];
          split<WT>(dl, af);
#pragma unroll
          for (int nt = 0; nt < NMAX / 8; ++nt) {
            if (nt * 8 >= g.np) break;
            mma_tile<WT, NT, true>(acc[nt], af, Ys, g.ldn, kb * 16, nt * 8);
          }
        }
        if (J) {   // dxw += M^T dy
          uint32_t af[WT][4];
          split<WT>(mm, af);
#pragma unroll
          for (int pt = 0; pt < PMAX / 8; ++pt) {
            if (pt * 8 >= g.pp) break;
            mma_tile<WT, NT, true>(dxw[pt], af, Dys, g.ldp, kb * 16, pt * 8);
          }
        }
      }
    }

    float lastpart = 0.f;   // j: this lane's part of Σ_j s_j <B_j dS_c, xw_j>
    if (J) {
      // dx = dxw dt + D dy, and <dxw, x>, <dy, x> a position
      const float dsk = a.d_skip[h];
      float px[2] = {0.f, 0.f}, py[2] = {0.f, 0.f};
      if (active) {
#pragma unroll
        for (int pt = 0; pt < PMAX / 8; ++pt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, row = r ? rowb : rowa, p = pt * 8 + c2 + (e & 1);
            if (row >= d.q || p >= d.P) continue;
            const long at = ((row0 + row) * d.H + h) * d.P + p;
            const float xv = repro::ld(a.x, at), dyv = tof(Dys[row * g.ldp + p]);
            repro::st(a.dx, at, dxw[pt][e] * th[row] + dsk * dyv);
            px[r] += dxw[pt][e] * xv;
            py[r] += dyv * xv;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sv = quad_sum(vdot[r]);
        rowsum[r] -= scale[r] * vdot[r];
        if ((lane & 3) == 0) lastpart += scale[r] * sv;
        px[r] = quad_sum(px[r]);
        py[r] = quad_sum(py[r]);
        const int row = r ? rowb : rowa;
        if (active && (lane & 3) == 0 && row < d.q) {
          const long at = (row0 + row) * d.H + h;
          a.ddt[at] = px[r];
          a.dyx[at] = py[r];
        }
      }
      // de_c = <dS_c, prev_c>, this thread's elements in order
      float de = 0.f;
      if (carry)
        for (int e = threadIdx.x; e < d.N * d.P; e += THREADS)
          de += a.dstate[sbase + e] * a.prev[sbase + e];
      lastpart = warp_sum(lastpart);
      de = warp_sum(de);
      if (lane == 0) {
        red[warp] = lastpart;
        red[8 + warp] = de;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(rowsum[r]);
      const int row = r ? rowb : rowa;
      if (active && (lane & 3) == 0 && row < d.q)
        (J ? a.ddac_j : a.ddac_i)[((long)bc * d.H + h) * d.q + row] = v;
    }
    __syncthreads();   // red is full; the tiles are restaged for the next head
    if (J && threadIdx.x == 0) {
      float s = 0.f, de = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) {
        s += red[w];
        de += red[8 + w];
      }
      a.lastx[(long)bc * d.H + h] = s + a.decay[(long)bc * d.H + h] * de;
    }
  }

  // the group's dC (i) or dB (j), f32, for launch 4 to sum over the groups
  if (active) {
    float* out = (J ? a.pdb : a.pdc) + ((long)bc * d.groups + grp) * d.q * d.N;
#pragma unroll
    for (int nt = 0; nt < NMAX / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e >> 1) ? rowb : rowa, n = nt * 8 + c2 + (e & 1);
        if (row < d.q && n < d.N) out[(long)row * d.N + n] = acc[nt][e];
      }
  }
}

// j blocks first (the heavier), then i blocks
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
roles_kernel(Ptrs<T> a, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blocks = d.B * d.nc * d.groups;
  if ((int)blockIdx.x < blocks) roles_body<T, true>(a, d, blockIdx.x, smem);
  else roles_body<T, false>(a, d, blockIdx.x - blocks, smem);
}

// ---- launch 4: the sums across blocks, in a fixed order ---------------------
template <typename T>
__global__ void __launch_bounds__(FIN)
finish_kernel(Ptrs<T> a, Dims d) {
  __shared__ float red[2 * FIN / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < d.H) {
    // one head: d(dac) -> dda (reverse cumulative sum in the chunk), ddt,
    // and the head's da_log and dD
    const int h = blockIdx.x;
    const float an = expf(a.a_log[h]);
    float pa = 0.f, pd = 0.f;
    for (int u = warp; u < d.B * d.nc; u += FIN / 32) {
      const int bi = u / d.nc, ci = u - bi * d.nc;
      const long unit = (long)u * d.H + h;
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = lane * 4 + t;
        v[t] = i < d.q ? a.ddac_i[unit * d.q + i] + a.ddac_j[unit * d.q + i]
                             + (i == d.q - 1 ? a.lastx[unit] : 0.f)
                       : 0.f;
      }
      float suf[4];   // this lane's suffix sums
      suf[3] = v[3];
#pragma unroll
      for (int t = 2; t >= 0; --t) suf[t] = v[t] + suf[t + 1];
      float incl = suf[0];   // over the lanes at and after this one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      const float after = incl - suf[0];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = lane * 4 + t;
        if (i >= d.q) continue;
        const float dda = after + suf[t];
        const long at = ((long)bi * d.S + (long)ci * d.q + i) * d.H + h;
        a.ddt[at] -= an * dda;
        pa += dda * (-an * a.dt[at]);
        pd += a.dyx[at];
      }
    }
    pa = warp_sum(pa);
    pd = warp_sum(pd);
    if (lane == 0) {
      red[warp] = pa;
      red[FIN / 32 + warp] = pd;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sa = 0.f, sd = 0.f;
      for (int w = 0; w < FIN / 32; ++w) {
        sa += red[w];
        sd += red[FIN / 32 + w];
      }
      a.da_log[h] = sa;
      a.dd[h] = sd;
    }
    return;
  }
  // dC, then dB: the head groups' partials summed in order
  const long total = (long)d.B * d.S * d.N;
  const long e = (long)(blockIdx.x - d.H) * FIN + threadIdx.x;
  if (e >= 2 * total) return;
  const bool isb = e >= total;
  const long r = isb ? e - total : e;
  const int n = (int)(r % d.N);
  const long bt = r / d.N;
  const int bi = (int)(bt / d.S), t = (int)(bt - (long)bi * d.S);
  const int ci = t / d.q, i = t - ci * d.q;
  const float* part = (isb ? a.pdb : a.pdc) + ((long)(bi * d.nc + ci) * d.groups * d.q + i) * d.N + n;
  float s = 0.f;
  for (int gi = 0; gi < d.groups; ++gi) s += part[(long)gi * d.q * d.N];
  repro::st(isb ? a.db : a.dc, r, s);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline size_t workspace_floats(int B, int S, int H, int P, int N, int q, int G) {
  const size_t nc = S / q, units = (size_t)B * nc * H;
  return units * ((size_t)N * P + 2 * q + 1) + (size_t)B * S * H +
         2 * (size_t)B * nc * (H / G) * q * N;
}

template <typename T>
int launch(const void* const* in, void* const* out, void* ws, int B, int S, int H, int P, int N,
           int q, int G, int phases, cudaStream_t stream) {
  const int nc = S / q;
  const Dims d{B, S, H, P, N, q, G, nc, H / G};
  Ptrs<T> a;
  a.x = static_cast<const T*>(in[0]);
  a.dt = static_cast<const float*>(in[1]);
  a.a_log = static_cast<const float*>(in[2]);
  a.b = static_cast<const T*>(in[3]);
  a.c = static_cast<const T*>(in[4]);
  a.d_skip = static_cast<const float*>(in[5]);
  a.dy = static_cast<const T*>(in[6]);
  a.d_final = static_cast<const float*>(in[7]);
  a.prev = static_cast<const float*>(in[8]);
  const size_t units = (size_t)B * nc * H;
  a.decay = a.prev + units * N * P;
  a.dx = static_cast<T*>(out[0]);
  a.ddt = static_cast<float*>(out[1]);
  a.da_log = static_cast<float*>(out[2]);
  a.db = static_cast<T*>(out[3]);
  a.dc = static_cast<T*>(out[4]);
  a.dd = static_cast<float*>(out[5]);
  float* w = static_cast<float*>(ws);
  a.dstate = w;
  a.ddac_i = a.dstate + units * N * P;
  a.ddac_j = a.ddac_i + units * q;
  a.lastx = a.ddac_j + units * q;
  a.dyx = a.lastx + units;
  a.pdc = a.dyx + (size_t)B * S * H;
  a.pdb = a.pdc + (size_t)B * nc * d.groups * q * N;
  const Geo g = geo(q, N, P);
  const unsigned blocks = (unsigned)((long)B * nc * d.groups);
  cudaError_t err;
  if (phases & 1) {
    const size_t smem = smem_dprev(g, G, sizeof(T));
    if ((err = repro::allow_smem(dprev_kernel<T>, smem)) != cudaSuccess) return (int)err;
    dprev_kernel<T><<<blocks, THREADS, smem, stream>>>(a, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    const int np_ = N * P;
    if (np_ % 4 == 0 && aligned16(a.dstate) && (a.d_final == nullptr || aligned16(a.d_final)))
      rpass_kernel<4><<<(unsigned)((long)B * H * ((np_ + 4 * PASS - 1) / (4 * PASS))), PASS, 0,
                        stream>>>(a.dstate, a.decay, a.d_final, H, np_, nc);
    else
      rpass_kernel<1><<<(unsigned)((long)B * H * ((np_ + PASS - 1) / PASS)), PASS, 0, stream>>>(
          a.dstate, a.decay, a.d_final, H, np_, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & 4) {
    const size_t smem = smem_roles(g, G, sizeof(T));
    if ((err = repro::allow_smem(roles_kernel<T>, smem)) != cudaSuccess) return (int)err;
    roles_kernel<T><<<2 * blocks, THREADS, smem, stream>>>(a, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & 8) {
    const long total = 2L * B * S * N;
    finish_kernel<T><<<(unsigned)(H + (total + FIN - 1) / FIN), FIN, 0, stream>>>(a, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

bool takes(int q, int N, int P) {
  return q > 0 && q <= QMAX && N > 0 && N <= NMAX && P > 0 && P <= PMAX;
}

int dispatch(const void* const* in, void* const* out, void* ws, int B, int S, int H, int P, int N,
             int q, int group, int dtype, int phases, void* stream) {
  if (!takes(q, N, P) || S % q != 0 || group < 1 || group > GMAX || H % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, out, ws, B, S, H, P, N, q, group, phases, s);
  if (dtype == 1) return launch<bf16>(in, out, ws, B, S, H, P, N, q, group, phases, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of launch 1-4 in bytes at a head group of `group`
// (kernels/ssd_scan.py:_ssd_bwd_smem computes the same); -1 for what the
// kernel does not take.
extern "C" long long ssd_scan_bwd_smem(int launch, int q, int N, int P, int group, int dtype) {
  if (!takes(q, N, P) || (dtype != 0 && dtype != 1) || launch < 1 || launch > 4 || group < 1 ||
      group > GMAX)
    return -1;
  const int isz = dtype == 0 ? 4 : 2;
  const Geo g = geo(q, N, P);
  return launch == 1 ? (long long)smem_dprev(g, group, isz)
                     : launch == 3 ? (long long)smem_roles(g, group, isz) : 0;
}

// Scratch bytes: the f32 states' gradient (B, NC, H, N, P), the two sides'
// d(dac) (B, NC, H, q) each, the last position's extra (B, NC, H), <dy, x>
// (B, S, H), then the groups' dC and dB (B, NC, H / group, q, N) each.
extern "C" long long ssd_scan_bwd_workspace(int B, int S, int H, int P, int N, int q, int group) {
  if (q <= 0 || S % q != 0 || group < 1 || H % group != 0) return -1;
  return 4 * (long long)workspace_floats(B, S, H, P, N, q, group);
}

// x (B, S, H, P); dt (B, S, H) float32; a_log, d_skip (H,) float32; b, c
// (B, S, N) in x's dtype; dy like x; d_final (B, H, N, P) float32 or null
// (zero); fws: the forward's scratch for these inputs (ssd_scan_workspace
// bytes: the carried states, then the chunk decays).  Writes dx, db, dc in
// x's dtype and ddt, da_log, dd in float32; ws: ssd_scan_bwd_workspace
// bytes.  q, N, P and group as ssd_scan_fwd takes them; dtype 0 = float32,
// 1 = bfloat16.  Runs the four launches of one call.  Returns 0 when every
// launch was accepted, else the CUDA error.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a_log, const void* b,
                            const void* c, const void* d_skip, const void* dy,
                            const void* d_final, const void* fws, void* dx, void* ddt,
                            void* da_log, void* db, void* dc, void* dd, void* ws, int B, int S,
                            int H, int P, int N, int q, int group, int dtype, void* stream) {
  const void* in[9] = {x, dt, a_log, b, c, d_skip, dy, d_final, fws};
  void* out[6] = {dx, ddt, da_log, db, dc, dd};
  return dispatch(in, out, ws, B, S, H, P, N, q, group, dtype, 15, stream);
}

// For timing only: launch k (1 d(prev), 2 reverse state pass, 3 chunk
// gradients, 4 sums) alone, with ssd_scan_bwd's arguments, on whatever the
// scratch holds: the gradients are right only after launches 1-4 in order.
extern "C" int ssd_scan_bwd_launch(int k, const void* x, const void* dt, const void* a_log,
                                   const void* b, const void* c, const void* d_skip,
                                   const void* dy, const void* d_final, const void* fws,
                                   void* dx, void* ddt, void* da_log, void* db, void* dc,
                                   void* dd, void* ws, int B, int S, int H, int P, int N, int q,
                                   int group, int dtype, void* stream) {
  if (k < 1 || k > 4) return (int)cudaErrorInvalidValue;
  const void* in[9] = {x, dt, a_log, b, c, d_skip, dy, d_final, fws};
  void* out[6] = {dx, ddt, da_log, db, dc, dd};
  return dispatch(in, out, ws, B, S, H, P, N, q, group, dtype, 1 << (k - 1), stream);
}
