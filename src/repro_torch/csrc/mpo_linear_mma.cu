// MPO-linear forward for Hopper: y[M, J] = x[M, I] @ W(cores), with W rebuilt
// in f32 on chip and its product with x on the tensor cores, for bfloat16 and
// float32 activations.  W is never written to device memory.  A stack of E
// matrices of one shape (the experts of a MoE layer: cores (E, d0, i, j, d1),
// x [E, M, I], y [E, M, J]) runs in the same launches, each launch's grid
// gaining the expert: the expert's R, P and split partials are its own
// blocks of the workspace.
//
// Replaces the Pallas TPU kernel repro/kernels/mpo_linear.py:_fwd_call /
// _fwd_kernel (float32 core shapes the plan refuses keep csrc/mpo_linear.cu).
//
// Function.  The core chain is split at a bond s (kernels/mpo_linear.py:
// _mma_plan): with I = (ip, is) and J = (jp, js) the row-major digit groups
// of cores [0, s) and [s, n),
//     W[ip, is, jp, js] = sum_d L[ip, jp, d] * R[d, is, js],
// L the contraction of the prefix cores, R of the suffix cores, both in f32.
// The products run in bf16 on the tensor cores (mma.sync, f32 accumulate),
// with each f32 operand split into bf16 terms, each term bf16 of what the
// terms before it leave:
//   bfloat16: x is bf16 already; each f32 value w of W enters as
//     w0 = bf16(w) and w1 = bf16(w - w0), ~16 bits of w; x.w0 + x.w1.
//   float32: x and W each enter as three terms (x0 + x1 + x2, w0 + w1 + w2,
//     ~24 bits each: float32's own precision), and the six products whose
//     size is at least 2^-24 of the leading one are issued, smallest first:
//     x2.w0, x1.w1, x1.w0, x0.w2, x0.w1, x0.w0.
// Every product is exact in f32.  bfloat16 sums them into one f32
// accumulator over all of I; float32 sums each 16 rows' six products of an
// output element into a fresh f32 value and adds that to the accumulator
// with a rounded add (the tensor cores truncate their sums, which over a
// long I biases one accumulator towards zero).  The order is fixed; y is
// rounded to its dtype once.  That is the arithmetic of the plain version
// (f32 W, f32 product), in another order.
//
// Design.
//   1. Two prologue kernels contract, once a call, the suffix cores into R
//      (f32, d_s * Is * Js values, laid out [d][js][is]) and the prefix
//      cores 0..s-2 into P[ipp, jpp, :] (f32), both into the workspace.
//      With ip = (ipp, ik) and jp = (jpp, jk) split at the last prefix
//      core, L[ip, jp, :] = P[ipp, jpp, :] . core_{s-1}[:, ik, jk, :].
//   2. mma_kernel: one block owns a BM x 128 output tile and a contiguous
//      range of BK = 32-row stages of I; 8 warps copy, rebuild and multiply
//      (at BM = 128, 8 more form L, see kSplitWarps).  It copies R into shared
//      memory with cp.async once, and double-buffers the x stage with
//      cp.async (16-byte chunks: 8 bf16 or 4 floats).  L is double-buffered
//      too: while a stage rebuilds W from this L (and, at BM = 128,
//      multiplies), the next ip's L is formed in one step from P (16-byte
//      loads of core rows, each applied to the two L vectors that read it,
//      the sum over d_{s-1} split over up to 8 lanes and added in a fixed
//      order).  The 32 x 128 W stage is rebuilt register-tiled:
//      each thread owns 4 is rows x TC jp columns that share one js, so per
//      d it reads one float4 of R and one float4 (float2) of L and does
//      4 x TC FMAs (0.5 shared reads an FMA at TC = 4).  R ([d][js][is])
//      and L ([q][d][jq]) are laid out so that a warp's reads are contiguous
//      or broadcast.  The f32 values go to two (float32: three) bf16 stage
//      tiles at a padded row pitch of 272 bytes; in float32 the same warps
//      split the landed f32 x stage into three bf16 tiles at an 80-byte
//      pitch.  The warps then load x (ldmatrix) and W (ldmatrix.trans)
//      fragments, conflict-free at the 80- and 272-byte pitches, and issue
//      mma.sync.m16n8k16 (bf16 in, f32 accumulate): bf16 w0 then w1 into
//      the accumulator, float32 the six term products of a k-step into a
//      zeroed fragment that is then added to it.
//   3. Few rows (at most 64): the stages are split over S blocks per tile so
//      the grid fills the card; each split writes f32 partials [S, M, J] and
//      reduce_kernel sums them in split order and rounds once.  No atomics:
//      two launches give the same bits.
//
// What bounds it on this card.  The product is M * I * J FMAs on the tensor
// cores (doubled by the bf16 W pair, six-fold in float32), but the rebuild
// runs on the CUDA cores in f32: ceil(M / BM) * I * J * d_s FMAs a call, and
// each block forms the L of every (ip, jp) it touches, reading d_{s-1} x d_s
// core rows from L2 for each.  With 8 to 16 warps an SM and a barrier
// between the rebuild and the product, both are latency-bound, the L step
// the most (it sets the pace at bert-base's matrices, PERF.md).  float32
// adds the x split, a third W tile and three times the products, and its
// larger stages leave one block an SM at BM = 64 where bf16 has two.  The
// next step is the rebuild itself as a batched [Is x d_s] . [d_s x njp]
// tensor-core product for each js, then wgmma with TMA-fed stages and warps
// specialised to load, rebuild and multiply, so the core rows' latency hides
// behind the products.
#include <stdint.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAXN = 8;
constexpr int THREADS = 256;          // 8 warps
constexpr int BN = 128;               // output tile columns
constexpr int BK = 32;                // rows of I a stage
constexpr int XP = BK + 8;            // bf16 x stage / term row pitch: 80 B
constexpr int WP = BN + 8;            // W stage row pitch (bf16): 272 B
constexpr int PC = 8;                 // digit pairs a prologue block

// the bf16 terms an f32 value enters the products as: x (bf16 or f32) and W
template <typename T>
constexpr int kXTerms = sizeof(T) == 4 ? 3 : 1;
template <typename T>
constexpr int kWTerms = sizeof(T) == 4 ? 3 : 2;

struct Args {
  const void* core[MAXN];
  long cstride[MAXN];  // elements of core k a matrix of the stack
  int bond[MAXN + 1];  // d_0 .. d_n  (d_0 = d_n = 1)
  int fin[MAXN];       // i_k
  int fout[MAXN];      // j_k
  int sin[MAXN];       // place value of core k's i digit within its group (ip or is)
  int sout[MAXN];      // the same for the j digit (jp or js)
  int n, s;
  int I, J, Is, Js, Ip, Jp;
  int M;
  int ds, dmax;
  int Isb;             // rows of one ip within a stage: min(Is, BK)
  int nq;              // ip values a stage covers: BK / Isb
  int njq;             // jp values a tile covers: BN / Js
  int nst;             // stages over I
  int per;             // stages a split
  int S;               // splits
  int E;               // matrices in the stack
};

// floats of P (one matrix): the prefix contraction through cores 0..s-2
__host__ __device__ inline long p_floats(const Args& a) {
  return a.s == 1 ? 1 : (long)(a.Ip / a.fin[a.s - 1]) * (a.Jp / a.fout[a.s - 1]) * a.bond[a.s - 1];
}

// core k of matrix e of the stack
template <typename T>
__device__ __forceinline__ const T* core_at(const Args& a, int k, int e) {
  return static_cast<const T*>(a.core[k]) + e * a.cstride[k];
}

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

// R[d][js][is] for the suffix cores s..n-1, contracted right to left, PC
// (is, js) pairs a block, every thread on one (pair, row) output.
template <typename T>
__global__ void __launch_bounds__(THREADS) suffix_kernel(Args a, float* __restrict__ R) {
  extern __shared__ float sbuf[];
  float* in = sbuf;                 // [PC][dmax]
  float* out = sbuf + PC * a.dmax;  // [PC][dmax]
  const int npair = a.Is * a.Js;
  const int pc0 = blockIdx.x * PC;
  const int np = min(PC, npair - pc0);
  const int ex = blockIdx.y;
  R += (long)ex * npair * a.ds;
  for (int k = a.n - 1; k >= a.s; --k) {
    const T* c = core_at<T>(a, k, ex);
    const int d0 = a.bond[k], d1 = a.bond[k + 1];
    const long row = (long)a.fin[k] * a.fout[k] * d1;
    for (int e = threadIdx.x; e < np * d0; e += THREADS) {
      const int p = e / d0, r = e % d0;
      const int pair = pc0 + p;
      const int is = pair / a.Js, js = pair % a.Js;
      const int ik = (is / a.sin[k]) % a.fin[k];
      const int jk = (js / a.sout[k]) % a.fout[k];
      const long base = r * row + ((long)ik * a.fout[k] + jk) * d1;
      float acc;
      if (k == a.n - 1) {
        acc = repro::ld(c, base);  // d_n = 1
      } else {
        acc = 0.f;
        const float* v = in + p * a.dmax;
#pragma unroll 8
        for (int b = 0; b < d1; ++b) acc += repro::ld(c, base + b) * v[b];
      }
      if (k == a.s) R[((long)r * a.Js + js) * a.Is + is] = acc;
      else out[p * a.dmax + r] = acc;
    }
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
}

// P[ipp, jpp, :] for the prefix cores 0..s-2, left to right, PC digit pairs
// a block: ip = ipp * i_{s-1} + ik and jp = jpp * j_{s-1} + jk, so each
// stage's L[ip, jp, :] = P[ipp, jpp, :] . core_{s-1}[:, ik, jk, :] is one
// step.  P = [1] when s = 1.
template <typename T>
__global__ void __launch_bounds__(THREADS) prefix_kernel(Args a, float* __restrict__ P) {
  extern __shared__ float sbuf[];
  float* in = sbuf;                 // [PC][dmax]
  float* out = sbuf + PC * a.dmax;  // [PC][dmax]
  const int ex = blockIdx.y;
  P += ex * p_floats(a);
  if (a.s == 1) {
    if (threadIdx.x == 0) P[0] = 1.f;
    return;
  }
  const int fi = a.fin[a.s - 1], fo = a.fout[a.s - 1];
  const int Jpp = a.Jp / fo;
  const int npair = a.Ip / fi * Jpp;
  const int pc0 = blockIdx.x * PC;
  const int np = min(PC, npair - pc0);
  for (int k = 0; k < a.s - 1; ++k) {
    const T* c = core_at<T>(a, k, ex);
    const int d0 = a.bond[k], d1 = a.bond[k + 1];
    const long row = (long)a.fin[k] * a.fout[k] * d1;
    for (int e = threadIdx.x; e < np * d1; e += THREADS) {
      const int p = e / d1, col = e % d1;
      const int pair = pc0 + p;
      const int ip = pair / Jpp * fi, jp = pair % Jpp * fo;
      const int ik = (ip / a.sin[k]) % a.fin[k];
      const int jk = (jp / a.sout[k]) % a.fout[k];
      const long base = ((long)ik * a.fout[k] + jk) * d1 + col;
      float v;
      if (k == 0) {
        v = repro::ld(c, base);  // d_0 = 1
      } else {
        v = 0.f;
        const float* u = in + p * a.dmax;
#pragma unroll 8
        for (int r = 0; r < d0; ++r) v += u[r] * repro::ld(c, r * row + base);
      }
      if (k == a.s - 2) P[(long)pair * d1 + col] = v;
      else out[p * a.dmax + col] = v;
    }
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
}

// Shared memory of mma_kernel, in bytes (kernels/mpo_linear.py:_mma_smem_bytes
// mirrors it): R, the two x stages (bf16 at pitch XP, f32 at pitch BK), two L
// buffers, in float32 the three bf16 x terms, and the W term stages.
__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ inline size_t lt_bytes(const Args& a) {
  return round16(sizeof(float) * (size_t)a.nq * a.ds * a.njq);
}
template <typename T>
size_t mma_smem(const Args& a, int bm) {
  const size_t xstage = sizeof(T) == 4 ? sizeof(float) * BK : sizeof(bf16) * XP;
  const size_t xterms = sizeof(T) == 4 ? kXTerms<T> * sizeof(bf16) * (size_t)bm * XP : 0;
  return sizeof(float) * (size_t)a.ds * a.Is * a.Js + 2 * xstage * bm + 2 * lt_bytes(a) +
         xterms + kWTerms<T> * sizeof(bf16) * (size_t)BK * WP;
}

// 128-row tiles add 8 warps that form the next stage's L while the first 8
// rebuild and multiply (one block an SM at 128 registers); smaller tiles keep
// 8 warps, two blocks an SM, and form L between the two
template <int BM>
constexpr bool kSplitWarps = BM >= 128;

template <typename T, int BM, int TC>
__global__ void __launch_bounds__(kSplitWarps<BM> ? 2 * THREADS : THREADS,
                                  kSplitWarps<BM> ? 1 : 2)
mma_kernel(Args a, const T* __restrict__ x, T* __restrict__ y,
           const float* __restrict__ Rg, const float* __restrict__ P,
           float* __restrict__ part) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NX = kXTerms<T>, NW = kWTerms<T>;
  constexpr int CH = 16 / sizeof(T);            // x elements a 16-byte chunk
  constexpr int XSP = F32 ? BK : XP;            // x stage row pitch, elements
  constexpr int WARPS_M = BM >= 128 ? 2 : 1;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WTM = BM / WARPS_M;
  constexpr int WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(NT % 2 == 0, "W fragments are loaded two n-tiles at a time");

  extern __shared__ __align__(16) unsigned char smem[];
  const int rsz = a.ds * a.Is * a.Js;
  float* Rs = reinterpret_cast<float*>(smem);                  // [ds][Js][Is]
  T* xs = reinterpret_cast<T*>(Rs + rsz);                      // [2][BM][XSP]
  float* Lt0 = reinterpret_cast<float*>(xs + 2 * BM * XSP);    // 2 x [nq][ds][njq]
  float* Lt1 = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Lt0) + lt_bytes(a));
  // float32: the three bf16 terms of the stage's x, [NX][BM][XP]
  bf16* xt = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Lt1) + lt_bytes(a));
  bf16* Wt = xt + (F32 ? NX * BM * XP : 0);                    // [NW][BK][WP]

  constexpr bool WS = kSplitWarps<BM>;
  const bool lwarp = WS && threadIdx.x >= THREADS;  // an L warp
  const int tid = threadIdx.x % THREADS, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int c0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int mtiles = (a.M + BM - 1) / BM;
  const int ex = blockIdx.z / mtiles;                         // the matrix of the stack
  const int m0 = blockIdx.z % mtiles * BM;
  x += (long)ex * a.M * a.I;
  y += (long)ex * a.M * a.J;
  Rg += (long)ex * rsz;
  P += ex * p_floats(a);
  part += (long)ex * a.S * a.M * a.J;
  const int st0 = split * a.per;
  const int st1 = min(a.nst, st0 + a.per);
  const int jp0 = c0 / a.Js;

  auto load_x = [&](int st, int buf) {
    const int i0 = st * BK;
    T* dst = xs + buf * BM * XSP;
    for (int e = tid; e < BM * (BK / CH); e += THREADS) {
      const int r = e / (BK / CH), ch = e % (BK / CH);
      const int m = m0 + r, i = i0 + ch * CH;
      const bool ok = m < a.M && i < a.I;       // I % CH == 0: whole chunks
      cp_async16(dst + r * XSP + ch * CH, ok ? x + (long)m * a.I + i : x, ok ? 16 : 0);
    }
  };

  // L[ip, jp0 + jq, :] of a stage's ip, one step from P through the last
  // prefix core, written to Lb; zero for ip or jp past the matrix's edge.
  // With ds % 8 == 0 on a 16-byte aligned core a task reads 8 columns of a
  // core row in 16-byte loads (one of bf16, two of f32) and applies them to
  // the VG <= 2 vectors of the stage that read the same row (jq equal mod
  // j_{s-1}, one jk: half the L2 traffic; more vectors a task spill
  // registers), and the RP lanes of one task split the sum over r and add
  // their parts by a fixed butterfly (same bits every launch).
  auto lstage = [&](int st, float* Lb) {
    const int ipb = st * BK / a.Is;
    const int nvec = a.nq * a.njq;
    const int k = a.s - 1;
    const T* c = core_at<T>(a, k, ex);
    const int d0 = a.bond[k], fi = a.fin[k], fo = a.fout[k];
    const int Jpp = a.Jp / fo;
    const long row = (long)fi * fo * a.ds;
    if (a.ds % 8 == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0) {
      const int per_jk = a.njq % fo == 0 ? a.njq / fo : 1;
      const int VG = per_jk % 2 == 0 ? 2 : 1;
      const int nvt = nvec / VG;             // vector groups
      const int n8 = a.ds / 8;
      const int ntask = nvt * n8;
      int RP = 1;
      while (RP < 8 && ntask * RP * 2 <= THREADS) RP *= 2;
      const int part = tid % RP;
      for (int t0 = 0; t0 < ntask; t0 += THREADS / RP) {
        const int task = t0 + tid / RP;
        const int vt = task / n8, c8 = task % n8;
        const int q = vt / (a.njq / VG), rem = vt % (a.njq / VG);
        const int ip = ipb + q;
        // the group's jq: jqb and jqb + fo, one jk
        const int jqb = rem % fo + fo * (rem / fo) * VG;
        float v[2][8];
        const float* u[2];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int jp = jp0 + jqb + fo * g;
          u[g] = (g < VG && jp < a.Jp) ? P + ((long)(ip / fi) * Jpp + jp / fo) * d0 : nullptr;
#pragma unroll
          for (int e = 0; e < 8; ++e) v[g][e] = 0.f;
        }
        if (task < ntask && ip < a.Ip && u[0] != nullptr) {
          const T* src = c + ((long)(ip % fi) * fo + (jp0 + jqb) % fo) * a.ds + 8 * c8;
#pragma unroll 8
          for (int r = part; r < d0; r += RP) {
            float f[8];
            if constexpr (F32) {
              const float4 lo = __ldg(reinterpret_cast<const float4*>(src + r * row));
              const float4 hi = __ldg(reinterpret_cast<const float4*>(src + r * row) + 1);
              f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
              f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
            } else {
              const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + r * row));
              const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 t = __bfloat1622float2(h[e]);
                f[2 * e] = t.x;
                f[2 * e + 1] = t.y;
              }
            }
#pragma unroll
            for (int g = 0; g < 2; ++g) {
              if (u[g] == nullptr) continue;
              const float ur = __ldg(u[g] + r);
#pragma unroll
              for (int e = 0; e < 8; ++e) v[g][e] = fmaf(ur, f[e], v[g][e]);
            }
          }
        }
#pragma unroll
        for (int o = 1; o < RP; o *= 2)
#pragma unroll
          for (int g = 0; g < 2; ++g)
#pragma unroll
            for (int e = 0; e < 8; ++e) v[g][e] += __shfl_xor_sync(0xffffffffu, v[g][e], o);
        if (task < ntask && part == 0) {
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            if (g >= VG) break;
            const int jq = jqb + fo * g;
#pragma unroll
            for (int e = 0; e < 8; ++e) Lb[(q * a.ds + 8 * c8 + e) * a.njq + jq] = v[g][e];
          }
        }
      }
    } else {
      for (int e = tid; e < nvec * a.ds; e += THREADS) {
        const int vi = e / a.ds, col = e % a.ds;
        const int q = vi / a.njq, jq = vi % a.njq;
        const int ip = ipb + q, jp = jp0 + jq;
        float v = 0.f;
        if (ip < a.Ip && jp < a.Jp) {
          const long base = ((long)(ip % fi) * fo + jp % fo) * a.ds + col;
          const float* u = P + ((long)(ip / fi) * Jpp + jp / fo) * d0;
#pragma unroll 8
          for (int r = 0; r < d0; ++r) v += __ldg(u + r) * repro::ld(c, r * row + base);
        }
        Lb[(q * a.ds + col) * a.njq + jq] = v;
      }
    }
  };

  // the W stage: thread patches of 4 is rows (one ip) x TC jp columns (one js)
  auto rebuild = [&](int st, const float* Lt) {
    const int isoff = st * BK % a.Is;  // 0 when Is < BK
    const int G = a.Isb / 4;
    const int U = G * a.Js;
    const int NJG = a.njq / TC;
    const int npatch = U * a.nq * NJG;  // BK * BN / (4 * TC)
    const int rstep = a.Js * a.Is;
    for (int p = tid; p < npatch; p += THREADS) {
      const int u = p % U, v = p / U;
      const int g = u % G, js = u / G;
      const int jg = v % NJG, q = v / NJG;
      const float* rp = Rs + js * a.Is + isoff + 4 * g;
      const float* lp = Lt + q * a.ds * a.njq + jg * TC;
      float acc[4][TC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < a.ds; ++d) {
        const float4 rv = *reinterpret_cast<const float4*>(rp + d * rstep);
        const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
        float lv[TC];
        if constexpr (TC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(lp + d * a.njq);
          lv[0] = t.x; lv[1] = t.y; lv[2] = t.z; lv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(lp + d * a.njq);
          lv[0] = t.x; lv[1] = t.y;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(lv[c], rr[r], acc[r][c]);
      }
      const int kk0 = q * a.Isb + 4 * g;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const int idx = (kk0 + r) * WP + (jg * TC + c) * a.Js + js;
          float w = acc[r][c];
#pragma unroll
          for (int t = 0; t < NW; ++t) {    // w_t = bf16(what w_0..w_{t-1} leave)
            const bf16 h = __float2bfloat16(w);
            Wt[t * BK * WP + idx] = h;
            w -= __bfloat162float(h);
          }
        }
    }
  };

  // float32: the landed x stage into its three bf16 terms, 4 values a task
  auto split_x = [&](int buf) {
    const float* src = reinterpret_cast<const float*>(xs) + buf * BM * XSP;
    for (int e = tid; e < BM * (BK / 4); e += THREADS) {
      const int r = e / (BK / 4), c4 = e % (BK / 4);
      const float4 v = *reinterpret_cast<const float4*>(src + r * XSP + 4 * c4);
      repro::split_terms4<NX>(v, xt + r * XP + 4 * c4, BM * XP);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // bfloat16: the x tile against both W terms, an n-tile pair's fragments
  // loaded together, w0 then w1 into the accumulator
  auto product_bf16 = [&](const bf16* xb) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], xb + (wm * WTM + mt * 16 + (lane & 15)) * XP + kk + (lane >> 4) * 8);
      const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        const int ncol = wn * WTN + nt * 8 + (lane >> 4) * 8;
        uint32_t bh[4], bl[4];
        ldmatrix_x4_trans(bh, Wt + krow * WP + ncol);
        ldmatrix_x4_trans(bl, Wt + BK * WP + krow * WP + ncol);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], af[mt], bh[0], bh[1]);
          mma_bf16(acc[mt][nt], af[mt], bl[0], bl[1]);
          mma_bf16(acc[mt][nt + 1], af[mt], bh[2], bh[3]);
          mma_bf16(acc[mt][nt + 1], af[mt], bl[2], bl[3]);
        }
      }
    }
  };

  // float32: for each 16 rows of I and each n-tile, the six products go
  // into a zeroed f32 fragment, smallest first, and a rounded f32 add puts
  // that into the accumulator.  The tensor cores truncate the sum they
  // return, so adding every product straight into one accumulator over all
  // of I shrinks y by a bias that grows with I (1.4e-4 of its largest
  // magnitude at I = 30720); a fragment that starts at zero a k-step keeps
  // that bias to the k-step's own products.
  auto product_f32 = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t b[NT / 2][NW][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
#pragma unroll
        for (int t = 0; t < NW; ++t)
          ldmatrix_x4_trans(b[np][t], Wt + t * BK * WP + krow * WP + wn * WTN + np * 16 +
                                          (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[NX][4];
#pragma unroll
        for (int t = 0; t < NX; ++t)
          ldmatrix_x4(af[t], xt + t * BM * XP + (wm * WTM + mt * 16 + (lane & 15)) * XP + kk +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int h = 2 * (nt & 1);
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          // x_t pairs with the W terms that keep the product >= 2^-24 of x0.w0
#pragma unroll
          for (int tx = NX - 1; tx >= 0; --tx)
#pragma unroll
            for (int tw = NW - 1 - tx; tw >= 0; --tw)
              mma_bf16(p, af[tx], b[nt / 2][tw][h], b[nt / 2][tw][h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
      }
    }
  };

  auto product = [&](int buf) {
    if constexpr (F32) product_f32();
    else product_bf16(reinterpret_cast<const bf16*>(xs) + buf * BM * XP);
  };

  if (!lwarp) {
    for (int e = tid; e < rsz / 4; e += THREADS) cp_async16(Rs + 4 * e, Rg + 4 * e, 16);
    if (st0 < st1) load_x(st0, 0);
    cp_async_commit();
  }
  if ((!WS || lwarp) && st0 < st1) lstage(st0, Lt0);
  float* Lcur = Lt0;
  float* Lnext = Lt1;
  for (int st = st0; st < st1; ++st) {
    const int buf = (st - st0) & 1;
    if (!lwarp) {
      if (st + 1 < st1) load_x(st + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // R and this stage's x have landed
    }
    __syncthreads();     // ... and this stage's L
    // the next stage's L (when its ip changes) alongside this stage's W
    const bool newL = st + 1 < st1 && (st + 1) * BK % a.Is == 0;
    if ((!WS || lwarp) && newL) lstage(st + 1, Lnext);
    if (!lwarp) {
      if constexpr (F32) split_x(buf);
      rebuild(st, Lcur);
      if (WS) asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS));  // the 8 W warps
      else __syncthreads();
      product(buf);
    }
    __syncthreads();
    if (newL) {
      float* t = Lcur;
      Lcur = Lnext;
      Lnext = t;
    }
  }
  if (lwarp) return;

  // epilogue: one rounding to y's dtype (or the split's f32 partial), ragged
  // M and J edges masked
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = c0 + wn * WTN + nt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WTM + mt * 16 + (lane >> 2) + 8 * h;
        if (m >= a.M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= a.J) continue;
          const float v = acc[mt][nt][2 * h + e];
          if (a.S == 1) repro::st(y, (long)m * a.J + col + e, v);
          else part[((long)split * a.M + m) * a.J + col + e] = v;
        }
      }
    }
}

// y = (sum of the S partials, in split order), rounded to y's dtype once;
// each matrix of the stack has its own [S, M, J] partials
template <typename T>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ part, T* __restrict__ y, long mj, int S, int E) {
  for (long i = blockIdx.x * (long)THREADS + threadIdx.x; i < E * mj;
       i += (long)gridDim.x * THREADS) {
    const long ex = i / mj, r = i % mj;
    float v = 0.f;
    for (int k = 0; k < S; ++k) v += part[(ex * S + k) * mj + r];
    repro::st(y, i, v);
  }
}

// Fills a from the core shapes for x elements of esize bytes; false when the
// kernel cannot take them.
bool make_args(Args& a, const void* const* cores, const int* shapes, int n, int split, int M,
               int S, int E, int esize) {
  if (n < 2 || n > MAXN || split < 1 || split >= n || S < 1 || E < 1) return false;
  a.n = n;
  a.s = split;
  a.I = a.J = a.Is = a.Js = 1;
  a.dmax = 1;
  for (int k = 0; k < n; ++k) {
    a.core[k] = cores ? cores[k] : nullptr;
    a.bond[k] = shapes[4 * k];
    a.fin[k] = shapes[4 * k + 1];
    a.fout[k] = shapes[4 * k + 2];
    a.cstride[k] = (long)shapes[4 * k] * a.fin[k] * a.fout[k] * shapes[4 * k + 3];
    a.I *= a.fin[k];
    a.J *= a.fout[k];
    if (k >= split) {
      a.Is *= a.fin[k];
      a.Js *= a.fout[k];
    }
    a.dmax = a.bond[k] > a.dmax ? a.bond[k] : a.dmax;
  }
  a.bond[n] = shapes[4 * (n - 1) + 3];
  a.dmax = a.bond[n] > a.dmax ? a.bond[n] : a.dmax;
  a.Ip = a.I / a.Is;
  a.Jp = a.J / a.Js;
  a.M = M;
  a.E = E;
  a.ds = a.bond[split];
  for (int k = n - 1, pi = 1, po = 1; k >= 0; --k) {
    if (k == split - 1) pi = po = 1;
    a.sin[k] = pi;
    a.sout[k] = po;
    pi *= a.fin[k];
    po *= a.fout[k];
  }
  // I in whole 16-byte chunks of x
  if (a.I % (16 / esize) || a.Is % 4 || (a.Is % BK && BK % a.Is) || BN % a.Js) return false;
  a.Isb = a.Is < BK ? a.Is : BK;
  a.nq = BK / a.Isb;
  a.njq = BN / a.Js;
  a.nst = (a.I + BK - 1) / BK;
  a.per = (a.nst + S - 1) / S;
  a.S = S;
  return (a.nst + a.per - 1) / a.per == S;
}

template <typename T, int BM, int TC>
int launch_main(const Args& a, const void* x, void* y, const float* R, const float* P,
                float* part, cudaStream_t st) {
  const size_t smem = mma_smem<T>(a, BM);
  cudaError_t err = repro::allow_smem(mma_kernel<T, BM, TC>, smem);
  if (err != cudaSuccess) return (int)err;
  const long zdim = (long)a.E * ((a.M + BM - 1) / BM);  // matrices x row tiles
  if (zdim > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((a.J + BN - 1) / BN, a.S, (unsigned)zdim);
  mma_kernel<T, BM, TC><<<grid, kSplitWarps<BM> ? 2 * THREADS : THREADS, smem, st>>>(
      a, static_cast<const T*>(x), static_cast<T*>(y), R, P, part);
  return (int)cudaGetLastError();
}

template <typename T, int BM>
int launch_tc(int tc, const Args& a, const void* x, void* y, const float* R, const float* P,
              float* part, cudaStream_t st) {
  if (tc == 4 && a.njq % 4 == 0) return launch_main<T, BM, 4>(a, x, y, R, P, part, st);
  if (tc == 2 && a.njq % 2 == 0) return launch_main<T, BM, 2>(a, x, y, R, P, part, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const Args& a, int bm, int tc, const void* x, void* y, float* ws, cudaStream_t st) {
  // the workspace: every matrix's R, then every matrix's P, then every
  // matrix's [S, M, J] partials
  float* R = ws;
  const long rsz = (long)a.ds * a.Is * a.Js;
  float* P = R + a.E * rsz;
  float* part = P + a.E * p_floats(a);
  const size_t ssmem = 2 * sizeof(float) * PC * a.dmax;
  suffix_kernel<T><<<dim3((a.Is * a.Js + PC - 1) / PC, a.E), THREADS, ssmem, st>>>(a, R);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  prefix_kernel<T><<<dim3((p_floats(a) / a.bond[a.s - 1] + PC - 1) / PC, a.E), THREADS, ssmem,
                     st>>>(a, P);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (bm == 128) rc = launch_tc<T, 128>(tc, a, x, y, R, P, part, st);
  else if (bm == 64) rc = launch_tc<T, 64>(tc, a, x, y, R, P, part, st);
  else if (bm == 16) rc = launch_tc<T, 16>(tc, a, x, y, R, P, part, st);
  else rc = (int)cudaErrorInvalidValue;
  if (rc || a.S == 1) return rc;
  const long mj = (long)a.M * a.J;
  const long want = (a.E * mj + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 4096 ? want : 4096);
  reduce_kernel<T><<<blocks, THREADS, 0, st>>>(part, static_cast<T*>(y), mj, a.S, a.E);
  return (int)cudaGetLastError();
}

int esize(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, cores and y alike).

// Floats of workspace one call over a stack of E matrices takes: each
// matrix's R, P, then (S > 1) its [S, M, J] partials.
extern "C" long mpo_linear_mma_workspace(const int* shapes, int n, int split, int M, int S,
                                         int E, int dtype) {
  Args a;
  if (!esize(dtype) || !make_args(a, nullptr, shapes, n, split, M, S, E, esize(dtype))) return -1;
  return E * ((long)a.ds * a.Is * a.Js + p_floats(a) + (S > 1 ? (long)S * M * a.J : 0));
}

// Dynamic shared memory of the main kernel at row tile bm, in bytes (a
// block's: the same for any stack of matrices).
extern "C" long mpo_linear_mma_smem(const int* shapes, int n, int split, int bm, int dtype) {
  Args a;
  if (!esize(dtype) || !make_args(a, nullptr, shapes, n, split, 1, 1, 1, esize(dtype)))
    return -1;
  return (long)(dtype == 0 ? mma_smem<float>(a, bm) : mma_smem<bf16>(a, bm));
}

// cores: n device pointers; shapes: n * 4 ints (d0, i, j, d1) per core of
// one matrix; E matrices stacked (each core E contiguous blocks of its
// shape; E = 1 for one matrix).  bm: 16, 64 or 128 rows an output tile; tc:
// 4 or 2 jp columns a rebuild patch; S: splits of I.  x [E, M, I] and y
// [E, M, J]; ws: the workspace.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int mpo_linear_mma_fwd(const void* const* cores, const int* shapes, int n, int split,
                                  int bm, int tc, int S, const void* x, void* y, int M, int E,
                                  void* ws, int dtype, void* stream) {
  Args a;
  if (!esize(dtype) || !make_args(a, cores, shapes, n, split, M, S, E, esize(dtype)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  return dtype == 0 ? launch<float>(a, bm, tc, x, y, w, st) : launch<bf16>(a, bm, tc, x, y, w, st);
}
