// MPO-linear forward for Hopper, float32, for the core shapes the
// tensor-core kernel csrc/mpo_linear_mma.cu refuses (kernels/mpo_linear.py:
// forward_kernel, route "cuda_core"): y[M, J] = x[M, I] @ W(cores), W rebuilt
// in f32 in shared memory and never written to device memory, its product
// with x on the tensor cores.  A stack of E matrices of one shape (the
// experts of a MoE layer: cores (E, d0, i, j, d1), x [E, M, I], y [E, M, J])
// runs in the same launch, the expert in the grid.
//
// Replaces the Pallas TPU kernel repro/kernels/mpo_linear.py:_fwd_call /
// _fwd_kernel for those shapes: whisper-tiny's layer matrices, zamba2-7b's
// shared attention, gemma2-27b's, nemotron-4-15b's and llava-next-34b's FFN,
// the vocabulary heads that no bond tiles (qwen3-14b's lm_head), the smoke
// configs' narrow matrices.  What the sibling needs and these shapes lack:
// R and P in a scratch within an eighth of W (whisper's R and P are 1.4x
// its W), digit groups in whole 4-row and 128-column tiles (whisper's 3 and
// 9, qwen3's js group of 6).
//
// Function.  The core chain is split at a bond s (kernels/mpo_linear.py:
// _narrow_plan): with I = (ip, is) and J = (jp, js) the row-major digit
// groups of cores [0, s) and [s, n),
//     W[ip, is, jp, js] = sum_d L[ip, jp, d] * R[d, is, js],
// L the contraction of the prefix cores, R of the suffix cores, both f32.
// The product runs as mpo_linear_mma.cu's float32 path: x and W each enter as
// three bf16 terms (each bf16 of what the terms before it leave, ~24 bits),
// the six products of size at least 2^-24 of x0.w0 are issued smallest first
// (x2.w0, x1.w1, x1.w0, x0.w2, x0.w1, x0.w0) into a zeroed f32 fragment a
// 16-row k-step, and a rounded f32 add puts that into the accumulator (the
// tensor cores truncate their sums; a long I would bias one accumulator
// towards zero).  The order of every sum is fixed and there are no atomics:
// two launches give the same bits.
//
// Design.  Digit groups are padded in shared memory, never in the cores: is
// to Isp (the power of two >= Is up to 32, else a multiple of 32) and js to
// Jsp (the power of two >= Js up to 64, else a multiple of 64), so that a
// 32-row stage of I holds whole ip groups (or lies in one) and a 64-column
// tile whole jp groups (or lies in one), and a tile never cuts a js group.
// Padded rows and columns are zero in R and in the x stage, and masked in
// the epilogue.  A block of 8 warps owns a 64-column tile of one expert, a
// contiguous range of the stages of I (a split) and a group of RG row tiles
// of BM = 64 or 128 rows:
//   1. R (f32, [d][js][is] at the padded pitches) is contracted once a
//      block, right to left through the suffix cores, into shared memory
//      (its chain buffers in the x and W region, free until then).
//   2. L is formed for L groups of lq ip (a few stages): ip = (ipp, ik), jp =
//      (jpp, jk) split at core s-1, P[ipp, jpp, :] the chain through cores
//      0..s-2 for the group's ipp and the tile's jpp (its steps through
//      cores 0..s-3 kept while their coarser prefixes hold; each step 4
//      columns a thread, float4 loads of core rows, the sum over the bond
//      split over lanes and added by a fixed butterfly), then L in one
//      product [(ipp, jpp) x d_{s-1}] . core_{s-1}[:, ik, jk, :], 4 columns
//      by up to 8 rows a thread: each core row is read once a group, as
//      float4, by consecutive threads.  Core rows stream from L2, and that
//      traffic, not the multiply-adds, sets the pace of L and P.
//   3. The block walks its stages in chunks of CH.  Each stage's 32 x 64 W
//      is rebuilt in f32 registers, 4 is rows x 2 jp columns a thread where
//      Isp % 4 == 0 and Jsp <= 32 (one float4 of R and one float2 of L a d),
//      else one value at a time, and written as three bf16 term tiles at a
//      144-byte pitch (ldmatrix.trans without bank conflicts) into the
//      chunk's slot of the stage.
//   4. Then every row tile of the group runs the chunk's stages against the
//      resident W: x stages (f32, BM x 32 at a 160-byte pitch) in three
//      buffers, two stages in flight, copied with cp.async across row tiles
//      and stages (16-byte chunks where Is is not padded and I % 4 == 0,
//      else 4-byte copies); each warp owns 16 rows, reads its A fragments
//      as float2 (conflict free), splits them into three bf16 terms in
//      registers, loads the W terms with ldmatrix.trans and issues
//      mma.sync.m16n8k16.  With one row tile the accumulator stays in
//      registers over the chunks; with more each row tile's f32 partial sum
//      goes to its output between chunks and comes back (the same thread,
//      exact in f32: the same bits as kept in registers).
//   5. Few rows (fewer blocks than two waves of the card): the stages are
//      split over S blocks a tile; each writes f32 partials [S, M, J] to the
//      workspace (below a quarter of the bf16 W: _narrow_plan) and a second
//      pass sums them in split order.
// kernels/mpo_linear.py:_narrow_plan picks BM, RG, CH, lq and S from a cost
// model calibrated on the H100 (PERF.md row 1c).
//
// What bounds it.  The product is M * I * J FMAs, six bf16 products each
// on the tensor cores (PERF.md's bound counts the f32 operations at
// float32's 67 TFLOP/s).  Each block rebuilds its tile's W once: I_split * 64 * d_s FMAs
// on the CUDA cores, and streams the core rows of L and P from L2 for each
// L group (with bond-128 chains, gemma2-27b's FFN, ~0.5 MB of core s-1 and
// ~0.6 MB of core s-2 per group of 4 stages).  At few rows (decode, M = 64,
// a vocabulary head at 2 rows) those core reads bound it: 45-85% of a
// block's cycles are L and P.  At many rows W is resident and rebuilt once
// a row group, and the x stages' wait (every 64-column tile reads all of x:
// J / 64 times over), the product and the partial sums' trips take most of
// it.  Next: wider column tiles (fewer x reads, more jpp a core row
// serves), the L and P products on the tensor cores, and wgmma.
#include <stdint.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAXN = 8;
constexpr int THREADS = 256;         // 8 warps
constexpr int BN = 64;               // padded output columns a tile
constexpr int BK = 32;               // padded rows of I a stage
constexpr int XPF = BK + 8;          // f32 x stage row pitch: 160 B
constexpr int WPB = BN + 8;          // bf16 W term row pitch: 144 B
constexpr int NTERM = 3;             // bf16 terms of an f32 operand
constexpr int PQ = 8;                // rows a thread of the L product
constexpr int NXB = 3;               // x stage buffers: two stages in flight

struct Args {
  const float* core[MAXN];
  long cstride[MAXN];  // elements of core k a matrix of the stack
  int bond[MAXN + 1];  // d_0 .. d_n  (d_0 = d_n = 1)
  int fin[MAXN];       // i_k
  int fout[MAXN];      // j_k
  int sin[MAXN];       // place value of core k's i digit within its group (ip or is)
  int sout[MAXN];      // the same for the j digit (jp or js)
  int n, s;
  int I, J, Is, Js, Ip, Jp;
  int Isp, Jsp;        // padded is and js groups
  int Isb, Jsb;        // rows of one ip a stage (min(Isp, BK)), columns of one jp a tile
  int M, E;
  int ds, dmax;
  int dpre;            // d_{s-1}: the length of P (1 when s == 1)
  int nq, njq;         // ip a stage, jp a tile
  int lq;             // ip an L group: a multiple of nq
  int npp, npq;        // ipp an L group, jpp a tile (at most)
  int pc;              // suffix (is, js) pairs a step of R's chain
  int nst;             // stages over the padded I
  int jtiles;          // column tiles over the padded J
  int per, S;          // stages a split, splits
  int rg, ch;          // row tiles a group, stages a chunk of resident W
  int vec;             // x copied in 16-byte chunks
  int fast;            // the W stage rebuilt in 4 x 2 register patches
};

__host__ __device__ inline int pow2ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}
__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }
// a chain buffer of P's steps (Q vectors: at most as many as P's)
__host__ __device__ inline int cbuf_floats(const Args& a) { return a.npp * a.npq * a.dmax; }

// Shared memory of one block at bm rows and ch stages of resident W, in
// bytes (kernels/mpo_linear.py:_narrow_smem_bytes mirrors it): the three x
// stage buffers, the chunk's three W term tiles a stage, R, L, P and the two
// chain buffers of P's steps, each rounded to 16 bytes.  R's chain runs in
// the x and W region before either is used (2 * pc * dmax floats).
__host__ __device__ inline size_t smem_x(int bm) {
  return round16(NXB * sizeof(float) * (size_t)bm * XPF);
}
__host__ __device__ inline size_t smem_w(int ch) {
  return round16((size_t)ch * NTERM * sizeof(bf16) * BK * WPB);
}
__host__ __device__ inline size_t smem_r(const Args& a) {
  return round16(sizeof(float) * (size_t)a.ds * a.Isp * a.Jsp);
}
__host__ __device__ inline size_t smem_l(const Args& a) {
  return round16(sizeof(float) * (size_t)a.lq * a.ds * a.njq);
}
__host__ __device__ inline size_t smem_p(const Args& a) {
  return round16(sizeof(float) * (size_t)a.npp * a.npq * a.dpre);
}
__host__ __device__ inline size_t smem_ch(const Args& a) {
  return round16(2 * sizeof(float) * (size_t)cbuf_floats(a));
}
__host__ __device__ inline size_t fwd_smem(const Args& a, int bm, int ch) {
  return smem_x(bm) + smem_w(ch) + smem_r(a) + smem_l(a) + smem_p(a) + smem_ch(a);
}

// 4 bytes from global to shared memory; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// two f32 values as three bf16x2 terms, each bf16 of what the terms before
// it leave
__device__ __forceinline__ void split3(float2 v, uint32_t& t0, uint32_t& t1, uint32_t& t2) {
  uint32_t* t[NTERM] = {&t0, &t1, &t2};
#pragma unroll
  for (int k = 0; k < NTERM; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
    const float2 b = __bfloat1622float2(h);
    v.x -= b.x;
    v.y -= b.y;
    *t[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// the lanes that split one task's sum (a power of two up to 8, adjacent
// lanes of a warp): as many as keep the tasks within one pass of the block
__device__ __forceinline__ int split_lanes(int ntask) {
  int rp = 1;
  while (rp < 8 && ntask * rp * 2 <= THREADS) rp *= 2;
  return rp;
}

// With -DMPO_NARROW_PROFILE (tools/torch_narrow_fwd_profile.py --phases
// builds it so), thread 0 of every block adds the clock cycles of each
// phase, barrier to barrier, to g_prof: R, P, L, the W rebuild, the wait for
// an x stage, the product, the partial sums' trips and the epilogue;
// g_prof[7] counts blocks.
#ifdef MPO_NARROW_PROFILE
__device__ unsigned long long g_prof[8];
#define PROF_MARK(k)                          \
  if (threadIdx.x == 0) {                     \
    const long long t_ = clock64();           \
    prof[k] += t_ - tprev;                    \
    tprev = t_;                               \
  }
#else
#define PROF_MARK(k)
#endif

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

// warp tiles of 16 rows, so no two warps split the same x rows: 128 rows 8 x
// 1 warps of 16 x 64, 64 rows 4 x 2 warps of 16 x 32
template <int BM>
__global__ void __launch_bounds__(THREADS, BM >= 128 ? 1 : 2)
fwd_kernel(Args a, const float* __restrict__ x, float* __restrict__ y, float* __restrict__ part) {
  constexpr int WARPS_M = BM / 16;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WTM = BM / WARPS_M;
  constexpr int WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(NT % 2 == 0, "W fragments are loaded two n-tiles at a time");

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                             // [NXB][BM][XPF]
  bf16* Wt = reinterpret_cast<bf16*>(smem + smem_x(BM));                 // [ch][3][BK][WPB]
  float* Rs = reinterpret_cast<float*>(smem + smem_x(BM) + smem_w(a.ch)); // [ds][Jsp][Isp]
  float* Lt = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Rs) + smem_r(a));
  float* Pb = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Lt) + smem_l(a));
  float* chb = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Pb) + smem_p(a));
  const int cbuf = cbuf_floats(a);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int ct = blockIdx.x;                        // column tile
  const int split = blockIdx.y;
  const int mtiles = (a.M + BM - 1) / BM;
  const int ngroups = (mtiles + a.rg - 1) / a.rg;
  const int ex = blockIdx.z / ngroups;              // the matrix of the stack
  const int rt0 = blockIdx.z % ngroups * a.rg;      // the group's row tiles
  const int nrt = min(a.rg, mtiles - rt0);
  x += (long)ex * a.M * a.I;
  y += (long)ex * a.M * a.J;
  part += (long)ex * a.S * a.M * a.J;
  float* out = a.S == 1 ? y : part + (long)split * a.M * a.J;   // [M, J]
  auto core = [&](int k) { return a.core[k] + ex * a.cstride[k]; };
  const int st0 = split * a.per;
  const int st1 = min(a.nst, st0 + a.per);
  // the tile's jp: njq whole groups from jpa, or the part of one group from
  // column jsoff of it
  const int jpa = a.Jsp <= BN ? ct * a.njq : ct * BN / a.Jsp;
  const int jsoff = a.Jsp <= BN ? 0 : ct * BN % a.Jsp;
  const int s = a.s;
  const int fi = a.fin[s - 1], fo = a.fout[s - 1];
  const int jppa = jpa / fo;
  const int npq = min(jpa + a.njq - 1, a.Jp - 1) / fo - jppa + 1;   // the tile's jpp

  // x stage st (padded rows 32 st ..) of row tile rt into buffer buf
  auto load_x = [&](int rt, int st, int buf) {
    float* dst = xs + buf * BM * XPF;
    const int m0 = rt * BM, r0 = st * BK;
    if (a.vec) {
      for (int e = tid; e < BM * (BK / 4); e += THREADS) {
        const int r = e / (BK / 4), c4 = e % (BK / 4);
        const int m = m0 + r, i = r0 + 4 * c4;          // not padded: padded row = i
        const bool ok = m < a.M && i < a.I;
        cp_async16(dst + r * XPF + 4 * c4, ok ? x + (long)m * a.I + i : x, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const int m = m0 + r, rho = r0 + k;
        const int ip = rho / a.Isp, is = rho % a.Isp;
        const bool ok = m < a.M && ip < a.Ip && is < a.Is;
        cp_async4(dst + r * XPF + k, ok ? x + (long)m * a.I + (long)ip * a.Is + is : x,
                  ok ? 4 : 0);
      }
    }
  };

  // One chain step for nv vectors: out[v][c] = sum_r in(v)[r] C_k[r, ik(v),
  // jk(v), c] (k == 0: C_0[0, ik, jk, c]), the digits from dig(v, ik, jk);
  // 4 columns a task where d1 % 4 == 0 on a 16-byte aligned core, the sum
  // over r split over the task's lanes and added by a fixed butterfly.
  // Writes dst[v * pitch + c].  No barrier.
  auto chain_step = [&](int k, int nv, auto in, float* dst, int pitch, auto dig) {
    const float* c = core(k);
    const int d0 = a.bond[k], d1 = a.bond[k + 1];
    const long row = (long)a.fin[k] * a.fout[k] * d1;
    if (d1 % 4 == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0) {
      const int n4 = d1 / 4, ntask = nv * n4;
      const int RP = split_lanes(ntask), part_ = tid % RP;
      for (int t0 = 0; t0 < ntask; t0 += THREADS / RP) {
        const int task = t0 + tid / RP;
        const int v = task / n4, c4 = task % n4;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (task < ntask) {
          int ik, jk;
          dig(v, ik, jk);
          const float4* src =
              reinterpret_cast<const float4*>(c + ((long)ik * a.fout[k] + jk) * d1) + c4;
          if (k == 0) {
            if (part_ == 0) {
              const float4 cv = __ldg(src);
              acc[0] = cv.x; acc[1] = cv.y; acc[2] = cv.z; acc[3] = cv.w;
            }
          } else {
            const float* u = in(v);
#pragma unroll 16
            for (int r = part_; r < d0; r += RP) {
              const float4 cv = __ldg(src + r * (row / 4));
              const float ur = u[r];
              acc[0] = fmaf(ur, cv.x, acc[0]);
              acc[1] = fmaf(ur, cv.y, acc[1]);
              acc[2] = fmaf(ur, cv.z, acc[2]);
              acc[3] = fmaf(ur, cv.w, acc[3]);
            }
          }
        }
#pragma unroll
        for (int o = 1; o < RP; o *= 2)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
        if (task < ntask && part_ == 0)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[v * pitch + 4 * c4 + e] = acc[e];
      }
    } else {
      for (int e = tid; e < nv * d1; e += THREADS) {
        const int v = e / d1, col = e % d1;
        int ik, jk;
        dig(v, ik, jk);
        const long base = ((long)ik * a.fout[k] + jk) * d1 + col;
        float val;
        if (k == 0) {
          val = __ldg(c + base);
        } else {
          val = 0.f;
          const float* u = in(v);
#pragma unroll 8
          for (int r = 0; r < d0; ++r) val = fmaf(u[r], __ldg(c + r * row + base), val);
        }
        dst[v * pitch + col] = val;
      }
    }
  };

  // 1. R[d][js][is] through the suffix cores s..n-1, right to left, pc
  //    pairs at a time; padding zero
  auto build_r = [&]() {
    const int rsz = a.ds * a.Isp * a.Jsp;
    for (int e = tid; e < rsz; e += THREADS) Rs[e] = 0.f;
    const int npair = a.Is * a.Js;
    for (int pc0 = 0; pc0 < npair; pc0 += a.pc) {
      const int np = min(a.pc, npair - pc0);
      float* in = xs;                  // the x and W region is free until the chunks
      float* outb = xs + a.pc * a.dmax;
      __syncthreads();   // R zeroed, or the previous pairs' buffers read
      for (int k = a.n - 1; k >= s; --k) {
        const float* c = core(k);
        const int d0 = a.bond[k], d1 = a.bond[k + 1];
        const long row = (long)a.fin[k] * a.fout[k] * d1;
        for (int e = tid; e < np * d0; e += THREADS) {
          const int p = e / d0, r = e % d0;
          const int pair = pc0 + p;
          const int is = pair / a.Js, js = pair % a.Js;
          const int ik = (is / a.sin[k]) % a.fin[k];
          const int jk = (js / a.sout[k]) % a.fout[k];
          const long base = r * row + ((long)ik * a.fout[k] + jk) * d1;
          float acc;
          if (k == a.n - 1) {
            acc = __ldg(c + base);  // d_n = 1
          } else if (d1 % 4 == 0 && a.dmax % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(c) & 15) == 0) {
            float4 a4 = {0.f, 0.f, 0.f, 0.f};     // 4 partial sums, added in order
            const float4* c4 = reinterpret_cast<const float4*>(c + base);
            const float4* v4 = reinterpret_cast<const float4*>(in + p * a.dmax);
#pragma unroll 8
            for (int b = 0; b < d1 / 4; ++b) {
              const float4 cv = __ldg(c4 + b), vv = v4[b];
              a4.x = fmaf(cv.x, vv.x, a4.x);
              a4.y = fmaf(cv.y, vv.y, a4.y);
              a4.z = fmaf(cv.z, vv.z, a4.z);
              a4.w = fmaf(cv.w, vv.w, a4.w);
            }
            acc = (a4.x + a4.y) + (a4.z + a4.w);
          } else {
            acc = 0.f;
            const float* v = in + p * a.dmax;
#pragma unroll 8
            for (int b = 0; b < d1; ++b) acc = fmaf(__ldg(c + base + b), v[b], acc);
          }
          if (k == s) Rs[((long)r * a.Jsp + js) * a.Isp + is] = acc;
          else outb[p * a.dmax + r] = acc;
        }
        __syncthreads();
        float* t = in;
        in = outb;
        outb = t;
      }
    }
  };

  // 2a. P[pp][pq][:] for ipp = ippa + pp (pp < npp) and the tile's jpp =
  //     jppa + pq (pq < npq): the chain through cores 0..s-2.  Its steps
  //     through cores 0..s-3 depend only on the prefixes ipp / i_{s-2} and
  //     jpp / j_{s-2}: those Q vectors are kept across calls while the
  //     prefixes they cover hold, and only the last step runs for every
  //     (ipp, jpp).  Vectors past the edge take wrapped digits; their L is
  //     masked.
  int q_ia = -1, q_ni = 0;       // the kept Q vectors' first i prefix and count
  const float* qbuf = chb;
  const int fq = s >= 2 ? a.fin[s - 2] : 1, gq = s >= 2 ? a.fout[s - 2] : 1;
  const int q_ja = jppa / gq, q_nj = (jppa + npq - 1) / gq - q_ja + 1;
  auto build_p = [&](int ippa, int npp) {
    const int nv = npp * npq;
    auto dig_of = [&](int k, int ipp, int jpp, int& ik, int& jk) {
      ik = (ipp * fi / a.sin[k]) % a.fin[k];
      jk = (jpp * fo / a.sout[k]) % a.fout[k];
    };
    if (s >= 3) {
      const int qa = ippa / fq, nqi = (ippa + npp - 1) / fq - qa + 1;
      if (qa != q_ia || nqi > q_ni) {
        // Q for prefixes (qa + qi, q_ja + qj): the chain through cores 0..s-3
        float* bufs[2] = {chb, chb + cbuf};
        for (int k = 0; k <= s - 3; ++k) {
          const float* in = bufs[(k + 1) & 1];
          chain_step(k, nqi * q_nj, [&](int v) { return in + v * a.dmax; }, bufs[k & 1],
                     a.dmax, [&](int v, int& ik, int& jk) {
                       dig_of(k, (qa + v / q_nj) * fq, (q_ja + v % q_nj) * gq, ik, jk);
                     });
          __syncthreads();
          qbuf = bufs[k & 1];
        }
        q_ia = qa;
        q_ni = nqi;
      }
    }
    chain_step(s - 2, nv,
               [&](int v) {
                 const int ipp = ippa + v / npq, jpp = jppa + v % npq;
                 return qbuf + ((ipp / fq - q_ia) * q_nj + jpp / gq - q_ja) * a.dmax;
               },
               Pb, a.dpre, [&](int v, int& ik, int& jk) {
                 dig_of(s - 2, ippa + v / npq, jppa + v % npq, ik, jk);
               });
    __syncthreads();
  };

  // 2b. L[ip - ipg0][d][jq] of the L group's ip (ipg0 .. ipg0 + lq) and the
  //     tile's jp = jpa + jq, in one product over core s-1's rows: rows the
  //     (ipp, jpp) pairs of the group and the tile (P's vectors), columns
  //     (ik, jk, d) (every ik, or the group's when it lies in one ipp; every
  //     jk, or the tile's when it lies in one jpp), so each core row is read
  //     once for the whole group; each output placed at its (ip, jq) when it
  //     falls in the group and tile, zero past the matrix's edge.  Where
  //     every ik of every ipp would waste more than the group needs (few ip
  //     a group, many ik: zamba2-7b's in_proj^T), one product a run of the
  //     group's ip within one ipp.  No barrier.
  auto build_l = [&](int ipg0, int ippa, int nipp) {
    const float* c = core(s - 1);
    const int d0 = a.dpre;
    const long row = (long)fi * fo * a.ds;
    for (int e = tid; e < a.lq * a.ds * a.njq; e += THREADS) {
      const int ip = ipg0 + e / (a.ds * a.njq), jq = e % a.njq;
      if (ip >= a.Ip || jpa + jq >= a.Jp) Lt[e] = 0.f;
    }
    const int ipg1 = min(ipg0 + a.lq, a.Ip);
    const int jlast = min(jpa + a.njq, a.Jp) - 1;
    const int jk0 = npq == 1 ? jpa % fo : 0, njk = npq == 1 ? jlast - jpa + 1 : fo;
    const bool v4 = a.ds % 4 == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0;
    const bool whole = nipp == 1 || nipp * fi <= 2 * (ipg1 - ipg0);
    // one product: P rows pp0 .. pp0 + npr (each with every jpp of the
    // tile), ik from ik0 (nik of them)
    auto product_l = [&](int pp0, int npr, int ik0, int nik) {
      const int rows = npr * npq, ncol = nik * njk * a.ds;
      const float* pb = Pb + pp0 * npq * d0;
      auto place = [&](int rw, int col, float v) {
        const int pp = pp0 + rw / npq, pq = rw % npq;
        const int ik = ik0 + col / (njk * a.ds), jk = jk0 + col / a.ds % njk, d = col % a.ds;
        const int ip = (ippa + pp) * fi + ik, jp = (jppa + pq) * fo + jk, jq = jp - jpa;
        if (ip >= ipg0 && ip < ipg1 && jq >= 0 && jq < a.njq && jp <= jlast)
          Lt[((ip - ipg0) * a.ds + d) * a.njq + jq] = v;
      };
      auto src_of = [&](int col) {   // the core column of output column col
        return c + ((long)(ik0 + col / (njk * a.ds)) * fo + jk0 + col / a.ds % njk) * a.ds +
               col % a.ds;
      };
      if (v4) {
        const int n4 = ncol / 4, nchunk = (rows + PQ - 1) / PQ, ntask = n4 * nchunk;
        const int RP = split_lanes(ntask), part_ = tid % RP;
        for (int t0 = 0; t0 < ntask; t0 += THREADS / RP) {
          const int task = t0 + tid / RP;
          const int c4 = task % n4, r0 = task / n4 * PQ;
          const int nr = task < ntask ? min(PQ, rows - r0) : 0;
          float acc[PQ][4];
#pragma unroll
          for (int k = 0; k < PQ; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
          if (nr > 0) {
            const float4* src = reinterpret_cast<const float4*>(src_of(4 * c4));
            // rows past the last read the last row's P (outputs dropped):
            // no branch in the loop, so its loads can be issued ahead
            const float* pr[PQ];
#pragma unroll
            for (int k = 0; k < PQ; ++k) pr[k] = pb + min(r0 + k, rows - 1) * d0;
#pragma unroll 8
            for (int r = part_; r < d0; r += RP) {
              const float4 cv = __ldg(src + r * (row / 4));
#pragma unroll
              for (int k = 0; k < PQ; ++k) {
                const float pv = pr[k][r];
                acc[k][0] = fmaf(pv, cv.x, acc[k][0]);
                acc[k][1] = fmaf(pv, cv.y, acc[k][1]);
                acc[k][2] = fmaf(pv, cv.z, acc[k][2]);
                acc[k][3] = fmaf(pv, cv.w, acc[k][3]);
              }
            }
          }
#pragma unroll
          for (int o = 1; o < RP; o *= 2)
#pragma unroll
            for (int k = 0; k < PQ; ++k)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], o);
          if (part_ == 0)
#pragma unroll
            for (int k = 0; k < PQ; ++k) {
              if (k >= nr) break;
#pragma unroll
              for (int e = 0; e < 4; ++e) place(r0 + k, 4 * c4 + e, acc[k][e]);
            }
        }
      } else {
        for (int e = tid; e < rows * ncol; e += THREADS) {
          const int rw = e / ncol, col = e % ncol;
          const float* u = pb + rw * d0;
          const float* src = src_of(col);
          float v = 0.f;
#pragma unroll 8
          for (int r = 0; r < d0; ++r) v = fmaf(u[r], __ldg(src + r * row), v);
          place(rw, col, v);
        }
      }
    };
    if (whole) {
      const int ik0 = nipp == 1 ? ipg0 % fi : 0;
      product_l(0, nipp, ik0, nipp == 1 ? ipg1 - ipg0 : fi);
    } else {
      for (int ip = ipg0; ip < ipg1;) {
        const int ik0 = ip % fi, nik = min(fi - ik0, ipg1 - ip);
        product_l(ip / fi - ippa, 1, ik0, nik);
        ip += nik;
      }
    }
  };

  // one f32 W value as its three bf16 terms at row kk, column cc of a slot
  auto put_w = [&](bf16* w3, int kk, int cc, float w) {
#pragma unroll
    for (int t = 0; t < NTERM; ++t) {
      const bf16 h = __float2bfloat16(w);
      w3[(t * BK + kk) * WPB + cc] = h;
      w -= __bfloat162float(h);
    }
  };

  // 3. stage st's W into a slot: W[kk][cc] = sum_d L[q][d][jq] R[d][js][is]
  //    for the stage's padded row kk = (q, is) and the tile's column cc =
  //    (jq, js)
  auto rebuild = [&](int st, bf16* w3, const float* Ls) {
    const int isoff = a.Isp <= BK ? 0 : st * BK % a.Isp;
    const int rstep = a.Jsp * a.Isp;
    if (a.fast) {
      // 4 is rows (one ip) x 2 jp columns (one js) a thread: 256 patches
      const int G = a.Isb / 4, U = G * a.Jsb, NJG = a.njq / 2;
      const int u = tid % U, v = tid / U;
      const int g = u % G, js = u / G;
      const int jg = v % NJG, q = v / NJG;
      const float* rp = Rs + js * a.Isp + isoff + 4 * g;
      const float* lp = Ls + q * a.ds * a.njq + 2 * jg;
      float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int d = 0; d < a.ds; ++d) {
        const float4 rv = *reinterpret_cast<const float4*>(rp + d * rstep);
        const float2 lv = *reinterpret_cast<const float2*>(lp + d * a.njq);
        const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(lv.x, rr[r], acc[r][0]);
          acc[r][1] = fmaf(lv.y, rr[r], acc[r][1]);
        }
      }
      const int kk0 = q * a.Isb + 4 * g;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) put_w(w3, kk0 + r, (2 * jg + c) * a.Jsb + js, acc[r][c]);
    } else {
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, cc = e % BN;
        const int q = kk / a.Isb, is = isoff + kk % a.Isb;
        const int jq = cc / a.Jsb, js = jsoff + cc % a.Jsb;
        const float* lp = Ls + q * a.ds * a.njq + jq;
        const float* rp = Rs + js * a.Isp + is;
        float w = 0.f;
#pragma unroll 4
        for (int d = 0; d < a.ds; ++d) w = fmaf(lp[d * a.njq], rp[d * rstep], w);
        put_w(w3, kk, cc, w);
      }
    }
  };

  float acc[MT][NT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  };

  // f(accumulator element, offset in [M, J]) for each of row tile rt's
  // elements inside the matrix (padded and ragged rows and columns masked)
  auto each_out = [&](int rt, auto f) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = wn * WTN + nt * 8 + 2 * (lane & 3) + e;
          const int jp = jpa + cc / a.Jsb, js = jsoff + cc % a.Jsb;
          if (jp >= a.Jp || js >= a.Js) continue;
          const long j = (long)jp * a.Js + js;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = rt * BM + wm * WTM + mt * 16 + (lane >> 2) + 8 * h;
            if (m < a.M) f(acc[mt][nt][2 * h + e], (long)m * a.J + j);
          }
        }
  };

  // 4. an x stage against a slot's three W terms: for each 16 rows of I and
  //    each n-tile, the six products into a zeroed f32 fragment, smallest
  //    first, and a rounded f32 add into the accumulator
  auto product = [&](int buf, const bf16* w3) {
    const float* xb = xs + buf * BM * XPF;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t b[NT / 2][NTERM][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
#pragma unroll
        for (int t = 0; t < NTERM; ++t)
          ldmatrix_x4_trans(b[np][t], w3 + (t * BK + krow) * WPB + wn * WTN + np * 16 +
                                          (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p0 = xb + (wm * WTM + mt * 16 + g) * XPF + kk + 2 * t4;
        const float* p1 = p0 + 8 * XPF;
        uint32_t af[NTERM][4];
        split3(*reinterpret_cast<const float2*>(p0), af[0][0], af[1][0], af[2][0]);
        split3(*reinterpret_cast<const float2*>(p1), af[0][1], af[1][1], af[2][1]);
        split3(*reinterpret_cast<const float2*>(p0 + 8), af[0][2], af[1][2], af[2][2]);
        split3(*reinterpret_cast<const float2*>(p1 + 8), af[0][3], af[1][3], af[2][3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int h = 2 * (nt & 1);
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          // x_t pairs with the W terms that keep the product >= 2^-24 of x0.w0
#pragma unroll
          for (int tx = NTERM - 1; tx >= 0; --tx)
#pragma unroll
            for (int tw = NTERM - 1 - tx; tw >= 0; --tw)
              mma_bf16(p, af[tx], b[nt / 2][tw][h], b[nt / 2][tw][h + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
      }
    }
  };

#ifdef MPO_NARROW_PROFILE
  long long prof[7] = {0, 0, 0, 0, 0, 0, 0};
  long long tprev = clock64();
#endif
  if (s == 1 && tid == 0) Pb[0] = 1.f;     // P = [1]: L is core 0 itself
  build_r();
  PROF_MARK(0);
  const bool keep = nrt == 1;    // one row tile: the accumulator stays in registers
  const int wslot = NTERM * BK * WPB;
  int ipg0 = -1, cur_ippa = -1, cur_npp = 0;
  zero_acc();
  for (int c0 = st0; c0 < st1; c0 += a.ch) {
    const int c1 = min(st1, c0 + a.ch), nch = c1 - c0, nt_ = nrt * nch;
    // the first two x stages of the chunk (the buffers are free: the last
    // chunk ended with a barrier, R's chain before it)
    for (int t = 0; t < 2; ++t) {
      if (t < nt_) load_x(rt0 + t / nch, c0 + t % nch, t);
      cp_async_commit();
    }
    // 2-3. the chunk's W, stage by stage into its slot
    for (int st = c0; st < c1; ++st) {
      const int ipa = a.Isp <= BK ? st * a.nq : st * BK / a.Isp;
      if (ipg0 < 0 || ipa < ipg0 || ipa >= ipg0 + a.lq) {
        // the L group of the stage's ip (groups of lq ip from 0)
        __syncthreads();             // the last rebuild is done with L and P
        ipg0 = ipa / a.lq * a.lq;
        const int ippa = ipg0 / fi;
        const int npp = (min(ipg0 + a.lq, a.Ip) - 1) / fi - ippa + 1;
        if (s > 1 && (ippa != cur_ippa || npp > cur_npp)) {
          build_p(ippa, npp);
          cur_ippa = ippa;
          cur_npp = npp;
        }
        PROF_MARK(1);
        build_l(ipg0, ippa, npp);
        __syncthreads();             // L
        PROF_MARK(2);
      }
      rebuild(st, Wt + (st - c0) * wslot, Lt + (ipa - ipg0) * a.ds * a.njq);
      PROF_MARK(3);
    }
    __syncthreads();                 // the chunk's W
    PROF_MARK(3);
    // 4. every row tile of the group through the chunk's stages
    for (int t = 0; t < nt_; ++t) {
      const int rt = rt0 + t / nch, sl = t % nch, buf = t % NXB;
      if (t + 2 < nt_) load_x(rt0 + (t + 2) / nch, c0 + (t + 2) % nch, (t + 2) % NXB);
      cp_async_commit();
      cp_async_wait<2>();            // this thread's copies of stage t
      if (!keep && sl == 0) {
        if (c0 == st0) zero_acc();
        else each_out(rt, [&](float& v, long o) { v = out[o]; });
      }
      __syncthreads();               // every thread's copies
      PROF_MARK(4);
      product(buf, Wt + sl * wslot);
      PROF_MARK(5);
      if (!keep && sl == nch - 1) each_out(rt, [&](float& v, long o) { out[o] = v; });
      __syncthreads();               // the buffer is free for stage t + 3
      PROF_MARK(6);
    }
  }
  if (keep) each_out(rt0, [&](float& v, long o) { out[o] = v; });
#ifdef MPO_NARROW_PROFILE
  PROF_MARK(6);
  if (tid == 0) {
    for (int k = 0; k < 7; ++k) atomicAdd(&g_prof[k], (unsigned long long)prof[k]);
    atomicAdd(&g_prof[7], 1ull);
  }
#endif
}

// y = (sum of the S partials, in split order); each matrix of the stack has
// its own [S, M, J] partials
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ part, float* __restrict__ y, long mj, int S, int E) {
  for (long i = blockIdx.x * (long)THREADS + threadIdx.x; i < E * mj;
       i += (long)gridDim.x * THREADS) {
    const long ex = i / mj, r = i % mj;
    float v = 0.f;
    for (int k = 0; k < S; ++k) v += part[(ex * S + k) * mj + r];
    y[i] = v;
  }
}

// Fills a from the core shapes and the launch (rows, splits, row tile, row
// tiles a group, stages a chunk, ip an L group); false when the kernel
// cannot take them.
bool make_args(Args& a, const void* const* cores, const int* shapes, int n, int split, int M,
               int S, int E, int bm, int rg, int ch, int lq) {
  if (n < 2 || n > MAXN || split < 1 || split >= n || S < 1 || E < 1 || M < 0) return false;
  if ((bm != 64 && bm != 128) || rg < 1 || ch < 1 || lq < 1) return false;
  a.n = n;
  a.s = split;
  long I = 1, J = 1;
  a.Is = a.Js = 1;
  a.dmax = 1;
  for (int k = 0; k < n; ++k) {
    a.core[k] = cores ? static_cast<const float*>(cores[k]) : nullptr;
    a.bond[k] = shapes[4 * k];
    a.fin[k] = shapes[4 * k + 1];
    a.fout[k] = shapes[4 * k + 2];
    if (a.bond[k] < 1 || a.fin[k] < 1 || a.fout[k] < 1) return false;
    if (k > 0 && shapes[4 * (k - 1) + 3] != a.bond[k]) return false;
    a.cstride[k] = (long)shapes[4 * k] * a.fin[k] * a.fout[k] * shapes[4 * k + 3];
    I *= a.fin[k];
    J *= a.fout[k];
    if (k >= split) {
      a.Is *= a.fin[k];
      a.Js *= a.fout[k];
    }
    a.dmax = a.bond[k] > a.dmax ? a.bond[k] : a.dmax;
  }
  a.bond[n] = shapes[4 * (n - 1) + 3];
  if (a.bond[0] != 1 || a.bond[n] != 1 || I > (1L << 30) || J > (1L << 30)) return false;
  a.I = (int)I;
  a.J = (int)J;
  a.Ip = a.I / a.Is;
  a.Jp = a.J / a.Js;
  a.M = M;
  a.E = E;
  a.ds = a.bond[split];
  a.dpre = split == 1 ? 1 : a.bond[split - 1];
  for (int k = n - 1, pi = 1, po = 1; k >= 0; --k) {
    if (k == split - 1) pi = po = 1;
    a.sin[k] = pi;
    a.sout[k] = po;
    pi *= a.fin[k];
    po *= a.fout[k];
  }
  a.Isp = a.Is <= BK ? pow2ceil(a.Is) : (a.Is + BK - 1) / BK * BK;
  a.Jsp = a.Js <= BN ? pow2ceil(a.Js) : (a.Js + BN - 1) / BN * BN;
  a.Isb = a.Isp < BK ? a.Isp : BK;
  a.Jsb = a.Jsp < BN ? a.Jsp : BN;
  a.nq = BK / a.Isb;
  a.njq = BN / a.Jsb;
  const int fi = a.fin[split - 1], fo = a.fout[split - 1];
  if (lq % a.nq) return false;
  a.lq = lq;
  a.npp = split == 1 ? 1 : (lq < (lq - 1) / fi + 2 ? lq : (lq - 1) / fi + 2);
  a.npq = split == 1 ? 1 : (a.njq < (a.njq - 1) / fo + 2 ? a.njq : (a.njq - 1) / fo + 2);
  // R's chain buffers (2 * pc * dmax floats) in the x and W region
  const long room = (long)(smem_x(bm) + smem_w(ch)) / (2 * sizeof(float) * a.dmax);
  const int pc = 4096 / a.dmax < 32 ? 32 : 4096 / a.dmax > 256 ? 256 : 4096 / a.dmax;
  a.pc = pc < room ? pc : (int)room;
  if (a.pc < 1) return false;
  const long rows = (long)a.Ip * a.Isp, cols = (long)a.Jp * a.Jsp;
  if (rows > (1L << 30) || cols > (1L << 30)) return false;
  a.nst = (int)((rows + BK - 1) / BK);
  a.jtiles = (int)((cols + BN - 1) / BN);
  a.per = (a.nst + S - 1) / S;
  a.S = S;
  a.rg = rg;
  a.ch = ch;
  a.vec = a.Isp == a.Is && a.I % 4 == 0;
  a.fast = a.Isp % 4 == 0 && a.njq % 2 == 0;
  return (a.nst + a.per - 1) / a.per == S;
}

template <int BM>
int launch_main(const Args& a, const float* x, float* y, float* part, cudaStream_t st) {
  const size_t smem = fwd_smem(a, BM, a.ch);
  cudaError_t err = repro::allow_smem(fwd_kernel<BM>, smem);
  if (err != cudaSuccess) return (int)err;
  const long groups = ((long)(a.M + BM - 1) / BM + a.rg - 1) / a.rg;
  const long zdim = (long)a.E * groups;              // matrices x row groups
  if (zdim > 65535 || a.S > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(a.jtiles, a.S, (unsigned)zdim);
  fwd_kernel<BM><<<grid, THREADS, smem, st>>>(a, x, y, part);
  return (int)cudaGetLastError();
}

long workspace_bytes(const Args& a) {
  return a.S > 1 ? (long)sizeof(float) * a.E * a.S * a.M * a.J : 0;
}

}  // namespace

#ifdef MPO_NARROW_PROFILE
// the phase cycles summed over blocks since the last read (8 counters: R, P,
// L, rebuild, x wait, product, partial sums and epilogue, blocks), then
// zeroed
extern "C" int mpo_linear_fwd_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

// Dynamic shared memory of one block at bm (64 or 128) rows, ch stages of
// resident W and lq ip an L group, in bytes (the same for any rows and any
// stack), or -1 for arguments the launcher refuses.
extern "C" long mpo_linear_fwd_smem(const int* shapes, int n, int split, int bm, int ch,
                                    int lq) {
  Args a;
  if (!make_args(a, nullptr, shapes, n, split, 1, 1, 1, bm, 1, ch, lq)) return -1;
  return (long)fwd_smem(a, bm, ch);
}

// Bytes of workspace one call over a stack of E matrices at M rows and S
// splits takes: each matrix's [S, M, J] f32 partials when S > 1, else none.
extern "C" long mpo_linear_fwd_workspace(const int* shapes, int n, int split, int M, int S,
                                         int E) {
  Args a;
  if (!make_args(a, nullptr, shapes, n, split, M, S, E, 64, 1, 1, BK)) return -1;
  return workspace_bytes(a);
}

// cores: n device pointers; shapes: n * 4 ints (d0, i, j, d1) per core of
// one matrix; E matrices stacked (each core E contiguous blocks of its
// shape, x [E, M, I], y [E, M, J]; E = 1 for one matrix).  bm: 64 or 128
// rows an output tile; rg: row tiles a block; ch: stages of resident W; lq:
// ip an L group (a multiple of the ip a stage); S: splits of I; ws: the
// workspace (S > 1).  x, cores and y float32.  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int mpo_linear_fwd(const void* const* cores, const int* shapes, int n, int split,
                              int bm, int rg, int ch, int lq, int S, const void* x, void* y,
                              int M, int E, void* ws, void* stream) {
  Args a;
  if (!make_args(a, cores, shapes, n, split, M, S, E, bm, rg, ch, lq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* part = static_cast<float*>(ws);
  const int rc = bm == 128 ? launch_main<128>(a, xf, yf, part, st)
                           : launch_main<64>(a, xf, yf, part, st);
  if (rc || a.S == 1) return rc;
  const long mj = (long)a.M * a.J;
  const long want = (a.E * mj + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 4096 ? want : 4096);
  reduce_kernel<<<blocks, THREADS, 0, st>>>(part, yf, mj, a.S, a.E);
  return (int)cudaGetLastError();
}
