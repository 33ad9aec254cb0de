// MPO-linear cores backward for Hopper: the gradient of sum(dy * (x @ W(cores)))
// with respect to every core, where dW = x^T dy and W are never written to
// device memory.
//
// Replaces the Pallas TPU kernel repro/kernels/mpo_linear.py:_bwd_cores_call /
// _bwd_cores_kernel.  That kernel walks a sequential (i1, j1, M/bm) grid: each
// step forms one (I/i1, J/j1) tile of dW in VMEM, pulls it back through the
// tile rebuild with jax.vjp, and adds the result into core-shaped outputs that
// every step revisits.  Hopper blocks run in no order, and a sum that every
// block writes needs atomics, whose order (and so whose rounding) changes from
// run to run.  Nothing here uses atomics: two runs give the same bits.
//
// Function.  The chain is split at a bond s (kernels/mpo_linear.py:_bwd_plan),
//     W[ip, is, jp, js] = sum_d L[ip, jp, d] * R[d, is, js],
// with (ip, jp) the digits of cores [0, s) and (is, js) those of [s, n).  Then
//     dL[ip, jp, d] = sum_{is, js} dW[ip, is, jp, js] R[d, is, js]
//     dR[d, is, js] = sum_{ip, jp} L[ip, jp, d] dW[ip, is, jp, js],
// and the core gradients follow from dL and dR through the prefix and suffix
// chains.  Every sum is in f32; each gradient is rounded to the cores' dtype
// once.  The products x^T dy run on the tensor cores from bf16 terms whose
// products are exact in f32: bfloat16 x and dy as they are; float32 x and dy
// each as three bf16 terms, the six products that keep ~24 bits (the split of
// the forward, csrc/mpo_linear_mma.cu).  So the arithmetic is the plain
// version's (an f32 dW pulled back in f32), summed in another order.
//
// Design: three launches a call, on the caller's stream.
//   1. chains (run_jobs, one cooperative launch): phi_k, the prefix chain
//      vectors, once per distinct prefix of digit pairs (phi_s = L), and
//      rho_k, the suffix vectors, once per distinct suffix (rho_s = R);
//      phi_1 and rho_{n-1} are cores 0 and n-1 themselves.  Chain vectors
//      and cotangents are rows numbered by the digit pairs (i_k, j_k), the
//      first most significant, so the rows sharing a prefix are contiguous
//      and each step is a small batched product.
//   2. tiles (tile_kernel, thread-block clusters of up to 8): each block of
//      a grid of at most the SM count walks a fixed set of TR x TC tiles of
//      dW, each whole (Is x Js) sub-tiles of its (ip, jp) pairs.  A tile is
//      x^T dy over all M rows: bf16 stages of 64 rows of x and dy land in
//      shared memory by cp.async, a ring of four (float32: 32 rows, two, each
//      split into its three bf16 terms once landed); both operands are loaded
//      by ldmatrix.trans (the sum runs over M, the rows of both) into
//      mma.sync.m16n8k16, 8 warps each 32 rows by TC / (256 / TR) columns.
//      The tile is then stored pair-major in shared memory only and pulled
//      back there on the CUDA cores in f32: dL = G . R^T for its pairs
//      (written once: no other tile holds them), and its share of
//      dR = sum_p L_p G_p into 64 registers a thread, carried over the
//      block's walk.  At the end the blocks of a cluster sum their shares
//      through distributed shared memory in rank order, each rank a slice,
//      and write one partial a cluster.
//   3. epilogue (run_jobs, one cooperative launch, a grid barrier between
//      steps): dR = the partials summed in cluster order, then, one core a
//      step from the split outwards, the prefix pullback dC_k = phi_k^T .
//      mu_{k+1}, mu_k = mu_{k+1} . C_k^T (mu_s = dL; mu_1 is dC_0), and the
//      suffix pullback dC_k = sum lam_k x rho_{k+1}, lam_{k+1} = lam_k . C_k
//      (lam_s = dR).  Sums longer than 256 run as slices in parallel, summed
//      in slice order the step after.
//   The jobs (shapes, strides, workspace offsets, steps) and the maps from
//   (ip, jp) and (is, js) to rows are built in Python (_bwd_jobs, _bwd_maps)
//   and passed in one int32 device array; the CPU tests replay the same jobs.
//
// A stack of matrices of one shape (a MoE layer's experts: cores, x, dy and
// the gradients back to back, expert after expert) runs in the same three
// launches.  The plan, jobs and maps are the one matrix's; each expert has
// its own scratch, one matrix's workspace at a stride.  The job runner walks
// every job tile of a step for each expert in turn (the expert's cores,
// gradients and scratch offset by its stride); the tile pass runs the one
// matrix's grid once an expert (blocks e * nb .. e * nb + nb - 1, whole
// clusters), so every expert's tiles, cluster sums and epilogue are those of
// its matrix run alone: the same bits.  Where the stack's scratch would pass
// the caller's budget, the experts run in groups, one launch set a group,
// each reusing the scratch (kernels/mpo_linear.py:_bwd_group).
//
// What bounds it.  The work it must do is x^T dy, 2 * M * I * J operations on
// the tensor cores (six products in float32), and the pullback, 4 * d_s * I *
// J on the CUDA cores.  Measured on an H100 (PERF.md): at bert-base's matrices
// at 2048 rows the tile pass runs x^T dy at about a tenth of the bf16
// tensor-core rate (one 256-thread block an SM, R and the stages taking most
// of the shared memory, every stage behind a barrier) and the pullback adds
// about half again; the two job launches are bound by latency, a few
// microseconds a step of small products and a grid barrier, not by their
// operations.  The next steps are
// the pullback on the tensor cores (G, R and L as split bf16 terms) and wgmma
// with warp-specialised loads.  The scratch is the chain vectors and
// cotangents (L and dL the largest) and one dR partial a cluster: below an f32
// dW at bert-base's matrices.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

constexpr int MAXN = 8;
constexpr int THREADS = 256;
constexpr int RMAX = 16384;                  // d_s * Is * Js
constexpr int RTASK = RMAX / 16 / THREADS;   // 4 x 4 dR values a task: 4 tasks a thread
constexpr int MAXCLUSTER = 8;
// rows of M a stage and stages in flight: bf16 64 rows, four stages (three
// in flight hide the L2 latency); float32 32 rows, two (its f32 stages and
// bf16 terms take twice the room, and six products a stage hide more)
template <typename T>
constexpr int kBK = sizeof(T) == 4 ? 32 : 64;
template <typename T>
constexpr int kStages = sizeof(T) == 4 ? 2 : 4;

// ---------------------------------------------------------------------------
// the job runner: out[z, m, n] = sum_{k1, k2} A[z, m, k1, k2] * B[z, k1, k2, n]
// ---------------------------------------------------------------------------

constexpr int WS = -2;             // operand sources: core k >= 0, WS, or -1: the value 1

// must match kernels/mpo_linear.py:JOB_FIELDS
struct Job {
  int step, M, N, K1, K2, Z;
  int a_src, a_off, a_sz, a_sm, a_s1, a_s2;
  int b_src, b_off, b_sz, b_s1, b_s2, b_sn;
  int c_dst, c_off, c_sz, c_sm, c_sn;
};
constexpr int JOB_INTS = 23;
constexpr int MAXJOBS = 64;        // jobs a launch (kernels/mpo_linear.py:BWD_MAXJOBS)
static_assert(sizeof(Job) == JOB_INTS * sizeof(int), "Job is 23 ints");

struct Cores {
  const void* in[MAXN];
  void* out[MAXN];
  long size[MAXN];  // elements of one matrix's core k: the stride between experts
};

// the cores and gradients of expert e of a stack
template <typename T>
__device__ __forceinline__ Cores expert_cores(const Cores& cs, int e) {
  Cores ce;
#pragma unroll
  for (int k = 0; k < MAXN; ++k) {
    ce.in[k] = cs.in[k] ? static_cast<const T*>(cs.in[k]) + e * cs.size[k] : nullptr;
    ce.out[k] = cs.out[k] ? static_cast<T*>(cs.out[k]) + e * cs.size[k] : nullptr;
    ce.size[k] = cs.size[k];
  }
  return ce;
}

// Output tiles: a job of one column (N = 1: a sum of slices or of the
// cluster partials) takes THREADS rows a tile, one a thread; a job of at
// least 64 x 64 outputs 64 x 64 tiles, 4 x 4 a thread (k chunks of 64);
// any other 32 x 32, 2 x 2 a thread (k chunks of 128).
template <int TM>
constexpr int kChunk = TM == 32 ? 128 : 64;
template <int TM>
constexpr int kPitch = TM + 1;  // shared-memory row pitch, floats: no bank conflict either way
constexpr int JOB_SMEM = 2 * 128 * 33 > 2 * 64 * 65 ? 2 * 128 * 33 : 2 * 64 * 65;  // floats

__device__ __forceinline__ int job_edge(const Job& j) { return j.M >= 64 && j.N >= 64 ? 64 : 32; }

__device__ __forceinline__ int job_tiles(const Job& j) {
  if (j.N == 1) return j.Z * ((j.M + THREADS - 1) / THREADS);
  const int e = job_edge(j);
  return j.Z * ((j.M + e - 1) / e) * ((j.N + e - 1) / e);
}

// f32 from raw bits: f32 as they are, bf16 in the low 16 bits
__device__ __forceinline__ float as_float(uint32_t raw, bool bf16) {
  return __uint_as_float(bf16 ? raw << 16 : raw);
}

// One tile of a one-column job: row m0 + threadIdx.x sums its K products in
// order, operands loaded straight from memory (K is a few slices or
// clusters).
template <typename T>
__device__ __forceinline__ void job_column(const Job j, int t, const Cores& cs, float* ws) {
  const int tm = (j.M + THREADS - 1) / THREADS;
  const int z = t / tm, m = t % tm * THREADS + threadIdx.x;
  if (m >= j.M) return;
  const int K = j.K1 * j.K2;
  const long a0 = j.a_off + (long)z * j.a_sz + (long)m * j.a_sm;
  const long b0 = j.b_off + (long)z * j.b_sz;
  const float* aw = j.a_src == WS ? ws + a0 : nullptr;
  const T* ac = j.a_src >= 0 ? static_cast<const T*>(cs.in[j.a_src]) + a0 : nullptr;
  const float* bw = j.b_src == WS ? ws + b0 : nullptr;
  const T* bc = j.b_src >= 0 ? static_cast<const T*>(cs.in[j.b_src]) + b0 : nullptr;
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const long ao = (long)(k / j.K2) * j.a_s1 + (long)(k % j.K2) * j.a_s2;
    const long bo = (long)(k / j.K2) * j.b_s1 + (long)(k % j.K2) * j.b_s2;
    const float va = aw ? aw[ao] : ac ? repro::ld(ac, ao) : 1.f;
    const float vb = bw ? bw[bo] : bc ? repro::ld(bc, bo) : 1.f;
    acc = fmaf(va, vb, acc);
  }
  const long i = j.c_off + (long)z * j.c_sz + (long)m * j.c_sm;
  if (j.c_dst >= 0) repro::st(static_cast<T*>(cs.out[j.c_dst]), i, acc);
  else ws[i] = acc;
}

// One TM x TM output tile of job j.  K runs in chunks staged in shared
// memory (A k-major as As[k][m], B as Bs[k][n]); the next chunk's operands
// are loaded into registers while this one is summed, so a long K pays the
// loads' latency about once a chunk.  Each thread sums R x R outputs over
// k = 0..K-1 in order.
template <typename T, int TM>
__device__ __forceinline__ void job_tile(const Job j, int t, const Cores& cs, float* ws,
                                         float* sm) {
  constexpr int KC = kChunk<TM>, P = kPitch<TM>, R = TM / 16;
  constexpr int PER = TM * KC / THREADS;   // operand values a thread stages a chunk
  float* As = sm;
  float* Bs = sm + KC * P;
  const int tm = (j.M + TM - 1) / TM, tn = (j.N + TM - 1) / TM;
  const int z = t / (tm * tn), r = t % (tm * tn);
  const int m0 = r / tn * TM, n0 = r % tn * TM;
  const int K = j.K1 * j.K2;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // rows m0 + row(u), columns n0 + col(v), 16 apart (a warp's loads of As
  // are two broadcasts, of Bs 16 banks)
  auto row = [&](int u) { return ty + 16 * u; };
  auto col = [&](int v) { return tx + 16 * v; };
  const bool afast = j.a_sm == 1;          // lanes along m where A is contiguous in m
  const bool bfast = j.b_sn == 1;
  // an operand is f32 (the workspace, or a float32 core), bf16 (a bfloat16
  // core) or the value 1; its raw bits are loaded (0 past an edge) and
  // converted at the shared-memory store, after the whole chunk has arrived:
  // converting each value as it lands would wait for each load in turn
  constexpr uint32_t ONE = 0x3f800000u;  // 1.0f
  auto kind = [&](int src) { return src == WS || (src >= 0 && sizeof(T) == 4) ? 0 : src >= 0 ? 2 : 1; };
  auto base = [&](int src, int off, int sz) -> const void* {
    if (src == WS) return ws + off + (long)z * sz;
    if (src >= 0) return static_cast<const T*>(cs.in[src]) + off + (long)z * sz;
    return nullptr;
  };
  const int ak_ = kind(j.a_src), bk_ = kind(j.b_src);
  const void* ab = base(j.a_src, j.a_off, j.a_sz);
  const void* bb = base(j.b_src, j.b_off, j.b_sz);
  uint32_t ra[PER], rb[PER];
  uint32_t amask, bmask;  // bit i: value i of this thread's chunk lies inside the operand
  // this thread's values of a chunk: element i at (row, k) = (r + i dr, k + i dk),
  // one of the two steps 0 (THREADS is a multiple of TM and of KC); k splits as
  // k1 * K2 + k2, carried along without a division an element.  Offsets
  // first (an element past an edge reads the operand's first value), then
  // the loads, none of them behind a branch
  auto fetch_one = [&](uint32_t (&out)[PER], uint32_t& mask, const void* p, int knd, bool fast,
                       int rows, int row0, int srow, int s1, int s2, int k0) {
    int r = row0 + (fast ? tid % TM : tid / KC);
    int k = k0 + (fast ? tid / TM : tid % KC);
    const int dr = fast ? 0 : THREADS / KC, dk = fast ? THREADS / TM : 0;
    int k1 = k / j.K2, k2 = k % j.K2;
    int off[PER];
    mask = 0u;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const bool ok = r < rows && k < K;
      mask |= (uint32_t)ok << i;
      off[i] = ok ? r * srow + k1 * s1 + k2 * s2 : 0;
      r += dr;
      k += dk;
      if (j.K2 == 1) {
        k1 += dk;
      } else {
        for (k2 += dk; k2 >= j.K2; k2 -= j.K2) ++k1;
      }
    }
    if (knd == 0) {
#pragma unroll
      for (int i = 0; i < PER; ++i) out[i] = static_cast<const uint32_t*>(p)[off[i]];
    } else if (knd == 2) {
#pragma unroll
      for (int i = 0; i < PER; ++i) out[i] = static_cast<const unsigned short*>(p)[off[i]];
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) out[i] = ONE;
    }
  };
  auto fetch = [&](int k0) {
    fetch_one(ra, amask, ab, ak_, afast, j.M, m0, j.a_sm, j.a_s1, j.a_s2, k0);
    fetch_one(rb, bmask, bb, bk_, bfast, j.N, n0, j.b_sn, j.b_s1, j.b_s2, k0);
  };
  const bool abf = ak_ == 2, bbf = bk_ == 2;
  float acc[R][R];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int v = 0; v < R; ++v) acc[u][v] = 0.f;
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // every thread is done with the last chunk
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      As[(afast ? e / TM : e % KC) * P + (afast ? e % TM : e / KC)] =
          amask >> i & 1u ? as_float(ra[i], abf) : 0.f;
      Bs[(bfast ? e / TM : e % KC) * P + (bfast ? e % TM : e / KC)] =
          bmask >> i & 1u ? as_float(rb[i], bbf) : 0.f;
    }
    __syncthreads();
    if (k0 + KC < K) fetch(k0 + KC);
    const int kn = min(KC, K - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float av[R], bv[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        av[u] = As[kk * P + row(u)];
        bv[u] = Bs[kk * P + col(u)];
      }
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int v = 0; v < R; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
  }
  T* cc = j.c_dst >= 0 ? static_cast<T*>(cs.out[j.c_dst]) : nullptr;
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int v = 0; v < R; ++v) {
      const int m = m0 + row(u), nn = n0 + col(v);
      if (m >= j.M || nn >= j.N) continue;
      const long i = j.c_off + (long)z * j.c_sz + (long)m * j.c_sm + (long)nn * j.c_sn;
      if (cc) repro::st(cc, i, acc[u][v]);
      else ws[i] = acc[u][v];
    }
}

// Steps 0..nsteps-1 of the jobs, a grid barrier between steps (a cooperative
// launch); within a step, the tiles of its jobs in job order for each of the
// stack's experts in turn (expert e's cores, gradients and scratch at e
// strides), block b taking tiles b, b + gridDim.x, ...
template <typename T>
__global__ void __launch_bounds__(THREADS)
run_jobs(const Job* __restrict__ jobs_g, int njobs, int nsteps, Cores cs, float* ws,
         int experts, long wstride) {
  __shared__ __align__(16) float sm[JOB_SMEM];
  __shared__ Job jobs[MAXJOBS];
  cg::grid_group grid = cg::this_grid();
  // the job table, read once: every tile's lookup then stays on chip
  for (int e = threadIdx.x; e < njobs * JOB_INTS; e += THREADS)
    reinterpret_cast<int*>(jobs)[e] = reinterpret_cast<const int*>(jobs_g)[e];
  __syncthreads();
  for (int step = 0; step < nsteps; ++step) {
    int per = 0;
    for (int q = 0; q < njobs; ++q)
      if (jobs[q].step == step) per += job_tiles(jobs[q]);
    for (int g = blockIdx.x; g < per * experts; g += gridDim.x) {
      const int e = g / per, r = g % per;
      int q = 0, base = 0;
      for (;; ++q) {
        if (jobs[q].step != step) continue;
        const int nt = job_tiles(jobs[q]);
        if (r < base + nt) break;
        base += nt;
      }
      const Job jb = jobs[q];
      const Cores ce = expert_cores<T>(cs, e);
      float* we = ws + e * wstride;
      if (jb.N == 1) job_column<T>(jb, r - base, ce, we);
      else if (job_edge(jb) == 64) job_tile<T, 64>(jb, r - base, ce, we, sm);
      else job_tile<T, 32>(jb, r - base, ce, we, sm);
    }
    if (step + 1 < nsteps) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// the tile pass
// ---------------------------------------------------------------------------

struct TileArgs {
  int I, J, M, Is, Js, Ip, Jp, ds, Q;
  int PI, PJ, npair, tiles_j, ntiles;
  int nb;          // blocks an expert: block b of the grid works for expert b / nb
  long wstride;    // floats of scratch an expert (L, R, dL and the partials below)
  int need_dl, need_dr;
  int vec;         // x and dy rows in whole 16-byte chunks: cp.async, else element loads
  const int* pmi;  // L / dL row of (ip, jp): pmi[ip] + pmj[jp]
  const int* pmj;
  const int* qmi;  // R / dR row of (is, js): qmi[is] + qmj[js]
  const int* qmj;
  const float* L;  // [Ip * Jp][ds]
  const float* R;  // [Q][ds]
  float* dL;       // [Ip * Jp][ds]
  float* part;     // [clusters][Q * ds]
};

__host__ __device__ inline int r4(int n) { return (n + 3) / 4 * 4; }

// Shared memory (bytes) of tile_kernel; kernels/mpo_linear.py:_bwd_smem_bytes
// computes the same: R [Q][ds], the tile's L rows [npair][ds], the is / js
// maps, then one region for the stages (bf16: the operands; float32: the f32
// stages, then the three bf16 terms of one stage), the pair-major dW tile
// [npair][Q + 4], and at the end the block's dR share [Q][ds].
template <typename T>
size_t tile_smem(int Q, int ds, int Is, int Js, int TR, int TC) {
  const size_t npair = (size_t)(TR / Is) * (TC / Js);
  const size_t ns = kStages<T>, bk = kBK<T>;
  const size_t stages = sizeof(T) == 2 ? ns * bk * (TR + 8 + TC + 8) * 2
                                       : ns * bk * (TR + 4 + TC + 4) * 4 +
                                             3 * bk * (size_t)(TR + 8 + TC + 8) * 2;
  size_t un = stages;
  un = un > 4 * npair * (Q + 4) ? un : 4 * npair * (Q + 4);
  un = un > 4 * (size_t)Q * ds ? un : 4 * (size_t)Q * ds;
  return 4 * (size_t)Q * ds + 4 * npair * ds + 4 * (size_t)r4(Is + Js) + un;
}

template <typename T, int TR, int TC>
__global__ void __launch_bounds__(THREADS, 1)
tile_kernel(TileArgs a, const T* __restrict__ x, const T* __restrict__ dy) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NS = kStages<T>, BK = kBK<T>;
  constexpr int CH = 16 / sizeof(T);            // elements a 16-byte chunk
  constexpr int XR = TR + CH, YR = TC + CH;     // stage pitches, elements
  constexpr int XP = TR + 8, YP = TC + 8;       // bf16 term pitches (float32)
  constexpr int WARPS_M = TR / 32, WARPS_N = 8 / WARPS_M;
  constexpr int WTN = TC / WARPS_N;             // a warp's columns
  constexpr int MT = 2, NT = WTN / 8;
  static_assert(NT % 2 == 0, "dy fragments are loaded two n-tiles at a time");

  extern __shared__ __align__(16) unsigned char smem[];
  // a stack of experts: this block's expert, its place among the expert's
  // blocks, and the expert's operands and scratch
  const int ex = blockIdx.x / a.nb, bx = blockIdx.x % a.nb;
  x += (long)ex * a.M * a.I;
  dy += (long)ex * a.M * a.J;
  a.L += ex * a.wstride;
  a.R += ex * a.wstride;
  a.dL += ex * a.wstride;
  a.part += ex * a.wstride;
  const int Q = a.Q, ds = a.ds, npair = a.npair, QP = Q + 4, dq = ds / 4;
  float* Rs = reinterpret_cast<float*>(smem);
  float* Ls = Rs + Q * ds;
  int* qm = reinterpret_cast<int*>(Ls + npair * ds);  // qmi [Is], then qmj [Js]
  unsigned char* un = reinterpret_cast<unsigned char*>(qm + r4(a.Is + a.Js));
  T* xr = reinterpret_cast<T*>(un);                    // [NS][BK][XR]
  T* yr = xr + NS * BK * XR;                           // [NS][BK][YR]
  bf16* xt = reinterpret_cast<bf16*>(yr + NS * BK * YR);  // float32: [3][BK][XP]
  bf16* yt = xt + 3 * BK * XP;                         // float32: [3][BK][YP]
  float* Gp = reinterpret_cast<float*>(un);            // [npair][QP]
  float* Rp = reinterpret_cast<float*>(un);            // [Q][ds], after the walk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  for (int e = tid; e < Q * ds / 4; e += THREADS) cp_async16(Rs + 4 * e, a.R + 4 * e, 16);
  cp_async_commit();
  for (int e = tid; e < a.Is; e += THREADS) qm[e] = a.qmi[e];
  for (int e = tid; e < a.Js; e += THREADS) qm[a.Is + e] = a.qmj[e];

  float racc[RTASK][4][4];
#pragma unroll
  for (int j = 0; j < RTASK; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) racc[j][u][w] = 0.f;
  const int nst = (a.M + BK - 1) / BK;

  for (int t = bx; t < a.ntiles; t += a.nb) {
    const int ip0 = t / a.tiles_j * a.PI, jp0 = t % a.tiles_j * a.PJ;
    const int r0 = ip0 * a.Is, c0 = jp0 * a.Js;
    if (a.need_dr) {  // L rows of the tile's pairs, zero past the matrix's edge
      for (int e = tid; e < npair * dq; e += THREADS) {
        const int pl = e / dq, d4 = e % dq;
        const int ip = ip0 + pl / a.PJ, jp = jp0 + pl % a.PJ;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ip < a.Ip && jp < a.Jp)
          v = *reinterpret_cast<const float4*>(a.L + (long)(a.pmi[ip] + a.pmj[jp]) * ds + 4 * d4);
        reinterpret_cast<float4*>(Ls)[e] = v;
      }
    }

    // stage st of x [BK rows][TR columns of I] and dy [BK][TC of J] into
    // buffer buf; rows past M and columns past I / J land as zeros.  With I
    // and J in whole 16-byte chunks, cp.async (a chunk is all in or all out);
    // else element loads, done when the next barrier is passed
    auto load = [&](int st, int buf) {
      const int m0 = st * BK;
      T* xd = xr + buf * BK * XR;
      T* yd = yr + buf * BK * YR;
      if (a.vec) {
        for (int e = tid; e < BK * (TR / CH); e += THREADS) {
          const int r = e / (TR / CH), ch = e % (TR / CH);
          const int m = m0 + r, col = r0 + ch * CH;
          const bool ok = m < a.M && col < a.I;
          cp_async16(xd + r * XR + ch * CH, ok ? x + (long)m * a.I + col : x, ok ? 16 : 0);
        }
        for (int e = tid; e < BK * (TC / CH); e += THREADS) {
          const int r = e / (TC / CH), ch = e % (TC / CH);
          const int m = m0 + r, col = c0 + ch * CH;
          const bool ok = m < a.M && col < a.J;
          cp_async16(yd + r * YR + ch * CH, ok ? dy + (long)m * a.J + col : dy, ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < BK * TR; e += THREADS) {
          const int r = e / TR, cc = e % TR, m = m0 + r, col = r0 + cc;
          repro::st(xd, r * XR + cc, m < a.M && col < a.I ? repro::ld(x, (long)m * a.I + col) : 0.f);
        }
        for (int e = tid; e < BK * TC; e += THREADS) {
          const int r = e / TC, cc = e % TC, m = m0 + r, col = c0 + cc;
          repro::st(yd, r * YR + cc, m < a.M && col < a.J ? repro::ld(dy, (long)m * a.J + col) : 0.f);
        }
      }
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    // acc += (x stage)^T . (dy stage): A = x^T from the [k][m] stage and B =
    // dy from the [k][n] stage, both by ldmatrix.trans
    auto product = [&](const bf16* xb, int xp, const bf16* yb, int yp) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4_trans(af[mt], xb + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * xp +
                                        wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8);
        const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, yb + krow * yp + wn * WTN + nt * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][nt], af[mt], b[0], b[1]);
            mma_bf16(acc[mt][nt + 1], af[mt], b[2], b[3]);
          }
        }
      }
    };

    // float32: the landed stage into three bf16 terms each
    auto split = [&](int buf) {
      const float* xs = reinterpret_cast<const float*>(xr + buf * BK * XR);
      const float* ys = reinterpret_cast<const float*>(yr + buf * BK * YR);
      for (int e = tid; e < BK * TR / 4; e += THREADS) {
        const int r = e / (TR / 4), c4 = e % (TR / 4);
        repro::split_terms4<3>(*reinterpret_cast<const float4*>(xs + r * XR + 4 * c4),
                               xt + r * XP + 4 * c4, BK * XP);
      }
      for (int e = tid; e < BK * TC / 4; e += THREADS) {
        const int r = e / (TC / 4), c4 = e % (TC / 4);
        repro::split_terms4<3>(*reinterpret_cast<const float4*>(ys + r * YR + 4 * c4),
                               yt + r * YP + 4 * c4, BK * YP);
      }
    };

#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < nst) load(s, s);
      cp_async_commit();
    }
    for (int st = 0; st < nst; ++st) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // stage st has landed, and every warp is done with stage st - 1
      if (st + NS - 1 < nst) load(st + NS - 1, (st + NS - 1) % NS);
      cp_async_commit();
      const int buf = st % NS;
      if constexpr (F32) {
        split(buf);
        __syncthreads();
        // x_t . dy_u for t + u <= 2, smallest first
#pragma unroll
        for (int tx = 2; tx >= 0; --tx)
#pragma unroll
          for (int ty = 2 - tx; ty >= 0; --ty)
            product(xt + tx * BK * XP, XP, yt + ty * BK * YP, YP);
      } else {
        product(reinterpret_cast<const bf16*>(xr + buf * BK * XR), XR,
                reinterpret_cast<const bf16*>(yr + buf * BK * YR), YR);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the dW tile, pair-major: G[p][q], p = (ip - ip0) * PJ + (jp - jp0),
    // q the R row of (is, js)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = wm * 32 + mt * 16 + (lane >> 2) + 8 * h;
            const int c = wn * WTN + nt * 8 + 2 * (lane & 3) + e;
            const int pl = r / a.Is * a.PJ + c / a.Js;
            Gp[pl * QP + qm[r % a.Is] + qm[a.Is + c % a.Js]] = acc[mt][nt][2 * h + e];
          }
    __syncthreads();

    // dL[p][d] = sum_q G[p][q] R[q][d], two pairs x four d a task
    if (a.need_dl) {
      for (int task = tid; task < npair / 2 * dq; task += THREADS) {
        const int p0 = task / dq * 2, d0 = task % dq * 4;
        const float* g0 = Gp + p0 * QP;
        float v[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int q = 0; q < Q; q += 4) {
          const float4 ga = *reinterpret_cast<const float4*>(g0 + q);
          const float4 gb = *reinterpret_cast<const float4*>(g0 + QP + q);
          const float gv[2][4] = {{ga.x, ga.y, ga.z, ga.w}, {gb.x, gb.y, gb.z, gb.w}};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 rv = *reinterpret_cast<const float4*>(Rs + (q + u) * ds + d0);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              v[h][0] = fmaf(gv[h][u], rv.x, v[h][0]);
              v[h][1] = fmaf(gv[h][u], rv.y, v[h][1]);
              v[h][2] = fmaf(gv[h][u], rv.z, v[h][2]);
              v[h][3] = fmaf(gv[h][u], rv.w, v[h][3]);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pl = p0 + h;
          const int ip = ip0 + pl / a.PJ, jp = jp0 + pl % a.PJ;
          if (ip < a.Ip && jp < a.Jp)
            *reinterpret_cast<float4*>(a.dL + (long)(a.pmi[ip] + a.pmj[jp]) * ds + d0) =
                make_float4(v[h][0], v[h][1], v[h][2], v[h][3]);
        }
      }
    }
    // the block's dR share += sum_p G[p][q] L[p][d], four q x four d a task
    if (a.need_dr) {
#pragma unroll
      for (int j = 0; j < RTASK; ++j) {
        const int task = tid + j * THREADS;
        if (task < Q * dq / 4) {
          const int q0 = task / dq * 4, d0 = task % dq * 4;
          for (int p = 0; p < npair; ++p) {
            const float4 g = *reinterpret_cast<const float4*>(Gp + p * QP + q0);
            const float4 l = *reinterpret_cast<const float4*>(Ls + p * ds + d0);
            const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              racc[j][u][0] = fmaf(gv[u], l.x, racc[j][u][0]);
              racc[j][u][1] = fmaf(gv[u], l.y, racc[j][u][1]);
              racc[j][u][2] = fmaf(gv[u], l.z, racc[j][u][2]);
              racc[j][u][3] = fmaf(gv[u], l.w, racc[j][u][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the region is the next tile's stages again
  }
  cp_async_wait<0>();

  // the cluster's dR partial: every block's share in shared memory, then
  // rank r sums slice r of them in rank order and writes it
  cg::cluster_group cl = cg::this_cluster();
  if (a.need_dr) {
#pragma unroll
    for (int j = 0; j < RTASK; ++j) {
      const int task = tid + j * THREADS;
      if (task < Q * dq / 4) {
        const int q0 = task / dq * 4, d0 = task % dq * 4;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float4*>(Rp + (q0 + u) * ds + d0) =
              make_float4(racc[j][u][0], racc[j][u][1], racc[j][u][2], racc[j][u][3]);
      }
    }
  }
  cl.sync();
  if (a.need_dr) {
    const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    const int E = Q * ds, per = (E + C - 1) / C;
    const int e1 = min(E, (rank + 1) * per);
    float* out = a.part + (long)(bx / C) * E;
    for (int e = rank * per + tid; e < e1; e += THREADS) {
      float v = 0.f;
      for (int r = 0; r < C; ++r) v += cl.map_shared_rank(Rp, r)[e];
      out[e] = v;
    }
  }
  cl.sync();  // no block leaves while the others read its shared memory
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Shape {
  int n, s;
  int bond[MAXN + 1], fin[MAXN], fout[MAXN];
  int I, J, Is, Js, Ip, Jp, ds, Q;
};

bool make_shape(Shape& c, const int* shapes, int n, int split) {
  if (n < 2 || n > MAXN || split < 1 || split >= n) return false;
  c.n = n;
  c.s = split;
  c.I = c.J = c.Is = c.Js = 1;
  for (int k = 0; k < n; ++k) {
    c.bond[k] = shapes[4 * k];
    c.fin[k] = shapes[4 * k + 1];
    c.fout[k] = shapes[4 * k + 2];
    c.I *= c.fin[k];
    c.J *= c.fout[k];
    if (k >= split) {
      c.Is *= c.fin[k];
      c.Js *= c.fout[k];
    }
  }
  c.bond[n] = shapes[4 * (n - 1) + 3];
  c.Ip = c.I / c.Is;
  c.Jp = c.J / c.Js;
  c.ds = c.bond[split];
  c.Q = c.Is * c.Js;
  return c.ds % 4 == 0 && c.Q % 4 == 0 && (long)c.ds * c.Q <= RMAX;
}

bool tile_ok(const Shape& c, int tr, int tc) {
  return (tr == 64 || tr == 128) && (tc == 64 || tc == 128) && tr % c.Is == 0 &&
         tc % c.Js == 0 && (tr / c.Is) * (tc / c.Js) % 2 == 0;
}

// floats of scratch (kernels/mpo_linear.py:_bwd_layout): phi_1..phi_s and
// mu_1..mu_s, prod_{t<k}(i_t j_t) * d_k floats each; rho_s..rho_{n-1} and
// lam_s..lam_{n-1}, prod_{t>=k}(i_t j_t) * d_k each; each region rounded to 16
// bytes; then the clusters' dR partials
long workspace(const Shape& c, int clusters) {
  long off = 0;
  for (int twice = 0; twice < 2; ++twice)
    for (int k = 1; k <= c.s; ++k) {
      long pre = 1;
      for (int t = 0; t < k; ++t) pre *= (long)c.fin[t] * c.fout[t];
      off += (pre * c.bond[k] + 3) / 4 * 4;
    }
  for (int twice = 0; twice < 2; ++twice)
    for (int k = c.s; k < c.n; ++k) {
      long suf = 1;
      for (int t = k; t < c.n; ++t) suf *= (long)c.fin[t] * c.fout[t];
      off += (suf * c.bond[k] + 3) / 4 * 4;
    }
  return off + (long)clusters * c.Q * c.ds;
}

template <typename T, int TR, int TC>
int launch_tiles(const TileArgs& ta, int nblocks, int cluster, const void* x, const void* dy,
                 cudaStream_t st) {  // nblocks: the whole grid, ta.nb an expert
  const size_t smem = tile_smem<T>(ta.Q, ta.ds, ta.Is, ta.Js, TR, TC);
  cudaError_t err = repro::allow_smem(tile_kernel<T, TR, TC>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tile_kernel<T, TR, TC>, ta, static_cast<const T*>(x),
                           static_cast<const T*>(dy));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_jobs(const Job* jobs, int njobs, int nsteps, const Cores& cs, float* ws, int experts,
                long wstride, int blocks, cudaStream_t st) {
  void* args[] = {(void*)&jobs,    (void*)&njobs,   (void*)&nsteps, (void*)&cs,
                  (void*)&ws,      (void*)&experts, (void*)&wstride};
  if (njobs > MAXJOBS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)run_jobs<T>, dim3(blocks),
                                                dim3(THREADS), args, 0, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// one launch set (chains, tiles, epilogue) for `experts` matrices of one
// shape: expert e's cores, gradients, x and dy at e strides, its scratch at
// e * wstride floats of ws
template <typename T>
int run(const Shape& c, const Cores& cs, const int* args, const int* meta, const void* x,
        const void* dy, int M, int experts, long wstride, float* ws, cudaStream_t st) {
  const int tr = args[1], tc = args[2], cluster = args[3], nblocks = args[4];
  const int jblocks = args[5], nchain = args[6], csteps = args[7], nepi = args[8];
  const int esteps = args[9];
  const Job* jobs = reinterpret_cast<const Job*>(meta);
  const int* maps = meta + JOB_INTS * (nchain + nepi);
  TileArgs ta;
  ta.I = c.I;
  ta.J = c.J;
  ta.M = M;
  ta.Is = c.Is;
  ta.Js = c.Js;
  ta.Ip = c.Ip;
  ta.Jp = c.Jp;
  ta.ds = c.ds;
  ta.Q = c.Q;
  ta.PI = tr / c.Is;
  ta.PJ = tc / c.Js;
  ta.npair = ta.PI * ta.PJ;
  ta.tiles_j = (c.Jp + ta.PJ - 1) / ta.PJ;
  ta.ntiles = (c.Ip + ta.PI - 1) / ta.PI * ta.tiles_j;
  ta.nb = nblocks;
  ta.wstride = wstride;
  ta.need_dl = args[10];
  ta.need_dr = args[11];
  ta.vec = c.I % (16 / sizeof(T)) == 0 && c.J % (16 / sizeof(T)) == 0 &&
           reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  ta.pmi = maps;
  ta.pmj = ta.pmi + c.Ip;
  ta.qmi = ta.pmj + c.Jp;
  ta.qmj = ta.qmi + c.Is;
  ta.L = ws + args[12];
  ta.R = ws + args[13];
  ta.dL = ws + args[14];
  ta.part = ws + args[15];

  const int grid = experts * nblocks;
  int rc = launch_jobs<T>(jobs, nchain, csteps, cs, ws, experts, wstride, jblocks, st);
  if (rc) return rc;
  if (tr == 128 && tc == 128) rc = launch_tiles<T, 128, 128>(ta, grid, cluster, x, dy, st);
  else if (tr == 128) rc = launch_tiles<T, 128, 64>(ta, grid, cluster, x, dy, st);
  else if (tc == 128) rc = launch_tiles<T, 64, 128>(ta, grid, cluster, x, dy, st);
  else rc = launch_tiles<T, 64, 64>(ta, grid, cluster, x, dy, st);
  if (rc) return rc;
  return launch_jobs<T>(jobs + nchain, nepi, esteps, cs, ws, experts, wstride, jblocks, st);
}

}  // namespace

// Floats of scratch mpo_linear_bwd_cores needs for these core shapes, split and
// cluster count, run `experts` matrices of a stack at a time (1 for one
// matrix); -1 if the kernel cannot take the shapes at this split.
extern "C" long mpo_linear_bwd_workspace(const int* shapes, int n, int split, int clusters,
                                         int experts) {
  Shape c;
  if (!make_shape(c, shapes, n, split) || clusters < 1 || experts < 1) return -1;
  return experts * workspace(c, clusters);
}

// Dynamic shared memory (bytes) of the tile pass at this split and tile;
// dtype 0 = float32, 1 = bfloat16.  -1 if the kernel cannot take them.
extern "C" long mpo_linear_bwd_smem(const int* shapes, int n, int split, int tr, int tc,
                                    int dtype) {
  Shape c;
  if (!make_shape(c, shapes, n, split) || !tile_ok(c, tr, tc) || dtype < 0 || dtype > 1)
    return -1;
  return (long)(dtype == 0 ? tile_smem<float>(c.Q, c.ds, c.Is, c.Js, tr, tc)
                           : tile_smem<bf16>(c.Q, c.ds, c.Is, c.Js, tr, tc));
}

// cores / dcores: n device pointers (a null dcores[k] gets no gradient; its
// job is absent from the epilogue), each to `experts` matrices' cores of one
// shape back to back (a MoE layer's expert stack; 1 for one matrix);
// shapes: n * 4 ints (d0, i, j, d1), one matrix's core;
// args (host): split, tile rows, tile columns, cluster, tile blocks, job-runner
// blocks, chain jobs, chain steps, epilogue jobs, epilogue steps, need dL,
// need dR, then the float offsets of L, R, dL and the partials in ws; meta
// (device): the chain jobs, the epilogue jobs, then the maps pmi [Ip], pmj [Jp],
// qmi [Is], qmj [Js]; x [experts][M, I], dy [experts][M, J] (16-byte
// aligned); dtype 0 = float32, 1 = bfloat16 (cores, x, dy and the gradients
// alike); ws: the workspace of `group` matrices.  The experts run `group` at
// a time, one launch set a group, each group reusing the scratch (stream
// order keeps them apart).  Returns the first launch error (0 = all
// launched).
extern "C" int mpo_linear_bwd_cores(const void* const* cores, void* const* dcores,
                                    const int* shapes, int n, const int* args, const int* meta,
                                    const void* x, const void* dy, int M, int experts, int group,
                                    int dtype, float* ws, void* stream) {
  Shape c;
  if (!make_shape(c, shapes, n, args[0]) || !tile_ok(c, args[1], args[2]) || M < 0 ||
      args[3] < 1 || args[3] > MAXCLUSTER || args[4] < 1 || args[4] % args[3] || args[5] < 1 ||
      experts < 1 || group < 1 || (long)group * args[4] > 0x7fffffffL || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const size_t isz = dtype == 0 ? 4 : 2;
  const long wstride = workspace(c, args[4] / args[3]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int g0 = 0; g0 < experts; g0 += group) {
    Cores cs;
    for (int k = 0; k < MAXN; ++k) {
      cs.size[k] = k < n ? (long)c.bond[k] * c.fin[k] * c.fout[k] * c.bond[k + 1] : 0;
      cs.in[k] = k < n ? static_cast<const char*>(cores[k]) + g0 * cs.size[k] * isz : nullptr;
      cs.out[k] = k < n && dcores[k] ? static_cast<char*>(dcores[k]) + g0 * cs.size[k] * isz
                                      : nullptr;
    }
    const void* xg = static_cast<const char*>(x) + (size_t)g0 * M * c.I * isz;
    const void* dyg = static_cast<const char*>(dy) + (size_t)g0 * M * c.J * isz;
    const int ge = experts - g0 < group ? experts - g0 : group;
    const int rc = dtype == 0 ? run<float>(c, cs, args, meta, xg, dyg, M, ge, wstride, ws, st)
                              : run<bf16>(c, cs, args, meta, xg, dyg, M, ge, wstride, ws, st);
    if (rc) return rc;
  }
  return 0;
}
