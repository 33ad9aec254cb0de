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
// Design.  As in the forward (mpo_linear.cu), the chain is split at a bond s,
//     W[ip, is, jp, js] = sum_d L[ip, jp, d] * R[d, is, js],
// with (ip, jp) the digits of cores [0, s) and (is, js) those of [s, n).  Then
//     dL[ip, jp, d] = sum_{is, js} dW[ip, is, jp, js] R[d, is, js]
//     dR[d, is, js] = sum_{ip, jp} L[ip, jp, d] dW[ip, is, jp, js].
// Passes, all on the stream the caller gives, each a kernel of its own:
//   1. chain: R, and L with the prefix vectors that lead to it, one thread per
//      (pair, bond index) output of each core step;
//   2. tiles: a grid sized near the SM count walks the (TR x TC) tiles of dW
//      (TR = PI * Is rows, TC = PJ * Js columns, so each tile holds whole
//      (ip, jp) sub-tiles), each block in a fixed order.  A tile is summed
//      over all M rows in f32 registers, 4 x 4 a thread, from x and dy rows
//      staged in shared memory, and is then kept in shared memory only.  From
//      it the block writes dL for the tile's pairs (no other block owns them)
//      and adds the tile's share of dR into its own partial in shared memory,
//      written out once per block;
//   3. reduce: dR is the sum of the block partials, in block order;
//   4. pullback: dR back through the suffix cores and dL back through the
//      prefix cores.  The gradient of core k is, for each of its entries, a
//      sum over the pairs whose k-th digits match of (cotangent vector from
//      the left) x (chain vector from the right); one thread per entry sums
//      its pairs in a fixed order, in f32, and rounds once to the cores'
//      dtype.
//
// What bounds it.  The work it must do is the dense product x^T dy
// (2 * M * I * J operations); the pullback adds 4 * ds * I * J and the chains
// less.  This version runs on the CUDA cores in f32 (about 67 TFLOP/s on an
// H100 SXM), far below the tensor cores' bf16 rate: moving the tile product
// to wgmma is the next step.  Bytes are x and dy once per tile column or row
// of tiles (they stay in L2 at bert-base sizes), the cores, and the
// core-sized scratch of the chains.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAXN = 8;
constexpr int THREADS = 256;
constexpr int TILE = 64;  // dW tile edge: 16 x 16 threads, 4 x 4 values each
constexpr int TP = TILE + 1;
constexpr int KC = 16;    // rows of x and dy staged per step

struct Chain {
  const void* core[MAXN];
  int bond[MAXN + 1];  // d_0 .. d_n  (d_0 = d_n = 1)
  int fin[MAXN], fout[MAXN];
  int sin[MAXN], sout[MAXN];  // place value of core k's digit within its group
  int n, s;
  int I, J, Ip, Jp, Is, Js;
};

// The pair group a core belongs to: (ip, jp) for the prefix, (is, js) for the
// suffix.  A pair index is p = pi * nj + pj.
struct Group {
  int ni, nj;
};

__device__ __forceinline__ Group group_of(const Chain& c, int k) {
  return k < c.s ? Group{c.Ip, c.Jp} : Group{c.Is, c.Js};
}

// out[p][b] = sum_a in[p][a] * C_k[a, i_k(p), j_k(p), b]; in == nullptr means
// the vector [1] (k = 0).
template <typename T>
__global__ void __launch_bounds__(THREADS)
chain_left(Chain c, int k, const float* __restrict__ in, float* __restrict__ out) {
  const Group g = group_of(c, k);
  const int d0 = c.bond[k], d1 = c.bond[k + 1];
  const T* core = static_cast<const T*>(c.core[k]);
  const long total = (long)g.ni * g.nj * d1;
  for (long e = blockIdx.x * (long)THREADS + threadIdx.x; e < total;
       e += (long)gridDim.x * THREADS) {
    const int p = (int)(e / d1), b = (int)(e % d1);
    const int ik = (p / g.nj / c.sin[k]) % c.fin[k];
    const int jk = (p % g.nj / c.sout[k]) % c.fout[k];
    const long base = ((long)ik * c.fout[k] + jk) * d1 + b;
    const long row = (long)c.fin[k] * c.fout[k] * d1;
    float v;
    if (in == nullptr) {
      v = repro::ld(core, base);
    } else {
      v = 0.f;
      const float* u = in + (long)p * d0;
      for (int a = 0; a < d0; ++a) v += u[a] * repro::ld(core, a * row + base);
    }
    out[e] = v;
  }
}

// out[p][a] = sum_b C_k[a, i_k(p), j_k(p), b] * in[p][b]; in == nullptr means
// the vector [1] (k = n - 1).
template <typename T>
__global__ void __launch_bounds__(THREADS)
chain_right(Chain c, int k, const float* __restrict__ in, float* __restrict__ out) {
  const Group g = group_of(c, k);
  const int d0 = c.bond[k], d1 = c.bond[k + 1];
  const T* core = static_cast<const T*>(c.core[k]);
  const long total = (long)g.ni * g.nj * d0;
  for (long e = blockIdx.x * (long)THREADS + threadIdx.x; e < total;
       e += (long)gridDim.x * THREADS) {
    const int p = (int)(e / d0), a = (int)(e % d0);
    const int ik = (p / g.nj / c.sin[k]) % c.fin[k];
    const int jk = (p % g.nj / c.sout[k]) % c.fout[k];
    const long base = (((long)a * c.fin[k] + ik) * c.fout[k] + jk) * d1;
    float v;
    if (in == nullptr) {
      v = repro::ld(core, base);
    } else {
      v = 0.f;
      const float* u = in + (long)p * d1;
      for (int b = 0; b < d1; ++b) v += repro::ld(core, base + b) * u[b];
    }
    out[e] = v;
  }
}

// dC_k[a, i, j, b] = sum over the pairs p of core k's group whose k-th digits
// are (i, j) of left[p][a] * right[p][b].  left == nullptr means [1] (k = 0),
// right == nullptr means [1] (k = n - 1).  One thread per entry, the pairs in
// a fixed order; one rounding to T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
outer_sum(Chain c, int k, const float* __restrict__ left, const float* __restrict__ right,
          T* __restrict__ dcore) {
  const Group g = group_of(c, k);
  const int d0 = c.bond[k], d1 = c.bond[k + 1];
  const int fi = c.fin[k], fo = c.fout[k];
  const int si = c.sin[k], so = c.sout[k];
  const int hi_n = g.ni / (si * fi), hj_n = g.nj / (so * fo);
  const long total = (long)d0 * fi * fo * d1;
  for (long e = blockIdx.x * (long)THREADS + threadIdx.x; e < total;
       e += (long)gridDim.x * THREADS) {
    const int b = (int)(e % d1);
    const int j = (int)(e / d1 % fo);
    const int i = (int)(e / d1 / fo % fi);
    const int a = (int)(e / d1 / fo / fi);
    float acc = 0.f;
    for (int hi = 0; hi < hi_n; ++hi)
      for (int lo = 0; lo < si; ++lo) {
        const int pi = (hi * fi + i) * si + lo;
        for (int hj = 0; hj < hj_n; ++hj)
          for (int lj = 0; lj < so; ++lj) {
            const long p = (long)pi * g.nj + (hj * fo + j) * so + lj;
            const float l = left == nullptr ? 1.f : left[p * d0 + a];
            const float r = right == nullptr ? 1.f : right[p * d1 + b];
            acc += l * r;
          }
      }
    repro::st(dcore, e, acc);
  }
}

struct TileArgs {
  int I, J, M;
  int Ip, Jp, Is, Js, ds;
  int PI, PJ;          // pairs a tile holds along ip / jp
  int tiles_i, tiles_j;
};

// Pass 2.  Shared memory: Rt[Q][ds] (R with d fastest), Rp[Q][ds] (this
// block's dR partial), G[TILE][TP] (the dW tile), xs/ys[KC][TILE] (staged
// rows), Lt[PI * PJ][ds] (L of the tile's pairs); Q = Is * Js.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_tiles(TileArgs a, const T* __restrict__ x, const T* __restrict__ dy,
         const float* __restrict__ L, const float* __restrict__ R,
         float* __restrict__ dL, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int ds = a.ds;
  const int rsz = a.Is * a.Js * ds;
  const int npair = a.PI * a.PJ;
  float* Rt = smem;
  float* Rp = Rt + rsz;
  float* G = Rp + rsz;
  float* xs = G + TILE * TP;
  float* ys = xs + KC * TILE;
  float* Lt = ys + KC * TILE;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, columns tx + 16 j

  for (int e = tid; e < rsz; e += THREADS) {
    Rt[e] = R[e];
    Rp[e] = 0.f;
  }
  const int ntiles = a.tiles_i * a.tiles_j;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ip0 = t / a.tiles_j * a.PI, jp0 = t % a.tiles_j * a.PJ;
    const int npi = min(a.PI, a.Ip - ip0), npj = min(a.PJ, a.Jp - jp0);
    const int r0 = ip0 * a.Is, c0 = jp0 * a.Js;
    const int tr = npi * a.Is, tc = npj * a.Js;  // rows and columns in use

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int m0 = 0; m0 < a.M; m0 += KC) {
      for (int e = tid; e < KC * TILE; e += THREADS) {
        const int kk = e / TILE, cc = e % TILE, m = m0 + kk;
        xs[e] = (m < a.M && cc < tr) ? repro::ld(x, (long)m * a.I + r0 + cc) : 0.f;
        ys[e] = (m < a.M && cc < tc) ? repro::ld(dy, (long)m * a.J + c0 + cc) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float xv[4], yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[kk * TILE + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) yv[j] = ys[kk * TILE + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * yv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) G[(ty + 16 * i) * TP + tx + 16 * j] = acc[i][j];
    for (int e = tid; e < npair * ds; e += THREADS) {
      const int lp = e / ds, d = e % ds;
      const int pi = lp / a.PJ, pj = lp % a.PJ;
      Lt[e] = (pi < npi && pj < npj)
                  ? L[((long)(ip0 + pi) * a.Jp + jp0 + pj) * ds + d] : 0.f;
    }
    __syncthreads();

    // dL[ip, jp, d] = sum_{is, js} G[ip-sub][is, js] * R[d, is, js]
    for (int e = tid; e < npair * ds; e += THREADS) {
      const int lp = e / ds, d = e % ds;
      const int pi = lp / a.PJ, pj = lp % a.PJ;
      if (pi >= npi || pj >= npj) continue;
      const float* gsub = G + pi * a.Is * TP + pj * a.Js;
      float v = 0.f;
      for (int is = 0; is < a.Is; ++is)
        for (int js = 0; js < a.Js; ++js)
          v += gsub[is * TP + js] * Rt[(is * a.Js + js) * ds + d];
      dL[((long)(ip0 + pi) * a.Jp + jp0 + pj) * ds + d] = v;
    }
    // dR partial += sum over the tile's pairs of L[ip, jp, d] * G[ip-sub][is, js]
    for (int e = tid; e < rsz; e += THREADS) {
      const int d = e % ds, q = e / ds;
      const int is = q / a.Js, js = q % a.Js;
      float v = 0.f;
      for (int pi = 0; pi < npi; ++pi)
        for (int pj = 0; pj < npj; ++pj)
          v += Lt[(pi * a.PJ + pj) * ds + d] * G[(pi * a.Is + is) * TP + pj * a.Js + js];
      Rp[e] += v;
    }
    __syncthreads();
  }
  for (int e = tid; e < rsz; e += THREADS) part[(long)blockIdx.x * rsz + e] = Rp[e];
}

// Pass 3: dR[e] = sum over blocks, in block order, of part[b][e].
__global__ void __launch_bounds__(THREADS)
reduce_partials(const float* __restrict__ part, int nblocks, int rsz, float* __restrict__ out) {
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < rsz; e += gridDim.x * THREADS) {
    float v = 0.f;
    for (int b = 0; b < nblocks; ++b) v += part[(long)b * rsz + e];
    out[e] = v;
  }
}

inline int grid_for(long total) {
  long g = (total + THREADS - 1) / THREADS;
  return (int)(g < 1 ? 1 : (g > 4096 ? 4096 : g));
}

// Offsets (in floats) of the scratch the passes share.
struct Layout {
  long phi[MAXN + 1];  // prefix chain vectors phi_k, k = 1..s  ([P][d_k]); phi_s = L
  long mu[MAXN + 1];   // prefix cotangents mu_k, k = 1..s ([P][d_k]); mu_s = dL
  long rho[MAXN + 1];  // suffix chain vectors rho_k, k = s..n-1 ([Q][d_k]); rho_s = R
  long lam[MAXN + 1];  // suffix cotangents lambda_k, k = s..n-1 ([Q][d_k]); lambda_s = dR
  long part;           // [nblocks][Q * d_s]
  long total;
};

bool make_chain(Chain& c, const void* const* cores, const int* shapes, int n, int split) {
  if (n < 2 || n > MAXN || split < 1 || split >= n) return false;
  c.n = n;
  c.s = split;
  c.I = c.J = c.Is = c.Js = 1;
  for (int k = 0; k < n; ++k) {
    c.core[k] = cores == nullptr ? nullptr : cores[k];
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
  for (int k = n - 1, pi = 1, po = 1; k >= 0; --k) {
    if (k == split - 1) pi = po = 1;
    c.sin[k] = pi;
    c.sout[k] = po;
    pi *= c.fin[k];
    po *= c.fout[k];
  }
  return true;
}

Layout layout(const Chain& c, int nblocks) {
  Layout l;
  const long P = (long)c.Ip * c.Jp, Q = (long)c.Is * c.Js;
  long off = 0;
  for (int k = 1; k <= c.s; ++k) {
    l.phi[k] = off;
    off += P * c.bond[k];
    l.mu[k] = off;
    off += P * c.bond[k];
  }
  for (int k = c.s; k < c.n; ++k) {
    l.rho[k] = off;
    off += Q * c.bond[k];
    l.lam[k] = off;
    off += Q * c.bond[k];
  }
  l.part = off;
  off += (long)nblocks * Q * c.bond[c.s];
  l.total = off;
  return l;
}

// Shared memory (bytes) one block of the tile pass takes; the Python gate
// (kernels/mpo_linear.py:_bwd_smem_bytes) computes the same.
size_t tile_smem(const Chain& c, int pi, int pj) {
  const size_t rsz = (size_t)c.Is * c.Js * c.bond[c.s];
  return sizeof(float) * (2 * rsz + TILE * TP + 2 * KC * TILE + (size_t)pi * pj * c.bond[c.s]);
}

#define RETURN_IF_ERR()                               \
  do {                                                \
    cudaError_t err_ = cudaGetLastError();            \
    if (err_ != cudaSuccess) return (int)err_;        \
  } while (0)

template <typename T>
int run(const Chain& c, void* const* dcores, int pi, int pj, int nblocks, const void* x,
        const void* dy, int M, float* ws, cudaStream_t st) {
  const Layout l = layout(c, nblocks);
  const int n = c.n, s = c.s;
  const long P = (long)c.Ip * c.Jp, Q = (long)c.Is * c.Js;
  // 1. the chains: rho_{n-1} .. rho_s = R (right to left), phi_1 .. phi_s = L
  for (int k = n - 1; k >= s; --k) {
    const float* in = k == n - 1 ? nullptr : ws + l.rho[k + 1];
    chain_right<T><<<grid_for(Q * c.bond[k]), THREADS, 0, st>>>(c, k, in, ws + l.rho[k]);
    RETURN_IF_ERR();
  }
  for (int k = 0; k < s; ++k) {
    const float* in = k == 0 ? nullptr : ws + l.phi[k];
    chain_left<T><<<grid_for(P * c.bond[k + 1]), THREADS, 0, st>>>(c, k, in, ws + l.phi[k + 1]);
    RETURN_IF_ERR();
  }
  // 2. the dW tiles -> dL and the block partials of dR
  TileArgs ta;
  ta.I = c.I;
  ta.J = c.J;
  ta.M = M;
  ta.Ip = c.Ip;
  ta.Jp = c.Jp;
  ta.Is = c.Is;
  ta.Js = c.Js;
  ta.ds = c.bond[s];
  ta.PI = pi;
  ta.PJ = pj;
  ta.tiles_i = (c.Ip + pi - 1) / pi;
  ta.tiles_j = (c.Jp + pj - 1) / pj;
  const size_t smem = tile_smem(c, pi, pj);
  cudaError_t err = repro::allow_smem(dw_tiles<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dw_tiles<T><<<nblocks, THREADS, smem, st>>>(ta, static_cast<const T*>(x),
                                              static_cast<const T*>(dy), ws + l.phi[s],
                                              ws + l.rho[s], ws + l.mu[s], ws + l.part);
  RETURN_IF_ERR();
  // 3. dR = lambda_s
  const int rsz = (int)(Q * c.bond[s]);
  reduce_partials<<<grid_for(rsz), THREADS, 0, st>>>(ws + l.part, nblocks, rsz, ws + l.lam[s]);
  RETURN_IF_ERR();
  // 4a. suffix: lambda_{k+1} from lambda_k, then dC_k = sum lambda_k x rho_{k+1}
  for (int k = s; k < n - 1; ++k) {
    chain_left<T><<<grid_for(Q * c.bond[k + 1]), THREADS, 0, st>>>(c, k, ws + l.lam[k],
                                                                   ws + l.lam[k + 1]);
    RETURN_IF_ERR();
  }
  for (int k = s; k < n; ++k) {
    if (dcores[k] == nullptr) continue;
    const float* right = k == n - 1 ? nullptr : ws + l.rho[k + 1];
    const long total = (long)c.bond[k] * c.fin[k] * c.fout[k] * c.bond[k + 1];
    outer_sum<T><<<grid_for(total), THREADS, 0, st>>>(c, k, ws + l.lam[k], right,
                                                      static_cast<T*>(dcores[k]));
    RETURN_IF_ERR();
  }
  // 4b. prefix: mu_k from mu_{k+1} (mu_s = dL), then dC_k = sum phi_k x mu_{k+1}
  for (int k = s - 1; k >= 1; --k) {
    chain_right<T><<<grid_for(P * c.bond[k]), THREADS, 0, st>>>(c, k, ws + l.mu[k + 1],
                                                                ws + l.mu[k]);
    RETURN_IF_ERR();
  }
  for (int k = 0; k < s; ++k) {
    if (dcores[k] == nullptr) continue;
    const float* left = k == 0 ? nullptr : ws + l.phi[k];
    const long total = (long)c.bond[k] * c.fin[k] * c.fout[k] * c.bond[k + 1];
    outer_sum<T><<<grid_for(total), THREADS, 0, st>>>(c, k, left, ws + l.mu[k + 1],
                                                      static_cast<T*>(dcores[k]));
    RETURN_IF_ERR();
  }
  return 0;
}

}  // namespace

// Floats of scratch mpo_linear_bwd_cores needs for these core shapes, split
// and block count; -1 if the shapes or split are not valid.
extern "C" long mpo_linear_bwd_workspace(const int* shapes, int n, int split, int nblocks) {
  Chain c;
  if (!make_chain(c, nullptr, shapes, n, split)) return -1;
  return layout(c, nblocks).total;
}

// cores / dcores: n device pointers (a null dcores[k] skips that gradient);
// shapes: n * 4 ints (d0, i, j, d1) per core; split: the bond s; pi, pj: pairs
// per tile (pi * Is <= 64, pj * Js <= 64); nblocks: blocks of the tile pass;
// x (M, I), dy (M, J); dtype: 0 = float32, 1 = bfloat16 (cores, x, dy and the
// gradients alike); ws: mpo_linear_bwd_workspace(...) floats of scratch.
// Returns the first launch error (0 = every pass launched).
extern "C" int mpo_linear_bwd_cores(const void* const* cores, void* const* dcores,
                                    const int* shapes, int n, int split, int pi, int pj,
                                    int nblocks, const void* x, const void* dy, int M,
                                    int dtype, float* ws, void* stream) {
  Chain c;
  if (!make_chain(c, cores, shapes, n, split)) return (int)cudaErrorInvalidValue;
  if (pi < 1 || pj < 1 || pi * c.Is > TILE || pj * c.Js > TILE || nblocks < 1 || M < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(c, dcores, pi, pj, nblocks, x, dy, M, ws, st);
  if (dtype == 1) return run<__nv_bfloat16>(c, dcores, pi, pj, nblocks, x, dy, M, ws, st);
  return (int)cudaErrorInvalidValue;
}
