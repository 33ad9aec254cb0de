// Fused MPO-linear forward for Hopper on the CUDA cores, float32: y[M, J] =
// x[M, I] @ W(cores), where W is rebuilt from the MPO cores inside each block
// and never written to device memory.  A stack of E matrices of one shape
// (the experts of a MoE layer: cores (E, d0, i, j, d1), x [E, M, I], y
// [E, M, J]) runs in the same launch, the expert a grid dimension.
//
// Replaces the Pallas TPU kernel repro/kernels/mpo_linear.py:_fwd_call /
// _fwd_kernel for the float32 core shapes the tensor-core kernel
// (csrc/mpo_linear_mma.cu) does not take: matrices so narrow that no bond
// keeps its scratch within an eighth of W, and chains whose bonds give no
// whole stage and tile groups (kernels/mpo_linear.py:forward_kernel).  The
// Pallas kernel holds a whole f32 (I/i1, J/j1) W tile and every remaining core
// in VMEM (256 KB to 3 MB a tile at bert-base widths) and
// carries the i1 reduction across sequential grid steps in the output dtype.
// Neither transfers: a block has at most 227 KB of shared memory, and blocks
// run in no order.
//
// Design.  The core chain is split at a bond s (chosen by the Python wrapper,
// kernels/mpo_linear.py:_launch_plan): with I = (ip, is) and J = (jp, js) the
// row-major digit groups of cores [0, s) and [s, n),
//     W[ip, is, jp, js] = sum_d L[ip, jp, d] * R[d, is, js],
// L the contraction of the prefix cores, R of the suffix cores.  One block of
// 256 threads owns a BM x BN output tile and loops over every row of I itself,
// keeping the sum in f32 registers, so nothing crosses blocks (16 x 16 tiles
// when there are at most 16 rows, so small decode batches spread over more
// SMs):
//   1. R for all (is, js) is contracted into shared memory once per block,
//      right to left through the suffix cores, PC pairs at a time;
//   2. for each ip, the block contracts the prefix vectors L[ip, jp, :] of the
//      jp its columns touch, then, KC rows of is at a time, rebuilds the
//      (KC x BN) W sub-block in shared memory and multiplies the (BM x KC)
//      x tile into the accumulators (4 x 4 per thread).
// Every chain step runs block-wide, one thread per output element, so the
// loads of core slices are coalesced and many are in flight at once.  Cores
// are read through L1/L2 (all of one matrix's cores are under 0.5 MB).  The
// ragged M and J edges are masked, not padded.
//
// What bounds it.  At bert-base widths the work it must do is the dense
// product (2*M*I*J operations); the rebuild adds 2*I*BN*d per block, the same
// again at BM = 64 when d = 64, and each block re-reads the prefix cores'
// slices once per ip.  Everything runs on the CUDA cores in f32 (about 67
// TFLOP/s on an H100 SXM), well below the tensor cores' bf16 rate.  Moving
// both products to wgmma and staging core slices in shared memory is the
// next step; this version is the simple one that is right.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAXN = 8;
constexpr int KC = 16;
constexpr int THREADS = 256;
// output tiles: 64 x 64 (4 x 4 accumulators a thread), and 16 x 16 (one a
// thread) for few rows, where 64-wide tiles would leave most SMs idle
constexpr int PC = 32;  // suffix (is, js) pairs contracted together when building R

struct MpoArgs {
  const void* core[MAXN];
  long cstride[MAXN];  // elements of core k a matrix of the stack
  int bond[MAXN + 1];  // d_0 .. d_n  (d_0 = d_n = 1)
  int fin[MAXN];       // i_k
  int fout[MAXN];      // j_k
  int sin[MAXN];       // place value of core k's i digit within its group (ip or is)
  int sout[MAXN];      // the same for the j digit (jp or js)
  int n, s;            // cores, split bond
  int I, J, Is, Js, Ip;
  int M;
  int E;               // matrices in the stack
  int dmax;            // largest bond
  int njp;             // prefix vectors a block holds
  int cb;              // vectors each chain buffer holds: max(PC, njp)
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
mpo_linear_fwd_kernel(MpoArgs a, const T* __restrict__ x, T* __restrict__ y) {
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ float smem[];
  const int ds = a.bond[a.s];
  const long rstride = (long)a.Is * a.Js;
  float* R = smem;                           // [ds][Is][Js]
  float* Lrow = R + ds * rstride;            // [njp][ds]
  float* bufA = Lrow + a.njp * ds;           // [cb][dmax] chain vectors
  float* bufB = bufA + a.cb * a.dmax;        // [cb][dmax]
  float* Wsub = bufB + a.cb * a.dmax;        // [KC][BN]
  float* xs = Wsub + KC * BN;                // [BM][KC + 1]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ex = blockIdx.z;                 // the matrix of the stack
  x += (long)ex * a.M * a.I;
  y += (long)ex * a.M * a.J;
  auto core = [&](int k) { return static_cast<const T*>(a.core[k]) + ex * a.cstride[k]; };
  const int cend = min(c0 + BN, a.J);
  const int jp0 = c0 / a.Js;
  const int njp_blk = (cend - 1) / a.Js - jp0 + 1;

  // 1. R[d][is][js]: the suffix cores s..n-1 contracted right to left, PC
  //    (is, js) pairs at a time, every thread on one (pair, row) output.
  for (int pc0 = 0; pc0 < rstride; pc0 += PC) {
    const int np = min(PC, (int)(rstride - pc0));
    float* in = bufA;
    float* out = bufB;
    for (int k = a.n - 1; k >= a.s; --k) {
      const T* c = core(k);
      const int d0 = a.bond[k], d1 = a.bond[k + 1];
      const long row = (long)a.fin[k] * a.fout[k] * d1;
      for (int e = tid; e < np * d0; e += THREADS) {
        const int p = e / d0, r = e % d0;
        const int pair = pc0 + p;
        const int ik = (pair / a.Js / a.sin[k]) % a.fin[k];
        const int jk = (pair % a.Js / a.sout[k]) % a.fout[k];
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
        if (k == a.s) R[r * rstride + pair] = acc;
        else out[p * a.dmax + r] = acc;
      }
      __syncthreads();
      float* t = in;
      in = out;
      out = t;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, cols tx + 16 j

  for (int ip = 0; ip < a.Ip; ++ip) {
    // 2a. L[ip, jp0 + q, :] through the prefix cores 0..s-1, left to right,
    //     every thread on one (q, column) output of each step.
    float* in = bufA;
    float* out = bufB;
    for (int k = 0; k < a.s; ++k) {
      const T* c = core(k);
      const int d0 = a.bond[k], d1 = a.bond[k + 1];
      const long row = (long)a.fin[k] * a.fout[k] * d1;
      const int ik = (ip / a.sin[k]) % a.fin[k];
      for (int e = tid; e < njp_blk * d1; e += THREADS) {
        const int q = e / d1, col = e % d1;
        const int jk = ((jp0 + q) / a.sout[k]) % a.fout[k];
        const long base = ((long)ik * a.fout[k] + jk) * d1 + col;
        float v;
        if (k == 0) {
          v = repro::ld(c, base);  // d_0 = 1
        } else {
          v = 0.f;
          const float* u = in + q * a.dmax;
#pragma unroll 8
          for (int r = 0; r < d0; ++r) v += u[r] * repro::ld(c, r * row + base);
        }
        if (k == a.s - 1) Lrow[q * ds + col] = v;
        else out[q * a.dmax + col] = v;
      }
      __syncthreads();
      float* t = in;
      in = out;
      out = t;
    }

    for (int is0 = 0; is0 < a.Is; is0 += KC) {
      // 2b. the x tile for rows m0.., columns ip * Is + is0..
      for (int e = tid; e < BM * KC; e += THREADS) {
        const int r = e / KC, kk = e % KC;
        const int m = m0 + r, is = is0 + kk;
        xs[r * (KC + 1) + kk] =
            (m < a.M && is < a.Is) ? repro::ld(x, (long)m * a.I + (long)ip * a.Is + is) : 0.f;
      }
      // 2c. W sub-block: Wsub[kk][cc] = sum_d L[ip, jp(cc), d] R[d, is0 + kk, js(cc)]
      for (int e = tid; e < KC * BN; e += THREADS) {
        const int kk = e / BN, cc = e % BN;
        const int col = c0 + cc, is = is0 + kk;
        float w = 0.f;
        if (col < a.J && is < a.Is) {
          const float* lr = Lrow + (col / a.Js - jp0) * ds;
          const float* rr = R + (long)is * a.Js + col % a.Js;
#pragma unroll 8
          for (int d = 0; d < ds; ++d) w += lr[d] * rr[d * rstride];
        }
        Wsub[kk * BN + cc] = w;
      }
      __syncthreads();
      // 2d. acc += x tile @ W sub-block
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float xv[TM], wv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) xv[i] = xs[(ty + 16 * i) * (KC + 1) + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) wv[j] = Wsub[kk * BN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += xv[i] * wv[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < a.J) repro::st(y, (long)m * a.J + col, acc[i][j]);
    }
  }
}

// dynamic shared memory of one block: R, the prefix rows, the two chain
// buffers, the W sub-block and the x tile (``_smem_bytes`` in Python)
size_t fwd_smem(const MpoArgs& a, int bm, int bn) {
  const int ds = a.bond[a.s];
  return sizeof(float) * ((size_t)ds * a.Is * a.Js + (size_t)a.njp * ds +
                          (size_t)2 * a.cb * a.dmax + KC * bn + bm * (KC + 1));
}

template <typename T, int BM, int BN>
int launch(const MpoArgs& a, const void* x, void* y, cudaStream_t stream) {
  const size_t smem = fwd_smem(a, BM, BN);
  cudaError_t err = repro::allow_smem(mpo_linear_fwd_kernel<T, BM, BN>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.J + BN - 1) / BN, (a.M + BM - 1) / BM, a.E);
  mpo_linear_fwd_kernel<T, BM, BN><<<grid, THREADS, smem, stream>>>(
      a, static_cast<const T*>(x), static_cast<T*>(y));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(int tile, const MpoArgs& a, const void* x, void* y, cudaStream_t stream) {
  if (tile == 0) return launch<T, 64, 64>(a, x, y, stream);
  if (tile == 1) return launch<T, 16, 16>(a, x, y, stream);
  return (int)cudaErrorInvalidValue;
}

// The launch arguments of one matrix's cores (pointers and rows left
// unset): factors, bonds, group sizes and digit place values.
MpoArgs make_args(const int* shapes, int n, int split, int njp) {
  MpoArgs a;
  a.n = n;
  a.s = split;
  a.I = a.J = a.Is = a.Js = 1;
  a.dmax = 1;
  for (int k = 0; k < n; ++k) {
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
  a.njp = njp;
  a.cb = njp > PC ? njp : PC;
  // digit place values inside each group: the prefix cores [0, s) make up
  // ip and jp, the suffix cores [s, n) make up is and js (row-major)
  for (int k = n - 1, pi = 1, po = 1; k >= 0; --k) {
    if (k == split - 1) pi = po = 1;
    a.sin[k] = pi;
    a.sout[k] = po;
    pi *= a.fin[k];
    po *= a.fout[k];
  }
  return a;
}

}  // namespace

// cores: n device pointers; shapes: n * 4 ints (d0, i, j, d1) per core of
// one matrix; E matrices stacked (each core E contiguous blocks of its
// shape, x [E, M, I], y [E, M, J]; E = 1 for one matrix).
// tile: 0 = 64 x 64 output tiles, 1 = 16 x 16 (njp must be sized for it).
// x, cores and y float32.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int mpo_linear_fwd(const void* const* cores, const int* shapes, int n, int split,
                              int njp, int tile, const void* x, void* y, int M, int E,
                              void* stream) {
  if (n < 2 || n > MAXN || split < 1 || split >= n || E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  MpoArgs a = make_args(shapes, n, split, njp);
  for (int k = 0; k < n; ++k) a.core[k] = cores[k];
  a.M = M;
  a.E = E;
  return launch_tile<float>(tile, a, x, y, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory one block of a launch with these arguments
// takes, bytes (-1 for arguments the launcher refuses).
extern "C" long mpo_linear_fwd_smem(const int* shapes, int n, int split, int njp, int tile) {
  if (n < 2 || n > MAXN || split < 1 || split >= n || tile < 0 || tile > 1) return -1;
  const MpoArgs a = make_args(shapes, n, split, njp);
  return (long)(tile == 0 ? fwd_smem(a, 64, 64) : fwd_smem(a, 16, 16));
}
