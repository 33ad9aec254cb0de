// Chunked Mamba2 SSD scan (state-space duality) for Hopper: the SSM family's
// prefill, f32 sums, the (N, P) state carried across chunks.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:ssd_scan / _kernel.
// There the grid is (batch, head, chunk) with the chunk axis innermost and
// sequential; a VMEM scratch holds the (N, P) f32 state across chunk steps,
// and each step holds its chunk's B and C (q x N), the q x q decay matrix
// L and the state at once (about 256 KB at q = N = 128, P = 64 in f32).
//
// Design.  One block of 256 threads per (batch, head) loops over the chunks
// in order, so the carry needs no cross-block pass; the state stays in shared
// memory for the whole sequence and is written out once, after the last
// chunk, as the final state prefill keeps.  Per chunk the block stages B, C
// (f32, odd row stride so both the row and the column walks are free of bank
// conflicts), x * dt and the per-row decays, then walks the chunk in row
// tiles of 32: the tile's decayed scores G = (C B^T) o L (only the columns up
// to the tile's last row: L is lower-triangular), then
// y = G (x dt) + exp(dacum) (C state) + x d_skip for the tile's rows, written
// straight to y.  Holding one 32-row tile of L instead of all q x q brings the
// block to 211 KB at the path shape, under the 227 KB a block may use.  Last,
// the state update state * exp(dacum_last) + (B o exp(dacum_last - dacum))^T
// (x dt).  Every decay is exp of a difference of the chunk's cumulative sums
// (one warp scan), as the reference forms them, so the rounding matches.
//
// What bounds it.  The least work is one read of x, dt, B, C and one write of
// y and the final state (about 34 MB at batch 8 x 512 tokens, 24 heads, bf16:
// 10 us at 3.35 TB/s) against about 5.6 GFLOP of products (the causal half of
// the two q x q products): 6 us at the bf16 tensor-core rate, 84 us at the
// f32 CUDA-core rate this kernel sums at.  It runs its products on the CUDA
// cores from shared memory (two to eight FMAs a load) with one block per SM
// (B * H = 192 blocks: 1.5 waves on 132 SMs at batch 8; 24 blocks at batch
// 1), so the products, not the bytes, set its time.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads per block
constexpr int QMAX = 128;   // chunk length
constexpr int NMAX = 128;   // state size
constexpr int PMAX = 64;    // head dim
constexpr int ROWS = 32;    // rows of one G tile (16 thread rows x 2)

__host__ __device__ inline size_t smem_floats(int q, int n, int p) {
  return 2 * (size_t)q * (n + 1) + (size_t)q * p + (size_t)n * p + (size_t)ROWS * (q + 1) +
         4 * (size_t)q;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bmat,
                const T* __restrict__ cmat, const float* __restrict__ d_skip, T* __restrict__ y,
                float* __restrict__ final_state, int S, int H, int P, int N, int q) {
  extern __shared__ float sm[];
  const int ldn = N + 1, ldg = q + 1;
  float* Bs = sm;                // [q][N + 1]
  float* Cs = Bs + q * ldn;      // [q][N + 1]
  float* Xs = Cs + q * ldn;      // [q][P]   x * dt
  float* St = Xs + q * P;        // [N][P]   the carried state
  float* G = St + N * P;         // [ROWS][q + 1] decayed scores of one row tile
  float* dts = G + ROWS * ldg;   // [q] dt
  float* dac = dts + q;          // [q] cumulative da within the chunk
  float* efs = dac + q;          // [q] exp(dac_i): decay from the chunk's start
  float* dte = efs + q;          // [q] exp(dac_last - dac_j): decay to its end

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H, h = blockIdx.x % H;
  const float a = -expf(a_log[h]);
  const float dsk = d_skip[h];
  for (int e = tid; e < N * P; e += NT) St[e] = 0.f;

  const int nc = S / q;
  for (int ci = 0; ci < nc; ++ci) {
    const long row0 = (long)bi * S + (long)ci * q;   // token index of the chunk's first row
    for (int j = tid; j < q; j += NT) dts[j] = dt[(row0 + j) * H + h];
    for (int e = tid; e < q * N; e += NT) {
      const int j = e / N, n = e - j * N;
      Bs[j * ldn + n] = repro::ld(bmat, row0 * N + e);
      Cs[j * ldn + n] = repro::ld(cmat, row0 * N + e);
    }
    __syncthreads();
    for (int e = tid; e < q * P; e += NT) {
      const int j = e / P, pp = e - j * P;
      Xs[e] = repro::ld(x, ((row0 + j) * H + h) * P + pp) * dts[j];
    }
    if (tid < 32) {   // cumulative sum of da = -exp(a_log) * dt: 4 rows a lane, then a warp scan
      float v[4], run = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = tid * 4 + t;
        run += j < q ? a * dts[j] : 0.f;
        v[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = tid * 4 + t;
        if (j < q) dac[j] = excl + v[t];
      }
    }
    __syncthreads();
    const float last = dac[q - 1];
    for (int j = tid; j < q; j += NT) {
      efs[j] = expf(dac[j]);
      dte[j] = expf(last - dac[j]);
    }
    __syncthreads();

    for (int r0 = 0; r0 < q; r0 += ROWS) {
      const int jmax = min(q, r0 + ROWS);   // L is zero right of the tile's last row
      const int ty = tid >> 4, tx = tid & 15;
      const int i0 = r0 + 2 * ty;           // this thread's rows: i0, i0 + 1
      const float* c0 = Cs + min(i0, q - 1) * ldn;
      const float* c1 = Cs + min(i0 + 1, q - 1) * ldn;
      {  // G[i - r0][j] = (C_i . B_j) * exp(dac_i - dac_j) for j <= i, else 0
        float acc[2][8];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[0][k] = acc[1][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float u0 = c0[n], u1 = c1[n];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int j = tx + 16 * k;
            if (j < jmax) {
              const float w = Bs[j * ldn + n];
              acc[0][k] += u0 * w;
              acc[1][k] += u1 * w;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + r;
          if (i < jmax) {
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int j = tx + 16 * k;
              if (j < jmax) G[(i - r0) * ldg + j] = j <= i ? acc[r][k] * expf(dac[i] - dac[j]) : 0.f;
            }
          }
        }
      }
      __syncthreads();
      {  // y = G (x dt) + exp(dac_i) (C_i state) + x d_skip for the tile's rows
        float off[2][4], dg[2][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) off[0][k] = off[1][k] = dg[0][k] = dg[1][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float u0 = c0[n], u1 = c1[n];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int pp = tx + 16 * k;
            if (pp < P) {
              const float w = St[n * P + pp];
              off[0][k] += u0 * w;
              off[1][k] += u1 * w;
            }
          }
        }
        const float* g0 = G + (2 * ty) * ldg;
        const float* g1 = g0 + ldg;
        for (int j = 0; j < jmax; ++j) {    // G's zeros past each row add nothing
          const float v0 = g0[j], v1 = g1[j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int pp = tx + 16 * k;
            if (pp < P) {
              const float w = Xs[j * P + pp];
              dg[0][k] += v0 * w;
              dg[1][k] += v1 * w;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + r;
          if (i < jmax) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int pp = tx + 16 * k;
              if (pp < P) {
                const long o = ((row0 + i) * H + h) * P + pp;
                repro::st(y, o, (dg[r][k] + off[r][k] * efs[i]) + repro::ld(x, o) * dsk);
              }
            }
          }
        }
      }
      __syncthreads();   // G is rewritten by the next tile
    }

    {  // state = state * exp(dac_last) + (B o dte)^T (x dt)
      const int ty = tid >> 3, tx = tid & 7;   // 32 x 8 threads: n = 4 ty + r, p = tx + 8 k
      const float decay = expf(last);
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
      for (int j = 0; j < q; ++j) {
        const float e = dte[j];
        float u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 4 * ty + r;
          u[r] = n < N ? Bs[j * ldn + n] * e : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int pp = tx + 8 * k;
          if (pp < P) {
            const float w = Xs[j * P + pp];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][k] += u[r] * w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 4 * ty + r;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int pp = tx + 8 * k;
          if (n < N && pp < P) St[n * P + pp] = St[n * P + pp] * decay + acc[r][k];
        }
      }
    }
    __syncthreads();   // the next chunk restages B, C and x
  }

  float* fs = final_state + (long)blockIdx.x * N * P;   // (B, H, N, P)
  for (int e = tid; e < N * P; e += NT) fs[e] = St[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* b, const void* c,
           const float* d_skip, void* y, float* state, int B, int S, int H, int P, int N, int q,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(q, N, P);
  cudaError_t err = repro::allow_smem(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(b), static_cast<const T*>(c),
      d_skip, static_cast<T*>(y), state, S, H, P, N, q);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P); dt (B, S, H) float32; a_log, d_skip (H,) float32; b, c (B, S, N)
// in x's dtype; y like x; state (B, H, N, P) float32, written after the last chunk.
// q: chunk length, 1..128, dividing S; N <= 128; P <= 64.
// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y alike).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log, const void* b,
                            const void* c, const void* d_skip, void* y, void* state, int B,
                            int S, int H, int P, int N, int q, int dtype, void* stream) {
  if (q <= 0 || q > QMAX || N <= 0 || N > NMAX || P <= 0 || P > PMAX || S % q != 0)
    return (int)cudaErrorInvalidValue;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a_log);
  const float* f_d = static_cast<const float*>(d_skip);
  float* f_st = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, f_dt, f_a, b, c, f_d, y, f_st, B, S, H, P, N, q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f_dt, f_a, b, c, f_d, y, f_st, B, S, H, P, N, q, st);
  return (int)cudaErrorInvalidValue;
}
