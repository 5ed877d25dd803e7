// Lane bodies of the bordered Newton-matrix factor (K3) and solve (K4),
// shared by those kernels and by the step-round kernel K5.
//
// M = [[A, b], [c^T, d]] with A the KK x KK species block. The factor is a
// pivot-free Doolittle LU of A (the JAX package's ops/linalg.py:124
// _lu_nopivot, diagonal clamped away from zero as :119 _clamp), v = A^-1 b,
// and the clamped Schur scalar d - c.v (:249 factor_bordered); the solve is
// :274 _solve_bordered_once. The pointers are generic: K3/K4 hand the lane
// bodies device memory, K5 shared memory.
#pragma once

#include "chem.cuh"

namespace chem {

constexpr int SOLVE_MAXR = 4;  // K4's solve: KK <= 32 * SOLVE_MAXR

__device__ __forceinline__ double clamp_diag(double d) {
  return fabs(d) > 1e-30 ? d : (d >= 0.0 ? 1e-30 : -1e-30);
}

// Factor the bordered M of one lane held in shared memory, by the whole
// block: A [n x n] (row-major) is replaced by its packed L\U (unit L
// implicit; the clamped pivot is used, the unclamped one stored), x [n]
// holds b on entry and v = A^-1 b on return, cs [n] is the border row c,
// lcol [n] and red [32] are scratch. Every thread must see A, x and cs on
// entry; returns the clamped d_schur = d - c.v, the same in every thread,
// with A and x complete.
__device__ inline double bordered_factor_lane(double* A, double* x,
                                              const double* cs, double d,
                                              double* lcol, double* red,
                                              int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // pivot-free Doolittle: rank-1 Schur update of the trailing block
  for (int k = 0; k < n - 1; ++k) {
    const double piv = clamp_diag(A[k * n + k]);
    for (int i = k + 1 + tid; i < n; i += nt) lcol[i] = A[i * n + k] / piv;
    __syncthreads();
    const int w = n - 1 - k;
    for (int e = tid; e < w * w; e += nt) {
      const int i = k + 1 + e / w, j = k + 1 + e % w;
      A[i * n + j] -= lcol[i] * A[k * n + j];
    }
    for (int i = k + 1 + tid; i < n; i += nt) A[i * n + k] = lcol[i];
    __syncthreads();
  }
  // v = A^-1 b: unit-L forward sweep, then U backward sweep
  for (int k = 0; k < n - 1; ++k) {
    const double xk = x[k];
    for (int i = k + 1 + tid; i < n; i += nt) x[i] -= A[i * n + k] * xk;
    __syncthreads();
  }
  for (int k = n - 1; k >= 0; --k) {
    const double xk = x[k] / clamp_diag(A[k * n + k]);
    __syncthreads();
    if (tid == 0) x[k] = xk;
    for (int i = tid; i < k; i += nt) x[i] -= A[i * n + k] * xk;
    __syncthreads();
  }
  double part = 0.0;
  for (int i = tid; i < n; i += nt) part += cs[i] * x[i];
  const double cv = block_sum(part, red);
  return clamp_diag(d - cv);
}

__device__ __forceinline__ double pick(const double (&u)[SOLVE_MAXR], int m) {
  double s = u[0];
#pragma unroll
  for (int r = 1; r < SOLVE_MAXR; ++r)
    if (m == r) s = u[r];
  return s;
}

// Solve M x = r for one lane by one warp (lane = threadIdx.x & 31), from a
// bordered_factor_lane factor: L [n x n] packed L\U, v and c [n], the
// clamped d_schur; rb and xb [n + 1]. With ``perm`` (a factor of
// bordered_factor_pivot_lane) the species part of rb is taken in the
// factor's row order. Each thread keeps up to SOLVE_MAXR entries of the
// solution in registers; the sweeps broadcast x_k with a shuffle, so L is
// read once. All 32 threads of the warp must call it; the arrays must not
// overlap.
__device__ inline void bordered_solve_warp(const double* __restrict__ L,
                                           const double* __restrict__ v,
                                           const double* __restrict__ c,
                                           double dsch,
                                           const double* __restrict__ rb,
                                           double* __restrict__ xb, int n,
                                           int lane,
                                           const int* __restrict__ perm = nullptr) {
  double u[SOLVE_MAXR];
#pragma unroll
  for (int m = 0; m < SOLVE_MAXR; ++m) {
    const int i = lane + 32 * m;
    u[m] = i < n ? rb[perm ? perm[i] : i] : 0.0;
  }
  for (int k = 0; k < n - 1; ++k) {
    const double xk = __shfl_sync(FULL_MASK, pick(u, k >> 5), k & 31);
#pragma unroll
    for (int m = 0; m < SOLVE_MAXR; ++m) {
      const int i = lane + 32 * m;
      if (i > k && i < n) u[m] -= L[(size_t)i * n + k] * xk;
    }
  }
  for (int k = n - 1; k >= 0; --k) {
    const double xr = __shfl_sync(FULL_MASK, pick(u, k >> 5), k & 31);
    const double xk = xr / clamp_diag(L[(size_t)k * n + k]);
#pragma unroll
    for (int m = 0; m < SOLVE_MAXR; ++m) {
      const int i = lane + 32 * m;
      if (i == k) u[m] = xk;
      else if (i < k) u[m] -= L[(size_t)i * n + k] * xk;
    }
  }
  double part = 0.0;
#pragma unroll
  for (int m = 0; m < SOLVE_MAXR; ++m) {
    const int i = lane + 32 * m;
    if (i < n) part += c[i] * u[m];
  }
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL_MASK, part, o);
  const double xT = (rb[n] - part) / dsch;
#pragma unroll
  for (int m = 0; m < SOLVE_MAXR; ++m) {
    const int i = lane + 32 * m;
    if (i < n) xb[i] = u[m] - xT * v[i];
  }
  if (lane == 0) xb[n] = xT;
}

// bordered_solve_warp for any n (the lanes of a mechanism too large for
// K4's registers, KK > 32 * SOLVE_MAXR): the solution is swept in xb
// itself, row i's entry updated by lane i % 32 in the same order of k as
// the register form, with a warp barrier per step. All 32 threads of the
// warp must call it; rb and xb must not overlap.
__device__ inline void bordered_solve_warp_mem(const double* __restrict__ L,
                                               const double* __restrict__ v,
                                               const double* __restrict__ c,
                                               double dsch,
                                               const double* __restrict__ rb,
                                               double* xb, int n, int lane,
                                               const int* __restrict__ perm = nullptr) {
  for (int i = lane; i < n; i += 32) xb[i] = rb[perm ? perm[i] : i];
  __syncwarp();
  for (int k = 0; k < n - 1; ++k) {
    const double xk = xb[k];
    for (int i = k + 1 + lane; i < n; i += 32) xb[i] -= L[(size_t)i * n + k] * xk;
    __syncwarp();
  }
  for (int k = n - 1; k >= 0; --k) {
    const double xk = xb[k] / clamp_diag(L[(size_t)k * n + k]);
    __syncwarp();
    if (lane == 0) xb[k] = xk;
    for (int i = lane; i < k; i += 32) xb[i] -= L[(size_t)i * n + k] * xk;
    __syncwarp();
  }
  double part = 0.0;
  for (int i = lane; i < n; i += 32) part += c[i] * xb[i];
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL_MASK, part, o);
  const double xT = (rb[n] - part) / dsch;
  for (int i = lane; i < n; i += 32) xb[i] = xb[i] - xT * v[i];
  if (lane == 0) xb[n] = xT;
  __syncwarp();
}

// Index of the row of largest |A[i][col]| over rows k <= i < n (the first
// one on ties, LAPACK idamax's choice), by the whole block; the same in
// every thread. rv and ri [32] are scratch.
__device__ inline int block_argmax_col(const double* A, int col, int k, int n,
                                       int stride, double* rv, int* ri) {
  const int tid = threadIdx.x, nt = blockDim.x;
  double best = -1.0;
  int bi = n;
  for (int i = k + tid; i < n; i += nt) {
    const double a = fabs(A[i * stride + col]);
    if (a > best) { best = a; bi = i; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const double ob = __shfl_down_sync(FULL_MASK, best, o);
    const int oi = __shfl_down_sync(FULL_MASK, bi, o);
    if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
  }
  const int lane = tid & 31, w = tid >> 5;
  __syncthreads();
  if (lane == 0) { rv[w] = best; ri[w] = bi; }
  __syncthreads();
  best = rv[0];
  bi = ri[0];
  for (int i = 1; i < (nt >> 5); ++i)
    if (rv[i] > best || (rv[i] == best && ri[i] < bi)) { best = rv[i]; bi = ri[i]; }
  return bi < n ? bi : k;
}

// The pivoted counterpart of bordered_factor_lane, for a general bordered
// Newton matrix (the steady-state solvers): A [n x n] is replaced by the
// packed L\U of P A with partial pivoting (row exchanges as LAPACK getrf,
// a zero pivot column left unscaled), perm [n] receives the row order
// (row i of P A is row perm[i] of A), bv [n] holds b on entry and
// v = A^-1 b on return (solved with the clamped diagonal, as the
// reference's bordered path), tmp [n], rv [32], ri [32] and red [32] are
// scratch. Every thread must see A, bv and cs on entry; returns the
// clamped d_schur = d - c.v in every thread, with A, perm and bv
// complete.
__device__ inline double bordered_factor_pivot_lane(double* A, int* perm,
                                                    double* bv,
                                                    const double* cs,
                                                    double d, double* tmp,
                                                    double* rv, int* ri,
                                                    double* red, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < n; i += nt) perm[i] = i;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const int p = block_argmax_col(A, k, k, n, n, rv, ri);
    if (p != k) {
      for (int j = tid; j < n; j += nt) {
        const double t = A[k * n + j];
        A[k * n + j] = A[p * n + j];
        A[p * n + j] = t;
      }
      if (tid == 0) {
        const int t = perm[k];
        perm[k] = perm[p];
        perm[p] = t;
      }
    }
    __syncthreads();
    if (k == n - 1) break;
    const double piv0 = A[k * n + k];
    const double piv = piv0 == 0.0 ? 1.0 : piv0;
    for (int i = k + 1 + tid; i < n; i += nt) tmp[i] = A[i * n + k] / piv;
    __syncthreads();
    const int w = n - 1 - k;
    for (int e = tid; e < w * w; e += nt) {
      const int i = k + 1 + e / w, j = k + 1 + e % w;
      A[i * n + j] -= tmp[i] * A[k * n + j];
    }
    for (int i = k + 1 + tid; i < n; i += nt) A[i * n + k] = tmp[i];
    __syncthreads();
  }
  // v = A^-1 b: b in the factor's row order, then the two sweeps
  for (int i = tid; i < n; i += nt) tmp[i] = bv[perm[i]];
  __syncthreads();
  for (int i = tid; i < n; i += nt) bv[i] = tmp[i];
  __syncthreads();
  for (int k = 0; k < n - 1; ++k) {
    const double xk = bv[k];
    for (int i = k + 1 + tid; i < n; i += nt) bv[i] -= A[i * n + k] * xk;
    __syncthreads();
  }
  for (int k = n - 1; k >= 0; --k) {
    const double xk = bv[k] / clamp_diag(A[k * n + k]);
    __syncthreads();
    if (tid == 0) bv[k] = xk;
    for (int i = tid; i < k; i += nt) bv[i] -= A[i * n + k] * xk;
    __syncthreads();
  }
  double part = 0.0;
  for (int i = tid; i < n; i += nt) part += cs[i] * bv[i];
  const double cv = block_sum(part, red);
  return clamp_diag(d - cv);
}

}  // namespace chem
