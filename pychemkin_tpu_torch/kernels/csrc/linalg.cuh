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
// clamped d_schur; rb and xb [n + 1]. Each thread keeps up to SOLVE_MAXR
// entries of the solution in registers; the sweeps broadcast x_k with a
// shuffle, so L is read once. All 32 threads of the warp must call it;
// the five arrays must not overlap.
__device__ inline void bordered_solve_warp(const double* __restrict__ L,
                                           const double* __restrict__ v,
                                           const double* __restrict__ c,
                                           double dsch,
                                           const double* __restrict__ rb,
                                           double* __restrict__ xb, int n,
                                           int lane) {
  double u[SOLVE_MAXR];
#pragma unroll
  for (int m = 0; m < SOLVE_MAXR; ++m) {
    const int i = lane + 32 * m;
    u[m] = i < n ? rb[i] : 0.0;
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

}  // namespace chem
