// K12 block_thomas: the block-tridiagonal solve of the flame's Newton
// system, B_i x_{i-1} + A_i x_i + C_i x_{i+1} = d_i (i = 0..N-1, B_0 and
// C_{N-1} ignored), B, A, C [N, M, M] and d [N, M] -> x [N, M].
//
// Replaces the JAX package's ops/blocktridiag.py:20-53 (the block Thomas
// scans) with ops/linalg.py:178 factor / :345 solve_factored on its CPU f64
// configuration, i.e. LU with partial pivoting (jax.scipy.linalg.lu_factor
// and lu_solve).
//
// Bound on the H100: by operations, and by the sweep's dependence chain:
// the launch reads 3 N M^2 + N M doubles and writes N M; step i forms
// A_i - B_i C'_{i-1} and B_i d'_{i-1} (2 M^3 + 2 M^2 flops) and eliminates
// the M x M block against its M + 1 right-hand sides (~M^3 flops), and step
// i needs step i - 1. Design: one thread block runs the whole sweep in
// order: at each step its threads form the augmented block
// [A_i - B_i C'_{i-1} | C_i | d_i - B_i d'_{i-1}] in shared memory, thread
// 0 picks each column's pivot (the first entry of largest magnitude, as
// LAPACK's getrf), the threads swap and eliminate, and one thread per
// right-hand side back-substitutes; C'_i and d'_i go to the workspace, and
// the backward substitution x_i = d'_i - C'_i x_{i+1} runs in the same
// launch.
#include "chem.cuh"

namespace chem {

__global__ void block_thomas_kernel(const double* __restrict__ Bm,
                                    const double* __restrict__ Am,
                                    const double* __restrict__ Cm,
                                    const double* __restrict__ d,
                                    double* __restrict__ x, double* Cps,
                                    double* dps, int N, int M) {
  CHEM_DYN_SMEM(sm);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = 2 * M + 1;       // [Ahat | C_i | rhs]
  double* aug = sm;              // [M, W]
  double* Cp = aug + M * W;      // C'_{i-1} [M, M]
  double* dp = Cp + M * M;       // d'_{i-1} [M]
  double* xn = dp + M;           // x_{i+1} [M]
  int* piv = reinterpret_cast<int*>(xn + M);
  for (int e = tid; e < M * M; e += nt) Cp[e] = 0.0;
  for (int e = tid; e < M; e += nt) dp[e] = 0.0;
  __syncthreads();
  for (int i = 0; i < N; ++i) {
    const double* Bi = Bm + (size_t)i * M * M;
    const double* Ai = Am + (size_t)i * M * M;
    const double* Ci = Cm + (size_t)i * M * M;
    for (int e = tid; e < M * W; e += nt) {
      const int r = e / W, c = e - r * W;
      double v;
      if (c < M) {
        double s = 0.0;
        for (int k = 0; k < M; ++k) s += Bi[r * M + k] * Cp[k * M + c];
        v = Ai[r * M + c] - s;
      } else if (c < 2 * M) {
        v = Ci[r * M + (c - M)];
      } else {
        double s = 0.0;
        for (int k = 0; k < M; ++k) s += Bi[r * M + k] * dp[k];
        v = d[(size_t)i * M + r] - s;
      }
      aug[e] = v;
    }
    __syncthreads();
    for (int col = 0; col < M; ++col) {
      if (tid == 0) {
        int p = col;
        double best = fabs(aug[col * W + col]);
        for (int r = col + 1; r < M; ++r) {
          const double a = fabs(aug[r * W + col]);
          if (a > best) {
            best = a;
            p = r;
          }
        }
        piv[0] = p;
      }
      __syncthreads();
      const int p = piv[0];
      if (p != col)
        for (int c = col + tid; c < W; c += nt) {
          const double t = aug[col * W + c];
          aug[col * W + c] = aug[p * W + c];
          aug[p * W + c] = t;
        }
      __syncthreads();
      const int rows = M - col - 1, cols = W - col - 1;
      for (int e = tid; e < rows * cols; e += nt) {
        const int r = col + 1 + e / cols, c = col + 1 + e % cols;
        const double f = aug[r * W + col] / aug[col * W + col];
        aug[r * W + c] -= f * aug[col * W + c];
      }
      __syncthreads();
    }
    // back substitution, one thread per right-hand side (C_i's columns and
    // the rhs)
    for (int rc = tid; rc < M + 1; rc += nt) {
      for (int r = M - 1; r >= 0; --r) {
        double s = aug[r * W + M + rc];
        for (int c = r + 1; c < M; ++c) s -= aug[r * W + c] * aug[c * W + M + rc];
        aug[r * W + M + rc] = s / aug[r * W + r];
      }
    }
    __syncthreads();
    for (int e = tid; e < M * M; e += nt) {
      const int r = e / M, c = e - r * M;
      Cp[e] = aug[r * W + M + c];
      Cps[(size_t)i * M * M + e] = Cp[e];
    }
    for (int r = tid; r < M; r += nt) {
      dp[r] = aug[r * W + 2 * M];
      dps[(size_t)i * M + r] = dp[r];
    }
    __syncthreads();
  }
  for (int r = tid; r < M; r += nt) xn[r] = 0.0;
  __syncthreads();
  for (int i = N - 1; i >= 0; --i) {
    double v = 0.0;
    if (tid < M) {
      double s = 0.0;
      for (int c = 0; c < M; ++c) s += Cps[(size_t)i * M * M + tid * M + c] * xn[c];
      v = dps[(size_t)i * M + tid] - s;
    }
    __syncthreads();
    if (tid < M) {
      xn[tid] = v;
      x[(size_t)i * M + tid] = v;
    }
    __syncthreads();
  }
}

}  // namespace chem

// Shared memory of one K12 launch in bytes: the augmented block, C', d',
// x_{i+1} and the pivot.
static size_t block_thomas_smem(int M) {
  return sizeof(double) * ((size_t)M * (2 * M + 1) + (size_t)M * M + 2 * M) +
         sizeof(double);
}

// K12: one system of N block rows of size M; ``ws`` holds N M^2 + N M
// doubles (C'_i and d'_i). One block of 128 threads.
extern "C" int chem_block_thomas(const double* B, const double* A,
                                 const double* C, const double* d, double* x,
                                 double* ws, int N, int M, void* stream) {
  if (N <= 0 || M <= 0) return 0;
  if (ws == nullptr || M > 128) return (int)cudaErrorInvalidValue;
  const size_t smem = block_thomas_smem(M);
  cudaError_t err = cudaFuncSetAttribute(
      chem::block_thomas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  CHEM_LAUNCH(1, 128, smem, stream, chem::block_thomas_kernel)(
      B, A, C, d, x, ws, ws + (size_t)N * M * M, N, M);
  return (int)cudaGetLastError();
}
