// K3 bordered_factor: forms M = I - hg J per lane and factors it by
// elimination of the T border over a pivot-free LU of the KK x KK species
// block.
//
// Replaces the JAX package's ops/odeint.py:482 (M = I - h gamma J),
// ops/linalg.py:249 factor_bordered, :124 _lu_nopivot (clamped diagonal,
// :119 _clamp) and the v = A^-1 b sweep of :151 _solve_nopivot; the
// d_schur clamp is :269-271.
//
// Bound on the H100: reading J (N^2 doubles) and writing the packed LU
// (KK^2) moves ~2 N^2 doubles per lane, 188 MB at B=4096 for grisyn,
// >= 56 us at 3.35 TB/s; the LU's ~KK^3/3 multiply-adds are ~0.2 GFLOP.
// Design: one block per lane holds the whole species block in shared memory
// (22.5 KB for KK=53) and does the KK rank-1 Schur updates there, so the
// LU costs no device-memory traffic beyond one read of J and one write of
// the factor. The lane body is chem::bordered_factor_lane (linalg.cuh),
// which K5 runs on the Newton matrix it forms in shared memory. A species
// block too large for shared memory (GM) is formed and factored in place in
// the output arrays.
#include "linalg.cuh"

namespace {

// GM: the species block is formed and factored in place in the lane's
// slice of ``lu`` (and v, c in theirs), for a block too large for shared
// memory, which then holds only the column and reduction scratch.
template <bool GM>
__global__ void bordered_factor_kernel(const double* __restrict__ J,
                                       const double* __restrict__ hg,
                                       double* lu, double* v, double* c,
                                       double* __restrict__ dsch, int B,
                                       int N) {
  CHEM_DYN_SMEM(sm);
  const int b = blockIdx.x;
  if (b >= B) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = N - 1;
  double* A = GM ? lu + (size_t)b * n * n : sm;
  double* x = GM ? v + (size_t)b * n : A + n * n;
  double* cs = GM ? c + (size_t)b * n : x + n;
  double* lcol = GM ? sm : cs + n;
  double* red = lcol + n;
  const double* Jb = J + (size_t)b * N * N;
  const double h = hg[b];

  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e - i * n;
    A[e] = (i == j ? 1.0 : 0.0) - h * Jb[i * N + j];
  }
  for (int i = tid; i < n; i += nt) {
    x[i] = 0.0 - h * Jb[i * N + n];
    cs[i] = 0.0 - h * Jb[n * N + i];
  }
  const double d = 1.0 - h * Jb[n * N + n];
  __syncthreads();
  const double ds = chem::bordered_factor_lane(A, x, cs, d, lcol, red, n);
  if (GM) {
    if (tid == 0) dsch[b] = ds;
    return;
  }

  double* lub = lu + (size_t)b * n * n;
  for (int e = tid; e < n * n; e += nt) lub[e] = A[e];
  for (int i = tid; i < n; i += nt) {
    v[(size_t)b * n + i] = x[i];
    c[(size_t)b * n + i] = cs[i];
  }
  if (tid == 0) dsch[b] = ds;
}

template <bool GM>
int launch_factor(const double* J, const double* hg, double* lu, double* v,
                  double* c, double* dsch, int B, int N, void* stream) {
  const int n = N - 1;
  const int threads = 256;
  const size_t smem =
      sizeof(double) * (GM ? (size_t)n + 32 : (size_t)n * n + 3 * n + 32);
  cudaError_t err = cudaFuncSetAttribute(
      bordered_factor_kernel<GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  CHEM_LAUNCH(B, threads, smem, stream, bordered_factor_kernel<GM>)(J, hg, lu, v, c, dsch, B, N);
  return (int)cudaGetLastError();
}

}  // namespace

// ``gm``: factor in place in lu, v and c (a species block too large for
// shared memory).
extern "C" int chem_bordered_factor(const double* J, const double* hg,
                                    double* lu, double* v, double* c,
                                    double* dsch, int B, int N, int gm,
                                    void* stream) {
  if (B <= 0) return 0;
  return gm ? launch_factor<true>(J, hg, lu, v, c, dsch, B, N, stream)
            : launch_factor<false>(J, hg, lu, v, c, dsch, B, N, stream);
}
