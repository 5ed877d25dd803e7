// K4 bordered_solve: x = M^-1 r from the K3 factor, r [B, N] -> x [B, N].
//
// Replaces the JAX package's ops/linalg.py:151 _solve_nopivot (unit-L
// forward and U backward sweeps with the clamped diagonal), :232
// _block_solve and :274 _solve_bordered_once (x_T = (r_T - c.u) / d_schur,
// x_Y = u - x_T v), called through :285 solve_bordered.
//
// Bound on the H100: every call reads the packed LU, KK^2 doubles per lane
// (92 MB at B=4096 for grisyn), >= 27 us at 3.35 TB/s; its ~KK^2
// multiply-adds are far below FP64 peak. ~8 calls per step attempt (the
// Newton directions and the error filter). Design: one warp per lane, each
// thread keeping up to MAXR entries of the solution in registers; the
// sweeps broadcast x_k with a shuffle and update the lanes' rows in
// parallel, so the LU is read once per call and nothing else is staged
// through memory. The lane body is chem::bordered_solve_warp
// (linalg.cuh), which K5 runs on its shared-memory factor.
#include "linalg.cuh"

namespace {

// MEM: the solve for any n, swept in x (linalg.cuh
// bordered_solve_warp_mem), where the register form's 32 * SOLVE_MAXR rows
// do not reach.
template <bool MEM>
__global__ void bordered_solve_kernel(const double* __restrict__ lu,
                                      const double* __restrict__ v,
                                      const double* __restrict__ c,
                                      const double* __restrict__ dsch,
                                      const double* __restrict__ r,
                                      double* __restrict__ x, int B, int N) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp leaves together
  const int n = N - 1;
  if constexpr (MEM)
    chem::bordered_solve_warp_mem(lu + (size_t)b * n * n, v + (size_t)b * n,
                                  c + (size_t)b * n, dsch[b], r + (size_t)b * N,
                                  x + (size_t)b * N, n, lane);
  else
    chem::bordered_solve_warp(lu + (size_t)b * n * n, v + (size_t)b * n,
                              c + (size_t)b * n, dsch[b], r + (size_t)b * N,
                              x + (size_t)b * N, n, lane);
}

}  // namespace

extern "C" int chem_bordered_solve(const double* lu, const double* v,
                                   const double* c, const double* dsch,
                                   const double* r, double* x, int B, int N,
                                   void* stream) {
  if (B <= 0) return 0;
  const int warps = 4;
  const int blocks = (B + warps - 1) / warps;
  if (N - 1 > 32 * chem::SOLVE_MAXR)
    CHEM_LAUNCH(blocks, 32 * warps, 0, stream, bordered_solve_kernel<true>)(lu, v, c, dsch, r, x, B, N);
  else
    CHEM_LAUNCH(blocks, 32 * warps, 0, stream, bordered_solve_kernel<false>)(lu, v, c, dsch, r, x, B, N);
  return (int)cudaGetLastError();
}
