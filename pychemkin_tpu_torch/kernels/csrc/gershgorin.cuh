// K8 gershgorin_rate: the Gershgorin bound of the reactor's closed-form
// Jacobian at each lane's state, y [B, N] -> rate [B] = max_i sum_j |J_ij|.
//
// Replaces ops/odeint.py:92 gershgorin_rate applied to the closed-form
// Jacobian at a lane state: the scheduler's cost predictor at t = 0
// (schedule/predictor.py:48-55), the solve profile's sample at the final
// state (ops/odeint.py:720-725) and the sweep kernel's harvest
// (ops/reactors.py:596-601). J is the full N x N d(rhs)/dy of the reactor
// code, T row and column included, unscaled.
//
// Bound on the H100: by operations. A lane writes 8 bytes, where K2 writes
// its N^2 doubles of J (95.6 MB at B=4096 for grisyn) to give the same
// rate; what is left is K2's arithmetic (the rate ladder, the triple
// products, the chain rule), whose FP64 count exceeds the bytes the lane
// must move by two orders. Design: one 256-thread block per lane runs K2's
// lane body (chem::chem_lane<true, PROB, XK>) with a sink that keeps J in
// the block's shared memory (N^2 doubles, 23.3 KB for grisyn, after the
// lane body's own); after a barrier one thread per row sums |J_ij| over j
// in ascending order, and the block maximum takes warp shuffles and one
// pass over the warps' partials. No atomics: the result is deterministic,
// and a NaN anywhere in J reaches the rate (maxp keeps NaN, as jnp.max
// does). GM puts the lane's working set (the lane body's, J, f and the
// partials) in its slice of a device-memory workspace, for mechanisms too
// large for shared memory. PRF (solve_batch's reactors) takes each lane's
// time and profiles, as K2's PRF instantiation does, so the rate is the
// one of the profile Jacobian the reference samples at t_final
// (ops/odeint.py:720-725 with solve_batch's jac_fn).
#pragma once
#include "chem.cuh"

namespace chem {

// Sink of K8: J row-major in the block's shared memory.
struct JacToShared {
  double* J;
  int N;
  __device__ void operator()(int i, int j, double v) const { J[i * N + j] = v; }
};

// Doubles of dynamic shared memory of one K8 lane: the lane body's, then
// J [N, N], f [N] and a 32-double reduction buffer.
__host__ __device__ inline int gershgorin_smem_doubles(const MechView* m) {
  const int N = m->KK + 1;
  return lane_smem_doubles(m->KK, m->II, m->n_tb, m->n_plog, true) + N * N +
         N + 32;
}

// The arguments of a K8 launch beyond the mechanism: states, constraint
// values (unused with PRF), the rates, the lanes' times and profiles
// (PRF), the workspace (GM).
struct GershCall {
  const double *y, *cval;
  double* rate;
  const double* t;
  ProfileView prf;
  double* ws;
  int B, problem;
  void* stream;
};

template <int PROB, bool XK, bool PRF, bool GM>
__global__ void gershgorin_kernel(MechView m, const double* __restrict__ y,
                                  const double* __restrict__ cval,
                                  double* __restrict__ rate, int B,
                                  const double* __restrict__ t,
                                  ProfileView prf, double* ws) {
  const int b = blockIdx.x;
  if (b >= B) return;
  CHEM_LANE_BASE(GM, sm, ws, b, gershgorin_smem_doubles(&m));
  const int N = m.KK + 1;
  double* Js = sm + lane_smem_doubles(m.KK, m.II, m.n_tb, m.n_plog, true);
  double* fs = Js + N * N;
  double* red = fs + N;
  LaneTerms lt;
  double c;
  if constexpr (PRF) {
    lt = lane_terms<PROB>(prf, b, t[b]);
    c = lt.c;
  } else {
    c = cval[b];
  }
  chem_lane<true, PROB, XK, PRF>(m, y + (size_t)b * N, c, sm, fs,
                                 JacToShared{Js, N}, PRF ? &lt : nullptr);
  __syncthreads();
  const int tid = threadIdx.x, nt = blockDim.x;
  double v = 0.0;  // row sums are >= 0 (or NaN)
  for (int i = tid; i < N; i += nt) {
    const double* row = Js + i * N;
    double s = 0.0;
    for (int j = 0; j < N; ++j) s += fabs(row[j]);
    v = maxp(v, s);
  }
  for (int o = 16; o > 0; o >>= 1)
    v = maxp(v, __shfl_down_sync(FULL_MASK, v, o));
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    double r = red[0];
    for (int w = 1; w < (nt >> 5); ++w) r = maxp(r, red[w]);
    rate[b] = r;
  }
}

template <int PROB, bool XK, bool PRF, bool GM>
int gershgorin_launch_as(const MechView* m, const GershCall& c) {
  const int threads = 256;
  const size_t smem = GM ? 0 : sizeof(double) * gershgorin_smem_doubles(m);
  if (!GM) {
    cudaError_t err = cudaFuncSetAttribute(
        gershgorin_kernel<PROB, XK, PRF, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  CHEM_LAUNCH(c.B, threads, smem, c.stream,
              gershgorin_kernel<PROB, XK, PRF, GM>)(
      *m, c.y, c.cval, c.rate, c.B, c.t, c.prf, c.ws);
  return (int)cudaGetLastError();
}

template <bool XK, bool PRF, bool GM>
int gershgorin_launch_xk(const MechView* m, const GershCall& c) {
  switch (c.problem) {
    case CONP: return gershgorin_launch_as<CONP, XK, PRF, GM>(m, c);
    case CONV: return gershgorin_launch_as<CONV, XK, PRF, GM>(m, c);
    case CONP_TGIV: return gershgorin_launch_as<CONP_TGIV, XK, PRF, GM>(m, c);
    case CONV_TGIV: return gershgorin_launch_as<CONV_TGIV, XK, PRF, GM>(m, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One K8 launch of the (PRF, GM) variant with the mechanism's lane body.
template <bool PRF, bool GM>
int gershgorin_launch(const MechView* m, const GershCall& c) {
  return extended(m) ? gershgorin_launch_xk<true, PRF, GM>(m, c)
                     : gershgorin_launch_xk<false, PRF, GM>(m, c);
}

// K8's PRF variants (gershgorin_prf.cu), built by their own nvcc.
int gershgorin_launch_prf(const MechView* m, const GershCall& c);

}  // namespace chem
