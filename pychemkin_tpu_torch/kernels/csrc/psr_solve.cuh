// K7 psr_solve: one whole PSR steady-state solve per lane in one launch.
//
// Replaces the JAX package's ops/psr.py:273 solve_psr with :148
// _newton_phase, :225 _pseudo_transient_phase, :101 make_rhs and the
// finish (:350-379), on the exact-path linear algebra of ops/linalg.py
// (:249 factor_bordered over a pivoted LU of the species block, :431
// solve_with_info with its full-system residual check): what the port's
// plain twin ops/psr.py:solve_psr_plain does to one lane. Where the
// reference takes jax.jacfwd over its closed-form kinetics rule, the
// Jacobian is CONP's closed form (chem_lane<true, CONP>) wrapped by the
// PSR flow shell (chem.cuh psr_shell; ops/jacobian.py:psr_rhs_jac). At the
// lane's explicit pressure the PLOG rows and fractional orders come in
// through chem_lane (its XK body, for mechanisms that have them).
//
// Phases, all on the card with no host sync: (a) the direct Newton on the
// tau-scaled residual, up to n_newton iterations: f and J, non-finite
// J -> 0 plus 1e-14 I, non-finite r -> 1e6, the pivoted bordered factor of
// the species block with the T row/column through the Schur scalar, the
// solve, the residual check against the kept full matrix (`unstable`),
// damping (150 K, 0.2), clips, the step norm (T over 1e3, weights at the
// new state); (b) only where (a) did not converge, n_pseudo implicit-Euler
// steps of the transient RHS with 6 fixed inner iterations each and the
// adaptive stride, then (c) the polish Newton; (d) the finish: exit state,
// rho, tau and V, the residual norm weighted at the un-normalised state,
// the status in the reference's order.
//
// Bound on the H100: a lane reads its inputs (~2 KK + 9 doubles) and writes
// its result (~KK + 10) once, so the FP64 operations of the lane bodies
// bound it: per Newton iteration one K2 body and a pivoted K3 body plus one
// solve, per pseudo-transient step one K2 body, one factor and 6 x (K1 body
// + solve). Design: one thread block per lane, the lane's whole state in
// shared memory (chem_lane's scratch, whose last block D holds the species
// block for the in-place factor, plus the kept N x N matrix and vectors);
// the threads per block follow N (64 up to N = 32, else 256: a narrow
// mechanism would leave most of 256 threads idle). Every loop exit (Newton
// converged or out of iterations, the pseudo-transient phase skipped) is
// decided from block sums or values every thread holds, so control flow is
// uniform across the block.
//
// FAULT reads a per-lane fault flag (the reference's linalg_unstable
// injection, ops/psr.py:298-301 -> ops/linalg.py:479-487): on a flagged
// lane each Newton direction is scaled by 1e8 after the residual check and
// the solve is reported unstable, so the lane fails to converge and the
// rescue ladder heals it. GM keeps the lane's working set in its slice of
// a device-memory workspace and solves with linalg.cuh's
// bordered_solve_warp_mem (any KK), for mechanisms too large for shared
// memory. This header holds the kernel template psr_kernel<XK, FAULT, GM>;
// psr_solve.cu instantiates the shared-memory variants and the C entry
// point, psr_solve_gm.cu the GM ones.
#pragma once

#include "linalg.cuh"

// The lanes (ops/psr.py PSRArgs and the guess), the PSRSolution fields,
// then the controls; kernels/__init__.py builds the same layout with
// ctypes.
struct PsrArgs {
  const double *P, *Y_in, *h_in, *tau, *volume, *mdot, *qloss, *T_fixed, *y0;
  double *T, *Y, *rho, *tau_out, *volume_out, *residual;
  unsigned char* converged;
  long long *n_newton, *n_direct, *n_polish;
  int* status;
  const int* fault;   // [B] linalg_unstable flags (null: no fault active)
  double* ws;         // GM: psr_lane_doubles per lane (null: shared memory)
  double ss_atol, ss_rtol, dt0, up, down, dt_min, dt_max, T_max,
      species_floor;
  int n_newton_max, n_pseudo, mode, energy;
};

namespace psr {

using chem::maxp;
using chem::minp;

constexpr double TINY = 1e-30;
constexpr double T_SCALE = 1e3;
constexpr int PT_INNER = 6;
// SolveStatus codes (resilience/status.py)
constexpr int ST_OK = 0, ST_TOL_NOT_MET = 1, ST_LINALG_UNSTABLE = 5,
              ST_NONFINITE = 6;

__device__ __forceinline__ double clipd(double x, double lo, double hi) {
  return minp(maxp(x, lo), hi);
}

// Shared memory of one lane beyond chem_lane's (whose last block D is the
// species block A of the factor).
struct Work {
  double *A, *Jm, *y, *yc, *ybuf, *f, *fs, *rhs, *x, *Yin, *bv, *cs, *tmp,
      *rv, *red;
  int *perm, *ri;
};

__host__ __device__ inline int work_doubles(int KK) {
  const int N = KK + 1;
  return N * N + 7 * N + 5 * KK + 64;
}

// Doubles of one lane's working set: chem_lane's with its D block, then
// the Work block.
__host__ __device__ inline int psr_lane_doubles(const chem::MechView* m) {
  return chem::lane_smem_doubles(m->KK, m->II, m->n_tb, m->n_plog, true) +
         work_doubles(m->KK);
}

__device__ inline Work work_layout(double* sm, const chem::MechView& m) {
  const int KK = m.KK, N = KK + 1;
  Work W;
  W.A = sm + chem::lane_smem_doubles(KK, m.II, m.n_tb, m.n_plog, false);
  W.red = W.A - 32;
  double* p = W.A + KK * KK;
  W.Jm = p; p += N * N;
  W.y = p; p += N;
  W.yc = p; p += N;
  W.ybuf = p; p += N;
  W.f = p; p += N;
  W.fs = p; p += N;
  W.rhs = p; p += N;
  W.x = p; p += N;
  W.Yin = p; p += KK;
  W.bv = p; p += KK;
  W.cs = p; p += KK;
  W.tmp = p; p += KK;
  W.perm = reinterpret_cast<int*>(p); p += KK;
  W.rv = p; p += 32;
  W.ri = reinterpret_cast<int*>(p);
  return W;
}

// f (into W.f) and, with JAC, J (into W.Jm) of the transient RHS, or with
// ``scaled`` of the tau-scaled residual, at the state y; returns tau.
template <bool JAC, bool XK>
__device__ double psr_eval(const chem::MechView& m, double* sm, const Work& W,
                           const double* y, const chem::PsrLane& ps,
                           bool scaled) {
  const int tid = threadIdx.x, nt = blockDim.x, KK = m.KK, N = KK + 1;
  for (int i = tid; i < N; i += nt)
    W.ybuf[i] = (i == KK && ps.tgiv) ? ps.T_fixed : y[i];
  __syncthreads();
  chem::chem_lane<JAC, chem::CONP, XK>(m, W.ybuf, ps.P, sm, W.f,
                                   chem::JacToGlobal{W.Jm, N});
  __syncthreads();
  const double tau = chem::psr_shell<JAC>(m, W.ybuf, sm, W.f, W.Jm, ps,
                                          scaled, W.red, W.fs);
  __syncthreads();
  return tau;
}

// The bordered factor of the matrix in W.Jm (species block into W.A, border
// column into W.bv, border row into W.cs); returns d_schur.
__device__ inline double factor_jm(const chem::MechView& m, const Work& W) {
  const int tid = threadIdx.x, nt = blockDim.x, KK = m.KK, N = KK + 1;
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e - i * N;
    const double v = W.Jm[e];
    if (i < KK && j < KK) W.A[i * KK + j] = v;
    else if (i < KK) W.bv[i] = v;
    else if (j < KK) W.cs[j] = v;
  }
  __syncthreads();
  return chem::bordered_factor_pivot_lane(W.A, W.perm, W.bv, W.cs,
                                          W.Jm[KK * N + KK], W.tmp, W.rv,
                                          W.ri, W.red, KK);
}

// x = M^-1 rhs on warp 0, from factor_jm's factor (GM: the solve for any
// KK).
template <bool GM>
__device__ inline void solve_jm(const chem::MechView& m, const Work& W,
                                double dsch) {
  if ((threadIdx.x >> 5) == 0) {
    if constexpr (GM)
      chem::bordered_solve_warp_mem(W.A, W.bv, W.cs, dsch, W.rhs, W.x, m.KK,
                                    threadIdx.x & 31, W.perm);
    else
      chem::bordered_solve_warp(W.A, W.bv, W.cs, dsch, W.rhs, W.x, m.KK,
                                threadIdx.x & 31, W.perm);
  }
  __syncthreads();
}

__device__ inline void clip_state(double* y, int i, int KK, double floor_,
                                  double T_max) {
  y[i] = i < KK ? clipd(y[i], floor_, 1.0) : clipd(y[i], 150.0, T_max);
}

struct NewtonOut {
  bool conv, unstable;
  long long it;
};

// The damped Newton (ops/psr.py:newton_phase) from the state in W.y,
// updated in place; ``flt`` (FAULT only): the lane's injected instability.
template <bool XK, bool FAULT, bool GM>
__device__ NewtonOut newton_phase(const chem::MechView& m, double* sm,
                                  const Work& W, const chem::PsrLane& ps,
                                  const PsrArgs& a, bool flt) {
  const int tid = threadIdx.x, nt = blockDim.x, KK = m.KK, N = KK + 1;
  NewtonOut o{false, false, 0};
  while (!o.conv && o.it < a.n_newton_max) {
    psr_eval<true, XK>(m, sm, W, W.y, ps, true);
    for (int e = tid; e < N * N; e += nt) {
      const int i = e / N, j = e - i * N;
      const double v = W.Jm[e];
      W.Jm[e] = (isfinite(v) ? v : 0.0) + (i == j ? 1e-14 : 0.0);
    }
    for (int i = tid; i < N; i += nt)
      W.rhs[i] = -(isfinite(W.f[i]) ? W.f[i] : 1e6);
    __syncthreads();
    const double dsch = factor_jm(m, W);
    solve_jm<GM>(m, W, dsch);
    // the full system's residual, the step's damping and clip
    double p_r = 0.0, p_b = 0.0, p_mY = 0.0;
    for (int i = tid; i < N; i += nt) {
      double acc = W.rhs[i];
      for (int j = 0; j < N; ++j) acc -= W.Jm[i * N + j] * W.x[j];
      p_r += acc * acc;
      p_b += W.rhs[i] * W.rhs[i];
      if (i < KK) {
        const double xi = (FAULT && flt) ? W.x[i] * 1e8 : W.x[i];
        p_mY = maxp(p_mY, fabs(isfinite(xi) ? xi : 0.0));
      }
    }
    const double rn = sqrt(chem::block_sum(p_r, W.red));
    const double bn = sqrt(chem::block_sum(p_b, W.red));
    const double mY = chem::block_max(p_mY, W.red);
    bool uns = !(rn <= 1e-4 * bn + 1e-300);
    if (FAULT && flt) {
      // the injected unstable factor: the direction scaled far off after
      // the residual check, and the flag forced
      for (int i = tid; i < N; i += nt) W.x[i] *= 1e8;
      __syncthreads();
      uns = true;
    }
    const double dT = isfinite(W.x[KK]) ? W.x[KK] : 0.0;
    const double aT = 150.0 / maxp(fabs(dT), TINY);
    const double aY = 0.2 / maxp(mY, TINY);
    const double alpha = minp(1.0, minp(aT, aY));
    double p_n = 0.0;
    for (int i = tid; i < N; i += nt) {
      const double dy = isfinite(W.x[i]) ? W.x[i] : 0.0;
      W.yc[i] = W.y[i] + alpha * dy;
      clip_state(W.yc, i, KK, a.species_floor, a.T_max);
      const double sc = i == KK ? T_SCALE : 1.0;
      const double w = a.ss_atol + a.ss_rtol * fabs(W.yc[i] / sc);
      const double qn = (dy / sc) / w;
      p_n += qn * qn;
    }
    const double norm = sqrt(chem::block_sum(p_n, W.red) / N);
    for (int i = tid; i < N; i += nt) W.y[i] = W.yc[i];
    o.conv = alpha >= 1.0 - 1e-12 && norm < 1.0 && !uns;
    o.unstable = uns;
    ++o.it;
    __syncthreads();
  }
  return o;
}

// The pseudo-transient continuation (ops/psr.py:pseudo_transient_phase)
// from the state in W.y, updated in place.
template <bool XK, bool GM>
__device__ void pseudo_transient(const chem::MechView& m, double* sm,
                                 const Work& W, const chem::PsrLane& ps,
                                 const PsrArgs& a) {
  const int tid = threadIdx.x, nt = blockDim.x, KK = m.KK, N = KK + 1;
  double dt = a.dt0;
  for (int step = 0; step < a.n_pseudo; ++step) {
    psr_eval<true, XK>(m, sm, W, W.y, ps, false);
    for (int e = tid; e < N * N; e += nt) {
      const int i = e / N, j = e - i * N;
      const double v = (i == j ? 1.0 : 0.0) - dt * W.Jm[e];
      W.Jm[e] = isfinite(v) ? v : 0.0;
    }
    for (int i = tid; i < N; i += nt) W.yc[i] = W.y[i];
    __syncthreads();
    const double dsch = factor_jm(m, W);
    bool bad = false;
    for (int inner = 0; inner < PT_INNER; ++inner) {
      psr_eval<false, XK>(m, sm, W, W.yc, ps, false);
      for (int i = tid; i < N; i += nt)
        W.rhs[i] = -((W.yc[i] - W.y[i]) - dt * W.f[i]);
      __syncthreads();
      solve_jm<GM>(m, W, dsch);
      bool nf = false;
      for (int i = tid; i < N; i += nt) {
        const double dy = W.x[i];
        nf = nf || !isfinite(dy);
        W.yc[i] = W.yc[i] + (isfinite(dy) ? dy : 0.0);
        clip_state(W.yc, i, KK, a.species_floor, a.T_max);
      }
      bad = (__syncthreads_or(nf) != 0) || bad;
    }
    // project Y back onto sum(Y) = 1
    double part = 0.0;
    for (int i = tid; i < KK; i += nt) part += clipd(W.yc[i], 0.0, 1.0);
    const double ysum = maxp(chem::block_sum(part, W.red), TINY);
    bool nf = false;
    for (int i = tid; i < N; i += nt) {
      if (i < KK) W.yc[i] = clipd(W.yc[i], 0.0, 1.0) / ysum;
      nf = nf || !isfinite(W.yc[i]);
    }
    const bool allfin = __syncthreads_or(nf) == 0;
    if (allfin)
      for (int i = tid; i < N; i += nt) W.y[i] = W.yc[i];
    const bool ok = allfin && !bad;
    dt = clipd(ok ? dt * a.up : dt / a.down, a.dt_min, a.dt_max);
    __syncthreads();
  }
}

template <bool XK, bool FAULT, bool GM>
__global__ void __launch_bounds__(256)
psr_kernel(chem::MechView m, PsrArgs a, int B) {
  const int b = blockIdx.x;
  if (b >= B) return;
  CHEM_LANE_BASE(GM, sm, a.ws, b, psr_lane_doubles(&m));
  const bool flt = FAULT && a.fault[b] != 0;
  const int tid = threadIdx.x, nt = blockDim.x, KK = m.KK, N = KK + 1;
  const Work W = work_layout(sm, m);
  for (int i = tid; i < N; i += nt) W.y[i] = a.y0[(size_t)b * N + i];
  for (int i = tid; i < KK; i += nt) W.Yin[i] = a.Y_in[(size_t)b * KK + i];
  chem::PsrLane ps;
  ps.P = a.P[b];
  ps.h_in = a.h_in[b];
  ps.tau = a.tau[b];
  ps.volume = a.volume[b];
  ps.mdot = a.mdot[b];
  ps.qloss = a.qloss[b];
  ps.T_fixed = a.T_fixed[b];
  ps.Yin = W.Yin;
  ps.vol = a.mode == 1;
  ps.tgiv = a.energy == 1;
  __syncthreads();

  const NewtonOut n1 = newton_phase<XK, FAULT, GM>(m, sm, W, ps, a, flt);
  NewtonOut n2{n1.conv, n1.unstable, 0};
  if (!n1.conv) {
    pseudo_transient<XK, GM>(m, sm, W, ps, a);
    n2 = newton_phase<XK, FAULT, GM>(m, sm, W, ps, a, flt);
  }

  // finish: exit state, rho, tau, V, residual norm, status
  const double R = m.r_gas;
  double p_s = 0.0;
  for (int i = tid; i < KK; i += nt) p_s += clipd(W.y[i], 0.0, 1.0);
  const double ysum = maxp(chem::block_sum(p_s, W.red), TINY);
  double p_w = 0.0;
  for (int i = tid; i < KK; i += nt) {
    const double Yk = clipd(W.y[i], 0.0, 1.0) / ysum;
    a.Y[(size_t)b * KK + i] = Yk;
    p_w += Yk * (1.0 / m.wt[i]);
  }
  const double s_w = chem::block_sum(p_w, W.red);
  const double T = ps.tgiv ? ps.T_fixed : maxp(W.y[KK], 50.0);
  const double rho = ps.P * (1.0 / maxp(s_w, 1e-30)) / (R * T);
  double tau, V;
  if (ps.vol) {
    V = ps.volume;
    tau = rho * V / maxp(ps.mdot, TINY);
  } else {
    tau = ps.tau;
    V = tau * maxp(ps.mdot, TINY) / rho;
  }
  psr_eval<false, XK>(m, sm, W, W.y, ps, true);
  double p_r = 0.0;
  bool nf = false;
  for (int i = tid; i < N; i += nt) {
    const double w = a.ss_atol + a.ss_rtol * fabs(W.y[i]);
    const double q = W.f[i] / w;
    p_r += q * q;
    nf = nf || !isfinite(W.y[i]);
  }
  const double rnorm = sqrt(chem::block_sum(p_r, W.red) / N);
  const bool finite = __syncthreads_or(nf) == 0 && isfinite(rnorm);
  if (tid == 0) {
    a.T[b] = T;
    a.rho[b] = rho;
    a.tau_out[b] = tau;
    a.volume_out[b] = V;
    a.residual[b] = rnorm;
    a.converged[b] = n2.conv ? 1 : 0;
    a.n_direct[b] = n1.it;
    a.n_polish[b] = n1.conv ? 0 : n2.it;
    a.n_newton[b] = n1.it + (n1.conv ? 0 : n2.it);
    a.status[b] = n2.conv ? ST_OK
                  : (!finite ? ST_NONFINITE
                     : (n2.unstable ? ST_LINALG_UNSTABLE : ST_TOL_NOT_MET));
  }
}

// Threads per block for a mechanism of N = KK + 1 state entries.
inline int psr_threads(int N) { return N <= 32 ? 64 : 256; }

template <bool XK, bool FAULT, bool GM>
int launch_psr(const chem::MechView* m, const PsrArgs* a, int B,
               void* stream) {
  const size_t smem = GM ? 0 : sizeof(double) * psr_lane_doubles(m);
  if (!GM) {
    cudaError_t err = cudaFuncSetAttribute(
        psr_kernel<XK, FAULT, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  CHEM_LAUNCH(B, psr_threads(m->KK + 1), smem, stream, psr_kernel<XK, FAULT, GM>)(
      *m, *a, B);
  return (int)cudaGetLastError();
}

// The (XK, FAULT) instantiations of one storage (psr_solve.cu: shared
// memory; psr_solve_gm.cu: GM).
template <bool GM>
int launch_psr_storage(const chem::MechView* m, const PsrArgs* a, int B,
                       void* stream) {
  const bool xk = chem::extended(m), fault = a->fault != nullptr;
  if (xk) return fault ? launch_psr<true, true, GM>(m, a, B, stream)
                       : launch_psr<true, false, GM>(m, a, B, stream);
  return fault ? launch_psr<false, true, GM>(m, a, B, stream)
               : launch_psr<false, false, GM>(m, a, B, stream);
}

int launch_psr_gm(const chem::MechView* m, const PsrArgs* a, int B,
                  void* stream);

}  // namespace psr
