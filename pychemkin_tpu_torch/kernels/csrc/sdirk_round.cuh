// K5 sdirk_round: up to max_attempts SDIRK3 step attempts per lane, the
// whole attempt on the card: one launch is one round of the sweep. This
// header holds the kernel template sdirk_round_kernel<PROB, PIVOT, FAULT,
// XK, PRF, GM>; each sdirk_round*.cu instantiates one (PIVOT, FAULT, XK,
// PRF, GM) tuple for the four reactor codes, so that nvcc builds the
// instantiations in parallel processes: the eight (PIVOT, FAULT, XK) of
// the ignition sweep and its rescue ladder, the same eight with GM, and
// PRF with and without XK and GM. XK (PLOG rows, fractional orders:
// chem.cuh chem_lane) is on for the mechanisms that have them, so every
// instantiation runs a mechanism without them on the body that leaves
// them out.
//
// PRF (solve_batch's reactors, ops/reactors.py:232 of the reference)
// evaluates the lane's profiles at each RHS's time: the Jacobian at the
// step's start t, the stages at the reference's t + c_s h. GM keeps the
// lane's working set in its slice of a device-memory workspace (a
// mechanism too large for the card's shared memory) and solves through
// linalg.cuh bordered_solve_warp_mem, which takes any KK. The attempt
// budget is per lane (``budget`` [B]): the sweep gives every lane
// max_steps_per_segment, solve_batch's output grid gives each segment the
// lane's attempts at its start plus that.
//
// Replaces the JAX package's ops/odeint.py:451 _segment_fns (the cond and
// body of the step loop), :322 _newton_stage, :355 _quad_peak, :377
// _update_events and :787 sweep_round, i.e. what the port's masked
// PyTorch loop ops/odeint.py:sweep_round(..., max_attempts=R) does to one
// lane. Each attempt: the fused (f, J) of K2 at the lane's state, with
// M = I - h gamma J formed on the fly into shared memory; the bordered
// factor of K3; three modified-Newton stage loops, each iteration one RHS
// of K1, one bordered solve of K4 and the weighted RMS norm, with the
// converged / diverged / 8-iteration exits; the error filter solve; the
// step controller; the event accumulator (T_inflection, T_rise,
// T_ignition or Species_peak); the reject counter, the stall and the
// status code.
//
// PIVOT factors the species block with partial pivoting
// (linalg.cuh bordered_factor_pivot_lane, K7's factor: the reference's
// exact-path factor, forced on the TPU by ops/linalg.py:95
// forced_pivoted) and solves through its row order. FAULT reads per-lane
// fault codes (the reference's resilience/faultinject.py hooks,
// ops/odeint.py:657-660): a nan_rhs lane's stage RHS is NaN from its
// t_min on, a newton_stall lane's stage Newtons never converge. Both are
// template flags, so the default instantiation (no pivoting, no faults)
// is the same body as without them.
//
// Bound on the H100: per attempt the work of K2 + K3 + (n_newton + 1) x
// (K1 + K4) on the lane; the bytes are the lane's state, read once and
// written once per launch, so the operations of the rate ladder and the
// LU bound it. Design: one block of 256 threads per lane loops over the
// attempts with the lane's whole state in shared memory (y, f, the stages,
// the LU) and its scalars in registers, so a round costs no device-memory
// traffic beyond the state and the mechanism's tables, and no host sync;
// J is never stored: the Jacobian body writes M = I - h gamma J straight
// into the shared block that K2 used for dwdot/dC, where K3's lane body
// factors it in place. The solve is K4's warp body on warp 0 (the other
// warps wait at the barrier). Every decision that ends a loop is taken from
// values every thread holds (block sums, or a shared value read after a
// barrier), so the block's control flow is uniform. A lane that is done
// returns at once; a lane advanced in rounds of R attempts is the same
// computation as one advanced in a single launch, since all of its state
// is carried in the StepState tensors.
#pragma once

#include "linalg.cuh"

// The lane constants and the carried state of ops/odeint.py (Lanes,
// StepState), one row per lane; the state is read at the start of a launch
// and written back in place at its end. ``fault``/``fault_t`` are the
// per-lane fault bits and nan_rhs start times (null when no fault is
// active); ``budget`` the lanes' attempt caps; ``species`` the
// Species_peak species; ``prf`` the profiles (PRF); ``ws`` the workspace
// (GM). kernels/__init__.py builds the same layout with ctypes.
struct SdirkArgs {
  const double *constraint, *atol, *t_end, *thresh;
  const int* fault;
  const double* fault_t;
  double *t, *y, *f, *h;
  long long *n_steps, *n_rejected, *n_newton, *consec_rej;
  double *acc_t, *acc_v;
  unsigned char* stalled;
  int* status;
  double* dt_min;
  const long long* budget;
  double* ws;
  double rtol;
  int max_attempts, event_mode, species;
  chem::ProfileView prf;
};

// Launch K5's (PIVOT, FAULT, XK) instantiation of ``problem``; each
// triple is defined in its own source file (sdirk_round.cu: none of the
// three; sdirk_round_pivot_xk.cu: PIVOT and XK; ...).
#define CHEM_SDIRK_LAUNCHER(suffix)                                        \
  int sdirk_launch##suffix(const chem::MechView* m, const SdirkArgs* a,   \
                           int B, int problem, void* stream)
CHEM_SDIRK_LAUNCHER();
CHEM_SDIRK_LAUNCHER(_xk);
CHEM_SDIRK_LAUNCHER(_pivot);
CHEM_SDIRK_LAUNCHER(_pivot_xk);
CHEM_SDIRK_LAUNCHER(_fault);
CHEM_SDIRK_LAUNCHER(_fault_xk);
CHEM_SDIRK_LAUNCHER(_pivot_fault);
CHEM_SDIRK_LAUNCHER(_pivot_fault_xk);
CHEM_SDIRK_LAUNCHER(_gm);
CHEM_SDIRK_LAUNCHER(_gm_xk);
CHEM_SDIRK_LAUNCHER(_pivot_gm);
CHEM_SDIRK_LAUNCHER(_pivot_gm_xk);
CHEM_SDIRK_LAUNCHER(_fault_gm);
CHEM_SDIRK_LAUNCHER(_fault_gm_xk);
CHEM_SDIRK_LAUNCHER(_pivot_fault_gm);
CHEM_SDIRK_LAUNCHER(_pivot_fault_gm_xk);
CHEM_SDIRK_LAUNCHER(_prf);
CHEM_SDIRK_LAUNCHER(_prf_xk);
CHEM_SDIRK_LAUNCHER(_prf_gm);
CHEM_SDIRK_LAUNCHER(_prf_gm_xk);

namespace sdirk {

using chem::maxp;
using chem::minp;

// SDIRK3 tableau and controller of ops/odeint.py (exact double values)
constexpr double GAMMA = 0x1.be53cb1d33509p-2;
constexpr double C2 = 0x1.6f94f2c74cd42p-1;
constexpr double A21 = 0x1.20d61a716657bp-2;
constexpr double B1 = 0x1.35600951895b4p+0;
constexpr double B2 = -0x1.49e9f831ac5eep-1;
constexpr double B3 = GAMMA;
constexpr double ERR_W1 = 0x1.be53cb1d33508p-2;
constexpr double ERR_W2 = -0x1.be53cb1d3350ap-1;
constexpr double ERR_W3 = 0x1.be53cb1d33509p-2;
constexpr double NEG_INV_ORDER = -0x1.5555555555555p-2;   // -1/3
constexpr double DT_MIN_REL = 5e-14;
constexpr double NEWTON_TOL = 0.03;
constexpr int NEWTON_MAX = 8;
constexpr double MIN_FACTOR = 0.2;
constexpr double MAX_FACTOR = 5.0;
constexpr double SAFETY = 0.9;
constexpr long long MAX_CONSECUTIVE_REJECTS = 30;
// SolveStatus codes (resilience/status.py)
constexpr int ST_OK = 0;
constexpr int ST_NEWTON_STALL = 2;
constexpr int ST_NEWTON_DIVERGED = 3;
constexpr int ST_NONFINITE = 6;
// event_mode: T_inflection, T_rise, T_ignition, Species_peak
constexpr int EV_T_INFLECTION = 0;
constexpr int EV_SPECIES_PEAK = 3;
// fault bits (ops/odeint.py FAULT_NAN, FAULT_STALL)
constexpr int FAULT_NAN = 1;
constexpr int FAULT_STALL = 2;

constexpr int THREADS = 256;

// Where the Jacobian body puts J(i, j): M = I - hg J of the bordered
// layout, the species block into A (the D block of chem_lane, which the
// entry's own thread has read), the border column into bcol, the border
// row into crow and the corner into *d.
struct NewtonMatrixSink {
  double* A;
  double* bcol;
  double* crow;
  double* d;
  double hg;
  int n;
  __device__ void operator()(int i, int j, double v) const {
    if (i < n && j < n) A[i * n + j] = (i == j ? 1.0 : 0.0) - hg * v;
    else if (i < n) bcol[i] = 0.0 - hg * v;
    else if (j < n) crow[j] = 0.0 - hg * v;
    else *d = 1.0 - hg * v;
  }
};

// Shared-memory layout of one lane beyond chem_lane's (whose last block,
// D, holds the Newton matrix and then its LU).
struct Lane {
  double *y, *f, *atol, *w, *z1, *z2, *z3, *ybase, *ybuf, *fbuf, *r, *dz,
      *ynew, *v, *c, *lcol, *scal;
};

__host__ __device__ inline int lane_extra_doubles(int KK) {
  return 13 * (KK + 1) + 3 * KK + 4;
}

// Doubles of the PIVOT instantiation's row order (KK ints) and argmax
// scratch (32 ints), placed after the lane's extra block.
__host__ __device__ inline int pivot_extra_doubles(int KK) {
  return (KK + 32 + 1) / 2;
}

__device__ inline Lane lane_layout(double* base, int KK) {
  const int N = KK + 1;
  Lane L;
  double* p = base;
  L.y = p; p += N;
  L.f = p; p += N;
  L.atol = p; p += N;
  L.w = p; p += N;
  L.z1 = p; p += N;
  L.z2 = p; p += N;
  L.z3 = p; p += N;
  L.ybase = p; p += N;
  L.ybuf = p; p += N;
  L.fbuf = p; p += N;
  L.r = p; p += N;
  L.dz = p; p += N;
  L.ynew = p; p += N;
  L.v = p; p += KK;
  L.c = p; p += KK;
  L.lcol = p; p += KK;
  L.scal = p;
  return L;
}

// Weighted RMS norm sqrt(mean((x / w)^2)) over N entries by one warp; every
// thread of the warp gets the value.
__device__ inline double warp_wrms(const double* x, const double* w, int N,
                                   int lane) {
  double part = 0.0;
  for (int i = lane; i < N; i += 32) {
    const double q = x[i] / w[i];
    part += q * q;
  }
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(chem::FULL_MASK, part, o);
  return sqrt(part / N);
}

// dz = M^-1 r on warp 0 and its norm over w into L.scal[1]; returns the
// norm in every thread of the block. PIVOT: the factor is pivoted, with
// row order ``perm``. GM: the solve for any KK, swept in x.
template <bool PIVOT, bool GM>
__device__ inline double solve_and_norm(const Lane& L, const double* lu,
                                        double dsch, const double* r,
                                        double* x, const double* w, int n,
                                        const int* perm) {
  if ((threadIdx.x >> 5) == 0) {
    const int lane = threadIdx.x & 31;
    if constexpr (GM)
      chem::bordered_solve_warp_mem(lu, L.v, L.c, dsch, r, x, n, lane,
                                    PIVOT ? perm : nullptr);
    else
      chem::bordered_solve_warp(lu, L.v, L.c, dsch, r, x, n, lane,
                                PIVOT ? perm : nullptr);
    __syncwarp();
    const double nrm = warp_wrms(x, w, n + 1, lane);
    if (lane == 0) L.scal[1] = nrm;
  }
  __syncthreads();
  return L.scal[1];
}

// One stage's modified Newton loop (ops/odeint.py:_newton_stage): solves
// z = h f(ybase + gamma z) from the z in shared memory (updated in place),
// with the factored M. Returns the iterations; converged and diverged as
// the reference's. ``poisoned`` (FAULT only): the lane's injected nan_rhs
// fault is on at this stage's time (its RHS reads NaN). PRF: ``lt`` holds
// the profile terms at the stage's time and ``cval`` their constraint.
template <int PROB, bool PIVOT, bool FAULT, bool XK, bool PRF, bool GM>
__device__ int newton_stage(const chem::MechView& m, double cval, double* sm,
                            const Lane& L, const double* lu, double dsch,
                            const int* perm, const double* ybase, double* z,
                            double hh, bool poisoned, bool* converged,
                            bool* diverged, const chem::LaneTerms* lt) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = m.KK, N = n + 1;
  bool conv = false, div = false;
  int it = 0;
  double prev_dn = INFINITY;
  while (true) {
    for (int i = tid; i < N; i += nt) L.ybuf[i] = ybase[i] + GAMMA * z[i];
    __syncthreads();
    chem::chem_lane<false, PROB, XK, PRF>(m, L.ybuf, cval, sm, L.fbuf,
                                      chem::JacToGlobal{nullptr, 0}, lt);
    __syncthreads();
    // a poisoned lane's residual is NaN (its RHS is); the expression
    // itself is the fault-free one, so other lanes round as without faults
    for (int i = tid; i < N; i += nt)
      L.r[i] = (FAULT && poisoned) ? (double)NAN : -(z[i] - hh * L.fbuf[i]);
    __syncthreads();
    double dn = solve_and_norm<PIVOT, GM>(L, lu, dsch, L.r, L.dz, L.w, n, perm);
    if (!isfinite(dn)) dn = INFINITY;
    const bool div_new = it > 0 && dn > 2.0 * prev_dn;
    const bool conv_new = dn < NEWTON_TOL;
    for (int i = tid; i < N; i += nt) z[i] = z[i] + L.dz[i];
    conv = conv_new;
    div = div_new;
    prev_dn = dn;
    ++it;
    if (conv || div || it >= NEWTON_MAX) break;
  }
  __syncthreads();
  *converged = conv;
  *diverged = div;
  return it;
}

// Maximum of the quadratic through (t0, g0), (t1, g1), (t2, g2) among the
// vertex (if the parabola opens downward) and the end points; ties and
// NaN as the reference's argmax (the first maximum; a NaN wins).
__device__ inline void quad_peak(double t0, double t1, double t2, double g0,
                                 double g1, double g2, double* tp,
                                 double* gp) {
  const double s1 = t1 - t0;
  const double s2 = t2 - t0;
  double denom = s1 * s2 * (s2 - s1);
  denom = fabs(denom) > 0.0 ? denom : 1.0;
  const double a = (s1 * (g2 - g0) - s2 * (g1 - g0)) / denom;
  const double b = (s2 * s2 * (g1 - g0) - s1 * s1 * (g2 - g0)) / denom;
  double s_v = fabs(a) > 0.0 ? -b / (a == 0.0 ? 1.0 : 2.0 * a) : 0.0;
  s_v = minp(maxp(s_v, 0.0), s2);
  const double g_v = a * s_v * s_v + b * s_v + g0;
  const double cand_t[3] = {t0 + s_v, t0, t2};
  const double cand_g[3] = {a < 0.0 ? g_v : -INFINITY, g0, g2};
  int best = 0;
  for (int j = 1; j < 3; ++j) {
    if (cand_g[best] != cand_g[best]) break;
    if (cand_g[j] != cand_g[j] || cand_g[j] > cand_g[best]) best = j;
  }
  *tp = cand_t[best];
  *gp = cand_g[best];
}

// The launch bounds of the instantiations of a source file: THREADS
// threads a block, which left ptxas at 128 registers (two lanes an SM) for
// the default body. The PIVOT, FAULT, PRF and GM files ask for two blocks
// an SM outright: with the threads alone ptxas gave the pivoted body 212
// registers, the PRF body 222 and the GM body 250, so one lane an SM (a
// PRF round then took 1.8x the default's, a 256-lane GM sweep 1.4x).
#ifndef SDIRK_LAUNCH_BOUNDS
#define SDIRK_LAUNCH_BOUNDS __launch_bounds__(THREADS)
#endif

// Doubles of one lane's working set: chem_lane's with its D block, the
// step's vectors and, with PIVOT, the row order.
__host__ __device__ inline int sdirk_lane_doubles(const chem::MechView* m,
                                                  bool pivot) {
  return chem::lane_smem_doubles(m->KK, m->II, m->n_tb, m->n_plog, true) +
         lane_extra_doubles(m->KK) + (pivot ? pivot_extra_doubles(m->KK) : 0);
}

template <int PROB, bool PIVOT, bool FAULT, bool XK, bool PRF, bool GM>
__global__ void SDIRK_LAUNCH_BOUNDS
sdirk_round_kernel(chem::MechView m, SdirkArgs a, int B) {
  const int b = blockIdx.x;
  if (b >= B) return;
  CHEM_LANE_BASE(GM, sm, a.ws, b, sdirk_lane_doubles(&m, PIVOT));
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = m.KK, N = n + 1;
  double* D = sm + chem::lane_smem_doubles(n, m.II, m.n_tb,
                                           XK ? m.n_plog : 0, false);
  double* red = D - 32;                 // chem_lane's reduction buffer
  const Lane L = lane_layout(D + n * n, n);
  // PIVOT: the factor's row order and the argmax scratch
  int* perm = PIVOT ? reinterpret_cast<int*>(D + n * n + lane_extra_doubles(n))
                    : nullptr;
  int* ri = PIVOT ? perm + n : nullptr;

  const double t_end = a.t_end[b];
  long long n_steps = a.n_steps[b], n_rej = a.n_rejected[b];
  double t = a.t[b];
  bool stalled = a.stalled[b] != 0;
  const long long budget = a.budget[b];
  if (!(t < t_end && !stalled && n_steps + n_rej < budget)) return;

  const size_t bo = (size_t)b * N;
  for (int i = tid; i < N; i += nt) {
    L.y[i] = a.y[bo + i];
    L.f[i] = a.f[bo + i];
    L.atol[i] = a.atol[bo + i];
  }
  double h = a.h[b], dt_min_acc = a.dt_min[b];
  double acc_t = a.acc_t[b], acc_v = a.acc_v[b];
  long long n_newton = a.n_newton[b], consec = a.consec_rej[b];
  int status = a.status[b];
  // PRF: the constraint comes from the profiles at each RHS's time
  const double cval = PRF ? 0.0 : a.constraint[b], thresh = a.thresh[b];
  const double rtol = a.rtol;
  const int fault = FAULT ? a.fault[b] : 0;
  const double fault_t = FAULT ? a.fault_t[b] : 0.0;
  const double dt_min = DT_MIN_REL * maxp(fabs(t_end), 1e-30);
  __syncthreads();

  for (int k = 0; k < a.max_attempts; ++k) {
    if (!(t < t_end && !stalled && n_steps + n_rej < budget)) break;
    // the lane is active (t < t_end): the step, clipped to the remainder
    const double remaining = maxp(t_end - t, dt_min);
    const double hh = minp(maxp(h, dt_min), remaining);
    const bool clipped = h > remaining;
    const double hg = hh * GAMMA;

    // M = I - hg J at y, factored in place
    chem::LaneTerms lt;
    if constexpr (PRF) lt = chem::lane_terms<PROB>(a.prf, b, t);
    chem::chem_lane<true, PROB, XK, PRF>(
        m, L.y, PRF ? lt.c : cval, sm, L.fbuf,
        NewtonMatrixSink{D, L.v, L.c, L.scal, hg, n}, PRF ? &lt : nullptr);
    __syncthreads();
    const double dsch =
        PIVOT ? chem::bordered_factor_pivot_lane(D, perm, L.v, L.c, L.scal[0],
                                                 L.lcol, red, ri, red, n)
              : chem::bordered_factor_lane(D, L.v, L.c, L.scal[0], L.lcol, red,
                                           n);

    // three stages: z_s = h f(base_s + gamma z_s), each from the last z
    int n_it = 0;
    bool newton_ok = true, newton_diverged = false;
    double y2T = 0.0;   // the T entry of stage 2's point, for T_rise
    for (int s = 0; s < 3; ++s) {
      double* z = s == 0 ? L.z1 : (s == 1 ? L.z2 : L.z3);
      const double* base = s == 0 ? L.y : L.ybase;
      for (int i = tid; i < N; i += nt) {
        if (s == 0) {
          L.w[i] = L.atol[i] + rtol * fabs(L.y[i]);
          z[i] = hh * L.f[i];
        } else if (s == 1) {
          L.ybase[i] = L.y[i] + A21 * L.z1[i];
          z[i] = L.z1[i];
        } else {
          L.ybase[i] = L.y[i] + B1 * L.z1[i] + B2 * L.z2[i];
          z[i] = L.z2[i];
        }
      }
      __syncthreads();
      bool ok, dv;
      // the reference's stage times t + c_s h: a nan_rhs fault is on from
      // its t_min, and the profiles are read there
      const double ts = s == 0 ? t + GAMMA * hh : (s == 1 ? t + C2 * hh : t + hh);
      const bool poisoned = FAULT && (fault & FAULT_NAN) && ts >= fault_t;
      if constexpr (PRF) lt = chem::lane_terms<PROB>(a.prf, b, ts);
      n_it += newton_stage<PROB, PIVOT, FAULT, XK, PRF, GM>(
          m, PRF ? lt.c : cval, sm, L, D, dsch, perm, base, z, hh, poisoned,
          &ok, &dv, PRF ? &lt : nullptr);
      newton_ok = newton_ok && ok;
      newton_diverged = newton_diverged || dv;
      if (s == 1) y2T = L.ybase[n] + GAMMA * L.z2[n];
      __syncthreads();
    }

    // error estimate filtered through M^-1, in the new state's weights
    bool bad = false;
    for (int i = tid; i < N; i += nt) {
      const double yn = L.ybase[i] + B3 * L.z3[i];
      L.ynew[i] = yn;
      L.r[i] = ERR_W1 * L.z1[i] + ERR_W2 * L.z2[i] + ERR_W3 * L.z3[i];
      L.w[i] = L.atol[i] + rtol * maxp(fabs(L.y[i]), fabs(yn));
      bad = bad || !isfinite(yn);
    }
    const bool nonfinite = __syncthreads_or(bad) != 0;
    const double err =
        solve_and_norm<PIVOT, GM>(L, D, dsch, L.r, L.dz, L.w, n, perm);
    if (FAULT && (fault & FAULT_STALL)) newton_ok = false;
    const bool finite = !nonfinite && isfinite(err);
    const bool accept = newton_ok && finite && err <= 1.0;

    // step controller
    const double err_safe = maxp(err, 1e-10);
    double fac_h = SAFETY * pow(err_safe, NEG_INV_ORDER);
    fac_h = (newton_ok && finite) ? minp(maxp(fac_h, MIN_FACTOR), MAX_FACTOR)
                                  : 0.25;
    double h_next = maxp(hh * fac_h, dt_min);
    if (accept && clipped) h_next = maxp(h_next, h);

    // event accumulator over the step's samples: start, stages 1 and 2,
    // end (f at a stage point is z / h)
    const double h_safe = maxp(hh, 1e-300);
    if (a.event_mode == EV_T_INFLECTION) {
      double tp, vp;
      quad_peak(t, t + C2 * hh, t + hh, L.f[n], L.z2[n] / h_safe,
                L.z3[n] / h_safe, &tp, &vp);
      if (accept && vp > acc_v) {
        acc_t = tp;
        acc_v = vp;
      }
    } else if (a.event_mode == EV_SPECIES_PEAK) {
      // the species' mass fraction at the start, at stage 2's point
      // (y + a21 z1 + gamma z2, as the stage loop formed it) and at the end
      const int k = a.species;
      double tp, vp;
      quad_peak(t, t + C2 * hh, t + hh, L.y[k],
                (L.y[k] + A21 * L.z1[k]) + GAMMA * L.z2[k], L.ynew[k], &tp,
                &vp);
      if (accept && vp > acc_v) {
        acc_t = tp;
        acc_v = vp;
      }
    } else {   // T_rise, T_ignition: the first upward crossing of thresh
      const double ts[4] = {t, t + GAMMA * hh, t + C2 * hh, t + hh};
      const double g[4] = {L.y[n] - thresh, (L.y[n] + GAMMA * L.z1[n]) - thresh,
                           y2T - thresh, L.ynew[n] - thresh};
      const bool not_yet = !isfinite(acc_t);
      bool found = false;
      for (int j = 0; j < 3; ++j) {
        const double g0 = g[j], g1 = g[j + 1];
        const double t0 = ts[j], t1 = ts[j + 1];
        const bool crossed = accept && not_yet && !found && g0 <= 0.0 &&
                             g1 > 0.0;
        const double dg = g1 - g0;
        const double frac = -g0 / (dg == 0.0 ? 1.0 : dg);
        const double tc = t0 + minp(maxp(frac, 0.0), 1.0) * (t1 - t0);
        const double slope = dg / maxp(t1 - t0, 1e-300);
        if (crossed) {
          acc_t = tc;
          acc_v = slope;
        }
        found = found || crossed;
      }
    }

    // rejects, stall and status (the first failure's code is kept)
    consec = accept ? 0 : consec + 1;
    const bool stall_new = consec >= MAX_CONSECUTIVE_REJECTS;
    const int fail_code = !finite ? ST_NONFINITE
                          : (newton_diverged ? ST_NEWTON_DIVERGED
                                             : ST_NEWTON_STALL);
    if (stall_new && status == ST_OK) status = fail_code;
    __syncthreads();   // every thread has read the step's samples
    if (accept) {
      for (int i = tid; i < N; i += nt) {
        L.y[i] = L.ynew[i];
        L.f[i] = L.z3[i] / h_safe;
      }
      t = t + hh;
      dt_min_acc = minp(dt_min_acc, hh);
      ++n_steps;
    } else {
      ++n_rej;
    }
    h = h_next;
    n_newton += n_it;
    stalled = stalled || stall_new;
    __syncthreads();
  }

  for (int i = tid; i < N; i += nt) {
    a.y[bo + i] = L.y[i];
    a.f[bo + i] = L.f[i];
  }
  if (tid == 0) {
    a.t[b] = t;
    a.h[b] = h;
    a.n_steps[b] = n_steps;
    a.n_rejected[b] = n_rej;
    a.n_newton[b] = n_newton;
    a.consec_rej[b] = consec;
    a.acc_t[b] = acc_t;
    a.acc_v[b] = acc_v;
    a.stalled[b] = stalled ? 1 : 0;
    a.status[b] = status;
    a.dt_min[b] = dt_min_acc;
  }
}

template <int PROB, bool PIVOT, bool FAULT, bool XK, bool PRF, bool GM>
int launch_sdirk_as(const chem::MechView* m, const SdirkArgs* a, int B,
                    void* stream) {
  const size_t smem = GM ? 0 : sizeof(double) * sdirk_lane_doubles(m, PIVOT);
  if (!GM) {
    cudaError_t err = cudaFuncSetAttribute(
        sdirk_round_kernel<PROB, PIVOT, FAULT, XK, PRF, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  CHEM_LAUNCH(B, THREADS, smem, stream,
              sdirk_round_kernel<PROB, PIVOT, FAULT, XK, PRF, GM>)(*m, *a, B);
  return (int)cudaGetLastError();
}

// The (PIVOT, FAULT, XK, PRF, GM) instantiation of the four reactor codes.
template <bool PIVOT, bool FAULT, bool XK, bool PRF = false, bool GM = false>
int launch_sdirk(const chem::MechView* m, const SdirkArgs* a, int B,
                 int problem, void* stream) {
  switch (problem) {
    case chem::CONP:
      return launch_sdirk_as<chem::CONP, PIVOT, FAULT, XK, PRF, GM>(m, a, B, stream);
    case chem::CONV:
      return launch_sdirk_as<chem::CONV, PIVOT, FAULT, XK, PRF, GM>(m, a, B, stream);
    case chem::CONP_TGIV:
      return launch_sdirk_as<chem::CONP_TGIV, PIVOT, FAULT, XK, PRF, GM>(m, a, B, stream);
    case chem::CONV_TGIV:
      return launch_sdirk_as<chem::CONV_TGIV, PIVOT, FAULT, XK, PRF, GM>(m, a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sdirk
