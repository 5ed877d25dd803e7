// Rate and thermo device code shared by kernels K1 (rhs), K2 (rhs_jac), K5
// (sdirk_round) and K7 (psr_solve).
//
// One thread block integrates the chemistry of one reactor lane: the lane's
// species and reaction intermediates live in shared memory, threads stride
// over species, reactions, and (K2) the KK x KK entries of dwdot/dC. Every
// sum runs over a contiguous CSR range of the staged index sets
// (mechanism/staging.py), so each output is one deterministic sum and no
// atomics are used.
//
// The arithmetic is that of the JAX package's staged sparse kinetics
// (ops/kinetics.py:_rop_intermediates_sparse, with :244 _plog_rate and the
// :412 fractional-order floor), closed-form Jacobian
// (ops/jacobian.py:kinetics_derivatives, _rate_constant_derivatives, whose
// jacfwd of the PLOG rows, :282-290, is written out here) and the four
// batch-reactor chain rules (ops/jacobian.py:_batch_jac_core, with its
// TGIV branches :585, :621), including the +-85 exponent clip, the 1e-30
// floors, sign(A) Arrhenius and the 50 K temperature floor. Clamps
// propagate NaN as the reference's do.
//
// The lane body chem_lane<JAC, PROB> is a __device__ function: K1 and K2
// are thin __global__ wrappers around it, and K5 calls it for every RHS
// and Jacobian of its step attempts, so all three compute one arithmetic.
// PROB is the reactor: CONP or CONP_TGIV (the lane's value is its
// pressure), CONV or CONV_TGIV (its density), with the energy equation or
// at the given temperature (the state's T entry, held by a zero rate).
//
// PRF (the solve_batch reactors, ops/reactors.py BatchArgs) reads the
// lane's constraint value, its slope, the given temperature and the
// heat-loss terms from piecewise-linear profiles at the lane's time
// (ProfileView, LaneTerms); without PRF the body is the constant-profile
// one of the ignition sweep. GM (a mechanism whose lane does not fit in
// the card's opt-in shared memory) points the same layout at a per-lane
// slice of a device-memory workspace instead of the block's dynamic
// shared memory.
//
// Defining CHEM_EMU before the include compiles the device code as host
// C++ (a harness then supplies the CUDA built-ins and runs each block's
// threads on the CPU).
#pragma once

#ifndef CHEM_EMU
#include <cuda_runtime.h>
#define CHEM_DYN_SMEM(name) extern __shared__ double name[]
// CHEM_LAUNCH(grid, block, smem, stream, kernel)(args...): the kernel last,
// so that a template's commas stay inside the variadic argument
#define CHEM_LAUNCH(grid, block, smem, stream, ...) \
  __VA_ARGS__<<<(grid), (block), (smem), (cudaStream_t)(stream)>>>
#endif

namespace chem {

constexpr double TINY = 1e-30;
constexpr double EXP_CLIP = 85.0;
constexpr double LN10 = 2.302585092994046;
constexpr double T_FLOOR = 50.0;
constexpr int FALLOFF_TROE = 2;
constexpr int FALLOFF_SRI = 3;
constexpr double FRAC_FLOOR = 1e-16;   // fractional FORD/RORD floor
constexpr unsigned FULL_MASK = 0xffffffffu;
// reactor of a lane (template parameter PROB)
constexpr int CONP = 0;
constexpr int CONV = 1;
constexpr int CONP_TGIV = 2;
constexpr int CONV_TGIV = 3;

// the lane's constraint value is its pressure (else its density)
__host__ __device__ constexpr bool conp_like(int prob) {
  return prob == CONP || prob == CONP_TGIV;
}

// T is given (no energy equation)
__host__ __device__ constexpr bool tgiv(int prob) {
  return prob == CONP_TGIV || prob == CONV_TGIV;
}

// Device views of a TorchMechanism (kernels/__init__.py builds the same
// layout with ctypes: pointers first, then doubles, then ints).
struct MechView {
  const double *wt, *nasa_lo, *nasa_hi, *t_mid;
  const double *A, *beta, *Ea_R;
  const int *plain_tb;
  const int *fo_rows;
  const double *fo_lowA, *fo_lowb, *fo_lowE;
  const int *fo_type, *fo_chem;
  const double *fo_troe, *fo_sri;
  const int *tb_rows;
  const double *tb_eff;
  const int *rev_rows;
  const double *rev_dnu;
  const int *rev_hasp;
  const double *rev_A, *rev_beta, *rev_Ea_R;
  const int *kc_ptr, *kc_sp;
  const double *kc_coef;
  const int *of_ptr, *of_sp;
  const double *of_coef;
  const int *or_ptr, *or_sp;
  const double *or_coef;
  const int *nus_ptr, *nus_rxn;
  const double *nus_coef;
  const int *jac_ptr, *jac_rxn;
  const double *jac_cf, *jac_cr;
  const int *tbs_ptr, *tbs_row;
  const double *tbs_nu;
  const double *ncf;  // [KK, MM] element counts (K6)
  // fractional FORD/RORD flags per ord entry and per Jacobian triple
  const int *of_frac, *or_frac, *jac_ff, *jac_rf;
  // PLOG rows: reaction index, compact index of each reaction (-1: none),
  // levels, ln P [n_plog, L], Arrhenius terms [n_plog, L, Tm]
  const int *plog_idx, *plog_pos, *plog_n_levels;
  const double *plog_ln_P, *plog_A, *plog_beta, *plog_Ea_R;
  double r_gas, p_atm;
  int KK, II, n_fo, n_tb, n_rev, MM, n_plog, plog_L, plog_Tm, any_frac;
};

// Piecewise-linear profiles of the solve_batch reactors (ops/reactors.py
// BatchArgs): the constraint (P(t) for the CONP codes, V(t) for the CONV
// codes), T(t) (TGIV), the heat-loss rate and the heat-transfer area, each
// as knots x and values y of n points whose rows advance by the given
// stride per lane (0: one profile shared by every lane); and the lanes'
// mass, wall heat-transfer coefficient and ambient temperature [B].
// kernels/__init__.py builds the same layout with ctypes.
struct ProfileView {
  const double *cx, *cy, *tx, *ty, *qx, *qy, *ax, *ay;
  const double *mass, *htc, *tamb;
  int cn, tn, qn, an;
  int cxs, cys, txs, tys, qxs, qys, axs, ays;
};

// max(a, b) and min(a, b) that keep a NaN of either argument
// (jnp.maximum / torch.clamp semantics)
__device__ __forceinline__ double maxp(double a, double b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ double minp(double a, double b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ double clip85(double x) {
  return x < -EXP_CLIP ? -EXP_CLIP : (x > EXP_CLIP ? EXP_CLIP : x);
}

__device__ __forceinline__ double safe_exp(double x) { return exp(clip85(x)); }

// derivative indicator of clip85: 1 strictly inside, 0 outside
__device__ __forceinline__ double ind(double x) {
  return (x > -EXP_CLIP && x < EXP_CLIP) ? 1.0 : 0.0;
}

// derivative of max(x, lo) in x as jax.jacfwd takes it: 1 above, 0 below,
// 0.5 at the tie
__device__ __forceinline__ double tie_ind(double x, double lo) {
  return x > lo ? 1.0 : (x == lo ? 0.5 : 0.0);
}

__device__ __forceinline__ double sgn(double a) {
  return a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : 0.0);
}

__device__ __forceinline__ double arr_arg(double A, double b, double E,
                                          double T, double lnT) {
  return log(maxp(fabs(A), TINY)) + b * lnT - E / T;
}

__device__ __forceinline__ double arrhenius(double A, double b, double E,
                                            double T, double lnT) {
  return sgn(A) * safe_exp(arr_arg(A, b, E, T, lnT));
}

__device__ __forceinline__ double arrhenius_dT(double A, double b, double E,
                                               double T, double lnT,
                                               double k) {
  return k * (b / T + E / (T * T)) * ind(arr_arg(A, b, E, T, lnT));
}

// Value and slope of the piecewise-linear profile (x, y) of n >= 2 knots
// at t (ops/reactors.py:profile_value_slope): the segment of
// searchsorted(x, t, side="right") - 1 clipped to [0, n - 2], the value
// clipped to the segment's range, flat outside the knots with slope 0
// there.
__device__ inline void profile_at(const double* x, const double* y, int n,
                                  double t, double* val, double* slope) {
  int cnt = 0;
  for (int j = 0; j < n; ++j) cnt += x[j] <= t ? 1 : 0;
  int i = cnt - 1;
  i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
  const double x0 = x[i], x1 = x[i + 1], y0 = y[i], y1 = y[i + 1];
  const double dx = maxp(x1 - x0, 1e-300);
  const double s = (y1 - y0) / dx;
  const bool inside = t >= x[0] && t <= x[n - 1];
  double v = minp(maxp(y0 + s * (t - x0), minp(y0, y1)), maxp(y0, y1));
  v = t < x[0] ? y[0] : (t > x[n - 1] ? y[n - 1] : v);
  *val = v;
  *slope = inside ? s : 0.0;
}

// The profile terms of one lane at time t: c the constraint value the lane
// body takes (P(t) for the CONP codes; rho = mass / V(t) for the CONV
// codes), cdot dP/dt or dV/dt, T and dT/dt of the TGIV profile, the
// heat-loss rate ql and area ar, and the lane's mass, htc and tamb.
struct LaneTerms {
  double c, cdot, T, Tdot, ql, ar, mass, htc, tamb;
};

template <int PROB>
__device__ inline LaneTerms lane_terms(const ProfileView& p, int b,
                                       double t) {
  LaneTerms L;
  double v, s;
  profile_at(p.cx + (size_t)b * p.cxs, p.cy + (size_t)b * p.cys, p.cn, t,
             &v, &s);
  L.mass = p.mass[b];
  L.c = conp_like(PROB) ? v : L.mass / v;
  L.cdot = s;
  L.T = L.Tdot = L.ql = L.ar = L.htc = L.tamb = 0.0;
  if (tgiv(PROB)) {
    profile_at(p.tx + (size_t)b * p.txs, p.ty + (size_t)b * p.tys, p.tn, t,
               &L.T, &L.Tdot);
  } else {
    profile_at(p.qx + (size_t)b * p.qxs, p.qy + (size_t)b * p.qys, p.qn, t,
               &L.ql, &s);
    profile_at(p.ax + (size_t)b * p.axs, p.ay + (size_t)b * p.ays, p.an, t,
               &L.ar, &s);
    L.htc = p.htc[b];
    L.tamb = p.tamb[b];
  }
  return L;
}

// Wall heat gain per unit mass of the ENRG reactors at T
// (ops/reactors.py:_heat_rate over the mass): (-qloss + htc area
// (tamb - T)) / mass.
__device__ __forceinline__ double heat_per_mass(const LaneTerms& L,
                                                double T) {
  return (-L.ql + L.htc * L.ar * (L.tamb - T)) / L.mass;
}

// Sum of v over the block; every thread gets the same value (the warp
// partials are added in one fixed order).
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  double s = 0.0;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) s += red[i];
  return s;
}

// Falloff blend of one row (ops/kinetics.py:falloff_blend) and, with JAC,
// its closed-form d/dT and d/d[M] (ops/jacobian.py:falloff_blend_derivs).
template <bool JAC>
__device__ void falloff_row(const MechView& m, int j, double T, double lnT,
                            double M, double ki, double dki, double* kf_out,
                            double* dT_out, double* dM_out) {
  const double k0 = arrhenius(m.fo_lowA[j], m.fo_lowb[j], m.fo_lowE[j], T, lnT);
  const double kic = maxp(ki, TINY);
  const double raw = k0 * M / kic;
  const double Pr = maxp(raw, 1e-35);
  const double lP = log(Pr) / LN10;
  const int ftype = m.fo_type[j];
  const bool chem_act = m.fo_chem[j] != 0;

  // Troe
  const double* tr = m.fo_troe + 4 * j;
  const double a = tr[0], T3 = tr[1], T1 = tr[2], T2 = tr[3];
  const bool has_T2 = isfinite(T2);
  const double T2s = has_T2 ? T2 : 0.0;
  const double x2 = -T2s / T;
  const double term2 = has_T2 ? safe_exp(x2) : 0.0;
  const double T3c = maxp(T3, 1e-30), T1c = maxp(T1, 1e-30);
  const double x3 = -T / T3c, x1 = -T / T1c;
  const double e3 = safe_exp(x3), e1 = safe_exp(x1);
  const double Fraw = (1.0 - a) * e3 + a * e1 + term2;
  const double Fc = maxp(Fraw, 1e-30);
  const double L = log(Fc) / LN10;
  const double c_t = -0.4 - 0.67 * L;
  const double n_t = 0.75 - 1.27 * L;
  const double x = lP + c_t;
  const double den = n_t - 0.14 * x;
  const double f1 = x / den;
  const double s = 1.0 + f1 * f1;
  const double lF = L / s;
  const double argF = LN10 * lF;
  const double Ft = safe_exp(argF);

  // SRI
  const double* sr = m.fo_sri + 5 * j;
  const double sa = sr[0], sb = sr[1], sc = sr[2], sd = sr[3], se = sr[4];
  const double q = 1.0 + lP * lP;
  const double xs = 1.0 / q;
  const double xb = -sb / T;
  const double eb = safe_exp(xb);
  const double scc = maxp(sc, 1e-30);
  const double xc = -T / scc;
  const double ec = safe_exp(xc);
  const double braw = sa * eb + ec;
  const double base = maxp(braw, TINY);
  const double lb = log(base);
  const double a1 = xs * lb, a2 = se * lnT;
  const double s1 = safe_exp(a1), s2 = safe_exp(a2);
  const double Fs = sd * s1 * s2;

  const double F = ftype == FALLOFF_TROE ? Ft : (ftype == FALLOFF_SRI ? Fs : 1.0);
  const double opr = 1.0 + Pr;
  const double bl = chem_act ? k0 / opr : ki * Pr / opr;
  *kf_out = bl * F;
  if (!JAC) return;

  const double dk0 = arrhenius_dT(m.fo_lowA[j], m.fo_lowb[j], m.fo_lowE[j], T, lnT, k0);
  const double i_ki = ki > TINY ? 1.0 : 0.0;
  const double i_pr = raw > 1e-35 ? 1.0 : 0.0;
  const double dPr_T = i_pr * M * (dk0 * kic - k0 * i_ki * dki) / (kic * kic);
  const double dPr_M = i_pr * k0 / kic;
  const double dlP_T = dPr_T / (Pr * LN10);
  const double dlP_M = dPr_M / (Pr * LN10);

  double dF_T = 0.0, dF_M = 0.0;
  if (ftype == FALLOFF_TROE) {
    const double dterm2 = has_T2 ? term2 * (T2s / (T * T)) * ind(x2) : 0.0;
    const double dFraw = (1.0 - a) * e3 * (-1.0 / T3c) * ind(x3)
                       + a * e1 * (-1.0 / T1c) * ind(x1) + dterm2;
    const double dFc = (Fraw > 1e-30 ? 1.0 : 0.0) * dFraw;
    const double dL = dFc / (Fc * LN10);
    const double gF = Ft * LN10 * ind(argF);
    // T
    {
      const double dx = dlP_T - 0.67 * dL;
      const double dden = -1.27 * dL - 0.14 * dx;
      const double df1 = (dx * den - x * dden) / (den * den);
      dF_T = gF * (dL / s - L * 2.0 * f1 * df1 / (s * s));
    }
    // [M]
    {
      const double dx = dlP_M;
      const double dden = -0.14 * dx;
      const double df1 = (dx * den - x * dden) / (den * den);
      dF_M = gF * (0.0 / s - L * 2.0 * f1 * df1 / (s * s));
    }
  } else if (ftype == FALLOFF_SRI) {
    const double dbase = (braw > TINY ? 1.0 : 0.0)
        * (sa * eb * (sb / (T * T)) * ind(xb) + ec * (-1.0 / scc) * ind(xc));
    const double dlb = dbase / base;
    {
      const double dxs = -2.0 * lP * dlP_T / (q * q);
      const double ds1 = s1 * ind(a1) * (dxs * lb + xs * dlb);
      const double ds2 = s2 * ind(a2) * (se / T);
      dF_T = sd * (ds1 * s2 + s1 * ds2);
    }
    {
      const double dxs = -2.0 * lP * dlP_M / (q * q);
      const double ds1 = s1 * ind(a1) * (dxs * lb + xs * 0.0);
      const double ds2 = s2 * ind(a2) * 0.0;
      dF_M = sd * (ds1 * s2 + s1 * ds2);
    }
  }
  double dbl_T, dbl_M;
  if (chem_act) {
    dbl_T = dk0 / opr - k0 * dPr_T / (opr * opr);
    dbl_M = -k0 * dPr_M / (opr * opr);
  } else {
    dbl_T = dki * Pr / opr + ki * dPr_T / (opr * opr);
    dbl_M = ki * dPr_M / (opr * opr);
  }
  *dT_out = dbl_T * F + bl * dF_T;
  *dM_out = dbl_M * F + bl * dF_M;
}

// k of PLOG row j (ops/kinetics.py:plog_rate) at T, lnT and the pressure
// P: ln k linear in ln P between the bracketing levels (flat outside the
// table), each level's terms summed in k space and floored at 1e-30; with
// JAC also dk/dT and dk/dP, with jacfwd's one-sided values at the clips
// (0 outside, half the slope exactly at a bound).
template <bool JAC>
__device__ void plog_row(const MechView& m, int j, double T, double lnT,
                         double P, double* k_out, double* dT_out,
                         double* dP_out) {
  const int L = m.plog_L, Tm = m.plog_Tm, n = m.plog_n_levels[j];
  const double* lp = m.plog_ln_P + (size_t)j * L;
  const double lnP = log(P);
  int below = 0;
  for (int l = 0; l < L; ++l) below += lp[l] < lnP ? 1 : 0;
  int i0 = below - 1 < 0 ? 0 : below - 1;
  if (i0 > n - 2) i0 = n - 2;
  if (n == 1) i0 = 0;
  const int i1 = n == 1 ? 0 : i0 + 1;
  double lk[2], dlk[2];
  for (int s = 0; s < 2; ++s) {
    const size_t o = ((size_t)j * L + (s == 0 ? i0 : i1)) * Tm;
    double acc = 0.0, dacc = 0.0;
    for (int t = 0; t < Tm; ++t) {
      const double a = m.plog_beta[o + t] * lnT - m.plog_Ea_R[o + t] / T;
      const double e = safe_exp(a);
      acc += m.plog_A[o + t] * e;
      if (JAC)
        dacc += m.plog_A[o + t] * e * ind(a) *
                (m.plog_beta[o + t] / T + m.plog_Ea_R[o + t] / (T * T));
    }
    const double kc = maxp(acc, TINY);
    lk[s] = log(kc);
    dlk[s] = JAC ? tie_ind(acc, TINY) * dacc / kc : 0.0;
  }
  const double dp = maxp(lp[i1] - lp[i0], 1e-12);
  const double w_raw = (lnP - lp[i0]) / dp;
  const double w = minp(maxp(w_raw, 0.0), 1.0);
  const double k = exp((1.0 - w) * lk[0] + w * lk[1]);
  *k_out = k;
  if (!JAC) return;
  *dT_out = k * ((1.0 - w) * dlk[0] + w * dlk[1]);
  const double gw = (w_raw > 0.0 && w_raw < 1.0) ? 1.0
                    : ((w_raw == 0.0 || w_raw == 1.0) ? 0.5 : 0.0);
  *dP_out = n == 1 ? 0.0 : k * (lk[1] - lk[0]) * gw / dp / P;
}

// Doubles of the PLOG scratch of one lane (dk/dP of kf and kr and dq/dP
// per PLOG row, nu^T dq/dP per species), 0 without PLOG rows.
__host__ __device__ inline int plog_smem_doubles(int KK, int n_plog) {
  return n_plog ? 3 * n_plog + KK : 0;
}

// Number of doubles of dynamic shared memory one lane needs; without JAC
// it is also the offset of the KK x KK block D (dwdot/dC) that K2, K5 and
// K7 place last, right after the 32-double reduction buffer.
__host__ __device__ inline int lane_smem_doubles(int KK, int II, int n_tb,
                                                 int n_plog, bool jac) {
  return 13 * KK + 13 * II + n_tb + plog_smem_doubles(KK, n_plog) + 32 +
         (jac ? KK * KK : 0);
}

// Molar energy / (R T) and molar heat capacity / R of the energy equation:
// enthalpy and cp at constant pressure, internal energy u = h - RT and
// cv = cp - R at constant volume.
template <int PROB>
__device__ __forceinline__ double energy_RT(double h_RT) {
  return conp_like(PROB) ? h_RT : h_RT - 1.0;
}

template <int PROB>
__device__ __forceinline__ double heat_cap_R(double cp_R) {
  return conp_like(PROB) ? cp_R : cp_R - 1.0;
}

// dT/dt of the ENRG reactors with profiles (ops/reactors.py
// conp_enrg_rhs, conv_enrg_rhs): (q + P'/rho - sum h w / rho) / cp at
// constant pressure, (q - P V'/m - sum u w / rho) / cv at constant volume
// with P = rho R T / Wbar; ``hw`` is sum_k e_k wdot_k, ``cp`` the mixture's
// cp or cv, ``s_w`` sum Y/W.
template <int PROB>
__device__ __forceinline__ double prf_dTdt(const LaneTerms& L, double T,
                                           double rho, double s_w, double hw,
                                           double cp, double R) {
  const double q = heat_per_mass(L, T);
  if (conp_like(PROB)) return (q + L.cdot / rho - hw / rho) / cp;
  const double P = rho * R * T / (1.0 / maxp(s_w, 1e-30));
  return (q - P * L.cdot / L.mass - hw / rho) / cp;
}

// Sink of the lane's Jacobian entries: K2 stores J row-major in device
// memory (K5 forms the Newton matrix from them instead, sdirk_round.cu).
struct JacToGlobal {
  double* J;
  int N;
  __device__ void operator()(int i, int j, double v) const { J[i * N + j] = v; }
};

// One lane of the RHS (K1, JAC false) or of the fused (f, J) (K2, K5 and
// K7, JAC true) at the state yb [N] and the lane's constraint value cval
// (pressure for the CONP codes, density for the CONV codes). ``sm`` is the
// block's dynamic shared memory (lane_smem_doubles(JAC) doubles); f goes to
// fb [N], and each J entry to ``jac(i, j, value)``. yb must be visible to
// every thread on entry, and fb is complete only after the caller's next
// __syncthreads(). With JAC the sink may overwrite D[i * KK + j] for the
// species block: that entry is read last by the thread that computes
// J(i, j). PLOG rows read the lane's pressure: cval for the CONP codes,
// sum(C) R T for the CONV codes (with its dP/dC_k = R T and
// dP/dT = sum(C) R in the Jacobian). XK compiles the PLOG rows and the
// fractional orders in; a mechanism with neither runs the XK=false body,
// which is the lane body of the integer-order, PLOG-free kinetics alone.
// PRF adds the profile terms ``pt`` of the lane's time (``cval`` is then
// pt->c): a TGIV lane's T and dT/dt are the profile's, and the energy
// equation gains the wall heat, P'/rho (CONP) or -P V'/m (CONV) and their
// derivatives, as the reference's RHS and _batch_jac_core write them.
template <bool JAC, int PROB, bool XK, bool PRF = false, class Sink>
__device__ void chem_lane(const MechView& m, const double* yb, double cval,
                          double* sm, double* fb, const Sink& jac,
                          const LaneTerms* pt = nullptr) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int KK = m.KK, II = m.II, N = KK + 1;
  const double R = m.r_gas;
  constexpr bool CP = conp_like(PROB), TG = tgiv(PROB);

  double* Yv = sm;
  double* C = Yv + KK;
  double* lnC = C + KK;
  double* hrt = lnC + KK;
  double* cpr = hrt + KK;
  double* grt = cpr + KK;
  double* wdot = grt + KK;
  double* dln = wdot + KK;
  double* dcpr = dln + KK;   // hrt, cpr, dcpr: LANE_HRT, LANE_CPR, LANE_DCPR
  double* wT = dcpr + KK;
  double* DC = wT + KK;
  double* hD = DC + KK;
  double* dwdT = hD + KK;
  double* kf = dwdT + KK;
  double* kr = kf + II;
  double* M = kr + II;
  double* pf = M + II;
  double* pr = pf + II;
  double* q = pr + II;
  double* dkfT = q + II;
  double* dkfM = dkfT + II;
  double* dkrT = dkfM + II;
  double* dkrM = dkrT + II;
  double* qfg = dkrM + II;
  double* qrg = qfg + II;
  double* dqdT = qrg + II;
  double* G = dqdT + II;
  double* plP = G + m.n_tb;      // PLOG rows: dkf/dP, dkr/dP, dq/dP
  double* plrP = plP + m.n_plog;
  double* pldq = plrP + m.n_plog;
  double* vP = pldq + m.n_plog;  // [KK] nu^T dq/dP
  double* red = XK ? plP + plog_smem_doubles(KK, m.n_plog) : plP;
  double* D = red + 32;

  const double Traw = yb[KK];
  // TGIV: T is the profile's value, read without the floor (without PRF
  // the state's T entry holds it)
  const double T = TG ? (PRF ? pt->T : Traw) : maxp(Traw, T_FLOOR);
  const double lnT = log(T);
  // CONV codes: P = sum(C) R T on the PLOG rows
  const bool p_from_c = XK && !CP && m.n_plog > 0;

  // mixture: CONP s = sum Y/W, rho = P Wbar / (R T); CONV rho given
  double s_w = 0.0, Wbar = 0.0, rho;
  if (CP) {
    double part = 0.0;
    for (int k = tid; k < KK; k += nt) {
      const double Yk = yb[k];
      Yv[k] = Yk;
      part += Yk * (1.0 / m.wt[k]);
    }
    s_w = block_sum(part, red);
    Wbar = 1.0 / maxp(s_w, 1e-30);
    rho = cval * Wbar / (R * T);
  } else if (PRF && !TG) {
    // CONV with the energy equation: P = rho R T / Wbar in the work term
    double part = 0.0;
    for (int k = tid; k < KK; k += nt) {
      const double Yk = yb[k];
      Yv[k] = Yk;
      part += Yk * (1.0 / m.wt[k]);
    }
    s_w = block_sum(part, red);
    rho = cval;
  } else {
    for (int k = tid; k < KK; k += nt) Yv[k] = yb[k];
    rho = cval;
  }

  // species: concentrations and NASA-7 polynomials
  double c_part = 0.0;
  for (int k = tid; k < KK; k += nt) {
    const double Ck = rho * Yv[k] / m.wt[k];
    C[k] = Ck;
    if (XK) c_part += Ck;
    lnC[k] = log(maxp(Ck, TINY));
    const double* a = (T < m.t_mid[k] ? m.nasa_lo : m.nasa_hi) + 7 * k;
    cpr[k] = a[0] + T * (a[1] + T * (a[2] + T * (a[3] + T * a[4])));
    const double h = a[0] + T * (a[1] / 2 + T * (a[2] / 3 + T * (a[3] / 4 + T * a[4] / 5))) + a[5] / T;
    const double sr = a[0] * lnT + T * (a[1] + T * (a[2] / 2 + T * (a[3] / 3 + T * a[4] / 4))) + a[6];
    hrt[k] = h;
    grt[k] = h - sr;
    if (JAC) {
      dcpr[k] = a[1] + T * (2.0 * a[2] + T * (3.0 * a[3] + T * 4.0 * a[4]));
      dln[k] = Ck > TINY ? 1.0 / maxp(Ck, TINY) : 0.0;
    }
  }
  // the PLOG rows' pressure, and d(P)/dT at fixed C
  double P_pl = cval, dPdT = 0.0;
  if (p_from_c) {
    const double c_sum = block_sum(c_part, red);
    P_pl = c_sum * R * T;
    dPdT = c_sum * R;
  }
  // forward Arrhenius everywhere
  for (int i = tid; i < II; i += nt) {
    const double k = arrhenius(m.A[i], m.beta[i], m.Ea_R[i], T, lnT);
    kf[i] = k;
    kr[i] = 0.0;
    M[i] = 0.0;
    if (JAC) {
      dkfT[i] = arrhenius_dT(m.A[i], m.beta[i], m.Ea_R[i], T, lnT, k);
      dkfM[i] = 0.0;
      dkrT[i] = 0.0;
      dkrM[i] = 0.0;
    }
  }
  __syncthreads();
  // third-body concentrations
  for (int j = tid; j < m.n_tb; j += nt) {
    const double* eff = m.tb_eff + (size_t)j * KK;
    double acc = 0.0;
    for (int k = 0; k < KK; ++k) acc += eff[k] * C[k];
    M[m.tb_rows[j]] = acc;
  }
  __syncthreads();
  // falloff blending on the falloff rows
  for (int j = tid; j < m.n_fo; j += nt) {
    const int i = m.fo_rows[j];
    double dT = 0.0, dM = 0.0;
    falloff_row<JAC>(m, j, T, lnT, M[i], kf[i], JAC ? dkfT[i] : 0.0, &kf[i],
                     &dT, &dM);
    if (JAC) {
      dkfT[i] = dT;
      dkfM[i] = dM;
    }
  }
  // PLOG interpolation on the PLOG rows
  for (int j = tid; XK && j < m.n_plog; j += nt) {
    const int i = m.plog_idx[j];
    double dT = 0.0, dP = 0.0;
    plog_row<JAC>(m, j, T, lnT, P_pl, &kf[i], &dT, &dP);
    if (JAC) {
      dkfT[i] = dT;
      dkfM[i] = 0.0;
      plP[j] = dP;
      plrP[j] = 0.0;
    }
  }
  __syncthreads();
  // reverse rates on the reversible rows
  const double ln_pRT = log(m.p_atm / (R * T));
  for (int j = tid; j < m.n_rev; j += nt) {
    const int i = m.rev_rows[j];
    double nu_g = 0.0, nu_h = 0.0;
    for (int e = m.kc_ptr[j]; e < m.kc_ptr[j + 1]; ++e) {
      nu_g += m.kc_coef[e] * grt[m.kc_sp[e]];
      if (JAC) nu_h += m.kc_coef[e] * hrt[m.kc_sp[e]];
    }
    const double ln_kc = -nu_g + m.rev_dnu[j] * ln_pRT;
    const double kfi = kf[i];
    const double kfc = maxp(kfi, TINY);
    const double ln_kr = log(kfc) - ln_kc;
    const bool hasp = m.rev_hasp[j] != 0;
    double kr_exp = 0.0;
    if (hasp) kr_exp = arrhenius(m.rev_A[j], m.rev_beta[j], m.rev_Ea_R[j], T, lnT);
    kr[i] = hasp ? kr_exp : safe_exp(ln_kr);
    if (JAC) {
      if (hasp) {
        dkrT[i] = arrhenius_dT(m.rev_A[j], m.rev_beta[j], m.rev_Ea_R[j], T, lnT, kr_exp);
        dkrM[i] = 0.0;
      } else {
        const double dlnkc = (nu_h - m.rev_dnu[j]) / T;
        const double i_kf = kfi > TINY ? 1.0 : 0.0;
        const double cg = ind(ln_kr) * safe_exp(ln_kr);
        dkrT[i] = cg * (i_kf * dkfT[i] / kfc - dlnkc);
        dkrM[i] = cg * i_kf * dkfM[i] / kfc;
        if (XK && m.n_plog) {
          const int pos = m.plog_pos[i];
          if (pos >= 0) plrP[pos] = cg * i_kf * plP[pos] / kfc;
        }
      }
    }
  }
  __syncthreads();
  // concentration products and rates of progress; fractional FORD/RORD
  // entries read ln max(C, FRAC_FLOOR)
  for (int i = tid; i < II; i += nt) {
    double af = 0.0, ar = 0.0;
    if (XK && m.any_frac) {
      for (int e = m.of_ptr[i]; e < m.of_ptr[i + 1]; ++e) {
        const int k = m.of_sp[e];
        af += m.of_coef[e] * (m.of_frac[e] ? log(maxp(C[k], FRAC_FLOOR)) : lnC[k]);
      }
      for (int e = m.or_ptr[i]; e < m.or_ptr[i + 1]; ++e) {
        const int k = m.or_sp[e];
        ar += m.or_coef[e] * (m.or_frac[e] ? log(maxp(C[k], FRAC_FLOOR)) : lnC[k]);
      }
    } else {
      for (int e = m.of_ptr[i]; e < m.of_ptr[i + 1]; ++e) af += m.of_coef[e] * lnC[m.of_sp[e]];
      for (int e = m.or_ptr[i]; e < m.or_ptr[i + 1]; ++e) ar += m.or_coef[e] * lnC[m.or_sp[e]];
    }
    const double pfi = safe_exp(af), pri = safe_exp(ar);
    const double tbm = m.plain_tb[i] ? M[i] : 1.0;
    const double qf = tbm * kf[i] * pfi;
    const double qr = tbm * kr[i] * pri;
    q[i] = qf - qr;
    if (JAC) {
      pf[i] = pfi;
      pr[i] = pri;
      qfg[i] = qf * ind(af);
      qrg[i] = qr * ind(ar);
      double dkfTi = dkfT[i], dkrTi = dkrT[i];
      if (p_from_c) {
        const int pos = m.plog_pos[i];
        if (pos >= 0) {
          dkfTi = dkfTi + plP[pos] * dPdT;
          dkrTi = dkrTi + plrP[pos] * dPdT;
          pldq[pos] = tbm * (plP[pos] * pfi - plrP[pos] * pri);
        }
      }
      dqdT[i] = tbm * (dkfTi * pfi - dkrTi * pri);
    }
  }
  __syncthreads();
  if (JAC) {
    // third-body / falloff correction factors G on the third-body rows
    for (int j = tid; j < m.n_tb; j += nt) {
      const int i = m.tb_rows[j];
      const bool plain = m.plain_tb[i] != 0;
      const double tbm = plain ? M[i] : 1.0;
      G[j] = (plain ? kf[i] * pf[i] - kr[i] * pr[i] : 0.0)
           + tbm * (dkfM[i] * pf[i] - dkrM[i] * pr[i]);
    }
  }
  // wdot = nu^T q (and dwdot/dT = nu^T dq/dT, dwdot/dP = nu^T dq/dP)
  // through nu by species
  for (int k = tid; k < KK; k += nt) {
    double w = 0.0, wt_ = 0.0, wp = 0.0;
    for (int e = m.nus_ptr[k]; e < m.nus_ptr[k + 1]; ++e) {
      const int r = m.nus_rxn[e];
      w += m.nus_coef[e] * q[r];
      if (JAC) wt_ += m.nus_coef[e] * dqdT[r];
      if (JAC && p_from_c) {
        const int pos = m.plog_pos[r];
        if (pos >= 0) wp += m.nus_coef[e] * pldq[pos];
      }
    }
    wdot[k] = w;
    if (JAC) wT[k] = wt_;
    if (JAC && p_from_c) vP[k] = wp;
  }
  __syncthreads();

  // energy row: e_k = h_k (CONP) or u_k (CONV), molar; c = cp or cv
  const double RT = R * T;
  if constexpr (!JAC) {
    if constexpr (TG) {
      for (int k = tid; k < KK; k += nt) fb[k] = wdot[k] * m.wt[k] / rho;
      if (tid == 0) fb[KK] = PRF ? pt->Tdot : 0.0;
    } else {
      double ph = 0.0, pc = 0.0;
      for (int k = tid; k < KK; k += nt) {
        ph += energy_RT<PROB>(hrt[k]) * RT * wdot[k];
        pc += Yv[k] * (heat_cap_R<PROB>(cpr[k]) * R / m.wt[k]);
        fb[k] = wdot[k] * m.wt[k] / rho;
      }
      const double hw = block_sum(ph, red);
      const double cp = block_sum(pc, red);
      if (tid == 0) {
        if constexpr (PRF) fb[KK] = prf_dTdt<PROB>(*pt, T, rho, s_w, hw, cp, R);
        else fb[KK] = (-hw / rho) / cp;
      }
    }
  } else {
    // dwdot/dC: one deterministic sum per entry over its triple segment,
    // scaled by d(lnC)/dC (by d ln max(C, FRAC_FLOOR)/dC on fractional
    // entries), plus the third-body correction and, where P is rebuilt
    // from C, the PLOG rows' dwdot/dP R T
    for (int e = tid; e < KK * KK; e += nt) {
      const int ko = e / KK, ki = e - ko * KK;
      double acc = 0.0, acc_hi = 0.0;
      if (XK && m.any_frac) {
        for (int t = m.jac_ptr[e]; t < m.jac_ptr[e + 1]; ++t) {
          const int r = m.jac_rxn[t];
          const double vf = qfg[r] * m.jac_cf[t], vr = qrg[r] * m.jac_cr[t];
          if (m.jac_ff[t]) acc_hi += vf; else acc += vf;
          if (m.jac_rf[t]) acc_hi -= vr; else acc -= vr;
        }
      } else {
        for (int t = m.jac_ptr[e]; t < m.jac_ptr[e + 1]; ++t) {
          const int r = m.jac_rxn[t];
          acc += qfg[r] * m.jac_cf[t] - qrg[r] * m.jac_cr[t];
        }
      }
      double tbc = 0.0;
      for (int t = m.tbs_ptr[ko]; t < m.tbs_ptr[ko + 1]; ++t) {
        const int j = m.tbs_row[t];
        tbc += m.tbs_nu[t] * G[j] * m.tb_eff[(size_t)j * KK + ki];
      }
      double d;
      if (XK && m.any_frac) {
        const double Ck = C[ki];
        const double dln_hi = Ck > FRAC_FLOOR ? 1.0 / maxp(Ck, FRAC_FLOOR) : 0.0;
        d = acc * dln[ki] + acc_hi * dln_hi + tbc;
      } else {
        d = acc * dln[ki] + tbc;
      }
      if (p_from_c) d = d + vP[ko] * RT;
      D[e] = d;
    }
    __syncthreads();
    // D C (CONP codes only: C depends on T and Y through rho) and e^T D
    for (int k = tid; k < KK; k += nt) {
      double dc = 0.0, hd = 0.0;
      for (int j = 0; j < KK; ++j) {
        if (CP) dc += D[k * KK + j] * C[j];
        if (!TG) hd += energy_RT<PROB>(hrt[j]) * RT * D[j * KK + k];
      }
      DC[k] = dc;
      hD[k] = hd;
    }
    __syncthreads();
    if constexpr (TG) {
      // T is given: dT/dt = 0, J's T row and column are zero, and the
      // species block is that of the reactor's constraint
      for (int e = tid; e < N * N; e += nt) {
        const int i = e / N, j = e - i * N;
        double val = 0.0;
        if (i < KK && j < KK) {
          val = D[i * KK + j] * (m.wt[i] / m.wt[j]);
          if (CP) {
            const double dYdt = wdot[i] * m.wt[i] / rho;
            const double rw = Wbar / m.wt[j] * (s_w > 1e-30 ? 1.0 : 0.0);
            val = val + (dYdt - m.wt[i] * DC[i] / rho) * rw;
          }
        }
        jac(i, j, val);
      }
      for (int k = tid; k < KK; k += nt) fb[k] = wdot[k] * m.wt[k] / rho;
      if (tid == 0) fb[KK] = PRF ? pt->Tdot : 0.0;
      return;
    } else {
    double p_hw = 0.0, p_cp = 0.0, p_hdc = 0.0, p_cpw = 0.0, p_hdw = 0.0, p_dcp = 0.0;
    for (int k = tid; k < KK; k += nt) {
      const double h = energy_RT<PROB>(hrt[k]) * RT;
      const double dw = CP ? wT[k] - DC[k] / T : wT[k];
      dwdT[k] = dw;
      p_hw += h * wdot[k];
      p_cp += Yv[k] * (heat_cap_R<PROB>(cpr[k]) * R / m.wt[k]);
      if (CP) p_hdc += h * DC[k];
      p_cpw += (heat_cap_R<PROB>(cpr[k]) * R) * wdot[k];
      p_hdw += h * dw;
      p_dcp += Yv[k] * (dcpr[k] * R / m.wt[k]);
    }
    const double hw = block_sum(p_hw, red);
    const double cp = block_sum(p_cp, red);
    const double hDC = CP ? block_sum(p_hdc, red) : 0.0;
    const double cpw = block_sum(p_cpw, red);
    const double hdw = block_sum(p_hdw, red);
    const double dcp_dT = block_sum(p_dcp, red);

    const double i_s = s_w > 1e-30 ? 1.0 : 0.0;
    const double mT = Traw > T_FLOOR ? 1.0 : 0.0;
    double dTdt, dN_dT;
    if constexpr (PRF) {
      // _batch_jac_core's terms: dq/dT = -htc area / m, P'/(rho T) at
      // constant pressure, -V'/m dP/dT (dP/dT = rho R sum(Y/W)) at
      // constant volume
      dTdt = prf_dTdt<PROB>(*pt, T, rho, s_w, hw, cp, R);
      const double dq_dT = -pt->htc * pt->ar / pt->mass;
      dN_dT = CP ? dq_dT + pt->cdot / (rho * T) - (cpw + hdw) / rho -
                       hw / (rho * T)
                 : dq_dT - pt->cdot / pt->mass * (rho * R * s_w * i_s) -
                       (cpw + hdw) / rho;
    } else {
      dTdt = (-hw / rho) / cp;
      dN_dT = CP ? -(cpw + hdw) / rho - hw / (rho * T) : -(cpw + hdw) / rho;
    }
    const double J_TT = (dN_dT - dTdt * dcp_dT) / cp;

    for (int e = tid; e < N * N; e += nt) {
      const int i = e / N, j = e - i * N;
      double val;
      if (i < KK) {
        const double dYdt = wdot[i] * m.wt[i] / rho;
        if (j < KK) {
          if (CP) {
            const double rw = Wbar / m.wt[j] * i_s;
            val = D[i * KK + j] * (m.wt[i] / m.wt[j])
                + (dYdt - m.wt[i] * DC[i] / rho) * rw;
          } else {
            val = D[i * KK + j] * (m.wt[i] / m.wt[j]);
          }
        } else if (CP) {
          val = ((m.wt[i] / rho) * dwdT[i] + dYdt / T) * mT;
        } else {
          val = ((m.wt[i] / rho) * dwdT[i]) * mT;
        }
      } else if (j < KK) {
        const double cpk = heat_cap_R<PROB>(cpr[j]) * R / m.wt[j];
        if (CP) {
          const double rw = Wbar / m.wt[j] * i_s;
          const double dN_dY = PRF ? (pt->cdot - hw + hDC) * rw / rho - hD[j] / m.wt[j]
                                   : (-hw + hDC) * rw / rho - hD[j] / m.wt[j];
          val = dN_dY / cp - dTdt * cpk / cp;
        } else if (PRF) {
          const double dN_dY = -(pt->cdot / pt->mass) * rho * R * T * i_s / m.wt[j] -
                               hD[j] / m.wt[j];
          val = dN_dY / cp - dTdt * cpk / cp;
        } else {
          val = (-hD[j] / m.wt[j]) / cp - dTdt * cpk / cp;
        }
      } else {
        val = J_TT * mT;
      }
      jac(i, j, val);
    }
    for (int k = tid; k < KK; k += nt) fb[k] = wdot[k] * m.wt[k] / rho;
    if (tid == 0) fb[KK] = dTdt;
    }
  }
}

// Offsets (in units of KK doubles) of chem_lane's per-species arrays in its
// scratch, which the PSR flow shell reads after chem_lane returns: h/RT,
// cp/R and (JAC only) d(cp/R)/dT at the lane's T.
constexpr int LANE_HRT = 3, LANE_CPR = 4, LANE_DCPR = 8;

// The constants of one PSR lane (ops/psr.py PSRArgs); Yin [KK] must be
// visible to every thread.
struct PsrLane {
  double P, h_in, tau, volume, mdot, qloss, T_fixed;
  const double* Yin;
  bool vol, tgiv;   // "vol" mode (else "tau"); TGIV (else ENRG)
};

// Maximum of v over the block (NaN-keeping); every thread gets the same
// value.
__device__ __forceinline__ double block_max(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v = maxp(v, __shfl_down_sync(FULL_MASK, v, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  double s = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) s = maxp(s, red[i]);
  return s;
}

// The PSR flow shell around chem_lane (the plain twin is
// ops/jacobian.py:psr_rhs_jac), applied after chem_lane<JAC, CONP> at yb
// (the state with T = T_fixed for TGIV) has left CONP's chemistry f in fb
// and, with JAC, its J in Jm [N x N] row-major, and after a barrier:
// adds (Y_in - Y)/tau to the species rows and, for ENRG,
// (h_in - Y_in . h_k(T))/tau - Qloss/(rho V), over cp, to the T row, with
// their derivatives (-1/tau on the species diagonal, Y_in . cp_k and
// d cp/d(Y, T) in the T row, and for "vol" mode the product rule through
// tau = rho V / mdot and rho(T, Y)); TGIV zeroes the T row and column.
// ``scaled`` multiplies f by tau and J by the product rule of f tau: the
// PSR Newton's residual. ``sm`` is chem_lane's scratch, ``red`` [32] and
// ``fs`` [N] scratch. Returns tau (clamped at 1e-30) in every thread; fb
// and Jm are complete after the caller's next barrier.
template <bool JAC>
__device__ double psr_shell(const MechView& m, const double* yb,
                            const double* sm, double* fb, double* Jm,
                            const PsrLane& ps, bool scaled, double* red,
                            double* fs) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int KK = m.KK, N = KK + 1;
  const double R = m.r_gas;
  const double* hrt = sm + LANE_HRT * KK;
  const double* cpr = sm + LANE_CPR * KK;
  const double* dcpr = sm + LANE_DCPR * KK;
  const double T_raw = yb[KK];
  const double T = maxp(T_raw, T_FLOOR);
  const double mT = (!ps.tgiv && T_raw > T_FLOOR) ? 1.0 : 0.0;
  const double RT = R * T;
  double p_sw = 0.0, p_cp = 0.0, p_yh = 0.0, p_ycp = 0.0, p_dcp = 0.0;
  for (int k = tid; k < KK; k += nt) {
    const double Yk = yb[k], w = m.wt[k];
    p_sw += Yk * (1.0 / w);
    p_cp += Yk * (cpr[k] * R / w);
    p_yh += ps.Yin[k] * (hrt[k] * RT / w);
    if (JAC) {
      p_ycp += ps.Yin[k] * (cpr[k] * R / w);
      p_dcp += Yk * (dcpr[k] * R / w);
    }
  }
  const double s_w = block_sum(p_sw, red);
  const double cp = block_sum(p_cp, red);
  const double yin_h = block_sum(p_yh, red);
  const double yin_cp = JAC ? block_sum(p_ycp, red) : 0.0;
  const double dcp_dT = JAC ? block_sum(p_dcp, red) : 0.0;
  const double Wbar = 1.0 / maxp(s_w, 1e-30);
  const double rho = ps.P * Wbar / (R * T);
  double tau, V;
  if (ps.vol) {
    V = ps.volume;
    tau = rho * V / maxp(ps.mdot, TINY);
  } else {
    tau = ps.tau;
    V = tau * maxp(ps.mdot, TINY) / rho;
  }
  const double tau_c = maxp(tau, TINY);
  const double rhoV = rho * V;
  const double q = ps.qloss / maxp(rhoV, TINY);
  const double h_in_term = ps.h_in - yin_h;
  const double F = h_in_term / tau_c - q;
  for (int i = tid; i < N; i += nt) {
    if (i < KK) fs[i] = fb[i] + (ps.Yin[i] - yb[i]) / tau_c;
    else fs[i] = ps.tgiv ? 0.0 : fb[KK] + F / cp;
  }
  __syncthreads();
  if (JAC) {
    const double i_s = s_w > 1e-30 ? 1.0 : 0.0;
    const double i_tau = tau > TINY ? 1.0 : 0.0;
    const double i_rv = rhoV > TINY ? 1.0 : 0.0;
    for (int e = tid; e < N * N; e += nt) {
      const int i = e / N, j = e - i * N;
      const double dlnrho = j < KK ? -(Wbar * i_s) / m.wt[j] : -mT / T;
      const double dtau = ps.vol ? (i_tau * tau) * dlnrho : 0.0;
      double v = Jm[e];
      if (i < KK) {
        if (i == j) v -= 1.0 / tau_c;
        v -= ((ps.Yin[i] - yb[i]) / (tau_c * tau_c)) * dtau;
      } else if (ps.tgiv) {
        v = 0.0;
      } else {
        double dF = -(h_in_term / (tau_c * tau_c)) * dtau;
        if (j == KK) dF -= yin_cp * mT / tau_c;
        if (ps.vol) dF += (q * i_rv) * dlnrho;
        const double dcp = j < KK ? cpr[j] * R / m.wt[j] : dcp_dT * mT;
        v += dF / cp - (F / (cp * cp)) * dcp;
      }
      if (ps.tgiv && j == KK) v = 0.0;
      if (scaled) v = tau_c * v + fs[i] * dtau;
      Jm[e] = v;
    }
  }
  for (int i = tid; i < N; i += nt) fb[i] = scaled ? fs[i] * tau_c : fs[i];
  return tau_c;
}

// Where a kernel keeps a lane's working set: the block's dynamic shared
// memory, or (GM) the lane's slice of ``ws``, ``lane_doubles`` doubles a
// lane, which the wrapper allocates for the launch's lanes.
#define CHEM_LANE_BASE(GM, name, ws, b, lane_doubles)                    \
  CHEM_DYN_SMEM(name##_smem);                                           \
  double* name = GM ? (ws) + (size_t)(b) * (size_t)(lane_doubles)        \
                    : name##_smem

// The arguments of a K1/K2 launch beyond the mechanism: states, constraint
// values (unused with PRF), outputs, the lanes' times and profiles (PRF),
// the workspace (GM).
struct ChemCall {
  const double *y, *cval;
  double *f, *J;
  const double* t;
  ProfileView prf;
  double* ws;
  int B, problem;
  void* stream;
};

// K1 (JAC false) and K2 (JAC true): one block per lane.
template <bool JAC, int PROB, bool XK, bool PRF, bool GM>
__global__ void chem_kernel(MechView m, const double* __restrict__ y,
                            const double* __restrict__ cval,
                            double* __restrict__ f, double* __restrict__ J,
                            int B, const double* __restrict__ t,
                            ProfileView prf, double* ws) {
  const int b = blockIdx.x;
  if (b >= B) return;
  CHEM_LANE_BASE(GM, sm, ws, b,
                 lane_smem_doubles(m.KK, m.II, m.n_tb, m.n_plog, JAC));
  const int N = m.KK + 1;
  LaneTerms lt;
  double c;
  if constexpr (PRF) {
    lt = lane_terms<PROB>(prf, b, t[b]);
    c = lt.c;
  } else {
    c = cval[b];
  }
  chem_lane<JAC, PROB, XK, PRF>(m, y + (size_t)b * N, c, sm, f + (size_t)b * N,
                                JacToGlobal{J + (size_t)b * N * N, N},
                                PRF ? &lt : nullptr);
}

template <bool JAC, int PROB, bool XK, bool PRF, bool GM>
inline int launch_chem_as(const MechView* m, const ChemCall& c) {
  const int threads = 256;
  const size_t smem = GM ? 0 : sizeof(double) *
      lane_smem_doubles(m->KK, m->II, m->n_tb, m->n_plog, JAC);
  if (!GM) {
    cudaError_t err = cudaFuncSetAttribute(
        chem_kernel<JAC, PROB, XK, PRF, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  CHEM_LAUNCH(c.B, threads, smem, c.stream, chem_kernel<JAC, PROB, XK, PRF, GM>)(
      *m, c.y, c.cval, c.f, c.J, c.B, c.t, c.prf, c.ws);
  return (int)cudaGetLastError();
}

// The lane body of this mechanism: with PLOG rows or fractional orders
// (XK), or without.
__host__ __device__ inline bool extended(const MechView* m) {
  return m->n_plog > 0 || m->any_frac != 0;
}

template <bool JAC, bool XK, bool PRF, bool GM>
inline int launch_chem_xk(const MechView* m, const ChemCall& c) {
  switch (c.problem) {
    case CONP: return launch_chem_as<JAC, CONP, XK, PRF, GM>(m, c);
    case CONV: return launch_chem_as<JAC, CONV, XK, PRF, GM>(m, c);
    case CONP_TGIV: return launch_chem_as<JAC, CONP_TGIV, XK, PRF, GM>(m, c);
    case CONV_TGIV: return launch_chem_as<JAC, CONV_TGIV, XK, PRF, GM>(m, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch one chemistry kernel of the (PRF, GM) variant for ``problem``
// (CONP, CONV, CONP_TGIV or CONV_TGIV) with the mechanism's lane body: one
// block of 256 threads per lane. Each source file instantiates the
// variants it launches (rhs.cu: K1's four; rhs_jac*.cu: one of K2's each).
template <bool JAC, bool PRF, bool GM>
inline int launch_chem(const MechView* m, const ChemCall& c) {
  if (c.B <= 0) return 0;
  if (GM && c.ws == nullptr) return (int)cudaErrorInvalidValue;
  if (PRF && c.t == nullptr) return (int)cudaErrorInvalidValue;
  return extended(m) ? launch_chem_xk<JAC, true, PRF, GM>(m, c)
                     : launch_chem_xk<JAC, false, PRF, GM>(m, c);
}

// K2's variants, one source file each (rhs_jac.cu, rhs_jac_prf.cu,
// rhs_jac_gm.cu, rhs_jac_prf_gm.cu), so that nvcc builds them in parallel.
int rhs_jac_launch(const MechView* m, const ChemCall& c);
int rhs_jac_launch_prf(const MechView* m, const ChemCall& c);
int rhs_jac_launch_gm(const MechView* m, const ChemCall& c);
int rhs_jac_launch_prf_gm(const MechView* m, const ChemCall& c);

}  // namespace chem
