// Rate and thermo device code shared by kernels K1 (rhs), K2 (rhs_jac) and
// K5 (sdirk_round).
//
// One thread block integrates the chemistry of one reactor lane: the lane's
// species and reaction intermediates live in shared memory, threads stride
// over species, reactions, and (K2) the KK x KK entries of dwdot/dC. Every
// sum runs over a contiguous CSR range of the staged index sets
// (mechanism/staging.py), so each output is one deterministic sum and no
// atomics are used.
//
// The arithmetic is that of the JAX package's staged sparse kinetics
// (ops/kinetics.py:_rop_intermediates_sparse), closed-form Jacobian
// (ops/jacobian.py:kinetics_derivatives, _rate_constant_derivatives) and
// the CONP/ENRG and CONV/ENRG chain rules (ops/jacobian.py:_batch_jac_core),
// including the +-85 exponent clip, the 1e-30 floors, sign(A) Arrhenius and
// the 50 K temperature floor. Clamps propagate NaN as the reference's do.
//
// The lane body chem_lane<JAC, PROB> is a __device__ function: K1 and K2
// are thin __global__ wrappers around it, and K5 calls it for every RHS
// and Jacobian of its step attempts, so all three compute one arithmetic.
// PROB is the constraint of the reactor: CONP (the lane's value is its
// pressure) or CONV (its density).
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
constexpr unsigned FULL_MASK = 0xffffffffu;
// reactor constraint of a lane (template parameter PROB)
constexpr int CONP = 0;
constexpr int CONV = 1;

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
  double r_gas, p_atm;
  int KK, II, n_fo, n_tb, n_rev, MM;
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

// Number of doubles of dynamic shared memory one lane needs; without JAC
// it is also the offset of the KK x KK block D (dwdot/dC) that K2 and K5
// place last.
__host__ __device__ inline int lane_smem_doubles(int KK, int II, int n_tb,
                                                 bool jac) {
  return 13 * KK + 13 * II + n_tb + 32 + (jac ? KK * KK : 0);
}

// Molar energy / (R T) and molar heat capacity / R of the energy equation:
// enthalpy and cp at constant pressure, internal energy u = h - RT and
// cv = cp - R at constant volume.
template <int PROB>
__device__ __forceinline__ double energy_RT(double h_RT) {
  return PROB == CONP ? h_RT : h_RT - 1.0;
}

template <int PROB>
__device__ __forceinline__ double heat_cap_R(double cp_R) {
  return PROB == CONP ? cp_R : cp_R - 1.0;
}

// Sink of the lane's Jacobian entries: K2 stores J row-major in device
// memory (K5 forms the Newton matrix from them instead, sdirk_round.cu).
struct JacToGlobal {
  double* J;
  int N;
  __device__ void operator()(int i, int j, double v) const { J[i * N + j] = v; }
};

// One lane of the RHS (K1, JAC false) or of the fused (f, J) (K2 and K5,
// JAC true) at the state yb [N] and the lane's constraint value cval
// (pressure for CONP, density for CONV). ``sm`` is the block's dynamic
// shared memory (lane_smem_doubles(JAC) doubles); f goes to fb [N], and each
// J entry to ``jac(i, j, value)``. yb must be visible to every thread on
// entry, and fb is complete only after the caller's next __syncthreads().
// With JAC the sink may overwrite D[i * KK + j] for the species block:
// that entry is read last by the thread that computes J(i, j).
template <bool JAC, int PROB, class Sink>
__device__ void chem_lane(const MechView& m, const double* yb, double cval,
                          double* sm, double* fb, const Sink& jac) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int KK = m.KK, II = m.II, N = KK + 1;
  const double R = m.r_gas;

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
  double* red = G + m.n_tb;
  double* D = red + 32;

  const double Traw = yb[KK];
  const double T = maxp(Traw, T_FLOOR);
  const double lnT = log(T);

  // mixture: CONP s = sum Y/W, rho = P Wbar / (R T); CONV rho given
  double s_w = 0.0, Wbar = 0.0, rho;
  if (PROB == CONP) {
    double part = 0.0;
    for (int k = tid; k < KK; k += nt) {
      const double Yk = yb[k];
      Yv[k] = Yk;
      part += Yk * (1.0 / m.wt[k]);
    }
    s_w = block_sum(part, red);
    Wbar = 1.0 / maxp(s_w, 1e-30);
    rho = cval * Wbar / (R * T);
  } else {
    for (int k = tid; k < KK; k += nt) Yv[k] = yb[k];
    rho = cval;
  }

  // species: concentrations and NASA-7 polynomials
  for (int k = tid; k < KK; k += nt) {
    const double Ck = rho * Yv[k] / m.wt[k];
    C[k] = Ck;
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
      }
    }
  }
  __syncthreads();
  // concentration products and rates of progress
  for (int i = tid; i < II; i += nt) {
    double af = 0.0, ar = 0.0;
    for (int e = m.of_ptr[i]; e < m.of_ptr[i + 1]; ++e) af += m.of_coef[e] * lnC[m.of_sp[e]];
    for (int e = m.or_ptr[i]; e < m.or_ptr[i + 1]; ++e) ar += m.or_coef[e] * lnC[m.or_sp[e]];
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
      dqdT[i] = tbm * (dkfT[i] * pfi - dkrT[i] * pri);
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
  // wdot = nu^T q (and dwdot/dT = nu^T dq/dT) through nu by species
  for (int k = tid; k < KK; k += nt) {
    double w = 0.0, wt_ = 0.0;
    for (int e = m.nus_ptr[k]; e < m.nus_ptr[k + 1]; ++e) {
      w += m.nus_coef[e] * q[m.nus_rxn[e]];
      if (JAC) wt_ += m.nus_coef[e] * dqdT[m.nus_rxn[e]];
    }
    wdot[k] = w;
    if (JAC) wT[k] = wt_;
  }
  __syncthreads();

  // energy row: e_k = h_k (CONP) or u_k (CONV), molar; c = cp or cv
  const double RT = R * T;
  if constexpr (!JAC) {
    double ph = 0.0, pc = 0.0;
    for (int k = tid; k < KK; k += nt) {
      ph += energy_RT<PROB>(hrt[k]) * RT * wdot[k];
      pc += Yv[k] * (heat_cap_R<PROB>(cpr[k]) * R / m.wt[k]);
      fb[k] = wdot[k] * m.wt[k] / rho;
    }
    const double hw = block_sum(ph, red);
    const double cp = block_sum(pc, red);
    if (tid == 0) fb[KK] = (-hw / rho) / cp;
  } else {
    // dwdot/dC: one deterministic sum per entry over its triple segment,
    // scaled by d(lnC)/dC, plus the third-body correction
    for (int e = tid; e < KK * KK; e += nt) {
      const int ko = e / KK, ki = e - ko * KK;
      double acc = 0.0;
      for (int t = m.jac_ptr[e]; t < m.jac_ptr[e + 1]; ++t) {
        const int r = m.jac_rxn[t];
        acc += qfg[r] * m.jac_cf[t] - qrg[r] * m.jac_cr[t];
      }
      double tbc = 0.0;
      for (int t = m.tbs_ptr[ko]; t < m.tbs_ptr[ko + 1]; ++t) {
        const int j = m.tbs_row[t];
        tbc += m.tbs_nu[t] * G[j] * m.tb_eff[(size_t)j * KK + ki];
      }
      D[e] = acc * dln[ki] + tbc;
    }
    __syncthreads();
    // D C (CONP only: C depends on T and Y through rho) and e^T D
    for (int k = tid; k < KK; k += nt) {
      double dc = 0.0, hd = 0.0;
      for (int j = 0; j < KK; ++j) {
        if (PROB == CONP) dc += D[k * KK + j] * C[j];
        hd += energy_RT<PROB>(hrt[j]) * RT * D[j * KK + k];
      }
      DC[k] = dc;
      hD[k] = hd;
    }
    __syncthreads();
    double p_hw = 0.0, p_cp = 0.0, p_hdc = 0.0, p_cpw = 0.0, p_hdw = 0.0, p_dcp = 0.0;
    for (int k = tid; k < KK; k += nt) {
      const double h = energy_RT<PROB>(hrt[k]) * RT;
      const double dw = PROB == CONP ? wT[k] - DC[k] / T : wT[k];
      dwdT[k] = dw;
      p_hw += h * wdot[k];
      p_cp += Yv[k] * (heat_cap_R<PROB>(cpr[k]) * R / m.wt[k]);
      if (PROB == CONP) p_hdc += h * DC[k];
      p_cpw += (heat_cap_R<PROB>(cpr[k]) * R) * wdot[k];
      p_hdw += h * dw;
      p_dcp += Yv[k] * (dcpr[k] * R / m.wt[k]);
    }
    const double hw = block_sum(p_hw, red);
    const double cp = block_sum(p_cp, red);
    const double hDC = PROB == CONP ? block_sum(p_hdc, red) : 0.0;
    const double cpw = block_sum(p_cpw, red);
    const double hdw = block_sum(p_hdw, red);
    const double dcp_dT = block_sum(p_dcp, red);

    const double i_s = s_w > 1e-30 ? 1.0 : 0.0;
    const double mT = Traw > T_FLOOR ? 1.0 : 0.0;
    const double dTdt = (-hw / rho) / cp;
    const double dN_dT = PROB == CONP ? -(cpw + hdw) / rho - hw / (rho * T)
                                      : -(cpw + hdw) / rho;
    const double J_TT = (dN_dT - dTdt * dcp_dT) / cp;

    for (int e = tid; e < N * N; e += nt) {
      const int i = e / N, j = e - i * N;
      double val;
      if (i < KK) {
        const double dYdt = wdot[i] * m.wt[i] / rho;
        if (j < KK) {
          if (PROB == CONP) {
            const double rw = Wbar / m.wt[j] * i_s;
            val = D[i * KK + j] * (m.wt[i] / m.wt[j])
                + (dYdt - m.wt[i] * DC[i] / rho) * rw;
          } else {
            val = D[i * KK + j] * (m.wt[i] / m.wt[j]);
          }
        } else if (PROB == CONP) {
          val = ((m.wt[i] / rho) * dwdT[i] + dYdt / T) * mT;
        } else {
          val = ((m.wt[i] / rho) * dwdT[i]) * mT;
        }
      } else if (j < KK) {
        const double cpk = heat_cap_R<PROB>(cpr[j]) * R / m.wt[j];
        if (PROB == CONP) {
          const double rw = Wbar / m.wt[j] * i_s;
          const double dN_dY = (-hw + hDC) * rw / rho - hD[j] / m.wt[j];
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

// K1 (JAC false) and K2 (JAC true): one block per lane.
template <bool JAC, int PROB>
__global__ void chem_kernel(MechView m, const double* __restrict__ y,
                            const double* __restrict__ cval,
                            double* __restrict__ f, double* __restrict__ J,
                            int B) {
  CHEM_DYN_SMEM(sm);
  const int b = blockIdx.x;
  if (b >= B) return;
  const int N = m.KK + 1;
  chem_lane<JAC, PROB>(m, y + (size_t)b * N, cval[b], sm, f + (size_t)b * N,
                       JacToGlobal{J + (size_t)b * N * N, N});
}

template <bool JAC, int PROB>
inline int launch_chem_as(const MechView* m, const double* y,
                          const double* cval, double* f, double* J, int B,
                          void* stream) {
  const int threads = 256;
  const size_t smem = sizeof(double) * lane_smem_doubles(m->KK, m->II, m->n_tb, JAC);
  cudaError_t err = cudaFuncSetAttribute(chem_kernel<JAC, PROB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  CHEM_LAUNCH(B, threads, smem, stream, chem_kernel<JAC, PROB>)(*m, y, cval, f, J, B);
  return (int)cudaGetLastError();
}

// Launch one chemistry kernel for ``problem`` (CONP or CONV): one block
// of 256 threads per lane.
template <bool JAC>
inline int launch_chem(const MechView* m, const double* y, const double* cval,
                       double* f, double* J, int B, int problem,
                       void* stream) {
  if (B <= 0) return 0;
  if (problem == CONP) return launch_chem_as<JAC, CONP>(m, y, cval, f, J, B, stream);
  if (problem == CONV) return launch_chem_as<JAC, CONV>(m, y, cval, f, J, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace chem
