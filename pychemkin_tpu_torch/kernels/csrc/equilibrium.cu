// K6 equil_solve: one chemical equilibrium per lane, the whole solve in one
// launch.
//
// Replaces the JAX package's ops/equilibrium.py:258 equilibrate and :150
// _solve (with :105 _mixture_props, :130 _constraint_residual, :93
// _soft_clip, the exact-path ops/linalg.py:431 solve_with_info with row
// equilibration, and the nested ln T loop of options 6 and 9, :298-330),
// i.e. what the port's plain twin ops/equilibrium.py:equilibrate_plain
// does to one lane. The Jacobian, which the reference takes with
// jax.jacfwd, is written out in closed form (ops/equilibrium.py:resid_jac
// is the same formulas in PyTorch).
//
// Per iteration: the species loop (g/RT, ln x = ncf.lambda - g - ln(P/Patm)
// soft-clipped into [-75, 40], x, N = nbar x, h, cp, s terms), the sums
// over species of the residual and of every Jacobian entry, the two
// constraint rows, non-finite J -> 0 plus 1e-12 I, non-finite r -> 1e3, row
// equilibration, an LU with partial pivoting (largest |a|, the first on
// ties), the solve, the full-system residual check (`unstable`), damping
// (potentials 8, ln T 0.3, ln P 0.5) and the clips of ln T and ln P. The
// loops run a fixed number of iterations, as the reference's fori_loops.
//
// Bound on the H100: the lane's inputs and outputs are ~(2 KK + 12) doubles,
// so the FP64 operations bound it: per iteration ~(MM + 4)(MM + 4) KK
// multiply-adds for the sums and ~KK (60 + 40 transcendental-equivalents)
// for the species loop. Design: one warp per lane (EQ_WARPS lanes a block),
// warp-synchronous: every species quantity sits in the warp's shared
// memory, each sum over species is one thread's sequential loop (one
// deterministic order, no atomics), the n x n system (n = MM + 3 <= 12)
// is factored by rows across the warp and solved by lane 0. Control flow
// is the same in every lane (fixed iteration counts), so warps never wait
// on each other and a block needs no barrier.
//
// Storage follows the mechanism's size: a block holds as many lanes (1 to
// EQ_WARPS) as the card's opt-in shared memory fits, and GM puts each
// lane's arrays in its slice of a device-memory workspace where not even
// one fits. FAULT reads a per-lane fault flag (the reference's
// linalg_unstable injection, ops/equilibrium.py:269-272 ->
// ops/linalg.py:479-487): on a flagged lane every Newton direction of the
// fault-carrying solve is scaled by 1e8 after the residual check and the
// solve reported unstable.
#include "chem.cuh"

// The lanes' initial states and the result fields, one row per lane;
// kernels/__init__.py builds the same layout with ctypes.
struct EquilArgs {
  const double *T, *P, *Y;
  double *T_out, *P_out, *X, *Y_out, *nbar, *h, *u, *s, *v, *residual;
  unsigned char* converged;
  int* status;
  const int* fault;   // [B] linalg_unstable flags (null: no fault active)
  double* ws;         // GM: eq_lane_doubles per lane (null: shared memory)
  int option, n_iter;
};

namespace {

using chem::maxp;
using chem::minp;

constexpr int EQ_WARPS = 4;     // most lanes (warps) per block
constexpr int EQ_MAX_N = 12;    // n = MM + 3
constexpr double TINY = 1e-30;
constexpr double X_FLOOR = 1e-35;
// constraint codes, in the order of ops/equilibrium.py's CON_* (T, P, V, H,
// U, S)
constexpr int CT = 0, CP = 1, CV = 2, CH = 3, CU = 4, CS = 5;
// the nested (P, S) / (V, S) solve
constexpr int NEST_OUTER = 20, NEST_INNER = 30, NEST_FINAL = 40,
              NEST_PRE = 30, N_PRE = 50;
// SolveStatus codes (resilience/status.py)
constexpr int ST_OK = 0, ST_TOL_NOT_MET = 1, ST_LINALG_UNSTABLE = 5,
              ST_NONFINITE = 6;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(chem::FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ double clipd(double x, double lo, double hi) {
  return minp(maxp(x, lo), hi);
}

// A warp's shared memory: per-species arrays [KK], the sums G, the n x n
// system and the scalars every thread reads.
struct EqLane {
  double *x, *N, *sc, *hrt, *cpr, *dcpr, *S, *ind;   // species [KK]
  double *Xi, *Xo, *Yo;                               // [KK]: guess, result
  double *G;        // (MM + 4) x (n + 1) sums over species
  double *A, *LU;   // n x n
  double *r, *x_s, *z;  // [n]
  double *b_eff, *b_scale, *bvec;  // [MM]
  int* perm;        // [n]
};

__host__ __device__ inline int eq_lane_doubles(int KK, int MM) {
  const int n = MM + 3;
  return 11 * KK + (MM + 4) * (n + 1) + 2 * n * n + 3 * n + 3 * MM + n;
}

__device__ inline EqLane eq_layout(double* p, int KK, int MM) {
  const int n = MM + 3;
  EqLane L;
  L.x = p; p += KK;
  L.N = p; p += KK;
  L.sc = p; p += KK;
  L.hrt = p; p += KK;
  L.cpr = p; p += KK;
  L.dcpr = p; p += KK;
  L.S = p; p += KK;
  L.ind = p; p += KK;
  L.Xi = p; p += KK;
  L.Xo = p; p += KK;
  L.Yo = p; p += KK;
  L.G = p; p += (MM + 4) * (n + 1);
  L.A = p; p += n * n;
  L.LU = p; p += n * n;
  L.r = p; p += n;
  L.x_s = p; p += n;
  L.z = p; p += n;
  L.b_eff = p; p += MM;
  L.b_scale = p; p += MM;
  L.bvec = p; p += MM;
  L.perm = reinterpret_cast<int*>(p);
  return L;
}

// NASA-7 at T for species k (Horner, as the reference's thermo)
__device__ inline void nasa7(const chem::MechView& m, int k, double T,
                             double lnT, double* cp, double* h, double* s,
                             double* dcp) {
  const double* a = (T < m.t_mid[k] ? m.nasa_lo : m.nasa_hi) + 7 * k;
  *cp = a[0] + T * (a[1] + T * (a[2] + T * (a[3] + T * a[4])));
  *h = a[0] + T * (a[1] / 2 + T * (a[2] / 3 + T * (a[3] / 4 + T * a[4] / 5))) + a[5] / T;
  *s = a[0] * lnT + T * (a[1] + T * (a[2] / 2 + T * (a[3] / 3 + T * a[4] / 4))) + a[6];
  *dcp = a[1] + T * (2.0 * a[2] + T * (3.0 * a[3] + T * 4.0 * a[4]));
}

// LU with partial pivoting of the n x n A (copied into LU), solve of
// A x = rhs into xs by lane 0 (``clamp`` false: the plain division of
// getrs). Warp-synchronous; every thread must call it.
__device__ inline void warp_lu_solve(const double* A, double* LU, int* perm,
                                     const double* rhs, double* xs, int n,
                                     int lane) {
  for (int e = lane; e < n * n; e += 32) LU[e] = A[e];
  if (lane < n) perm[lane] = lane;
  __syncwarp();
  for (int k = 0; k < n; ++k) {
    double best = -1.0;
    int bi = n;
    if (lane >= k && lane < n) {
      best = fabs(LU[lane * n + k]);
      bi = lane;
      if (!(best >= 0.0)) { best = -1.0; bi = n; }   // NaN never wins
    }
    for (int o = 16; o > 0; o >>= 1) {
      const double ob = __shfl_xor_sync(chem::FULL_MASK, best, o);
      const int oi = __shfl_xor_sync(chem::FULL_MASK, bi, o);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    const int p = bi < n ? bi : k;
    if (p != k) {
      if (lane < n) {
        const double t = LU[k * n + lane];
        LU[k * n + lane] = LU[p * n + lane];
        LU[p * n + lane] = t;
      }
      if (lane == 0) {
        const int t = perm[k];
        perm[k] = perm[p];
        perm[p] = t;
      }
    }
    __syncwarp();
    if (lane > k && lane < n) {
      const double piv0 = LU[k * n + k];
      const double l = LU[lane * n + k] / (piv0 == 0.0 ? 1.0 : piv0);
      for (int j = k + 1; j < n; ++j) LU[lane * n + j] -= l * LU[k * n + j];
      LU[lane * n + k] = l;
    }
    __syncwarp();
  }
  if (lane == 0) {
    for (int i = 0; i < n; ++i) {
      double acc = rhs[perm[i]];
      for (int j = 0; j < i; ++j) acc -= LU[i * n + j] * xs[j];
      xs[i] = acc;
    }
    for (int i = n - 1; i >= 0; --i) {
      double acc = xs[i];
      for (int j = i + 1; j < n; ++j) acc -= LU[i * n + j] * xs[j];
      xs[i] = acc / LU[i * n + i];
    }
  }
  __syncwarp();
}

// The scalars of a lane's properties at z (every thread holds them).
struct Props {
  double T, P, nbar, sum_x, h, u, s, cp, v;
};

// Species loop at z, the primal sums, and with JAC the Jacobian sums
// G[row][j] (rows: MM element balances, x, h, cp, s; column n the primal).
template <bool JAC>
__device__ Props eval(const chem::MechView& m, const EqLane& L, int lane) {
  const int KK = m.KK, MM = m.MM, n = MM + 3;
  const double R = m.r_gas;
  const double lnT = L.z[MM + 1], lnP = L.z[MM + 2];
  Props p;
  p.T = exp(lnT);
  p.P = exp(lnP);
  p.nbar = exp(L.z[MM]);
  const double lnTT = log(p.T);
  const double dlnP = lnP - log(m.p_atm);
  for (int k = lane; k < KK; k += 32) {
    double cp, h, s, dcp;
    nasa7(m, k, p.T, lnTT, &cp, &h, &s, &dcp);
    double raw = 0.0;
    for (int e = 0; e < MM; ++e) raw += m.ncf[k * MM + e] * L.z[e];
    raw = raw - (h - s) - dlnP;
    // _soft_clip(raw, -75, 40) and its slope
    double lx = raw, sc = 1.0;
    if (raw > 40.0) { lx = 40.0 + log1p(maxp(raw - 40.0, 0.0)); sc = 1.0 / (1.0 + (raw - 40.0)); }
    if (lx < -75.0) { sc = 1.0 / (1.0 + (-75.0 - lx)); lx = -75.0 - log1p(maxp(-75.0 - lx, 0.0)); }
    const double x = exp(lx);
    L.x[k] = x;
    L.N[k] = p.nbar * x;
    L.sc[k] = sc;
    L.hrt[k] = h;
    L.cpr[k] = cp;
    L.dcpr[k] = dcp;
    L.S[k] = (s - clipd(lx, -85.0, 0.0) - dlnP) * R;
    L.ind[k] = (lx > -85.0 && lx < 0.0) ? 1.0 : 0.0;
  }
  __syncwarp();
  const int cols = n + 1, rows = MM + 4;
  const double RT = R * p.T;
  for (int e = lane; e < rows * cols; e += 32) {
    const int row = e / cols, j = e - row * cols;
    if (!JAC && j < n) continue;
    double acc = 0.0;
    for (int k = 0; k < KK; ++k) {
      const double Nk = L.N[k];
      if (j == n) {   // the primal sums
        if (row < MM) acc += m.ncf[k * MM + row] * Nk;
        else if (row == MM) acc += L.x[k];
        else if (row == MM + 1) acc += Nk * (L.hrt[k] * RT);
        else if (row == MM + 2) acc += Nk * (L.cpr[k] * R);
        else acc += Nk * L.S[k];
        continue;
      }
      // d ln x_k / d z_j and d N_k / d z_j
      const double a = j < MM ? m.ncf[k * MM + j]
                       : (j == MM ? 0.0 : (j == MM + 1 ? L.hrt[k] : -1.0));
      const double dlx = L.sc[k] * a;
      const double dN = Nk * (dlx + (j == MM ? 1.0 : 0.0));
      if (row < MM) {
        acc += m.ncf[k * MM + row] * dN;
      } else if (row == MM) {
        acc += L.x[k] * dlx;
      } else if (row == MM + 1) {
        acc += dN * (L.hrt[k] * RT) + (j == MM + 1 ? Nk * L.cpr[k] * RT : 0.0);
      } else if (row == MM + 2) {
        acc += dN * (L.cpr[k] * R) + (j == MM + 1 ? Nk * L.dcpr[k] * RT : 0.0);
      } else {
        acc += dN * L.S[k]
             + R * ((j == MM + 1 ? Nk * L.cpr[k] : 0.0)
                    - Nk * L.ind[k] * dlx - (j == MM + 2 ? Nk : 0.0));
      }
    }
    L.G[e] = acc;
  }
  __syncwarp();
  p.sum_x = L.G[MM * cols + n];
  p.h = L.G[(MM + 1) * cols + n];
  p.cp = L.G[(MM + 2) * cols + n];
  p.s = L.G[(MM + 3) * cols + n];
  p.u = p.h - p.nbar * R * p.T * p.sum_x;
  p.v = p.nbar * R * p.T / p.P;
  return p;
}

// One constraint's residual and, with row != nullptr, its Jacobian row.
__device__ inline double con_row(int kind, double target, const Props& p,
                                 const EqLane& L, int MM, double R,
                                 double* row) {
  const int n = MM + 3, cols = n + 1;
  const double* Gx = L.G + MM * cols;
  const double* Gh = L.G + (MM + 1) * cols;
  const double* Gc = L.G + (MM + 2) * cols;
  const double* Gs = L.G + (MM + 3) * cols;
  const double cp = maxp(p.cp, TINY);
  const double icp = p.cp > TINY ? 1.0 : 0.0;
  double r = 0.0;
  switch (kind) {
    case CT:
      r = log(p.T) - log(target);
      if (row) for (int j = 0; j < n; ++j) row[j] = j == MM + 1 ? 1.0 : 0.0;
      break;
    case CP:
      r = log(p.P) - log(target);
      if (row) for (int j = 0; j < n; ++j) row[j] = j == MM + 2 ? 1.0 : 0.0;
      break;
    case CV: {
      r = log(maxp(p.v, TINY)) - log(target);
      const double iv = p.v > TINY ? 1.0 : 0.0;
      if (row)
        for (int j = 0; j < n; ++j)
          row[j] = iv * ((j == MM ? 1.0 : 0.0) + (j == MM + 1 ? 1.0 : 0.0)
                         - (j == MM + 2 ? 1.0 : 0.0));
      break;
    }
    case CH: {
      const double cT = cp * p.T;
      r = (p.h - target) / cT;
      if (row) {
        const double q = (p.h - target) / (cT * cT);
        for (int j = 0; j < n; ++j)
          row[j] = Gh[j] / cT - q * ((icp * Gc[j]) * p.T
                                     + cT * (j == MM + 1 ? 1.0 : 0.0));
      }
      break;
    }
    case CU: {
      const double a = cp - p.nbar * R;
      const double cv = maxp(a, 0.1 * cp);
      const double cvT = cv * p.T;
      r = (p.u - target) / cvT;
      if (row) {
        const double q = (p.u - target) / (cvT * cvT);
        const double RnT = R * p.nbar * p.T;
        for (int j = 0; j < n; ++j) {
          const double en = j == MM ? 1.0 : 0.0, eT = j == MM + 1 ? 1.0 : 0.0;
          const double du = Gh[j] - RnT * (p.sum_x * (en + eT) + Gx[j]);
          const double dcp = icp * Gc[j];
          const double dcv = a > 0.1 * cp ? dcp - R * p.nbar * en : 0.1 * dcp;
          row[j] = du / cvT - q * (dcv * p.T + cvT * eT);
        }
      }
      break;
    }
    default: {   // CS
      r = (p.s - target) / cp;
      if (row) {
        const double q = (p.s - target) / (cp * cp);
        for (int j = 0; j < n; ++j) row[j] = Gs[j] / cp - q * (icp * Gc[j]);
      }
    }
  }
  return r;
}

struct System {
  int c1, c2;
  double t1, t2;
};

// Residual [n] into r and, with JAC, the Jacobian into A (rows by thread).
template <bool JAC>
__device__ Props residual(const chem::MechView& m, const EqLane& L,
                          const System& sys, int lane) {
  const int MM = m.MM, n = MM + 3, cols = n + 1;
  const Props p = eval<JAC>(m, L, lane);
  if (lane < MM) {
    L.r[lane] = (L.G[lane * cols + n] - L.b_eff[lane]) / L.b_scale[lane];
    if (JAC)
      for (int j = 0; j < n; ++j) L.A[lane * n + j] = L.G[lane * cols + j] / L.b_scale[lane];
  } else if (lane == MM) {
    L.r[MM] = log(maxp(p.sum_x, TINY));
    if (JAC) {
      const double is = p.sum_x > TINY ? 1.0 : 0.0;
      for (int j = 0; j < n; ++j) L.A[MM * n + j] = L.G[MM * cols + j] / p.sum_x * is;
    }
  } else if (lane == MM + 1 || lane == MM + 2) {
    const bool first = lane == MM + 1;
    L.r[lane] = con_row(first ? sys.c1 : sys.c2, first ? sys.t1 : sys.t2, p,
                        L, MM, m.r_gas, JAC ? L.A + lane * n : nullptr);
  }
  __syncwarp();
  return p;
}

// ``iters`` damped Newton iterations on z (in L.z); returns the last
// iteration's ``unstable`` (``unstable`` if there was none). ``flt``
// (FAULT only): the lane's injected instability.
template <bool FAULT>
__device__ bool newton(const chem::MechView& m, const EqLane& L,
                       const System& sys, int iters, bool unstable,
                       int lane, bool flt) {
  const int MM = m.MM, n = MM + 3;
  const double lo_T = log(150.0), hi_T = log(6000.0);
  const double lo_P = log(1e-2), hi_P = log(1e12);
  for (int it = 0; it < iters; ++it) {
    residual<true>(m, L, sys, lane);
    if (lane < n) {
      // sanitize, then row-equilibrate A and b = -r
      double mx = 0.0;
      for (int j = 0; j < n; ++j) {
        double a = L.A[lane * n + j];
        a = isfinite(a) ? a : 0.0;
        if (j == lane) a += 1e-12;
        L.A[lane * n + j] = a;
        mx = maxp(mx, fabs(a));
      }
      const double rs = 1.0 / maxp(mx, 1e-300);
      for (int j = 0; j < n; ++j) L.A[lane * n + j] *= rs;
      const double ri = L.r[lane];
      L.r[lane] = -(isfinite(ri) ? ri : 1e3) * rs;
    }
    __syncwarp();
    warp_lu_solve(L.A, L.LU, L.perm, L.r, L.x_s, n, lane);
    // residual of the full (equilibrated) system
    double res = 0.0, bb = 0.0;
    if (lane < n) {
      double acc = L.r[lane];
      for (int j = 0; j < n; ++j) acc -= L.A[lane * n + j] * L.x_s[j];
      res = acc * acc;
      bb = L.r[lane] * L.r[lane];
    }
    const double rn = sqrt(warp_sum(res)), bn = sqrt(warp_sum(bb));
    unstable = !(rn <= 1e-4 * bn + 1e-300);
    if (FAULT && flt) {
      // the injected unstable factor: the direction scaled far off after
      // the residual check, and the flag forced
      __syncwarp();
      if (lane < n) L.x_s[lane] *= 1e8;
      __syncwarp();
      unstable = true;
    }
    // damping
    double mxd = 0.0;
    for (int j = 0; j < n; ++j) {
      const double d = isfinite(L.x_s[j]) ? L.x_s[j] : 0.0;
      mxd = maxp(mxd, fabs(d));
    }
    const double dT = isfinite(L.x_s[MM + 1]) ? L.x_s[MM + 1] : 0.0;
    const double dP = isfinite(L.x_s[MM + 2]) ? L.x_s[MM + 2] : 0.0;
    double alpha = minp(1.0, 8.0 / maxp(mxd, TINY));
    alpha = minp(alpha, 0.3 / maxp(fabs(dT), TINY));
    alpha = minp(alpha, 0.5 / maxp(fabs(dP), TINY));
    __syncwarp();
    if (lane < n) {
      const double d = isfinite(L.x_s[lane]) ? L.x_s[lane] : 0.0;
      double zj = L.z[lane] + alpha * d;
      if (lane == MM + 1) zj = clipd(zj, lo_T, hi_T);
      if (lane == MM + 2) zj = clipd(zj, lo_P, hi_P);
      L.z[lane] = zj;
    }
    __syncwarp();
  }
  return unstable;
}

struct Result {
  double T, P, nbar, h, u, s, v, rnorm, cp_mix;
  bool converged;
  int status;
};

// The reference's _solve for one lane: b in L.bvec, X_init in L.Xi; the
// result's X and Y go to L.Xo and L.Yo; ``flt`` as newton's.
template <bool FAULT>
__device__ Result solve(const chem::MechView& m, const EqLane& L, int c1,
                        int c2, double t1, double t2, double T_init,
                        double P_init, int n_iter, int n_pre, int lane,
                        bool flt) {
  const int KK = m.KK, MM = m.MM, n = MM + 3;
  double b_tot = 0.0;
  for (int e = 0; e < MM; ++e) b_tot += L.bvec[e];
  b_tot = maxp(b_tot, TINY);
  if (lane < MM) {
    const double be = maxp(L.bvec[lane], 1e-25 * b_tot);
    L.b_eff[lane] = be;
    L.b_scale[lane] = maxp(be, 1e-6 * b_tot);
  }
  // weighted least-squares start
  const double T0 = clipd(T_init, 250.0, 5500.0);
  const double lnT0 = log(T0), lnP0 = log(P_init);
  double part = 0.0;
  for (int k = lane; k < KK; k += 32) part += maxp(L.Xi[k], 1e-10);
  const double xsum = warp_sum(part);
  const double lnT0T = log(T0);
  for (int k = lane; k < KK; k += 32) {
    const double x0 = maxp(L.Xi[k], 1e-10) / xsum;
    double cp, h, s, dcp;
    nasa7(m, k, T0, lnT0T, &cp, &h, &s, &dcp);
    L.sc[k] = maxp(x0, 0.01);                               // W
    L.x[k] = (h - s) + (lnP0 - log(m.p_atm)) + log(x0);     // t_k
  }
  __syncwarp();
  for (int e = lane; e < MM * (MM + 1); e += 32) {
    const int row = e / (MM + 1), col = e - row * (MM + 1);
    double acc = 0.0;
    for (int k = 0; k < KK; ++k) {
      const double wk = L.sc[k] * m.ncf[k * MM + row];
      acc += col < MM ? wk * m.ncf[k * MM + col] : wk * L.x[k];
    }
    if (col < MM) L.A[row * MM + col] = acc + (row == col ? 1e-8 : 0.0);
    else L.r[row] = acc;
  }
  __syncwarp();
  warp_lu_solve(L.A, L.LU, L.perm, L.r, L.x_s, MM, lane);
  if (lane < MM) L.z[lane] = L.x_s[lane];
  if (lane == 0) {
    L.z[MM] = log(maxp(b_tot, TINY));
    L.z[MM + 1] = lnT0;
    L.z[MM + 2] = lnP0;
  }
  __syncwarp();

  bool unstable = false;
  if (n_pre > 0 && !(c1 == CT && c2 == CP))
    unstable = newton<FAULT>(m, L, System{CT, CP, exp(lnT0), P_init}, n_pre,
                             unstable, lane, flt);
  const System sys{c1, c2, t1, t2};
  unstable = newton<FAULT>(m, L, sys, n_iter, unstable, lane, flt);

  const Props p = residual<false>(m, L, sys, lane);
  double rr = 0.0;
  for (int i = 0; i < n; ++i) rr += L.r[i] * L.r[i];
  Result res;
  res.rnorm = sqrt(rr / n);
  // x normalised, floored, renormalised; Y
  part = 0.0;
  const double sx = maxp(p.sum_x, TINY);
  for (int k = lane; k < KK; k += 32) {
    double x = L.x[k] / sx;
    x = x < X_FLOOR ? 0.0 : x;
    L.Xo[k] = x;
    part += x;
  }
  const double s2 = maxp(warp_sum(part), TINY);
  part = 0.0;
  for (int k = lane; k < KK; k += 32) {
    const double x = L.Xo[k] / s2;
    L.Xo[k] = x;
    part += x * m.wt[k];
  }
  const double wbar = maxp(warp_sum(part), TINY);
  part = 0.0;
  for (int k = lane; k < KK; k += 32) {
    const double y = L.Xo[k] * m.wt[k] / wbar;
    L.Yo[k] = y;
    part += y * (L.cpr[k] * m.r_gas / m.wt[k]);
  }
  res.cp_mix = warp_sum(part);   // mixture_cp_mass(T, Y) (NASA at p.T)
  __syncwarp();
  res.T = p.T;
  res.P = p.P;
  res.nbar = p.nbar;
  res.h = p.h;
  res.u = p.u;
  res.s = p.s;
  res.v = p.v;
  res.converged = res.rnorm < 1e-7;
  res.status = res.converged ? ST_OK
               : (!isfinite(res.rnorm) ? ST_NONFINITE
                  : (unstable ? ST_LINALG_UNSTABLE : ST_TOL_NOT_MET));
  return res;
}

__constant__ int OPT_C1[10] = {0, CT, CT, CT, CP, CP, CP, CV, CV, CV};
__constant__ int OPT_C2[10] = {0, CP, CV, CS, CV, CH, CS, CU, CH, CS};

template <bool FAULT, bool GM>
__global__ void __launch_bounds__(32 * EQ_WARPS)
equil_kernel(chem::MechView m, EquilArgs a, int B) {
  CHEM_DYN_SMEM(sm);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;   // the whole warp: lanes are warps
  const int KK = m.KK, MM = m.MM;
  const int per = eq_lane_doubles(KK, MM);
  const EqLane L = eq_layout(GM ? a.ws + (size_t)b * per : sm + w * per, KK, MM);
  const bool flt = FAULT && a.fault[b] != 0;
  const double R = m.r_gas;
  const double T = a.T[b], P = a.P[b];
  const double* Yb = a.Y + (size_t)b * KK;
  const int c1 = OPT_C1[a.option], c2 = OPT_C2[a.option];

  // Y normalised; element moles; initial-state targets
  double part = 0.0;
  for (int k = lane; k < KK; k += 32) part += Yb[k];
  const double ysum = maxp(warp_sum(part), TINY);
  double p_sw = 0.0, p_h = 0.0, p_u = 0.0;
  const double lnT = log(T);
  for (int k = lane; k < KK; k += 32) {
    const double y = Yb[k] / ysum;
    double cp, h, s, dcp;
    nasa7(m, k, T, lnT, &cp, &h, &s, &dcp);
    L.N[k] = y / m.wt[k];            // moles per gram
    L.S[k] = s;
    p_sw += y * (1.0 / m.wt[k]);
    p_h += y * (h * R * T / m.wt[k]);
    p_u += y * ((h - 1.0) * R * T / m.wt[k]);
  }
  const double sw = warp_sum(p_sw);
  const double h0 = warp_sum(p_h), u0 = warp_sum(p_u);
  const double wbar0 = 1.0 / maxp(sw, 1e-30);
  __syncwarp();
  part = 0.0;
  double nsum = 0.0;
  for (int k = 0; k < KK; ++k) nsum += L.N[k];
  for (int k = lane; k < KK; k += 32) {
    const double X0 = L.N[k] / nsum;
    L.Xi[k] = X0;
    part += X0 * (L.S[k] - log(maxp(X0, 1e-30)) - log(P / m.p_atm));
  }
  const double s0 = warp_sum(part) * R / wbar0;
  if (lane < MM) {
    double acc = 0.0;
    for (int k = 0; k < KK; ++k) acc += m.ncf[k * MM + lane] * L.N[k];
    L.bvec[lane] = acc;
  }
  __syncwarp();
  const double v0 = R * T / (P * wbar0);
  const double targets[6] = {T, P, v0, h0, u0, s0};
  const bool hot = c1 == CH || c2 == CH || c1 == CU || c2 == CU;
  const double T_init = hot ? maxp(T, 2200.0) : T;

  Result res;
  if (c2 == CS && (c1 == CP || c1 == CV)) {
    // nested: quasi-Newton on ln T around (T, P/V) solves
    const double s_target = targets[CS], mt = targets[c1];
    double lnTo = log(T_init), P_ws = P;
    for (int o = 0; o < NEST_OUTER; ++o) {
      const double Tn = exp(lnTo);
      res = solve<FAULT>(m, L, CT, c1, Tn, mt, Tn, P_ws, NEST_INNER, NEST_PRE,
                         lane, false);
      const double cpm = maxp(res.cp_mix, TINY);
      const double dlnT = clipd((s_target - res.s) / cpm, -0.4, 0.4);
      lnTo = clipd(lnTo + dlnT, log(200.0), log(5800.0));
      P_ws = res.P;
      for (int k = lane; k < KK; k += 32) L.Xi[k] = L.Xo[k];
      __syncwarp();
    }
    const double Tf = exp(lnTo);
    res = solve<FAULT>(m, L, CT, c1, Tf, mt, Tf, P_ws, NEST_FINAL, NEST_PRE,
                       lane, flt);
    const double cpm = maxp(res.cp_mix, TINY);
    const bool s_ok = fabs(res.s - s_target) / cpm < 1e-7;
    if (res.status == ST_OK && !s_ok) res.status = ST_TOL_NOT_MET;
    res.converged = res.converged && s_ok;
  } else {
    res = solve<FAULT>(m, L, c1, c2, targets[c1], targets[c2], T_init, P,
                       a.n_iter, N_PRE, lane, flt);
  }

  for (int k = lane; k < KK; k += 32) {
    a.X[(size_t)b * KK + k] = L.Xo[k];
    a.Y_out[(size_t)b * KK + k] = L.Yo[k];
  }
  if (lane == 0) {
    a.T_out[b] = res.T;
    a.P_out[b] = res.P;
    a.nbar[b] = res.nbar;
    a.h[b] = res.h;
    a.u[b] = res.u;
    a.s[b] = res.s;
    a.v[b] = res.v;
    a.residual[b] = res.rnorm;
    a.converged[b] = res.converged ? 1 : 0;
    a.status[b] = res.status;
  }
}


template <bool FAULT, bool GM>
int launch_equil(const chem::MechView* m, const EquilArgs* a, int B,
                 int warps, void* stream) {
  const size_t smem =
      GM ? 0 : sizeof(double) * warps * eq_lane_doubles(m->KK, m->MM);
  if (!GM) {
    cudaError_t err = cudaFuncSetAttribute(
        equil_kernel<FAULT, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + warps - 1) / warps;
  CHEM_LAUNCH(grid, 32 * warps, smem, stream, equil_kernel<FAULT, GM>)(*m, *a, B);
  return (int)cudaGetLastError();
}

}  // namespace

// ``warps``: lanes per block (1 to EQ_WARPS, the most whose arrays fit in
// the card's shared memory); the GM variant where a->ws is not null, the
// FAULT one where a->fault is not null.
extern "C" int chem_equil_solve(const chem::MechView* m, const EquilArgs* a,
                                int B, int warps, void* stream) {
  if (B <= 0) return 0;
  if (a->option < 1 || a->option > 9 || m->MM + 3 > EQ_MAX_N || warps < 1 ||
      warps > EQ_WARPS)
    return (int)cudaErrorInvalidValue;
  const bool fault = a->fault != nullptr;
  if (a->ws)
    return fault ? launch_equil<true, true>(m, a, B, warps, stream)
                 : launch_equil<false, true>(m, a, B, warps, stream);
  return fault ? launch_equil<true, false>(m, a, B, warps, stream)
               : launch_equil<false, false>(m, a, B, warps, stream);
}

// Doubles of one K6 lane (one warp): its shared memory, or its GM
// workspace.
extern "C" long long chem_equil_lane_doubles(const chem::MechView* m) {
  return eq_lane_doubles(m->KK, m->MM);
}
