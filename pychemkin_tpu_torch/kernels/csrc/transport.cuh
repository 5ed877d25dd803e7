// Transport device code shared by kernels K9 (transport_props), K10
// (flame_residual) and K11 (flame_jac).
//
// The arithmetic is that of the JAX package's ops/transport.py (:38-229):
// Neufeld collision integrals with the Brokaw dipole term and the 1e-3
// floor of t*, Chapman-Enskog species viscosities, the Warnatz split of the
// species conductivities with the Parker Zrot(T), binary diffusion over the
// combined pair parameters, the Wilke viscosity, the combination-averaged
// conductivity and the mixture-averaged diffusion coefficients over
// x = max(X, 1e-30) renormalised (with the pure-species limit D_kk where
// sum_{j != k} x_j / D_jk <= 1e-30), and the light-species thermal
// diffusion ratios with the plateau constants B* = 1.11 and C* = 0.93.
//
// Every function is a serial per-thread template over the scalar type S:
// double (K9, K10) or Dual, a forward-mode dual number that carries one
// tangent (K11: one tangent per thread, so that K11 computes what
// jax.jacfwd of the reference's stencil computes, with jacfwd's one-sided
// derivative at a clip's bound: half the slope at a tie of max/min, the
// branch's slope through a where).
//
// The pair parameters (sigma_jk, eps_jk with the polar/nonpolar induction
// correction, the reduced mass and the pair reduced dipole) and the species
// reduced dipole depend on the mechanism alone: the wrapper computes them
// once per mechanism on the device with the plain twin's formulas
// (ops/transport.py:pair_params) and passes them in TransView.
#pragma once
#include "chem.cuh"

namespace chem {

constexpr double PI = 3.141592653589793;
constexpr double PI15 = 5.568327996831708;       // pi ** 1.5
constexpr double HALF_PI15 = 2.784163998415854;  // 0.5 * pi ** 1.5
constexpr double PARKER_E = 4.4674011002723395;  // 0.25 * pi ** 2 + 2
constexpr double TWO_PI_INV = 0.6366197723675814;  // 2 / pi
constexpr double BOLTZMANN = 1.380649e-16;
constexpr double AVOGADRO = 6.02214076e+23;
constexpr double ANGSTROM = 1.0e-8;

// Forward-mode dual number: value and one tangent.
struct Dual {
  double v, d;
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator+(Dual a, double b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(double a, Dual b) { return {a + b.v, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, double b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(double a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(Dual a, double b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(double a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  return {a.v / b.v, (a.d * b.v - a.v * b.d) / (b.v * b.v)};
}
__device__ __forceinline__ Dual operator/(Dual a, double b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ Dual operator/(double a, Dual b) {
  return {a / b.v, -a * b.d / (b.v * b.v)};
}

__device__ __forceinline__ double val(double x) { return x; }
__device__ __forceinline__ double val(Dual x) { return x.v; }
__device__ __forceinline__ double tan_of(double) { return 0.0; }
__device__ __forceinline__ double tan_of(Dual x) { return x.d; }

__device__ __forceinline__ double s_exp(double x) { return exp(x); }
__device__ __forceinline__ Dual s_exp(Dual x) {
  const double e = exp(x.v);
  return {e, e * x.d};
}
__device__ __forceinline__ double s_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ Dual s_sqrt(Dual x) {
  const double r = sqrt(x.v);
  return {r, x.d * (0.5 / r)};
}
// x ** p for a constant exponent
__device__ __forceinline__ double s_pow(double x, double p) { return pow(x, p); }
__device__ __forceinline__ Dual s_pow(Dual x, double p) {
  return {pow(x.v, p), x.d * (p * pow(x.v, p - 1.0))};
}

// max(x, c) and min(x, c) for a constant c, NaN-keeping; the tangent is
// jax.jacfwd's: the slope above (below), half of it at the tie, 0 past it
__device__ __forceinline__ double fmaxc(double x, double c) { return maxp(x, c); }
__device__ __forceinline__ Dual fmaxc(Dual x, double c) {
  return {maxp(x.v, c), x.v > c ? x.d : (x.v == c ? 0.5 * x.d : 0.0)};
}
__device__ __forceinline__ double fminc(double x, double c) { return minp(x, c); }
__device__ __forceinline__ Dual fminc(Dual x, double c) {
  return {minp(x.v, c), x.v < c ? x.d : (x.v == c ? 0.5 * x.d : 0.0)};
}
// clip(Y, 0, 1) as jnp.clip: min(max(Y, 0), 1)
template <class S>
__device__ __forceinline__ S clip01(S y) {
  return fminc(fmaxc(y, 0.0), 1.0);
}

// The mechanism's transport data on the device (kernels/flame.py builds the
// same layout with ctypes): geometry code, eps/k (K), sigma (Angstrom),
// Zrot(298), the species reduced dipole [KK], and the pair parameters
// [KK, KK] row-major: sigma_jk (cm), eps_jk (K), reduced mass (g), pair
// reduced dipole.
struct TransView {
  const int* geom;
  const double *eps_k, *sigma, *zrot, *delta;
  const double *psig, *peps, *pmred, *pdelta;
};

template <class S>
__device__ __forceinline__ S omega22(S t_star, double delta_star) {
  const S ts = fmaxc(t_star, 1e-3);
  const S base = 1.16145 * s_pow(ts, -0.14874) + 0.52487 * s_exp(-0.77320 * ts) +
                 2.16178 * s_exp(-2.43787 * ts);
  return base + (0.2 * (delta_star * delta_star)) / ts;
}

template <class S>
__device__ __forceinline__ S omega11(S t_star, double delta_star) {
  const S ts = fmaxc(t_star, 1e-3);
  const S base = 1.06036 * s_pow(ts, -0.15610) + 0.19300 * s_exp(-0.47635 * ts) +
                 1.03587 * s_exp(-1.52996 * ts) + 1.76474 * s_exp(-3.89411 * ts);
  return base + (0.19 * (delta_star * delta_star)) / ts;
}

// cp/R of species k at T (NASA-7, the range chosen by T's value)
template <class S>
__device__ __forceinline__ S species_cp_R(const MechView& m, int k, S T) {
  const double* a = (val(T) < m.t_mid[k] ? m.nasa_lo : m.nasa_hi) + 7 * k;
  return a[0] + T * (a[1] + T * (a[2] + T * (a[3] + T * a[4])));
}

// Pure-species viscosity (g/(cm s)) and conductivity (erg/(cm K s)) of
// species k at T (ops/transport.py:63-116).
template <class S>
__device__ void species_mu_lam(const MechView& m, const TransView& tv, int k,
                               S T, S* mu_out, S* lam_out) {
  const double w = m.wt[k];
  const double mk = w / AVOGADRO;
  const double sig = tv.sigma[k] * ANGSTROM;
  const double den = PI * (sig * sig);
  const S t_star = T / tv.eps_k[k];
  const S root = s_sqrt(PI * mk * BOLTZMANN * T);
  const S mu = (5.0 / 16.0) * root / (den * omega22(t_star, tv.delta[k]));
  *mu_out = mu;
  if (lam_out == nullptr) return;
  const S rhoD = (3.0 / 8.0) * root / (den * omega11(t_star, tv.delta[k]));
  const S cv_R = species_cp_R(m, k, T) - 1.0;
  const int g = tv.geom[k];
  const double cv_rot = g == 1 ? 1.0 : (g == 2 ? 1.5 : 0.0);
  const S cv_vib = fmaxc(cv_R - 1.5 - cv_rot, 0.0);
  const S f_vib = rhoD / fmaxc(mu, 1e-300);
  const S A = 2.5 - f_vib;
  // Parker: Zrot(T) = Zrot(298) F(298) / F(T)
  const double e298 = tv.eps_k[k] / 298.0;
  const double F298 = 1.0 + HALF_PI15 * sqrt(e298) + PARKER_E * e298 +
                      PI15 * pow(e298, 1.5);
  const S e = tv.eps_k[k] / T;
  const S FT = 1.0 + HALF_PI15 * s_sqrt(e) + PARKER_E * e + PI15 * s_pow(e, 1.5);
  const S zrot = tv.zrot[k] * F298 / FT;
  const S B = zrot + TWO_PI_INV * ((5.0 / 3.0) * cv_rot + f_vib);
  S f_tr, f_rot;
  if (cv_rot > 0.0) {
    f_tr = 2.5 * (1.0 - TWO_PI_INV * (cv_rot / 1.5) * (A / B));
    f_rot = f_vib * (1.0 + TWO_PI_INV * (A / B));
  } else {
    f_tr = S{} + 2.5;
    f_rot = S{} + 0.0;
  }
  *lam_out = (mu / w) * m.r_gas * (f_tr * 1.5 + f_rot * cv_rot + f_vib * cv_vib);
}

// Binary diffusion coefficient D_kj (cm^2/s) at (T, P), ops/transport.py:146.
template <class S>
__device__ __forceinline__ S binary_diffusion(const TransView& tv, int KK, int k,
                                              int j, S T, double P) {
  const int e = k * KK + j;
  const double sig = tv.psig[e];
  const S om = omega11(T / tv.peps[e], tv.pdelta[e]);
  const S kT = BOLTZMANN * T;
  // ** 3 as the reference's integer power: two products
  return (3.0 / 16.0) * s_sqrt(2.0 * PI * (kT * kT * kT) / tv.pmred[e]) /
         (P * PI * (sig * sig) * om);
}

// x = max(X, 1e-30) / sum(max(X, 1e-30)) of mole fractions X [KK] into x.
template <class S>
__device__ void floored_fractions(int KK, const S* X, S* x) {
  S s = S{};
  for (int k = 0; k < KK; ++k) s = s + fmaxc(X[k], 1e-30);
  for (int k = 0; k < KK; ++k) x[k] = fmaxc(X[k], 1e-30) / s;
}

// Combination-averaged mixture conductivity at T over the floored,
// renormalised fractions x [KK] (ops/transport.py:174).
template <class S>
__device__ S mixture_lambda(const MechView& m, const TransView& tv, S T,
                            const S* x) {
  S a = S{}, b = S{};
  for (int k = 0; k < m.KK; ++k) {
    S mu, lam;
    species_mu_lam(m, tv, k, T, &mu, &lam);
    a = a + x[k] * lam;
    b = b + x[k] * (1.0 / fmaxc(lam, 1e-300));
  }
  return 0.5 * (a + 1.0 / b);
}

// Mixture-averaged diffusion coefficient of species k over x from its
// binary coefficients D_kj = Dkj(j) (ops/transport.py:185); ``Yk`` is
// species k's mass fraction of x.
template <class S, class Row>
__device__ S mixture_diffusion_of(int KK, int k, const S* x, S Yk, Row Dkj) {
  S sum = S{}, inv_k = S{}, D_kk = S{};
  for (int j = 0; j < KK; ++j) {
    const S D = Dkj(j);
    const S inv = x[j] / D;
    sum = sum + inv;
    if (j == k) {
      inv_k = inv;
      D_kk = D;
    }
  }
  const S off = sum - inv_k;
  return val(off) > 1e-30 ? (1.0 - Yk) / fmaxc(off, 1e-300) : D_kk;
}

// The same at (T, P), each D_kj computed here (the faces of K10 and K11).
template <class S>
__device__ S mixture_diffusion(const TransView& tv, int KK, int k, S T,
                               double P, const S* x, S Yk) {
  return mixture_diffusion_of(KK, k, x, Yk, [&](int j) {
    return binary_diffusion(tv, KK, k, j, T, P);
  });
}

// Thermal diffusion ratio of species k at T over x (ops/transport.py:201).
template <class S>
__device__ S thermal_diffusion(const MechView& m, const TransView& tv, int k,
                               S T, const S* x) {
  const int KK = m.KK;
  const double wk = m.wt[k];
  if (!(wk <= 5.0)) return S{};
  S acc = S{};
  for (int j = 0; j < KK; ++j) {
    const int e = k * KK + j;
    const S t_star = T / tv.peps[e];
    const S a = omega22(t_star, tv.pdelta[e]) / omega11(t_star, tv.pdelta[e]);
    const S factor = (15.0 / 2.0) * (2.0 * a + 5.0) * (6.0 * 0.93 - 5.0) /
                     (a * (16.0 * a - 12.0 * 1.11 + 55.0));
    const double wj = m.wt[j];
    const double dm = (wk - wj) / (wk + wj);
    acc = acc + factor * dm * x[j];
  }
  return acc * x[k];
}

// The arguments of a K9 launch: states T, P [B], X [B, KK]; outputs species
// viscosities and conductivities [B, KK], mixture viscosity and
// conductivity [B], D_km and Theta [B, KK], the binary diffusion
// coefficients [B, KK, KK]; ``ws`` 2 KK doubles a state.
struct TransportCall {
  const double *T, *P, *X;
  double *mu_k, *lam_k, *mu, *lam, *D, *theta, *Djk, *ws;
  int B;
  void* stream;
};

}  // namespace chem
