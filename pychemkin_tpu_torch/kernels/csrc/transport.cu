// K9 transport_props: every transport property of K states at once,
// (T, P [B], X [B, KK]) -> species viscosities and conductivities
// [B, KK], the Wilke mixture viscosity and the combination-averaged
// conductivity [B], the mixture-averaged diffusion coefficients and the
// thermal diffusion ratios [B, KK], and the binary diffusion coefficients
// [B, KK, KK].
//
// Replaces the JAX package's ops/transport.py:63-229 (species_viscosities,
// _parker_zrot, species_conductivities, binary_diffusion_coefficients
// through _pair_params, mixture_viscosity, mixture_conductivity,
// mixture_diffusion_coefficients, thermal_diffusion_ratios), which the
// Mixture getters call one state at a time.
//
// Bound on the H100: by bytes. A state reads KK + 2 doubles and writes
// KK^2 + 4 KK + 2; its work is KK (KK + 1) / 2 pair collision integrals (a
// pow and three exps each) for D_jk, which D_km reuses, one more integral
// per pair on the rows of Theta with W <= 5, KK Wilke terms per species,
// and KK species integrals. Design: one thread per state runs the serial double
// instantiation of transport.cuh, the code K10 and K11 run at the flame's
// faces; the floored, renormalised fractions live in the state's slice of
// a device-memory workspace (2 KK doubles). Blocks of 128 states.
#include "transport.cuh"

namespace chem {

__global__ void transport_kernel(MechView m, TransView tv, TransportCall c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= c.B) return;
  const int KK = m.KK;
  const double T = c.T[b], P = c.P[b];
  const double* X = c.X + (size_t)b * KK;
  double* mu_k = c.mu_k + (size_t)b * KK;
  double* lam_k = c.lam_k + (size_t)b * KK;
  double* x = c.ws + (size_t)b * 2 * KK;
  for (int k = 0; k < KK; ++k) species_mu_lam(m, tv, k, T, &mu_k[k], &lam_k[k]);
  // Wilke over x = max(X, 1e-30) (not renormalised, as the reference)
  double mu = 0.0;
  for (int k = 0; k < KK; ++k) {
    double den = 0.0;
    for (int j = 0; j < KK; ++j) {
      const double ratio_w = m.wt[j] / m.wt[k];
      const double s = 1.0 + sqrt(mu_k[k] / maxp(mu_k[j], 1e-300)) * pow(ratio_w, 0.25);
      const double phi = (s * s) / sqrt(8.0 * (1.0 + 1.0 / ratio_w));
      den += phi * maxp(X[j], 1e-30);
    }
    mu += maxp(X[k], 1e-30) * mu_k[k] / maxp(den, 1e-300);
  }
  c.mu[b] = mu;
  floored_fractions(KK, X, x);
  double a = 0.0, r = 0.0, sxw = 0.0;
  for (int k = 0; k < KK; ++k) {
    a += x[k] * lam_k[k];
    r += x[k] * (1.0 / maxp(lam_k[k], 1e-300));
    sxw += x[k] * m.wt[k];
  }
  c.lam[b] = 0.5 * (a + 1.0 / r);
  for (int k = 0; k < KK; ++k) {
    // D_km from the row of binary coefficients just written
    double* Dk = c.Djk + ((size_t)b * KK + k) * KK;
    for (int j = 0; j < KK; ++j) Dk[j] = binary_diffusion(tv, KK, k, j, T, P);
    c.D[(size_t)b * KK + k] =
        mixture_diffusion_of(KK, k, x, x[k] * m.wt[k] / sxw, [&](int j) { return Dk[j]; });
    c.theta[(size_t)b * KK + k] = thermal_diffusion(m, tv, k, T, x);
  }
}

}  // namespace chem

// K9: the transport properties of B states; ``ws`` holds 2 KK doubles a
// state.
extern "C" int chem_transport_props(const chem::MechView* m,
                                    const chem::TransView* tv,
                                    const chem::TransportCall* c) {
  if (c->B <= 0) return 0;
  if (c->ws == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  CHEM_LAUNCH((c->B + threads - 1) / threads, threads, 0, c->stream,
              chem::transport_kernel)(*m, *tv, *c);
  return (int)cudaGetLastError();
}
