// The 1-D premixed flame's stencil, shared by kernels K10 (flame_residual)
// and K11 (flame_jac).
//
// Replaces the JAX package's ops/flame1d.py:103-275: _face (both faces'
// conduction and diffusion fluxes: mixture-averaged or fixed-Lewis
// diffusion, the optional Soret term and the correction flux
// j - Y_f sum(j)), the interior rows of make_residual (upwind or central
// convection, the energy row over rho cp, the species rows over rho, the
// pinned-point eigenvalue rows of the free flame), left_bc and right_bc,
// and jacobian_blocks (jax.jacfwd of those stencils). Y is clipped to
// [0, 1] before every conversion, as the reference clips it.
//
// Design: one block per grid point. At an interior point the block first
// runs the chemistry lane body of K1/K2 (chem_lane<JAC, CONP, XK>, the XK
// body for fractional orders or PLOG rows) at (clip(Y_i), T_i) and the
// flame's pressure: its f holds wdot W / rho and -sum h wdot W / (rho cp),
// exactly the chemistry terms of the species and energy rows, and with JAC
// its closed-form J holds their derivatives in (Y, T) at constant P. Then
// the flame's own terms (the faces' fluxes, convection, the boundary and
// eigenvalue rows) run as a serial per-thread template over the scalar type
// (transport.cuh): K10 evaluates them in doubles on one thread and adds the
// chemistry values; K11 runs one thread per tangent (3M at an interior
// point, 2M at a boundary) with a dual number seeded with the unit tangent
// on one unknown of (u_{i-1}, u_i, u_{i+1}), and adds the chemistry
// columns of J, chained through Y's clip (half the slope at a bound, as
// jax.jacfwd takes jnp.clip). Each thread's arrays (its three points, the
// faces' fractions and fluxes, the rows) live in its slice of a
// device-memory workspace (flame_thread_doubles).
#pragma once
#include <type_traits>

#include "transport.cuh"

namespace chem {

// The arguments of a K10/K11 launch beyond the mechanism: the packed state
// u [N, M] (M = KK + 2: T, Mdot, Y), the grid x [N], the given temperature
// T_given [N] (TGIV) and the inlet Y_in [KK]; the outputs (K10: F [N, M];
// K11: the blocks B, A, C [N, M, M], row-major in (row, column)); the
// workspace; the problem's scalars and switches (FlameConfig, FlameData).
struct FlameArgs {
  const double *u, *x, *T_given, *Y_in;
  double *F, *Bb, *Ab, *Cb, *ws;
  double P, T_in, mdot_in, T_fix, lewis;
  int N, i_fix, tgiv, free_flame, upwind, lewis_tr, soret, flux_bc;
};

// Doubles of one thread's workspace slice: the three points (3 M), the
// rows (M) and the face arrays (4 KK), in scalars of S (a Dual is two
// doubles).
__host__ __device__ inline int flame_thread_doubles(int KK, bool jac) {
  return (4 * (KK + 2) + 4 * KK) * (jac ? 2 : 1);
}

// Threads of one K10/K11 block: K11 one per tangent of an interior point
// (3 M), rounded up to whole warps; K10 two warps.
__host__ __device__ inline int flame_threads(int KK, bool jac) {
  return jac ? ((3 * (KK + 2) + 31) / 32) * 32 : 64;
}

// Workspace slices of one block: one per tangent (K11), one (K10).
__host__ __device__ inline int flame_slots(int KK, bool jac) {
  return jac ? 3 * (KK + 2) : 1;
}

// Sink of the chemistry lane body: J row-major in shared memory.
struct FlameJacSink {
  double* J;
  int N;
  __device__ void operator()(int i, int j, double v) const { J[i * N + j] = v; }
};

// Fluxes at the face between the points ul and ur [M] at xl < xr
// (ops/flame1d.py:103): the conduction flux q and the diffusive mass
// fluxes j [KK], positive in +x. Xf and xn [KK] are scratch.
template <class S>
__device__ void face_flux(const MechView& m, const TransView& tv,
                          const FlameArgs& a, const S* ul, const S* ur,
                          double xl, double xr, S* j, S* Xf, S* xn, S* q) {
  const int KK = m.KK;
  const double h = xr - xl;
  const S Tf = 0.5 * (ul[0] + ur[0]);
  S snf = S{}, snl = S{}, snr = S{};
  for (int k = 0; k < KK; ++k) {
    const double w = m.wt[k];
    const S nf = clip01(0.5 * (ul[2 + k] + ur[2 + k])) / w;
    Xf[k] = nf;
    snf = snf + nf;
    snl = snl + clip01(ul[2 + k]) / w;
    snr = snr + clip01(ur[2 + k]) / w;
  }
  S wbar = S{};
  for (int k = 0; k < KK; ++k) {
    Xf[k] = Xf[k] / snf;
    wbar = wbar + Xf[k] * m.wt[k];
  }
  const S rho = a.P * (1.0 / fmaxc(snf, 1e-30)) / (m.r_gas * Tf);
  floored_fractions(KK, Xf, xn);
  const S lam = mixture_lambda(m, tv, Tf, xn);
  const S dTdx = (ur[0] - ul[0]) / h;
  S D_lewis = S{}, sxw = S{};
  if (a.lewis_tr) {
    S cp = S{};
    for (int k = 0; k < KK; ++k)
      cp = cp + clip01(0.5 * (ul[2 + k] + ur[2 + k])) *
                    (species_cp_R(m, k, Tf) * m.r_gas / m.wt[k]);
    D_lewis = lam / (rho * cp * a.lewis);
  } else {
    for (int k = 0; k < KK; ++k) sxw = sxw + xn[k] * m.wt[k];
  }
  S sj = S{};
  for (int k = 0; k < KK; ++k) {
    const double w = m.wt[k];
    const S D = a.lewis_tr ? D_lewis
                           : mixture_diffusion(tv, KK, k, Tf, a.P, xn,
                                               xn[k] * w / sxw);
    const S rw = rho * (w / wbar);
    const S dX = (clip01(ur[2 + k]) / w / snr - clip01(ul[2 + k]) / w / snl) / h;
    S jk = -rw * D * dX;
    if (a.soret) {
      const S theta = thermal_diffusion(m, tv, k, Tf, xn);
      jk = jk - rw * D * theta * dTdx / Tf;
    }
    j[k] = jk;
    sj = sj + jk;
  }
  for (int k = 0; k < KK; ++k)
    j[k] = j[k] - clip01(0.5 * (ul[2 + k] + ur[2 + k])) * sj;
  *q = -lam * dTdx;
}

// The flame's own terms of the rows at grid point i (ops/flame1d.py:151-237)
// into F [M]: at an interior point everything but the chemistry terms
// (-f of the lane body: the energy row's sum h wdot W / (rho cp), the
// species rows' wdot W / rho), which the caller adds; at the boundaries
// the whole left_bc / right_bc rows. um, uc, up [M] are the points i - 1,
// i, i + 1 (at i = 0: uc, up = u_0, u_1; at i = N - 1: um, uc =
// u_{N-2}, u_{N-1}); ``sc`` 4 KK scalars of scratch.
template <class S>
__device__ void flame_rows(const MechView& m, const TransView& tv,
                           const FlameArgs& a, int i, const S* um,
                           const S* uc, const S* up, S* F, S* sc) {
  const int KK = m.KK, N = a.N;
  S* jl = sc;
  S* jr = sc + KK;
  S* Xf = sc + 2 * KK;
  S* xn = sc + 3 * KK;
  if (i == 0) {
    // left_bc(u_0, u_1)
    F[0] = uc[0] - a.T_in;
    if (a.flux_bc) {
      S q;
      face_flux(m, tv, a, uc, up, a.x[0], a.x[1], jr, Xf, xn, &q);
      const S Mc = fmaxc(uc[1], 1e-8);
      for (int k = 0; k < KK; ++k) F[2 + k] = (uc[2 + k] - a.Y_in[k]) + jr[k] / Mc;
    } else {
      for (int k = 0; k < KK; ++k) F[2 + k] = uc[2 + k] - a.Y_in[k];
    }
    F[1] = a.free_flame ? uc[1] - up[1] : uc[1] - a.mdot_in;
    return;
  }
  if (i == N - 1) {
    // right_bc(u_{N-2}, u_{N-1}): um, uc
    F[0] = a.tgiv ? uc[0] - a.T_given[N - 1] : uc[0] - um[0];
    for (int k = 0; k < KK; ++k) F[2 + k] = uc[2 + k] - um[2 + k];
    F[1] = a.free_flame ? uc[1] - um[1] : uc[1] - a.mdot_in;
    return;
  }
  const double xm = a.x[i - 1], xc = a.x[i], xp = a.x[i + 1];
  const double dxc = 0.5 * (xp - xm);
  S ql, qr;
  face_flux(m, tv, a, um, uc, xm, xc, jl, Xf, xn, &ql);
  face_flux(m, tv, a, uc, up, xc, xp, jr, Xf, xn, &qr);
  const S Tc = uc[0], Mc = uc[1];
  S sw = S{};
  for (int k = 0; k < KK; ++k) sw = sw + clip01(uc[2 + k]) / m.wt[k];
  const S rho = a.P * (1.0 / fmaxc(sw, 1e-30)) / (m.r_gas * Tc);
  const double dxu = a.upwind ? xc - xm : xp - xm;
  const S* ua = a.upwind ? uc : up;
  const S dTdx = (ua[0] - um[0]) / dxu;
  for (int k = 0; k < KK; ++k) {
    const S dYdx = (ua[2 + k] - um[2 + k]) / dxu;
    F[2 + k] = (Mc * dYdx + (jr[k] - jl[k]) / dxc) / rho;
  }
  if (a.tgiv) {
    F[0] = Tc - a.T_given[i];
  } else {
    S cp = S{}, jcp = S{};
    for (int k = 0; k < KK; ++k) {
      const S cpk = species_cp_R(m, k, Tc) * m.r_gas / m.wt[k];
      cp = cp + clip01(uc[2 + k]) * cpk;
      jcp = jcp + (0.5 * (jl[k] + jr[k])) * cpk;
    }
    F[0] = (Mc * cp * dTdx + (qr - ql) / dxc + jcp * dTdx) / (rho * cp);
  }
  if (a.free_flame) {
    F[1] = i == a.i_fix ? Tc - a.T_fix : (i < a.i_fix ? Mc - up[1] : Mc - um[1]);
  } else {
    F[1] = Mc - a.mdot_in;
  }
}

// d clip(y, 0, 1)/dy as jax.jacfwd takes jnp.clip
__device__ __forceinline__ double clip01_slope(double y) {
  return (y > 0.0 && y < 1.0) ? 1.0 : ((y == 0.0 || y == 1.0) ? 0.5 : 0.0);
}

// Shared memory of one K10 (JAC false) or K11 block, in doubles: the lane
// body's scratch, J (K11), f and the lane body's state.
__host__ __device__ inline int flame_smem_doubles(const MechView* m, bool jac) {
  const int NC = m->KK + 1;
  return lane_smem_doubles(m->KK, m->II, m->n_tb, m->n_plog, jac) +
         (jac ? NC * NC : 0) + 2 * NC;
}

template <bool JAC, bool XK>
__global__ void flame_kernel(MechView m, TransView tv, FlameArgs a) {
  using S = typename std::conditional<JAC, Dual, double>::type;
  const int i = blockIdx.x;
  const int N = a.N, KK = m.KK, M = KK + 2, NC = KK + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  CHEM_DYN_SMEM(sm);
  double* Jc = sm + lane_smem_doubles(KK, m.II, m.n_tb, m.n_plog, JAC);
  double* fb = Jc + (JAC ? NC * NC : 0);
  double* yb = fb + NC;
  const bool inner = i > 0 && i < N - 1;
  if (inner) {
    const double* uc = a.u + (size_t)i * M;
    for (int k = tid; k < KK; k += nt) yb[k] = minp(maxp(uc[2 + k], 0.0), 1.0);
    if (tid == 0) yb[KK] = uc[0];
    __syncthreads();
    chem_lane<JAC, CONP, XK>(m, yb, a.P, sm, fb, FlameJacSink{Jc, NC});
  }
  __syncthreads();
  if (JAC) {
    // the blocks JAX leaves zero: B_0 and C_{N-1}
    if (i == 0)
      for (int e = tid; e < M * M; e += nt) a.Bb[e] = 0.0;
    if (i == N - 1)
      for (int e = tid; e < M * M; e += nt) a.Cb[(size_t)(N - 1) * M * M + e] = 0.0;
  }
  const int n_tan = JAC ? (inner ? 3 * M : 2 * M) : 1;
  if (tid >= n_tan) return;
  // this thread's slice: the points (3 M), the rows (M), the face arrays
  S* base = reinterpret_cast<S*>(a.ws + ((size_t)i * flame_slots(KK, JAC) + tid) *
                                            flame_thread_doubles(KK, JAC));
  S* pts = base;
  S* F = pts + 3 * M;
  S* sc = F + M;
  const int first = inner ? i - 1 : (i == 0 ? 0 : N - 2);
  const int n_pts = inner ? 3 : 2;
  for (int p = 0; p < n_pts; ++p)
    for (int c = 0; c < M; ++c) {
      const double v = a.u[(size_t)(first + p) * M + c];
      if constexpr (JAC) pts[p * M + c] = Dual{v, (p * M + c == tid) ? 1.0 : 0.0};
      else pts[p * M + c] = v;
    }
  // (um, uc, up) of flame_rows: (u_0, u_1) at the left boundary are uc and
  // up, (u_{N-2}, u_{N-1}) at the right one um and uc
  const S* um = pts;
  const S* uc = i == 0 ? pts : pts + M;
  const S* up = i == 0 ? pts + M : pts + 2 * M;
  flame_rows(m, tv, a, i, um, uc, up, F, sc);
  if constexpr (!JAC) {
    double* out = a.F + (size_t)i * M;
    for (int r = 0; r < M; ++r) {
      double v = val(F[r]);
      if (inner && r != 1 && (r >= 2 || !a.tgiv)) v = v - fb[r == 0 ? KK : r - 2];
      out[r] = v;
    }
  } else {
    const int side = tid / M, comp = tid - side * M;
    // chemistry columns: the unknown's column of J (T: column KK; Y_j:
    // column j times clip's slope at Y_j; Mdot: none)
    int col = -1;
    double fac = 0.0;
    if (inner && side == 1 && comp != 1) {
      col = comp == 0 ? KK : comp - 2;
      fac = comp == 0 ? 1.0 : clip01_slope(a.u[(size_t)i * M + comp]);
    }
    double* blk;
    if (inner) blk = side == 0 ? a.Bb : (side == 1 ? a.Ab : a.Cb);
    else if (i == 0) blk = side == 0 ? a.Ab : a.Cb;
    else blk = side == 0 ? a.Bb : a.Ab;
    blk += (size_t)i * M * M + comp;
    for (int r = 0; r < M; ++r) {
      double d = tan_of(F[r]);
      if (col >= 0 && (r >= 2 || !a.tgiv) && r != 1)
        d = d - Jc[(r == 0 ? KK : r - 2) * NC + col] * fac;
      blk[(size_t)r * M] = d;
    }
  }
}

// Launch K10 (JAC false) or K11 with the mechanism's lane body: N blocks of
// flame_threads(KK, JAC) threads, flame_smem_doubles of shared memory.
template <bool JAC, bool XK>
inline int launch_flame_as(const MechView* m, const TransView* tv,
                           const FlameArgs* a, void* stream) {
  const size_t smem = sizeof(double) * flame_smem_doubles(m, JAC);
  cudaError_t err = cudaFuncSetAttribute(
      flame_kernel<JAC, XK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  CHEM_LAUNCH(a->N, flame_threads(m->KK, JAC), smem, stream,
              flame_kernel<JAC, XK>)(*m, *tv, *a);
  return (int)cudaGetLastError();
}

template <bool JAC>
inline int launch_flame(const MechView* m, const TransView* tv,
                        const FlameArgs* a, void* stream) {
  if (a->N < 3) return (int)cudaErrorInvalidValue;
  if (a->ws == nullptr) return (int)cudaErrorInvalidValue;
  return extended(m) ? launch_flame_as<JAC, true>(m, tv, a, stream)
                     : launch_flame_as<JAC, false>(m, tv, a, stream);
}

}  // namespace chem
