// K2 rhs_jac: the fused CONP/ENRG or CONV/ENRG (f, J) from one evaluation
// of the rate ladder, y [B, N] -> f [B, N], J [B, N, N].
//
// Replaces ops/jacobian.py:710 fused_rhs_jacobian -> :558 _batch_jac_core
// (with_rhs=True; its CONP and CONV branches), :374 kinetics_derivatives,
// :230
// _rate_constant_derivatives and the COO triple products of :118
// _stoich_coo (grisyn: 4071 triples), on top of the rate ladder K1 shares
// (chem.cuh).
//
// Bound on the H100: writing J is N^2 doubles per lane, 95.6 MB at B=4096
// for grisyn, >= 29 us at 3.35 TB/s; the arithmetic (triples, the KK^2
// chain rule and the rate ladder) is of the same order at FP64 peak. Design:
// dwdot/dC is built in shared memory (KK^2 doubles), one thread per output
// entry summing its own jac_seg segment (deterministic, no atomics), and J
// is written once, row-major and coalesced. K5 runs the same lane body
// (chem::chem_lane<true, PROB>) with M = I - h gamma J as the sink.
//
// This file builds the constant-profile, shared-memory variant and the C
// entry point; rhs_jac_prf.cu (profiles: the reference's _batch_jac_core
// with its q, dq/dT, P'/(rho T), V' and TGIV T(t) terms,
// ops/jacobian.py:585-700), rhs_jac_gm.cu (the lane in a device-memory
// workspace) and rhs_jac_prf_gm.cu build the others.
#include "chem.cuh"

namespace chem {
int rhs_jac_launch(const MechView* m, const ChemCall& c) {
  return launch_chem<true, false, false>(m, c);
}
}  // namespace chem

// ``t`` and ``prf``: the lanes' times and profiles (null: the constant
// constraint values ``cval``); ``ws``: the workspace (null: shared memory).
extern "C" int chem_rhs_jac(const chem::MechView* m, const double* y,
                            const double* cval, double* f, double* J, int B,
                            int problem, const double* t,
                            const chem::ProfileView* prf, double* ws,
                            void* stream) {
  chem::ChemCall c{y, cval, f, J, t, prf ? *prf : chem::ProfileView{}, ws, B,
                   problem, stream};
  const bool p = prf != nullptr, g = ws != nullptr;
  if (p && g) return chem::rhs_jac_launch_prf_gm(m, c);
  if (p) return chem::rhs_jac_launch_prf(m, c);
  if (g) return chem::rhs_jac_launch_gm(m, c);
  return chem::rhs_jac_launch(m, c);
}
