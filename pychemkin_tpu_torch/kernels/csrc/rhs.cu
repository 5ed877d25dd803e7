// K1 rhs: the adiabatic RHS f = dy/dt at constant pressure (CONP) or
// constant volume (CONV), [B, N] -> [B, N].
//
// Replaces the JAX package's ENRG RHS chain: ops/reactors.py:100
// conp_enrg_rhs and :132 conv_enrg_rhs -> ops/kinetics.py:610
// rop_intermediates -> :558
// _rop_intermediates_sparse (with :234 _arrhenius, :290 falloff_blend,
// :504 _reverse_rates_sparse, :475 _staged_kc_terms, :530
// _conc_product_args_sparse, :215 _nu_T_contract) and ops/thermo.py:26-66.
//
// Bound on the H100: the lane's inputs and outputs are 2 N doubles (0.9 KB
// for grisyn), so bytes bound it only below a microsecond at B=4096; the
// work is ~II transcendentals and ~nnz(ord)+nnz(nu) multiply-adds per lane,
// a few microseconds of FP64 at the card's peak. Design: one block per lane
// keeps every intermediate in shared memory (no device-memory traffic
// beyond y, the lane's pressure or density, and f) and reads the staged CSR
// ranges, so each sum is one deterministic loop. The lane body
// (chem::chem_lane<false, PROB>) is also K5's RHS, ~7 times per attempt.
//
// Variants: PRF (the solve_batch reactors: the lane's constraint value,
// T and heat-loss terms from profiles at its time t [B], ops/reactors.py
// conp_enrg_rhs ... conv_tgiv_rhs of the reference, :100-160) and GM (the
// lane's working set in a device-memory workspace ``ws`` instead of
// shared memory, for mechanisms too large for it).
#include "chem.cuh"

// ``t`` and ``prf``: the lanes' times and profiles (null: the constant
// constraint values ``cval``); ``ws``: the workspace (null: shared memory).
extern "C" int chem_rhs(const chem::MechView* m, const double* y,
                        const double* cval, double* f, int B, int problem,
                        const double* t, const chem::ProfileView* prf,
                        double* ws, void* stream) {
  chem::ChemCall c{y, cval, f, nullptr, t, prf ? *prf : chem::ProfileView{},
                   ws, B, problem, stream};
  const bool p = prf != nullptr, g = ws != nullptr;
  if (p && g) return chem::launch_chem<false, true, true>(m, c);
  if (p) return chem::launch_chem<false, true, false>(m, c);
  if (g) return chem::launch_chem<false, false, true>(m, c);
  return chem::launch_chem<false, false, false>(m, c);
}

// The card's opt-in shared memory per block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
// of ``device``, in bytes: the limit the wrappers' size chooser holds a
// lane's working set to.
extern "C" int chem_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
