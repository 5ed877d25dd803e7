// K5 sdirk_round, the default instantiation (pivot-free factor, no
// faults, constant profiles, shared memory) of the four reactor codes for
// mechanisms without PLOG rows and fractional orders, and the C entry
// point that picks the (PIVOT, FAULT, XK, PRF, GM) instantiation; the
// kernel is sdirk_round.cuh's.
#include "sdirk_round.cuh"

CHEM_SDIRK_LAUNCHER() {
  return sdirk::launch_sdirk<false, false, false>(m, a, B, problem, stream);
}

namespace {

using Launcher = int (*)(const chem::MechView*, const SdirkArgs*, int, int,
                         void*);

// [GM][PIVOT][FAULT][XK] without profiles; [GM][XK] with them (the PIVOT
// and FAULT rungs of solve_batch's rescue are not instantiated)
const Launcher SWEEP[2][2][2][2] = {
    {{{sdirk_launch, sdirk_launch_xk}, {sdirk_launch_fault, sdirk_launch_fault_xk}},
     {{sdirk_launch_pivot, sdirk_launch_pivot_xk},
      {sdirk_launch_pivot_fault, sdirk_launch_pivot_fault_xk}}},
    {{{sdirk_launch_gm, sdirk_launch_gm_xk},
      {sdirk_launch_fault_gm, sdirk_launch_fault_gm_xk}},
     {{sdirk_launch_pivot_gm, sdirk_launch_pivot_gm_xk},
      {sdirk_launch_pivot_fault_gm, sdirk_launch_pivot_fault_gm_xk}}}};
const Launcher PROFILED[2][2] = {{sdirk_launch_prf, sdirk_launch_prf_xk},
                                 {sdirk_launch_prf_gm, sdirk_launch_prf_gm_xk}};

}  // namespace

// ``problem``: the reactor code (chem.cuh); ``pivot``: partially pivoted
// factors; ``profiles``: the lanes' constraint, T and heat loss from
// a->prf at each RHS's time (PRF). The FAULT instantiation runs where
// a->fault is not null, the GM one where a->ws is not null.
extern "C" int chem_sdirk_round(const chem::MechView* m, const SdirkArgs* a,
                                int B, int problem, int pivot, int profiles,
                                void* stream) {
  if (B <= 0 || a->max_attempts <= 0) return 0;
  const bool gm = a->ws != nullptr, fault = a->fault != nullptr;
  if ((!gm && m->KK > 32 * chem::SOLVE_MAXR) || a->event_mode < 0 ||
      a->event_mode > 3 || a->species < 0 || a->species >= m->KK ||
      a->budget == nullptr || (profiles && (pivot || fault)) ||
      (!profiles && a->constraint == nullptr))
    return (int)cudaErrorInvalidValue;
  const int xk = chem::extended(m) ? 1 : 0;
  if (profiles) return PROFILED[gm][xk](m, a, B, problem, stream);
  return SWEEP[gm][pivot ? 1 : 0][fault ? 1 : 0][xk](m, a, B, problem, stream);
}

// Doubles of one lane's working set of ``kernel`` (1 rhs, 2 rhs_jac,
// 5 sdirk_round (``pivot``), 8 gershgorin_rate) for the mechanism: the
// workspace a GM launch needs per lane, and the dynamic shared memory of
// the others. K6 and K7 answer for themselves (chem_equil_lane_doubles,
// chem_psr_lane_doubles).
extern "C" long long chem_lane_doubles(const chem::MechView* m, int kernel,
                                       int pivot) {
  switch (kernel) {
    case 1: return chem::lane_smem_doubles(m->KK, m->II, m->n_tb, m->n_plog, false);
    case 2: return chem::lane_smem_doubles(m->KK, m->II, m->n_tb, m->n_plog, true);
    case 5: return sdirk::sdirk_lane_doubles(m, pivot != 0);
    case 8: {
      const int N = m->KK + 1;
      return chem::lane_smem_doubles(m->KK, m->II, m->n_tb, m->n_plog, true) +
             N * N + N + 32;
    }
    default: return -1;
  }
}
