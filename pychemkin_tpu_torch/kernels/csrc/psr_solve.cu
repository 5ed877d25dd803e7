// K7 psr_solve: one whole PSR steady-state solve per lane in one launch
// (psr_solve.cuh). This file builds the shared-memory instantiations, with
// and without the PLOG/fractional-order body (XK) and the fault flags
// (FAULT), and the C entry point; psr_solve_gm.cu builds the GM ones.
#include "psr_solve.cuh"

// The lane body with PLOG rows and fractional orders (XK) where the
// mechanism has either; FAULT where a->fault is not null; GM where a->ws
// is not null.
extern "C" int chem_psr_solve(const chem::MechView* m, const PsrArgs* a,
                              int B, void* stream) {
  if (B <= 0) return 0;
  if ((a->ws == nullptr && m->KK > 32 * chem::SOLVE_MAXR) || a->mode < 0 ||
      a->mode > 1 || a->energy < 0 || a->energy > 1)
    return (int)cudaErrorInvalidValue;
  return a->ws ? psr::launch_psr_gm(m, a, B, stream)
               : psr::launch_psr_storage<false>(m, a, B, stream);
}

// Doubles of one K7 lane's working set (the GM workspace per lane).
extern "C" long long chem_psr_lane_doubles(const chem::MechView* m) {
  return psr::psr_lane_doubles(m);
}
