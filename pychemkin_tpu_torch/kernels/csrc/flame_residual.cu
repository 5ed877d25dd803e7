// K10 flame_residual: the premixed flame's residual F [N, M] at the packed
// state u [N, M] on the grid x [N]: the left and right boundary rows and
// every interior stencil (faces' fluxes, convection, chemistry, the
// energy row over rho cp, the species rows over rho, the eigenvalue rows).
//
// Replaces the JAX package's ops/flame1d.py:103-249 (_face and
// make_residual's residual, with B1-B4's thermo and kinetics and B14's
// transport inside).
//
// Bound on the H100: by operations. The launch reads N M + N doubles and
// writes N M; the least work is each face once (KK (KK + 1) / 2 pair
// collision integrals for D_km, KK species integrals) and one chemistry
// lane a point; each interior point here evaluates both its faces. Design: one block of 64 threads per grid point (flame.cuh): the
// chemistry lane body of K1 (chem_lane<false, CONP, XK>) at the point,
// then the flame's own terms on one thread in doubles.
#include "flame.cuh"

extern "C" int chem_flame_residual(const chem::MechView* m,
                                   const chem::TransView* tv,
                                   const chem::FlameArgs* a, void* stream) {
  return chem::launch_flame<false>(m, tv, a, stream);
}
