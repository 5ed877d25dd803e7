// K8 gershgorin_rate: the C entry point and the constant-constraint
// variants; the kernel and its design are in gershgorin.cuh, the PRF
// variants in gershgorin_prf.cu.
#include "gershgorin.cuh"

// ``problem``: the reactor code (chem.cuh); ``cval`` the lanes' pressure
// (CONP codes) or density (CONV codes); ``t`` and ``prf``: the lanes'
// times and profiles (null: the constant constraint values ``cval``);
// ``ws``: the workspace of the GM variant (null: shared memory). One
// block of 256 threads a lane.
extern "C" int chem_gershgorin(const chem::MechView* m, const double* y,
                               const double* cval, double* rate, int B,
                               int problem, const double* t,
                               const chem::ProfileView* prf, double* ws,
                               void* stream) {
  if (B <= 0) return 0;
  chem::GershCall c{y, cval, rate, t, prf ? *prf : chem::ProfileView{}, ws,
                    B, problem, stream};
  if (prf) {
    if (t == nullptr) return (int)cudaErrorInvalidValue;
    return chem::gershgorin_launch_prf(m, c);
  }
  return ws ? chem::gershgorin_launch<false, true>(m, c)
            : chem::gershgorin_launch<false, false>(m, c);
}
