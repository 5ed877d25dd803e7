// K7 psr_solve, the instantiations with the lane's working set in a
// device-memory workspace (GM), for mechanisms too large for shared
// memory (psr_solve.cuh); psr_solve.cu's C entry point calls them.
#include "psr_solve.cuh"

namespace psr {
int launch_psr_gm(const chem::MechView* m, const PsrArgs* a, int B,
                  void* stream) {
  return launch_psr_storage<true>(m, a, B, stream);
}
}  // namespace psr
