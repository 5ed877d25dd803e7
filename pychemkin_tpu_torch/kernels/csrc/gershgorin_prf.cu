// K8 gershgorin_rate, the variants with profiles (PRF) of the four reactor
// codes, in shared memory or the GM workspace; gershgorin.cu's C entry
// point calls them.
#include "gershgorin.cuh"

namespace chem {
int gershgorin_launch_prf(const MechView* m, const GershCall& c) {
  return c.ws ? gershgorin_launch<true, true>(m, c)
              : gershgorin_launch<true, false>(m, c);
}
}  // namespace chem
