// K2 rhs_jac, the variant with the lane in a device-memory workspace (GM) of the four
// reactor codes (chem.cuh); rhs_jac.cu's C entry point calls it.
#include "chem.cuh"

namespace chem {
int rhs_jac_launch_gm(const MechView* m, const ChemCall& c) {
  return launch_chem<true, false, true>(m, c);
}
}  // namespace chem
