// K2 rhs_jac, the variant with profiles (PRF) of the four
// reactor codes (chem.cuh); rhs_jac.cu's C entry point calls it.
#include "chem.cuh"

namespace chem {
int rhs_jac_launch_prf(const MechView* m, const ChemCall& c) {
  return launch_chem<true, true, false>(m, c);
}
}  // namespace chem
