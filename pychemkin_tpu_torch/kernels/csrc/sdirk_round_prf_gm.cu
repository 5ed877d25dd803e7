// K5 sdirk_round, the instantiation with the pivot-free factor, no faults,
// profiles (PRF), the lane in a device-memory workspace (GM) and the lane
// body without PLOG rows and fractional orders, for the four reactor codes
// (sdirk_round.cuh); sdirk_round.cu's C entry point calls it.
#define SDIRK_LAUNCH_BOUNDS __launch_bounds__(THREADS, 2)
#include "sdirk_round.cuh"

CHEM_SDIRK_LAUNCHER(_prf_gm) {
  return sdirk::launch_sdirk<false, false, false, true, true>(
      m, a, B, problem, stream);
}
