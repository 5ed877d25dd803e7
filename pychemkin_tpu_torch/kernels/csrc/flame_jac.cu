// K11 flame_jac: the blocks (B, A, C) [N, M, M] of dF/du of the premixed
// flame's residual (K10), B_i = dF_i/du_{i-1}, A_i = dF_i/du_i,
// C_i = dF_i/du_{i+1}, with B_0 = C_{N-1} = 0.
//
// Replaces the JAX package's ops/flame1d.py:251-275 (jacobian_blocks:
// jax.jacfwd of the interior stencil under jax.vmap over the grid, and of
// the two boundary rows).
//
// Bound on the H100: by operations. The launch reads N M + N doubles and
// writes 3 N M^2; the least work is each face once with the 2 M tangents
// of its two points (~2 flops a tangent per primal operation, a
// transcendental's tangent reusing its value), each point's own terms with
// its 3 M tangents, and one closed-form chemistry Jacobian. This kernel
// does more: each interior point evaluates both its faces, and each of its
// 3 M threads carries its tangent through them. Design: one block
// per grid point of 3 M threads rounded up to warps (flame.cuh): the
// chemistry lane body of K2 (chem_lane<true, CONP, XK>) gives the
// chemistry columns in closed form, chained through Y's clip; each
// thread carries one unit tangent through the flame's own terms in dual
// numbers and writes one column of the point's blocks.
#include "flame.cuh"

extern "C" int chem_flame_jac(const chem::MechView* m,
                              const chem::TransView* tv,
                              const chem::FlameArgs* a, void* stream) {
  return chem::launch_flame<true>(m, tv, a, stream);
}

// Doubles of the K10 (jac 0) or K11 (jac 1) workspace of an N-point grid.
extern "C" long long chem_flame_ws_doubles(int KK, int N, int jac) {
  return (long long)N * chem::flame_slots(KK, jac != 0) *
         chem::flame_thread_doubles(KK, jac != 0);
}
