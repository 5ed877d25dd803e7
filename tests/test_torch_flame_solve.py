"""The PyTorch port's flame Newton and whole flame solve (the host loop
over the twins of K10-K12) against the JAX package's
``ops/flame1d.py``; the stencils' h2o2 cases are in
``test_torch_flame.py``.

- ``make_residual`` and ``jacobian_blocks`` on ch4global (fractional
  orders: the XK lane body on the card) at a 16-point state, free ENRG
  and TGIV burner: F within 1e-12 and the blocks within 1e-10 of the
  reference, scale-relative per grid point.
- The whole ``solve_flame`` on the TGIV burner flame of
  ``tests/test_flame1d.py:160`` from a 20-point mesh (``max_regrids=0``,
  ``skip_fixed_T=True``): the same converged, n_points and n_newton, T
  and Y within 1e-8; restarted from the reference's solution (the CNTN
  continuation, ``u0``/``x0``) the port converges on the same grid.
- The Jacobian twin's own forward-mode rules (``ops/dual.py``, with the
  closed-form chemistry columns) against ``torch.func.jacfwd`` of the
  twin residual on an 8-point h2o2 state: the blocks within 1e-10.
- Three damped Newton iterations from that converged solution perturbed
  by 10 % (seeded): u within 1e-9 scale-relative per point, the same
  iteration count and stall flag, and the same accepted damping factor in
  each iteration, to rounding (the reference's replayed from its own
  residual, blocks, block solve, ``_lambda_bound``, ``_clip_state`` and
  step norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import blocktridiag as jbt
from pychemkin_tpu.ops import flame1d as jf
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import flame1d as tf

from torch_port_cases import (P_ATM, ch4_air, flame_data_pair, flame_numpy,
                              flame_state, scale_rel, stoich_h2_air)

F_TOL = 1e-12
J_TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mechs():
    return {name: (jmech.load_embedded(name),
                   tmech.TorchMechanism(tmech.load_embedded(name), "cpu"))
            for name in ("h2o2", "ch4global")}


# -- the Dual-number twin against PyTorch's own forward-mode AD ---------------

@pytest.mark.parametrize("cfg_kw", [
    dict(), dict(soret=True, upwind=False), dict(transport="LEWIS", lewis=1.1),
    dict(energy="TGIV", free_flame=False)],
    ids=["mix", "tdif-central", "lewis", "tgiv-burner"])
def test_dual_blocks_match_torch_func_jacfwd(mechs, cfg_kw):
    """ops/dual.py's forward-mode rules (with the closed-form chemistry
    columns) give the blocks that torch.func.jacfwd of the twin residual
    gives, on an 8-point state with exact zeros (the clip's ties, where
    both take half the slope)."""
    _, tm = mechs["h2o2"]
    u, x = flame_state(tm.record.species_names, np.asarray(tm.record.wt),
                       8, 3)
    assert (u[:, 2:] == 0.0).any()
    data = tf.FlameData(x=torch.tensor(x), P=P_ATM, T_in=298.0,
                        Y_in=torch.tensor(u[0, 2:]), mdot_in=0.08,
                        T_fix=400.0, i_fix=3,
                        T_given=torch.tensor(u[:, 0].copy()))
    res, jac = tf.make_residual(tm, tf.FlameConfig(**cfg_kw))
    ut = torch.tensor(u)
    J = torch.func.jacfwd(lambda v: res(v, data))(ut)
    N = u.shape[0]
    ref = [np.stack([J[i, :, i + o].numpy() if 0 <= i + o < N else
                     np.zeros_like(J[0, :, 0].numpy()) for i in range(N)])
           for o in (-1, 0, 1)]
    for b, r in zip(jac(ut, data), ref):
        assert scale_rel(b.numpy(), r) <= J_TOL


@pytest.mark.parametrize("cfg_kw", [dict(), dict(energy="TGIV",
                                                 free_flame=False)])
def test_residual_and_blocks_ch4global(mechs, cfg_kw):
    jm, tm = mechs["ch4global"]
    Y_in = ch4_air(jm.species_names, np.asarray(jm.wt))
    u, x = flame_state(jm.species_names, np.asarray(jm.wt), 16, 4,
                       Y_in=Y_in)
    jcfg, tcfg, jd, td = flame_data_pair(jf, tf, u, x, cfg_kw)
    jres, jjac = jf.make_residual(jm, jcfg)
    # compiled: two programs cost less than the first eager call's
    # per-operation compiles on these shapes
    F_ref, blk_ref = jax.jit(lambda uu: (jres(uu, jd), jjac(uu, jd)))(
        jnp.asarray(u))
    F_ref = np.asarray(F_ref)
    blk_ref = [np.asarray(b) for b in blk_ref]
    ut = torch.tensor(u)
    assert scale_rel(kernels.flame_residual(tm, tcfg, ut, td).numpy(),
                     F_ref) <= F_TOL
    for b, r in zip(kernels.flame_jac(tm, tcfg, ut, td), blk_ref):
        assert scale_rel(b.numpy(), r) <= J_TOL


def _tprof(x):
    return 298.0 + (1500.0 - 298.0) * 0.5 * (1.0 + np.tanh((x - 0.4) / 0.12))


@pytest.fixture(scope="module")
def tgiv_solves(mechs):
    jm, tm = mechs["h2o2"]
    Y_in = stoich_h2_air(jm.species_names, np.asarray(jm.wt))
    kw = dict(P=P_ATM, T_in=298.0, Y_in=Y_in, x_start=0.0, x_end=1.2,
              energy="TGIV", free_flame=False, mdot=0.03, T_given_fn=_tprof,
              max_regrids=0, ntot=50, x_init=np.linspace(0.0, 1.2, 20),
              skip_fixed_T=True)
    with torch.inference_mode():
        mine = flame_numpy(tf.solve_flame(tm, **kw))
    return kw, flame_numpy(jf.solve_flame(jm, **kw)), mine


def test_solve_flame_tgiv_burner_matches(mechs, tgiv_solves):
    _, tm = mechs["h2o2"]
    kw, ref, mine = tgiv_solves
    assert mine["converged"] and ref["converged"]
    assert mine["n_points"] == ref["n_points"]
    assert mine["n_newton"] == ref["n_newton"]
    assert np.max(np.abs(mine["T"] - ref["T"])) <= 1e-8 * ref["T"].max()
    assert np.max(np.abs(mine["Y"] - ref["Y"])) <= 1e-8
    # restarted from the reference's solution (its last grid, where the
    # refined points hold interpolated values), the port converges on that
    # grid (no point added: ntot is its size) with T the given profile
    # past the inlet point (which holds T_in)
    again = tf.solve_flame(tm, **dict(kw, u0=ref["u"], x0=ref["x"],
                                      ntot=ref["n_points"]))
    assert again.converged and again.n_points == ref["n_points"]
    assert again.T[0] == 298.0
    assert np.max(np.abs(again.T[1:] - _tprof(ref["x"][1:]))) <= 1e-8 * 1500


def _reference_lams(jm, jcfg, u0, jd, n_it):
    """The reference's accepted damping factor in each of n_it iterations,
    replayed from its own residual, blocks, block solve, bounds and step
    norm (the body of ops/flame1d.py:make_newton)."""
    res, jac = jf.make_residual(jm, jcfg)
    step = jax.jit(lambda u: jbt.solve(*jac(u, jd), -res(u, jd)))

    def norm(du, u):
        w = jcfg.ss_atol + jcfg.ss_rtol * jnp.abs(u)
        n = float(jnp.sqrt(jnp.mean((du / w) ** 2)))
        return n if np.isfinite(n) else np.inf

    u = jf._clip_state(jnp.asarray(u0))
    lams = []
    for _ in range(n_it):
        du = step(u)
        n0 = norm(du, u)
        lam = float(jf._lambda_bound(u, du))
        acc = None
        for _ in range(jcfg.n_damp):
            u_try = jf._clip_state(u + lam * du)
            if norm(step(u_try), u_try) < n0:
                acc, u = lam, u_try
                break
            lam *= 0.5
        lams.append(acc)
        if acc is None:
            break
    return lams


def test_three_damped_newton_iterations(mechs, tgiv_solves):
    jm, tm = mechs["h2o2"]
    _, ref, _ = tgiv_solves
    rng = np.random.default_rng(0)
    u0 = ref["u"] * (1.0 + 0.1 * rng.standard_normal(ref["u"].shape))
    jcfg, tcfg, jd, td = flame_data_pair(
        jf, tf, u0, ref["x"], dict(energy="TGIV", free_flame=False,
                                   n_newton=3),
        i_fix=1, mdot=0.03, T_given=_tprof(ref["x"]))
    u_ref, _, n_ref, norm_ref, st_ref = jf.make_newton(jm, jcfg)(
        jnp.asarray(u0), jd)
    res = tf.make_newton(tm, tcfg)(torch.tensor(u0), td)
    assert int(n_ref) == 3 and res.n_it == 3
    assert res.stalled == bool(st_ref)
    assert scale_rel(res.u.numpy(), np.asarray(u_ref)) <= 1e-9
    assert abs(res.last_norm - float(norm_ref)) <= 1e-9 * float(norm_ref)
    # the same iterations accept a damping factor, each the reference's
    # to rounding (the bound is a continuous function of the direction)
    ref_lams = _reference_lams(jm, jcfg, u0, jd, 3)
    assert [lam is None for lam in res.lams] == [
        lam is None for lam in ref_lams]
    for lam, ref_lam in zip(res.lams, ref_lams):
        if lam is not None:
            assert abs(lam - ref_lam) <= 1e-9 * ref_lam


def test_staged_free_flame_on_a_tiny_budget(mechs):
    """The fixed-temperature stage (the default, ``skip_fixed_T=False``)
    runs on the CPU route, and an unconverged free flame reports no speed
    (NaN), as the reference's acceptance test requires
    (tests/test_flame1d.py:190-197)."""
    jm, tm = mechs["h2o2"]
    Y_in = stoich_h2_air(jm.species_names, np.asarray(jm.wt))
    with torch.inference_mode():
        sol = tf.solve_flame(tm, P=P_ATM, T_in=298.0, Y_in=Y_in,
                             x_start=0.0, x_end=2.0,
                             x_init=np.linspace(0.0, 2.0, 10), ntot=10,
                             max_ts_rounds=0, ts_steps=1, max_regrids=0)
    assert "fixT_newton_s" in sol.report
    assert sol.report["n_points"] == sol.n_points == 11   # the pin's node
    if not sol.converged:
        assert np.isnan(sol.flame_speed)
        assert sol.report["status_name"] in ("NEWTON_STALL", "TOL_NOT_MET",
                                             "NONFINITE")
