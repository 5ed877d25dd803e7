"""The PyTorch port's constant-volume (CONV/ENRG) reactor and its step
round (the plain twin of kernel K5, ``kernels.sdirk_round``), against
the JAX package.

(a) Thermo (u/RT, cv, P from rho) and the CONV/ENRG RHS and fused (f, J)
    against ``thermo``, ``reactors.conv_enrg_rhs`` and
    ``jacobian.fused_rhs_jacobian("CONV", "ENRG")`` at 32 random states
    (T 800-2500 K, one below the 50 K floor) on h2o2 and grisyn, each lane
    at the density of its own (T, P, Y): 1e-12 scale-relative, with T
    nondimensionalised by the lane's temperature for f and J
    (``torch_port_cases.rate_rel``; measured: at most 1.5e-14). J is also
    held to 1e-12 against ``torch.func.jacfwd`` of the port's own RHS.
(b) An h2o2 CONV/ENRG sweep (T0 1200-1400 K, 1 atm, stoichiometric
    H2/air, t_end 2e-3 s) against one JAX
    ``reactors.ignition_sweep_kernel(mech, "CONV", "ENRG", round_len=40)``
    shared by the module: after 40 attempts t, h and y within 1e-8
    relative and identical step, rejection and Newton counts; run to the
    end through ``ignition_delay_sweep``, identical status codes and
    ignition times within the integrator rtol (1e-6).
(c) The round invariant of the twin: rounds of 7 attempts give bitwise
    the state of one pass of 21.
(d) ``kernels.sdirk_round`` on CPU tensors is its twin, launches nothing,
    and rejects a bad device, dtype, shape, event mode or problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import jacobian as jjac
from pychemkin_tpu.ops import reactors as jre
from pychemkin_tpu.ops import thermo as jthermo
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import jacobian, odeint, reactors, thermo
from pychemkin_tpu_torch.resilience.status import SolveStatus

from torch_port_cases import P_ATM, random_states, rate_rel, scale_rel, \
    stoich_h2_air

T0S = np.array([1200.0, 1300.0, 1400.0])
RTOL, ATOL = 1e-6, 1e-12
T_END = 2e-3
B = 32


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's CPU path is many tiny tensor operations: one intra-op
    thread is faster than several."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) thermo, RHS and (f, J) -----------------------------------------------

def _jax_conv(jm, y, P):
    """The JAX package's conv_enrg_rhs and fused CONV/ENRG (f, J), each
    lane at the density of its own state (unit volume)."""
    fj = jjac.fused_rhs_jacobian("CONV", "ENRG")

    def one(y, P):
        args, _, _ = jre.sweep_lane_args(jm, "CONV", y[-1], P, y[:-1])
        return jre.conv_enrg_rhs(0.0, y, args), fj(0.0, y, args)

    f_rhs, (f_ref, J_ref) = jax.jit(jax.vmap(one))(jnp.asarray(y),
                                                  jnp.asarray(P))
    return np.asarray(f_rhs), np.asarray(f_ref), np.asarray(J_ref)


@pytest.fixture(scope="module", params=["h2o2", "grisyn"])
def conv_case(request):
    jm = jmech.load_embedded(request.param)
    tm = tmech.TorchMechanism(tmech.load_embedded(request.param), "cpu")
    T, P, Y = random_states(tm.KK, B, seed=13)
    T[0] = 40.0            # below T_FLOOR: exercises the clamp indicator
    y = np.concatenate([Y, T[:, None]], axis=1)
    return (jm, tm, y, P) + _jax_conv(jm, y, P)


def _rho(tm, y, P):
    yt = torch.tensor(y)
    return thermo.density(tm, yt[:, -1], torch.tensor(P), yt[:, :-1])


def test_conv_thermo_matches_jax(conv_case):
    jm, tm, y, P, _, _, _ = conv_case
    T, Y = y[:, -1], y[:, :-1]
    Tt, Yt = torch.tensor(T), torch.tensor(Y)
    rho = _rho(tm, y, P)
    for name, port in (("u_RT", thermo.u_RT(tm, Tt)),
                       ("cv_R", thermo.cv_R(tm, Tt))):
        ref = jax.vmap(lambda t, f=getattr(jthermo, name): f(jm, t))(
            jnp.asarray(T))
        assert scale_rel(port, ref) < 1e-12, name
    cv_ref = jax.vmap(lambda t, yy: jthermo.mixture_cv_mass(jm, t, yy))(
        jnp.asarray(T), jnp.asarray(Y))
    P_ref = jax.vmap(lambda t, r, yy: jthermo.pressure(jm, t, r, yy))(
        jnp.asarray(T), jnp.asarray(rho.numpy()), jnp.asarray(Y))
    assert scale_rel(thermo.mixture_cv_mass(tm, Tt, Yt)[:, None],
                     np.asarray(cv_ref)[:, None]) < 1e-12
    P_port = thermo.pressure(tm, Tt, rho, Yt)
    assert scale_rel(P_port[:, None], np.asarray(P_ref)[:, None]) < 1e-12
    assert scale_rel(P_port[:, None], P[:, None]) < 1e-12   # round trip


def test_conv_rhs_and_jacobian_match_jax(conv_case):
    _, tm, y, P, f_rhs, f_ref, J_ref = conv_case
    yt, rho = torch.tensor(y), _rho(tm, y, P)
    f = reactors.conv_enrg_rhs(tm, yt, rho)
    assert rate_rel(f, f_rhs, y[:, -1], tm.KK) < 1e-12
    fj, J = jacobian.conv_enrg_rhs_jac(tm, yt, rho)
    assert rate_rel(fj, f_ref, y[:, -1], tm.KK) < 1e-12
    assert rate_rel(J, J_ref, y[:, -1], tm.KK) < 1e-12
    assert (J[0, :, -1] == 0).all() and (J_ref[0, :, -1] == 0).all()
    # the kernel wrappers take the same twins on CPU tensors
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(kernels.rhs(tm, yt, rho, problem="CONV"), f,
                               rtol=0, atol=0)
    torch.testing.assert_close(
        kernels.rhs_jac(tm, yt, rho, problem="CONV")[1], J, rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def test_conv_jacobian_matches_autodiff(conv_case):
    _, tm, y, P, _, _, _ = conv_case
    yt, rho = torch.tensor(y[:8]), _rho(tm, y[:8], P[:8])
    _, J = jacobian.conv_enrg_rhs_jac(tm, yt, rho)
    J_ad = torch.stack([
        torch.func.jacfwd(lambda v, r=rho[i:i + 1]:
                          reactors.conv_enrg_rhs(tm, v[None], r)[0])(yt[i])
        for i in range(8)])
    assert rate_rel(J, J_ad, y[:8, -1], tm.KK) < 1e-12


# -- (b) the CONV/ENRG sweep --------------------------------------------------

def _inputs(rec):
    n = T0S.size
    Y0 = stoich_h2_air(rec.species_names, rec.wt)
    return (T0S, np.full(n, P_ATM), np.tile(Y0, (n, 1)), np.full(n, T_END),
            np.arange(n))


@pytest.fixture(scope="module")
def jax_conv_sweep():
    """The JAX CONV/ENRG sweep kernel on h2o2: the state after its first
    40-attempt round, and the harvest after running every lane to the
    end."""
    mech = jmech.load_embedded("h2o2")
    k = jre.ignition_sweep_kernel(mech, "CONV", "ENRG", rtol=RTOL,
                                  atol=ATOL, round_len=40)
    args = _inputs(mech)
    state = k.advance(k.init(*args), *args)
    first = jax.tree_util.tree_map(np.asarray, state)
    while not bool(np.all(np.asarray(k.harvest(state, *args)["done"]))):
        state = k.advance(state, *args)
    return first, jax.tree_util.tree_map(np.asarray, k.harvest(state, *args))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _start(rec, ignition_mode=reactors.IGN_T_INFLECTION):
    """(tm, lanes, events, state) of the h2o2 CONV sweep at t = 0."""
    tm = tmech.TorchMechanism(rec, "cpu")
    T0, P0, Y0, t_end, _ = (torch.tensor(a, dtype=torch.float64)
                            for a in _inputs(rec))
    events = reactors.ignition_events(ignition_mode)
    lanes, y0 = reactors.sweep_lane_args(tm, T0, P0, Y0, t_end, atol=ATOL,
                                         ignition_mode=ignition_mode,
                                         problem="CONV")
    with torch.inference_mode():
        s = odeint.sweep_start(reactors.plain_ops("CONV"), tm, lanes, y0,
                               RTOL, events)
    return tm, lanes, events, s


def test_conv_stepping_parity_after_40_attempts(jax_conv_sweep):
    jstate, _ = jax_conv_sweep
    tm, lanes, events, s = _start(tmech.load_embedded("h2o2"))
    with torch.inference_mode():
        s = kernels.sdirk_round(tm, lanes, s, rtol=RTOL, budget=20_000,
                                max_attempts=40, event_mode=0,
                                problem="CONV")
    np.testing.assert_array_equal(s.n_steps.numpy(), jstate.n_steps)
    np.testing.assert_array_equal(s.n_rejected.numpy(), jstate.n_rejected)
    np.testing.assert_array_equal(s.n_newton.numpy(), jstate.n_newton)
    assert (s.n_steps + s.n_rejected == 40).all()
    assert _rel(s.t, jstate.t) < 1e-8
    assert _rel(s.h, jstate.h) < 1e-8
    y_scale = np.abs(jstate.y).max(1, keepdims=True)
    assert np.max(np.abs(s.y.numpy() - jstate.y) / y_scale) < 1e-8
    np.testing.assert_array_equal(s.status.numpy(), jstate.status)


def test_conv_sweep_matches_jax(jax_conv_sweep):
    _, jh = jax_conv_sweep
    rec = tmech.load_embedded("h2o2")
    T0, P0, Y0, t_end, _ = _inputs(rec)
    times, ok, status, prof = reactors.ignition_delay_sweep(
        rec, "CONV", "ENRG", T0, P0, Y0, t_end, rtol=RTOL, atol=ATOL,
        device="cpu", profile=True)
    np.testing.assert_array_equal(status.numpy(), jh["status"])
    assert (status.numpy() == int(SolveStatus.OK)).all()
    np.testing.assert_array_equal(ok.numpy(), jh["ok"])
    assert np.isfinite(times.numpy()).all()
    assert _rel(times, jh["times"]) < RTOL
    np.testing.assert_array_equal(prof["n_steps"].numpy(), jh["n_steps"])
    np.testing.assert_array_equal(prof["n_rejected"].numpy(),
                                  jh["n_rejected"])


# -- (c) round invariant, (d) the K5 wrapper on the CPU -----------------------

@pytest.mark.parametrize("mode", [reactors.IGN_T_INFLECTION,
                                  reactors.IGN_T_RISE])
def test_rounds_are_bitwise_one_pass(mode):
    tm, lanes, events, s0 = _start(tmech.load_embedded("h2o2"), mode)
    ops = reactors.plain_ops("CONV")
    with torch.inference_mode():
        one = odeint.sweep_round(ops, tm, lanes, events, RTOL, 20_000, s0,
                                 max_attempts=21)
        s = s0
        for _ in range(3):
            s = odeint.sweep_round(ops, tm, lanes, events, RTOL, 20_000, s,
                                   max_attempts=7)
    for name, a, b in zip(odeint.StepState._fields, one, s):
        assert torch.equal(a.nan_to_num(7.0) if a.is_floating_point() else a,
                           b.nan_to_num(7.0) if b.is_floating_point() else b
                           ), name


def test_sdirk_round_routes_cpu_tensors_to_the_twin():
    tm, lanes, events, s0 = _start(tmech.load_embedded("h2o2"),
                                   reactors.IGN_T_RISE)
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = kernels.sdirk_round(tm, lanes, s0, rtol=RTOL, budget=20_000,
                                  max_attempts=5, event_mode=1,
                                  problem="CONV")
        want = odeint.sweep_round(reactors.plain_ops("CONV"), tm, lanes,
                                  events, RTOL, 20_000, s0, max_attempts=5)
    for name, a, b in zip(odeint.StepState._fields, got, want):
        assert torch.equal(a.nan_to_num(7.0) if a.is_floating_point() else a,
                           b.nan_to_num(7.0) if b.is_floating_point() else b
                           ), name
    assert kernels.LAUNCHES == before


def test_sdirk_round_rejects_bad_arguments():
    tm, lanes, _, s = _start(tmech.load_embedded("h2o2"))
    kw = dict(rtol=RTOL, budget=20_000, max_attempts=5, event_mode=0,
              problem="CONV")
    with pytest.raises(TypeError, match="int64"):
        kernels.sdirk_round(tm, lanes, s._replace(n_steps=s.n_steps.int()),
                            **kw)
    with pytest.raises(TypeError, match="float64"):
        kernels.sdirk_round(tm, lanes, s._replace(h=s.h.float()), **kw)
    with pytest.raises(ValueError, match="shape"):
        kernels.sdirk_round(tm, lanes, s._replace(acc_t=s.acc_t[:, 0]),
                            **kw)
    with pytest.raises(ValueError, match="shape"):
        kernels.sdirk_round(tm, lanes._replace(t_end=lanes.t_end[:-1]), s,
                            **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sdirk_round(tm, lanes, s._replace(y=s.y.t().contiguous().t()),
                            **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.sdirk_round(tm, lanes._replace(
            **{k: v.to("meta") for k, v in lanes._asdict().items()}),
            type(s)(*[x.to("meta") for x in s]), **kw)
    with pytest.raises(ValueError, match="several devices"):
        kernels.sdirk_round(tm, lanes, s._replace(y=s.y.to("meta")), **kw)
    with pytest.raises(ValueError, match="event_mode"):
        kernels.sdirk_round(tm, lanes, s, **dict(kw, event_mode=2))
    with pytest.raises(ValueError, match="problem"):
        kernels.sdirk_round(tm, lanes, s, **dict(kw, problem="CONX"))
