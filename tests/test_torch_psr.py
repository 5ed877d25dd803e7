"""The PyTorch port's PSR steady-state solve (plain twin of kernel K7) and
its closed-form Jacobians, against the JAX package's ``ops/psr.py``.

Jacobians: ``jacobian.psr_rhs_jac`` (the chemistry of CONP's closed form
plus the PSR flow shell, as K7 evaluates it) against ``jax.jacfwd`` of the
reference's transient ``rhs`` and of its tau-scaled ``resid``, for
tau/vol x ENRG/TGIV on h2o2 and grisyn random states with heat loss: f
and J within 1e-12 scale-relative per lane, with T nondimensionalised as
in ``test_torch_kinetics.py`` (f_T / T; J's T row / T and T column x T).
The port's ``make_rhs`` must agree with the reference's rhs the same way.

Solves, h2o2, the reference's defaults; both packages get the same numpy
inputs (guesses from the reference's HP equilibrium of each inlet):

- tau/ENRG on the 63-lane map (phi 0.5, 1, 2 x inlet 298.15, 600, 900 K
  x tau 1e-6..1 s, 1 atm, mdot 10 g/s). On the lanes the reference solves
  OK the port gives the same status, n_newton_direct and n_newton_polish,
  T within 1e-8 relative and Y within 1e-10 absolute; on the lanes it
  does not, the port does not report OK. The two lanes named below take
  the pseudo-transient phase. Lanes through that phase are the fragile
  ones: a trajectory that swings between the 150 K and 5000 K clamps
  decides between basins on trace species of 1e-19 vs exactly 0, so
  rounding alone (LAPACK's recursive LU vs the port's, XLA's sums vs
  PyTorch's) can move it. With both packages started from the port's
  own equilibrium guesses (equal to the reference's to ~1e-15), phi 0.5,
  inlet 900 K, tau 1e-3 s ends TOL_NOT_MET in the port where the
  reference converges; from the reference's guesses every lane agrees. The card check of K7 allows 1 % of its lanes to differ.
- vol/ENRG (the reference's ``tests/test_psr.py`` set-up: V 50 cm^3,
  mdot 20 g/s, hot guess) and tau/TGIV (T_fixed 1500 K, tau 1e-3 s, guess
  the inlet at T_fixed), each with two more volumes or temperatures:
  every lane as on the map, no exception.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import equilibrium as jeq
from pychemkin_tpu.ops import psr as jpsr
from pychemkin_tpu.ops import thermo as jthermo
import pychemkin_tpu_torch as ptt
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import jacobian, psr
from pychemkin_tpu_torch.resilience.status import SolveStatus

from torch_port_cases import (P_ATM, h2_air, psr_map_lanes, random_states,
                              rate_rel)

J_TOL = 1e-12
T_REL = 1e-8
Y_ABS = 1e-10
#: map lanes (phi, inlet T, tau) that run the pseudo-transient phase
PT_LANES = ((1.0, 298.15, 1e-5), (0.5, 298.15, 1e-3))


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny tensor operations: one intra-op thread is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mechs():
    return {name: (jmech.load_embedded(name),
                   tmech.TorchMechanism(tmech.load_embedded(name), "cpu"))
            for name in ("h2o2", "grisyn")}


def _lanes_np(KK, B, seed):
    """Random PSR lane constants and states, numpy."""
    rng = np.random.default_rng(seed)
    T, P, Y = random_states(KK, B, seed)
    return dict(
        y=np.concatenate([Y, T[:, None]], 1), P=P,
        Y_in=random_states(KK, B, seed + 1)[2],
        h_in=rng.uniform(-1e10, 1e10, B), tau=10 ** rng.uniform(-6, 0, B),
        volume=rng.uniform(1.0, 100.0, B), mdot=rng.uniform(1.0, 20.0, B),
        qloss=rng.uniform(0.0, 1e9, B), T_fixed=rng.uniform(800, 2000, B))


def _ref_fj(jm, mode, energy, L):
    """The reference's (rhs, d rhs/dy) and its tau-scaled (resid,
    d resid/dy) at the lanes ``L``, under one jit."""
    rhs = jpsr.make_rhs(mode, energy)

    def one(y, P, Y_in, h_in, tau, volume, mdot, qloss, T_fixed):
        args = jpsr.PSRArgs(mech=jm, P=P, Y_in=Y_in, h_in=h_in, tau=tau,
                            volume=volume, mdot=mdot, qloss=qloss,
                            T_fixed=T_fixed)

        def resid(z):       # solve_psr's residual
            Y, T = jpsr._split(z)
            if energy == "TGIV":
                T = args.T_fixed
            rho = jthermo.density(jm, T, args.P, Y)
            tau_eff, _ = jpsr._tau_volume(args, rho, mode)
            return rhs(0.0, z, args) * jnp.maximum(tau_eff, 1e-30)
        out = []
        for f in (lambda z: rhs(0.0, z, args), resid):
            out += [f(y), jpsr._resid_jac(lambda z, _: f(z), y, args, True)]
        return out

    fields = ("y", "P", "Y_in", "h_in", "tau", "volume", "mdot", "qloss",
              "T_fixed")
    out = jax.jit(jax.vmap(one))(*[jnp.asarray(L[k]) for k in fields])
    return [(np.asarray(out[0]), np.asarray(out[1])),
            (np.asarray(out[2]), np.asarray(out[3]))]


@pytest.mark.parametrize("energy", ["ENRG", "TGIV"])
@pytest.mark.parametrize("mode", ["tau", "vol"])
@pytest.mark.parametrize("name", ["h2o2", "grisyn"])
def test_psr_rhs_jac_matches_jacfwd(mechs, name, mode, energy):
    jm, tm = mechs[name]
    L = _lanes_np(tm.KK, 8, seed=21)
    args = psr.PSRArgs(*[torch.tensor(L[k]) for k in psr.PSRArgs._fields])
    y = torch.tensor(L["y"])
    T = L["y"][:, -1] if energy == "ENRG" else L["T_fixed"]
    for scaled, (f_ref, J_ref) in zip((False, True),
                                      _ref_fj(jm, mode, energy, L)):
        f, J = jacobian.psr_rhs_jac(tm, y, args, mode, energy, scaled=scaled)
        assert rate_rel(f.numpy(), f_ref, T, tm.KK) <= J_TOL, scaled
        assert rate_rel(J.numpy(), J_ref, T, tm.KK) <= J_TOL, scaled
        if not scaled:
            f_rhs = psr.make_rhs(mode, energy)(tm, y, args)
            assert rate_rel(f_rhs.numpy(), f_ref, T, tm.KK) <= J_TOL
        else:
            r = psr.resid(tm, y, args, mode, energy)
            assert rate_rel(r.numpy(), f_ref, T, tm.KK) <= J_TOL


def _inlets(jm, phi, T_in):
    """Inlet mass fractions, enthalpies and the reference's HP-equilibrium
    guesses, numpy."""
    Y_in = h2_air(jm.species_names, jm.wt, phi)
    h_in = np.array(jax.vmap(lambda t, y: jthermo.mixture_enthalpy_mass(
        jm, t, y))(T_in, Y_in))
    g = jax.jit(jax.vmap(lambda t, y: jeq.equilibrate(jm, t, P_ATM, y,
                                                      option=5)))(T_in, Y_in)
    return Y_in, h_in, np.array(g.T), np.array(g.Y)


def _solve_both(jm, tm, mode, energy, **lanes):
    """The same lanes through the reference (jit/vmap) and the port's
    entry point on the CPU."""
    names = ("Y_in", "h_in", "T_guess", "Y_guess", "tau", "volume", "mdot",
             "T_fixed")

    def one(Y_in, h_in, T_guess, Y_guess, tau, volume, mdot, T_fixed):
        return jpsr.solve_psr(jm, mode, energy, P=P_ATM, Y_in=Y_in,
                              h_in=h_in, T_guess=T_guess, Y_guess=Y_guess,
                              tau=tau, volume=volume, mdot=mdot,
                              T_fixed=T_fixed)
    ref = jax.jit(jax.vmap(one))(*[jnp.asarray(lanes[k]) for k in names])
    got = ptt.solve_psr(tm, mode, energy, P=P_ATM, device="cpu",
                        **{k: lanes[k] for k in names})
    return ref, got


def _apart(ref, got):
    """Lanes where the port does not meet the contract: status or Newton
    counts differ where the reference is OK, or OK where it is not; and
    the worst T and Y errors on the OK lanes that meet it."""
    st = np.asarray(ref.status)
    ok = st == int(SolveStatus.OK)
    same = ((got.status.numpy() == st)
            & (got.n_newton_direct.numpy() == np.asarray(ref.n_newton_direct))
            & (got.n_newton_polish.numpy()
               == np.asarray(ref.n_newton_polish)))
    apart = (ok & ~same) | (~ok & (got.status.numpy() == int(SolveStatus.OK)))
    good = ok & same
    eT = (np.abs(got.T.numpy() - np.asarray(ref.T)) / np.asarray(ref.T))[good]
    eY = np.abs(got.Y.numpy() - np.asarray(ref.Y))[good]
    return apart, good, eT.max(initial=0.0), eY.max(initial=0.0)


def test_map_tau_enrg_matches_jax(mechs):
    jm, tm = mechs["h2o2"]
    phi, T_in, tau = psr_map_lanes()
    Y_in, h_in, T_g, Y_g = _inlets(jm, phi, T_in)
    B = phi.size
    ref, got = _solve_both(jm, tm, "tau", "ENRG", Y_in=Y_in, h_in=h_in,
                           T_guess=T_g, Y_guess=Y_g, tau=tau,
                           volume=np.zeros(B), mdot=np.full(B, 10.0),
                           T_fixed=np.zeros(B))
    apart, good, eT, eY = _apart(ref, got)
    assert not apart.any(), np.flatnonzero(apart)
    assert eT <= T_REL and eY <= Y_ABS, (eT, eY)
    for lane in PT_LANES:
        i = int(np.flatnonzero(np.isclose(phi, lane[0]) & np.isclose(T_in, lane[1])
                               & np.isclose(tau, lane[2]))[0])
        assert good[i] and int(ref.n_newton_polish[i]) > 0, lane
    # the map has both branches and lanes the reference does not solve
    T = np.asarray(ref.T)
    assert (good & (np.abs(T - T_in) < 1.0)).any()
    assert (good & (T > 2000.0)).any()
    assert (np.asarray(ref.status) != int(SolveStatus.OK)).any()


def test_set_volume_matches_jax(mechs):
    jm, tm = mechs["h2o2"]
    Y_in, h_in, T_g, Y_g = _inlets(jm, np.ones(3), np.full(3, 298.15))
    ref, got = _solve_both(jm, tm, "vol", "ENRG", Y_in=Y_in, h_in=h_in,
                           T_guess=T_g, Y_guess=Y_g, tau=np.zeros(3),
                           volume=np.array([50.0, 5.0, 500.0]),
                           mdot=np.full(3, 20.0), T_fixed=np.zeros(3))
    apart, good, eT, eY = _apart(ref, got)
    assert not apart.any() and good.all()
    assert eT <= T_REL and eY <= Y_ABS, (eT, eY)
    np.testing.assert_allclose(got.tau.numpy(), np.asarray(ref.tau),
                               rtol=T_REL)


def test_fixed_temperature_matches_jax(mechs):
    jm, tm = mechs["h2o2"]
    Y_in = h2_air(jm.species_names, jm.wt, np.ones(3))
    T_fix = np.array([1500.0, 1200.0, 1800.0])
    ref, got = _solve_both(jm, tm, "tau", "TGIV", Y_in=Y_in,
                           h_in=np.zeros(3), T_guess=T_fix, Y_guess=Y_in,
                           tau=np.full(3, 1e-3), volume=np.zeros(3),
                           mdot=np.full(3, 10.0), T_fixed=T_fix)
    apart, good, eT, eY = _apart(ref, got)
    assert not apart.any() and good.all()
    assert eT <= T_REL and eY <= Y_ABS, (eT, eY)
    assert np.array_equal(got.T.numpy(), T_fix)


def test_wrapper_routes_cpu_tensors_to_the_twin(mechs):
    _, tm = mechs["h2o2"]
    B = 2
    Y_in = torch.tensor(h2_air(tm.record.species_names, tm.record.wt,
                               np.ones(B)))
    f64 = dict(dtype=torch.float64)
    args = psr.PSRArgs(P=torch.full((B,), P_ATM, **f64), Y_in=Y_in,
                       h_in=torch.zeros(B, **f64),
                       tau=torch.tensor([1e-6, 1e-5], **f64),
                       volume=torch.zeros(B, **f64),
                       mdot=torch.full((B,), 10.0, **f64),
                       qloss=torch.zeros(B, **f64),
                       T_fixed=torch.zeros(B, **f64))
    y0 = torch.cat([Y_in, torch.full((B, 1), 298.15, **f64)], 1)
    ctl = psr.PSRControls(n_pseudo=2)
    kernels.reset_launches()
    got = kernels.psr_solve(tm, "tau", "ENRG", args, y0, ctl)
    want = psr.solve_psr_plain(tm, "tau", "ENRG", args, y0, ctl)
    assert kernels.LAUNCHES["psr_solve"] == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        kernels.psr_solve(tm, "volume", "ENRG", args, y0, ctl)
    with pytest.raises(ValueError):
        kernels.psr_solve(tm, "tau", "ENRG", args, y0[:, :-1], ctl)
    with pytest.raises(TypeError):
        kernels.psr_solve(tm, "tau", "ENRG", args._replace(tau=args.tau.float()),
                          y0, ctl)
