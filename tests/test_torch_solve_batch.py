"""The PyTorch port's ``solve_batch`` (the general batch integrator with
P(t), V(t) and T(t) profiles, wall heat loss and an output grid) against
the JAX package's, on h2o2 with B = 8 lanes and n_out = 11.

- For each of the four reactors, with its constraint profile, a heat-loss
  profile and htc/area/tamb on the ENRG ones (an area profile on one),
  the port's ``solve_batch(device="cpu")`` against ``jax.vmap`` of the
  reference's: the same SolveStatus codes, T, P and V at every output
  time within 1e-6 relative, Y within 1e-6 max(|Y|, 1e-8), ignition
  times within rtol (1e-6) relative. The only intended difference is LU
  roundoff (the reference's CPU path pivots, the port's does not).
- The profile twins of K1/K2 (``RHS_PRF_TWINS``: f and the fused J)
  against the reference's ``_RHS`` and ``_batch_jac_core(with_rhs=True)``
  at random states and times, within 1e-12 scale-relative.
- K8's wrapper with profiles (the stiffness rate ``solve_batch(profile=
  True)`` samples at t_final; its twin on the CPU) against the
  reference's ``gershgorin_rate`` of that Jacobian, on all four reactors,
  within 1e-12 relative.

The TGIV reactors' checks and the constant-profile checks against the
sweep are in test_torch_solve_batch_tgiv.py, so that each file stays near a minute
(the JAX reference compiles once per reactor). Horizons are cut to the
first microseconds around ignition so that the CPU twins stay cheap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import jacobian as jjac
from pychemkin_tpu.ops import odeint as jode
from pychemkin_tpu.ops import reactors as jre
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import reactors
from pychemkin_tpu_torch.resilience.status import SolveStatus

from torch_port_cases import (P_ATM, radical_pool_states, rate_rel,
                              stoich_h2_air)

B, N_OUT = 8, 11
RTOL, ATOL = 1e-6, 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's CPU path is many tiny tensor operations: one intra-op
    thread is faster than several."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def h2o2():
    jm = jmech.load_embedded("h2o2")
    return jm, tmech.load_embedded("h2o2")


#: the four reactors: T0 range, t_end, profiles (knots, values) and the
#: heat-loss settings. CONV/ENRG is a rapid compression with wall loss
#: whose lanes ignite inside the window; CONP/ENRG a pressure ramp with a
#: heat-loss rate and an area profile; the TGIV ones (the companion file
#: test_torch_solve_batch_tgiv.py) a temperature ramp, Species_peak of OH.
CASES = {
    "conv_enrg": dict(
        problem="CONV", energy="ENRG", T0=(1200.0, 1300.0), t_end=2e-5,
        constraint=([0.0, 1e-5, 2e-5], [1.0, 0.7, 0.7]),
        qloss=([0.0, 2e-5], [1e7, 1e7]), area=None,
        htc=5e5, area_c=1.0, tamb=300.0, mode="T_inflection"),
    "conp_enrg": dict(
        problem="CONP", energy="ENRG", T0=(1350.0, 1450.0), t_end=1e-5,
        constraint=([0.0, 1e-5], [1.0 * P_ATM, 2.0 * P_ATM]),
        qloss=([0.0, 1e-5], [0.0, 1e8]), area=([0.0, 1e-5], [1.0, 2.0]),
        htc=5e5, area_c=0.0, tamb=300.0, mode="T_inflection"),
    "conp_tgiv": dict(
        problem="CONP", energy="TGIV", T0=(1300.0, 1400.0), t_end=5e-6,
        constraint=([0.0, 5e-6], [1.0 * P_ATM, 1.5 * P_ATM]),
        tprof=([0.0, 5e-6], [1300.0, 1600.0]), qloss=None, area=None,
        htc=0.0, area_c=0.0, tamb=298.15, mode="Species_peak"),
    "conv_tgiv": dict(
        problem="CONV", energy="TGIV", T0=(1300.0, 1400.0), t_end=5e-6,
        constraint=([0.0, 2.5e-6, 5e-6], [1.0, 0.8, 0.8]),
        tprof=([0.0, 5e-6], [1300.0, 1600.0]), qloss=None, area=None,
        htc=0.0, area_c=0.0, tamb=298.15, mode="Species_peak"),
}

#: the cases of this file (the TGIV ones run in the companion file)
ENRG = ("conv_enrg", "conp_enrg")


def _jprof(p):
    return None if p is None else jre.Profile(x=jnp.asarray(p[0]),
                                              y=jnp.asarray(p[1]))


def _tprof(p):
    return None if p is None else reactors.Profile(
        x=torch.tensor(p[0], dtype=torch.float64),
        y=torch.tensor(p[1], dtype=torch.float64))


def _lanes(rec, c):
    T0 = np.linspace(*c["T0"], B)
    Y0 = np.tile(stoich_h2_air(rec.species_names, np.asarray(rec.wt)),
                 (B, 1))
    return T0, np.full(B, P_ATM), Y0, np.full(B, c["t_end"])


def _kw(rec, c):
    oh = list(rec.species_names).index("OH")
    return ({"species_index": oh} if c["mode"] == "Species_peak" else None)


def _reference(jm, c):
    T0, P0, Y0, t_end = _lanes(jm, c)
    kw = dict(n_out=N_OUT, rtol=RTOL, atol=ATOL,
              constraint_profile=_jprof(c["constraint"]),
              t_profile=_jprof(c.get("tprof")),
              qloss_profile=_jprof(c["qloss"]),
              area_profile=_jprof(c["area"]), htc=c["htc"],
              tamb=c["tamb"], area=c["area_c"], ignition_mode=c["mode"],
              ignition_kwargs=_kw(jm, c))
    fn = jax.jit(jax.vmap(lambda T, P, Y, te: jre.solve_batch(
        jm, c["problem"], c["energy"], T, P, Y, te, **kw)))
    sol = fn(*(jnp.asarray(a) for a in (T0, P0, Y0, t_end)))
    return jax.tree_util.tree_map(np.asarray, sol)


def _port(rec, c, **over):
    T0, P0, Y0, t_end = _lanes(rec, c)
    kw = dict(n_out=N_OUT, rtol=RTOL, atol=ATOL,
              constraint_profile=_tprof(c["constraint"]),
              t_profile=_tprof(c.get("tprof")),
              qloss_profile=_tprof(c["qloss"]),
              area_profile=_tprof(c["area"]), htc=c["htc"],
              tamb=c["tamb"], area=c["area_c"], ignition_mode=c["mode"],
              ignition_kwargs=_kw(rec, c), device="cpu")
    kw.update(over)
    return reactors.solve_batch(rec, c["problem"], c["energy"], T0, P0, Y0,
                                t_end, **kw)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def check_against_jax(h2o2, case):
    """The port's solve_batch against the reference's on ``case``."""
    jm, rec = h2o2
    c = CASES[case]
    want = _reference(jm, c)
    got = _port(rec, c)
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    assert (got.status.numpy() == int(SolveStatus.OK)).all()
    np.testing.assert_array_equal(got.success.numpy(), want.success)
    np.testing.assert_allclose(got.times.numpy(), want.times, rtol=1e-15,
                               atol=0)
    for name in ("T", "P", "volume"):
        assert _rel(getattr(got, name).numpy(), getattr(want, name)) <= 1e-6, \
            name
    Yg, Yw = got.Y.numpy(), want.Y
    assert np.all(np.abs(Yg - Yw) <= 1e-6 * np.maximum(np.abs(Yw), 1e-8))
    tw = want.ignition_time
    assert np.all(np.isfinite(tw))
    np.testing.assert_allclose(got.ignition_time.numpy(), tw, rtol=RTOL,
                               atol=0)
    # the profile is not a constant: the solution moved with it
    if c["energy"] == "TGIV":
        np.testing.assert_allclose(got.T.numpy()[:, -1], c["tprof"][1][-1])


@pytest.mark.parametrize("case", ENRG)
def test_solve_batch_matches_jax(h2o2, case):
    check_against_jax(h2o2, case)


def _rhs_args(jm, rec, c, seed):
    """Random igniting states, times inside the profiles' knots, per-lane
    mass, htc and tamb: the reference's vmapped BatchArgs pieces and the
    port's BatchArgs."""
    rng = np.random.default_rng(seed)
    T, Y = radical_pool_states(rec.species_names, np.asarray(rec.wt), B,
                               seed)
    y = np.concatenate([Y, T[:, None]], axis=1)
    t = rng.uniform(0.0, c["t_end"], B)
    mass = rng.uniform(5e-5, 2e-4, B)
    htc = rng.uniform(1e5, 1e6, B)
    tamb = rng.uniform(280.0, 320.0, B)
    profs = {k: (c.get(k) or ([0.0, 1.0], [v, v])) for k, v in (
        ("constraint", 1.0), ("tprof", 1500.0), ("qloss", 1e8),
        ("area", 1.5))}
    targs = reactors.BatchArgs(
        *(reactors.Profile(
            x=torch.tensor(p[0], dtype=torch.float64).expand(B, -1),
            y=torch.tensor(p[1], dtype=torch.float64).expand(B, -1))
          for p in (profs["constraint"], profs["tprof"], profs["qloss"],
                    profs["area"])),
        mass=torch.tensor(mass), htc=torch.tensor(htc),
        tamb=torch.tensor(tamb))
    jprofs = [_jprof(profs[k]) for k in ("constraint", "tprof", "qloss",
                                         "area")]
    return y, t, (mass, htc, tamb), jprofs, targs


def check_profile_twins(h2o2, case):
    """The profile twins of K1/K2 against the reference's on ``case``'s
    profiles at random states and times."""
    jm, rec = h2o2
    c = CASES[case]
    y, t, (mass, htc, tamb), jprofs, targs = _rhs_args(jm, rec, c, 7)
    problem, energy = c["problem"], c["energy"]

    def one(tt, yy, m, h, ta):
        args = jre.BatchArgs(jm, *jprofs, mass=m, htc=h, tamb=ta)
        f = jre._RHS[(problem, energy)](tt, yy, args)
        fj, J = jjac._batch_jac_core(problem, energy, tt, yy, args,
                                     with_rhs=True)
        return f, fj, J

    f_w, fj_w, J_w = (np.asarray(a) for a in jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in (t, y, mass, htc, tamb))))
    code = reactors.variant(problem, energy)
    rhs, rhs_jac = reactors.RHS_PRF_TWINS[code]
    tt, yt = torch.tensor(t), torch.tensor(y)
    f = rhs(rec_tm(rec), tt, yt, targs)
    f2, J = rhs_jac(rec_tm(rec), tt, yt, targs)
    T = y[:, -1]
    KK = rec.n_species
    assert rate_rel(f.numpy(), f_w, T, KK) <= 1e-12
    assert rate_rel(f2.numpy(), fj_w, T, KK) <= 1e-12
    assert rate_rel(J.numpy(), J_w, T, KK) <= 1e-12
    # the twin's f and the fused f are the same function
    assert rate_rel(f2.numpy(), f.numpy(), T, KK) <= 1e-13


_TM = {}


def rec_tm(rec):
    key = id(rec)
    if key not in _TM:
        _TM[key] = tmech.TorchMechanism(rec, "cpu")
    return _TM[key]


@pytest.mark.parametrize("case", ENRG)
def test_profile_rhs_and_jacobian_match_jax(h2o2, case):
    check_profile_twins(h2o2, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_profile_stiffness_matches_jax(h2o2, case):
    """K8 with profiles on CPU tensors (its twin) is the reference's
    Gershgorin rate of the profile Jacobian at the same (t, y)."""
    jm, rec = h2o2
    c = CASES[case]
    y, t, (mass, htc, tamb), jprofs, targs = _rhs_args(jm, rec, c, 11)
    problem, energy = c["problem"], c["energy"]

    def one(tt, yy, m, h, ta):
        args = jre.BatchArgs(jm, *jprofs, mass=m, htc=h, tamb=ta)
        return jode.gershgorin_rate(jjac._batch_jac_core(
            problem, energy, tt, yy, args, with_rhs=True)[1])

    want = np.asarray(jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in (t, y, mass, htc, tamb))))
    code = reactors.variant(problem, energy)
    kernels.reset_launches()
    got = kernels.gershgorin_rate(rec_tm(rec), torch.tensor(y), targs,
                                  problem=code, t=torch.tensor(t))
    assert not any(kernels.LAUNCHES.values())
    assert np.isfinite(want).all() and (want > 0).all()
    assert _rel(got.numpy(), want) <= 1e-12
    with pytest.raises(ValueError, match="times t"):
        kernels.gershgorin_rate(rec_tm(rec), torch.tensor(y), targs,
                                problem=code)
