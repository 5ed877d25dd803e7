"""The PyTorch port's batched chemical equilibrium (plain twin of kernel
K6) against the JAX package's ``ops/equilibrium.py``.

The same numpy inputs go through the reference (``equilibrate`` under
jit/vmap, one program per option for the module) and through
``pychemkin_tpu_torch.equilibrate(..., device="cpu")``, whose kernel
wrapper takes the plain twin on CPU tensors.

- h2o2, all nine options, 6 states (T 300-2500 K, H2/air at phi 0.5-2,
  1-10 atm): the same SolveStatus on every state; on the OK states T
  within 1e-9 relative, X within 1e-11 absolute, h, s and v within 1e-9
  relative. Both run the same damped Newton with fixed iteration counts
  on the same f64 arithmetic; what differs is summation order and the LU
  (LAPACK's recursive getrf vs the port's right-looking one with the same
  pivots), so agreement is to rounding of a converged Newton.
- grisyn option 5 at 4 states, the same tolerances.
- The closed-form Jacobian K6 evaluates (``equilibrium.resid_jac``)
  against ``jax.jacfwd`` of the reference's residual, built from its
  ``_mixture_props`` and ``_constraint_residual`` exactly as ``_solve``'s
  ``make_resid`` does, for every constraint kind: per row, max |dJ| over
  max |J| of that row within 1e-12 (rows of an equilibrium Jacobian span
  decades, so the bound is per row, not per lane).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import equilibrium as jeq
from pychemkin_tpu.ops import thermo as jthermo
import pychemkin_tpu_torch as ptt
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import equilibrium as teq
from pychemkin_tpu_torch.ops import thermo
from pychemkin_tpu_torch.resilience.status import SolveStatus

from torch_port_cases import equilibrium_states, scale_rel

T_REL = 1e-9
X_ABS = 1e-11
PROP_REL = 1e-9
JAC_ROW_REL = 1e-12


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


def _compare(jm, tm, T, P, Y, option):
    ref = jax.jit(jax.vmap(lambda t, p, y: jeq.equilibrate(
        jm, t, p, y, option=option)))(T, P, Y)
    got = ptt.equilibrate(tm, T, P, Y, option=option, device="cpu")
    st_ref = np.asarray(ref.status)
    assert np.array_equal(got.status.numpy(), st_ref), option
    assert np.array_equal(got.converged.numpy(), np.asarray(ref.converged))
    ok = st_ref == int(SolveStatus.OK)
    assert ok.any(), option
    rel = {f: np.abs(getattr(got, f).numpy() - np.asarray(getattr(ref, f)))[ok]
           / np.abs(np.asarray(getattr(ref, f)))[ok] for f in ("T", "h", "s",
                                                              "v", "P")}
    assert rel["T"].max() <= T_REL, (option, rel["T"].max())
    for f in ("h", "s", "v", "P"):
        assert rel[f].max() <= PROP_REL, (option, f, rel[f].max())
    x_err = np.abs(got.X.numpy() - np.asarray(ref.X))[ok].max()
    assert x_err <= X_ABS, (option, x_err)
    y_err = np.abs(got.Y.numpy() - np.asarray(ref.Y))[ok].max()
    assert y_err <= X_ABS, (option, y_err)


@pytest.mark.parametrize("option", range(1, 10))
def test_h2o2_options_match_jax(mechs, option):
    jm, tm = mechs["h2o2"]
    T, P, Y = equilibrium_states(tm.record.species_names, tm.record.wt, 6,
                                 seed=1)
    _compare(jm, tm, T, P, Y, option)


def test_grisyn_option5_matches_jax(mechs):
    jm, tm = mechs["grisyn"]
    T, P, Y = equilibrium_states(tm.record.species_names, tm.record.wt, 4,
                                 seed=2)
    _compare(jm, tm, T, P, Y, 5)


def _ref_resid(jm, c1, c2):
    """The reference's residual of ``_solve`` for the pair (c1, c2)."""
    MM = jm.ncf.shape[1]

    def resid(z, t1, t2, b_eff, b_scale):
        props = jeq._mixture_props(jm, z[:MM], z[MM], z[MM + 1], z[MM + 2])
        r_el = (jm.ncf.T @ props["N"] - b_eff) / b_scale
        r_norm = jnp.log(jnp.maximum(jnp.sum(props["x"]), 1e-30))
        r1 = jeq._constraint_residual(c1, props, t1, props["nbar"])
        r2 = jeq._constraint_residual(c2, props, t2, props["nbar"])
        return jnp.concatenate([r_el, jnp.stack([r_norm, r1, r2])])
    return resid


#: constraint pairs covering all six kinds
PAIRS = (("T", "P"), ("P", "H"), ("V", "U"), ("T", "S"), ("T", "V"))


@pytest.mark.parametrize("name", ["h2o2", "grisyn"])
def test_closed_form_jacobian_matches_jacfwd(mechs, name):
    jm, tm = mechs[name]
    B = 8
    rng = np.random.default_rng(4)
    T, P, Y = equilibrium_states(tm.record.species_names, tm.record.wt, B,
                                 seed=3)
    Tt, Pt, Yt = (torch.tensor(a) for a in (T, P, Y))
    # Newton states near and far from the solution: a converged state with
    # the potentials, ln nbar, ln T and ln P perturbed (some ln x beyond
    # the soft-clip band, some inside the entropy's clip)
    sol = teq.equilibrate_plain(tm, Tt, Pt, Yt, 5)
    Yn, b, targets, _, _ = teq.initial_state(tm, Tt, Pt, Yt, 5)
    b_tot = b.sum(-1, keepdim=True)
    b_eff = torch.maximum(b, 1e-25 * b_tot)
    b_scale = torch.maximum(b_eff, 1e-6 * b_tot)
    lam_fit = torch.linalg.lstsq(
        tm.ncf, (torch.log(torch.clamp(sol.X, min=1e-300)).T
                 + teq.thermo.g_RT(tm, sol.T).T + torch.log(
                     sol.P / teq.P_ATM))).solution.T
    z = torch.cat([lam_fit, torch.stack([torch.log(sol.nbar),
                                         torch.log(sol.T),
                                         torch.log(sol.P)], 1)], 1)
    z = z + torch.tensor(rng.normal(0.0, 1.0, z.shape)) * torch.tensor(
        [3.0] * tm.MM + [0.3, 0.2, 0.3])
    z[0, 0] += 60.0       # some ln x above 40
    z[1, 1] -= 60.0       # some below -75
    for c1, c2 in PAIRS:
        sys_ = teq._System((c1, c2), targets[c1], targets[c2], b_eff,
                           b_scale)
        r, J = teq.resid_jac(tm, z, sys_)
        fn = _ref_resid(jm, c1, c2)
        args = (z.numpy(), targets[c1].numpy(), targets[c2].numpy(),
                b_eff.numpy(), b_scale.numpy())
        r_ref, J_ref = jax.jit(jax.vmap(lambda *a: (fn(*a), jax.jacfwd(fn)(
            *a))))(*args)
        J_ref = np.asarray(J_ref)
        np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-12, atol=1e-14)
        err = (np.abs(J.numpy() - J_ref).max(-1)
               / np.maximum(np.abs(J_ref).max(-1), 1e-300))
        assert err.max() <= JAC_ROW_REL, ((c1, c2), err.max())


def test_thermo_counterparts_match_jax(mechs):
    """The mixture properties the equilibrium's targets use, 1e-12."""
    jm, tm = mechs["grisyn"]
    T, P, Y = equilibrium_states(tm.record.species_names, tm.record.wt, 6,
                                 seed=6)
    X = np.asarray(jax.vmap(lambda y: jthermo.Y_to_X(jm, y))(Y))
    Tt, Pt, Yt, Xt = (torch.tensor(a) for a in (T, P, Y, X))
    checks = (
        (thermo.species_enthalpy_mass(tm, Tt),
         jax.vmap(lambda t: jthermo.species_enthalpy_mass(jm, t))(T)),
        (thermo.Y_to_X(tm, Yt), X),
        (thermo.mean_molecular_weight_X(tm, Xt)[:, None],
         jax.vmap(lambda x: jthermo.mean_molecular_weight_X(jm, x))(X)[:, None]),
        (thermo.mixture_enthalpy_mass(tm, Tt, Yt)[:, None],
         jax.vmap(lambda t, y: jthermo.mixture_enthalpy_mass(jm, t, y))(
             T, Y)[:, None]),
        (thermo.mixture_internal_energy_mass(tm, Tt, Yt)[:, None],
         jax.vmap(lambda t, y: jthermo.mixture_internal_energy_mass(
             jm, t, y))(T, Y)[:, None]),
        (thermo.mixture_entropy_molar(tm, Tt, Pt, Xt)[:, None],
         jax.vmap(lambda t, p, x: jthermo.mixture_entropy_molar(jm, t, p, x))(
             T, P, X)[:, None]))
    for i, (got, want) in enumerate(checks):
        assert scale_rel(got, want) <= 1e-12, i


def test_wrapper_routes_cpu_tensors_to_the_twin(mechs):
    _, tm = mechs["h2o2"]
    T, P, Y = (torch.tensor(a) for a in equilibrium_states(
        tm.record.species_names, tm.record.wt, 3, seed=5))
    kernels.reset_launches()
    got = kernels.equil_solve(tm, T, P, Y, 1, 80)
    want = teq.equilibrate_plain(tm, T, P, Y, 1, 80)
    assert kernels.LAUNCHES["equil_solve"] == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        kernels.equil_solve(tm, T, P, Y, 10, 80)
    with pytest.raises(TypeError):
        kernels.equil_solve(tm, T.float(), P, Y, 1, 80)
    with pytest.raises(ValueError):
        kernels.equil_solve(tm, T, P, Y[:, :-1], 1, 80)


def test_entry_point_needs_a_card_unless_told_cpu(mechs, monkeypatch):
    _, tm = mechs["h2o2"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptt.equilibrate(tm.record, 300.0, 1.01325e6,
                        np.full(tm.KK, 1.0 / tm.KK))
