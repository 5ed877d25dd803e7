"""The PyTorch port's bordered factor and solve (plain twins of kernels
K3 and K4) and its batched SDIRK3 sweep, against the JAX package.

Linear algebra: the pivot-free LU and its sweeps agree with
``linalg._lu_nopivot``/``_solve_nopivot`` to 1e-12 relative to the
largest entry (same algorithm, rounding only). The bordered factor +
solve of M = I - h gamma J, with J from igniting grisyn states and h
from 1e-9 to 1e-4 s, has a normwise relative residual
||M x - r||_inf / (||M||_inf ||x||_inf + ||r||_inf) <= 1e-10 and agrees
with numpy's pivoted LAPACK solve to 1e-10 relative to max |x|; the
difference is LU roundoff only.

Sweep, on h2o2 with T0 in {1200, 1300, 1400} K, 1 atm, stoichiometric
H2/air, rtol 1e-6, atol 1e-12, against one JAX
``reactors.ignition_sweep_kernel(mech, "CONP", "ENRG", round_len=40)``
shared by the module:

(a) Stepping parity: after ``init`` and one ``advance``, the port's state
    after 40 step attempts has t, h and y within 1e-8 relative and
    identical n_steps, n_rejected and n_newton. The only intended
    difference is LU roundoff: the reference's CPU path factors the
    species block with pivoted LAPACK, the port pivot-free.
(b) Whole sweep to t_end 2e-3 s: ignition times within 1e-4 relative of
    the JAX sweep kernel run to completion (which its package documents
    as bit-identical to the one-shot ``ignition_delay_sweep``), with
    identical SolveStatus codes and step counts.

The port runs on the CPU, through the kernel wrappers, which take their
plain twins there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import linalg as jlinalg
from pychemkin_tpu.ops import reactors as jre
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import jacobian, linalg, odeint, reactors
from pychemkin_tpu_torch.ops.odeint import _GAMMA
from pychemkin_tpu_torch.resilience.status import SolveStatus

from torch_port_cases import (P_ATM, radical_pool_states, scale_rel,
                              stoich_h2_air)

T0S = np.array([1200.0, 1300.0, 1400.0])
RTOL, ATOL = 1e-6, 1e-12
T_END = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's CPU path is many tiny tensor operations: one intra-op
    thread is faster than several."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rec, t_end):
    B = T0S.size
    Y0 = stoich_h2_air(rec.species_names, rec.wt)
    return (T0S, np.full(B, P_ATM), np.tile(Y0, (B, 1)), np.full(B, t_end),
            np.arange(B))


class _JaxSweep:
    """One JAX sweep kernel (h2o2, round_len=40, t_end 2e-3 s) for the
    module: the state after the first ``advance`` and, on demand, the
    harvest after advancing every lane to the end."""

    def __init__(self):
        self.mech = jmech.load_embedded("h2o2")
        self.kernel = jre.ignition_sweep_kernel(
            self.mech, "CONP", "ENRG", rtol=RTOL, atol=ATOL, round_len=40)
        self.args = _inputs(self.mech, T_END)
        self.state = self.kernel.advance(self.kernel.init(*self.args),
                                         *self.args)
        self.first = jax.tree_util.tree_map(np.asarray, self.state)

    def run_to_end(self):
        k, args, state = self.kernel, self.args, self.state
        while not bool(np.all(np.asarray(k.harvest(state, *args)["done"]))):
            state = k.advance(state, *args)
        return jax.tree_util.tree_map(np.asarray, k.harvest(state, *args))


@pytest.fixture(scope="module")
def jax_sweep():
    return _JaxSweep()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_stepping_parity_after_40_attempts(jax_sweep):
    jstate = jax_sweep.first
    rec = tmech.load_embedded("h2o2")
    tm = tmech.TorchMechanism(rec, "cpu")
    T0, P0, Y0, t_end, _ = (torch.tensor(a, dtype=torch.float64)
                            for a in _inputs(rec, T_END))
    events = reactors.ignition_events(reactors.IGN_T_INFLECTION)
    lanes, y0 = reactors.sweep_lane_args(tm, T0, P0, Y0, t_end, atol=ATOL)
    ops = reactors.kernel_ops("CONP")
    with torch.inference_mode():
        s = odeint.sweep_start(ops, tm, lanes, y0, RTOL, events)
        s = odeint.sweep_round(ops, tm, lanes, events, RTOL, 20_000, s,
                               max_attempts=40)
    np.testing.assert_array_equal(s.n_steps.numpy(), jstate.n_steps)
    np.testing.assert_array_equal(s.n_rejected.numpy(), jstate.n_rejected)
    np.testing.assert_array_equal(s.n_newton.numpy(), jstate.n_newton)
    assert (s.n_steps + s.n_rejected == 40).all()
    assert _rel(s.t, jstate.t) < 1e-8
    assert _rel(s.h, jstate.h) < 1e-8
    y_scale = np.abs(jstate.y).max(1, keepdims=True)
    assert np.max(np.abs(s.y.numpy() - jstate.y) / y_scale) < 1e-8
    np.testing.assert_array_equal(s.status.numpy(), jstate.status)


def test_h2o2_sweep_matches_jax(jax_sweep):
    jh = jax_sweep.run_to_end()
    rec = tmech.load_embedded("h2o2")
    T0, P0, Y0, t_end, _ = _inputs(rec, T_END)
    times, ok, status, prof = reactors.ignition_delay_sweep(
        rec, "CONP", "ENRG", T0, P0, Y0, t_end, rtol=RTOL, atol=ATOL,
        device="cpu", profile=True)
    np.testing.assert_array_equal(status.numpy(), jh["status"])
    assert (status.numpy() == int(SolveStatus.OK)).all()
    np.testing.assert_array_equal(ok.numpy(), jh["ok"])
    assert np.isfinite(times.numpy()).all()
    assert _rel(times, jh["times"]) < 1e-4
    np.testing.assert_array_equal(prof["n_steps"].numpy(), jh["n_steps"])
    np.testing.assert_array_equal(prof["n_rejected"].numpy(),
                                  jh["n_rejected"])


def test_default_device_needs_cuda(monkeypatch):
    rec = tmech.load_embedded("h2o2")
    args = _inputs(rec, 2e-3)[:4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reactors.ignition_delay_sweep(rec, "CONP", "ENRG", *args)


def test_cuda_request_raises_without_a_card():
    """Asking for the card where there is none raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rec = tmech.load_embedded("h2o2")
    args = _inputs(rec, 2e-3)[:4]
    with pytest.raises((RuntimeError, AssertionError)):
        reactors.ignition_delay_sweep(rec, "CONP", "ENRG", *args,
                                      device="cuda")
    tm = tmech.TorchMechanism(rec, "cpu")
    y = torch.zeros(1, tm.N, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.rhs(tm, y, torch.zeros(1, dtype=torch.float64,
                                       device="meta"))


@pytest.mark.parametrize("problem, energy, ported", [
    ("CONV", "ENRG", True), ("CONP", "TGIV", False), ("CONV", "TGIV", False)])
def test_unported_variants_raise(problem, energy, ported):
    """CONV/ENRG runs (to a short horizon here; its parity with the JAX
    package is in test_torch_sdirk.py); the TGIV variants raise."""
    rec = tmech.load_embedded("h2o2")
    args = _inputs(rec, 1e-6)[:4]
    if ported:
        times, ok, status = reactors.ignition_delay_sweep(
            rec, problem, energy, *args, device="cpu")
        assert times.shape == ok.shape == status.shape == (T0S.size,)
        assert (status.numpy() == int(SolveStatus.OK)).all()
        return
    with pytest.raises(NotImplementedError, match="CONP/ENRG and CONV/ENRG"):
        reactors.ignition_delay_sweep(rec, problem, energy, *args,
                                      device="cpu")


def _diag_dominant(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    A[:, np.arange(n), np.arange(n)] += 2.0 * n
    return A


@pytest.mark.parametrize("n", [10, 53])
def test_lu_and_sweeps_match_jax(n):
    A = _diag_dominant(8, n, seed=n)
    b = np.random.default_rng(1).normal(size=(8, n))
    lu = linalg.lu_nopivot(torch.tensor(A))
    lu_ref = np.asarray(jlinalg._lu_nopivot(jnp.asarray(A)))
    assert scale_rel(lu, lu_ref) < 1e-12
    x = linalg.solve_nopivot(lu, torch.tensor(b))
    x_ref = np.asarray(jlinalg._solve_nopivot(jnp.asarray(lu_ref),
                                              jnp.asarray(b)))
    assert scale_rel(x, x_ref) < 1e-12


def test_clamped_pivot_matches_jax():
    """A zero pivot is clamped to +1e-30, as in the reference."""
    A = np.array([[[0.0, 1.0], [1.0, 1.0]]])
    lu = linalg.lu_nopivot(torch.tensor(A))
    np.testing.assert_array_equal(lu.numpy(),
                                  np.asarray(jlinalg._lu_nopivot(A)))


@pytest.fixture(scope="module")
def grisyn_jacobians():
    tm = tmech.TorchMechanism(tmech.load_embedded("grisyn"), "cpu")
    T, Y = radical_pool_states(tm.record.species_names, tm.record.wt, 32,
                               seed=5)
    y = torch.tensor(np.concatenate([Y, T[:, None]], axis=1))
    _, J = jacobian.conp_enrg_rhs_jac(tm, y, torch.full((32,), P_ATM,
                                                        dtype=torch.float64))
    return J


@pytest.mark.parametrize("h", [1e-9, 1e-7, 1e-6, 1e-5, 1e-4])
def test_bordered_factor_and_solve_against_numpy(grisyn_jacobians, h):
    J = grisyn_jacobians
    B, N = J.shape[0], J.shape[-1]
    hg = torch.full((B,), h * _GAMMA, dtype=torch.float64)
    r = torch.tensor(np.random.default_rng(int(-np.log10(h))).normal(
        size=(B, N)))
    fac = linalg.factor_bordered(J, hg)
    x = linalg.solve_bordered(fac, r).numpy()
    M = linalg.newton_matrix(J, hg).numpy()
    rn = r.numpy()
    res = np.abs(np.einsum("bij,bj->bi", M, x) - rn).max(1)
    scale = np.abs(M).sum(2).max(1) * np.abs(x).max(1) + np.abs(rn).max(1)
    assert (res / scale).max() <= 1e-10
    x_np = np.linalg.solve(M, rn[..., None])[..., 0]
    assert scale_rel(x, x_np) <= 1e-10


def test_wrappers_route_cpu_tensors_to_the_twins(grisyn_jacobians):
    J = grisyn_jacobians
    B, N = J.shape[0], J.shape[-1]
    hg = torch.full((B,), 1e-6, dtype=torch.float64)
    r = torch.tensor(np.random.default_rng(0).normal(size=(B, N)))
    before = dict(kernels.LAUNCHES)
    fac = kernels.bordered_factor(J, hg)
    ref = linalg.factor_bordered(J, hg)
    for a, b in zip(fac, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(kernels.bordered_solve(fac, r),
                               linalg.solve_bordered(ref, r), rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def test_wrappers_reject_bad_arguments(grisyn_jacobians):
    J = grisyn_jacobians
    B = J.shape[0]
    hg = torch.full((B,), 1e-6, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        kernels.bordered_factor(J.float(), hg.float())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.bordered_factor(J.transpose(1, 2), hg)
    with pytest.raises(ValueError, match="shape"):
        kernels.bordered_factor(J, hg[:-1])
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.bordered_factor(J.to("meta"), hg.to("meta"))
    fac = kernels.bordered_factor(J, hg)
    with pytest.raises(ValueError, match="shape"):
        kernels.bordered_solve(fac, torch.zeros(B, 3, dtype=torch.float64))


def test_profile_value_slope_matches_jax():
    """The piecewise-linear profile (flat outside its knots) against the
    reference's, inside, on the knots and on both sides."""
    x = np.array([0.0, 1e-3, 2e-3])
    yv = np.array([1.0, 3.0, 2.0]) * P_ATM
    t = np.array([-1e-3, 0.0, 4e-4, 1e-3, 1.5e-3, 2e-3, 5e-3])
    jp = jre.Profile(x=jnp.asarray(x), y=jnp.asarray(yv))
    want = jax.vmap(lambda tt: jre.profile_value_slope(jp, tt))(
        jnp.asarray(t))
    tp = reactors.Profile(x=torch.tensor(x), y=torch.tensor(yv))
    got = reactors.profile_value_slope(tp, torch.tensor(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15,
                                   atol=0)


@pytest.mark.parametrize("mode", ["T_inflection", "T_rise"])
def test_event_accumulators_match_jax(mode):
    """Both ignition definitions' event updates over one accepted step
    (samples at the step start, the two inner stages and the end), for
    lanes with and without an earlier hit."""
    from pychemkin_tpu.ops import odeint as jodeint
    rng = np.random.default_rng(4)
    B, N = 6, 3
    ts = np.sort(rng.uniform(0, 1e-4, (4, B)), axis=0)
    ys = rng.uniform(1000.0, 1600.0, (4, B, N))
    fs = rng.normal(0.0, 1e6, (4, B, N))
    T0 = np.full(B, 1000.0)
    active = np.array([True, True, True, False, True, True])
    kind = "max" if mode == "T_inflection" else "crossing"
    acc_t = np.where(np.arange(B) % 2 == 0,
                     np.inf if kind == "crossing" else np.nan, 5e-5)
    acc_v = np.where(np.arange(B) % 2 == 0, -np.inf, 2e5)
    jev = jre.ignition_events(mode, T0=1000.0)

    def one(t, y, f, at, av, act):
        samples = [(t[j], y[j], f[j]) for j in range(4)]
        return jodeint._update_events(jev, at[None], av[None], samples, act)

    want = jax.vmap(one, in_axes=(1, 1, 1, 0, 0, 0))(
        ts, ys, fs, acc_t, acc_v, active)
    tev = reactors.ignition_events(mode)
    lanes = odeint.Lanes(constraint=None, atol=None, t_end=None,
                         thresh=torch.tensor(T0 + 400.0))
    samples = [(torch.tensor(ts[j]), torch.tensor(ys[j]),
                torch.tensor(fs[j])) for j in range(4)]
    got = odeint._update_events(tev, lanes, torch.tensor(acc_t)[:, None],
                                torch.tensor(acc_v)[:, None], samples,
                                torch.tensor(active))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[:, 0], np.asarray(w)[:, 0],
                                   rtol=1e-14, atol=0, equal_nan=True)
