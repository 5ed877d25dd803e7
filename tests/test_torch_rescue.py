"""Fault injection and the rescue ladder of the PyTorch port
(``resilience/faultinject.py``, ``resilience/rescue.py``), and the
sweep's rescue knobs (``h0``, ``pivoted_lu``), against the JAX package on
the CPU.

- FaultSpec parsing (dict and the ``PYCHEMKIN_FAULTS`` env var), the
  ``inject`` context's scope, and the per-lane masks: a lane is poisoned
  while the rescue level is below its spec's ``heal_at``.
- ``run_rescue`` on a synthetic solver: only fixed lanes' values are
  merged, the ladder stops once every lane is fixed, and
  ``PYCHEMKIN_RESCUE=0`` turns it off.
- ``resilient_ignition_sweep`` on h2o2, B=8, with the same FaultSpecs in
  both packages (a Newton stall healing at rung 1, a NaN RHS healing at
  rung 2, a stall healing at rung 4, a NaN RHS that never heals): the
  same status codes and ``RescueReport`` (its dict without the walls),
  and times within 1e-6 relative. The port factors pivot-free where the
  reference's CPU path pivots (LAPACK), so times agree to the rtol, not
  bitwise.
- ``pivoted_lu=True`` against the reference under
  ``linalg.forced_pivoted()``, and an explicit ``h0``: the same status
  codes, step and Newton counts, times within 1e-6 relative.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import linalg as jlinalg
from pychemkin_tpu.ops import reactors as jre
from pychemkin_tpu.resilience import faultinject as jfi
from pychemkin_tpu.resilience import rescue as jrescue
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import linalg, odeint, reactors
from pychemkin_tpu_torch.resilience import faultinject, rescue
from pychemkin_tpu_torch.resilience.status import SolveStatus

from torch_port_cases import P_ATM, stoich_h2_air

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fault_spec_parsing(monkeypatch):
    s = faultinject.FaultSpec.from_dict(
        {"mode": "nan_rhs", "elements": [3, "5"], "t_min": "1e-5",
         "heal_at": 2})
    assert s == faultinject.FaultSpec("nan_rhs", (3, 5), 1e-5, 2)
    assert faultinject.FaultSpec.from_dict(
        {"mode": "newton_stall", "elements": [0]}).heal_at == -1
    with pytest.raises(ValueError, match="unknown fault mode"):
        faultinject.FaultSpec.from_dict({"mode": "typo", "elements": [0]})
    monkeypatch.delenv("PYCHEMKIN_FAULTS", raising=False)
    assert not faultinject.enabled()
    assert faultinject.sweep_elem_ids(4) is None
    monkeypatch.setenv("PYCHEMKIN_FAULTS", json.dumps(
        {"mode": "newton_stall", "elements": [1], "heal_at": 1}))
    assert faultinject.specs() == (
        faultinject.FaultSpec("newton_stall", (1,), 0.0, 1),)
    monkeypatch.setenv("PYCHEMKIN_FAULTS", json.dumps(
        [{"mode": "nan_rhs", "elements": [2]},
         {"mode": "linalg_unstable", "elements": [0]}]))
    assert [s.mode for s in faultinject.specs()] == ["nan_rhs",
                                                     "linalg_unstable"]
    assert len(faultinject.specs("nan_rhs")) == 1
    assert torch.equal(faultinject.sweep_elem_ids(3), torch.arange(3))


def test_fault_scoping_and_lane_masks(monkeypatch):
    monkeypatch.delenv("PYCHEMKIN_FAULTS", raising=False)
    ids = torch.tensor([7, 1, 3, 4])
    a = faultinject.FaultSpec("nan_rhs", (7, 3), t_min=2e-5, heal_at=2)
    b = faultinject.FaultSpec("nan_rhs", (3,), t_min=1e-5)
    c = faultinject.FaultSpec("newton_stall", (4,), heal_at=1)
    d = faultinject.FaultSpec("linalg_unstable", (1,))
    assert faultinject.lane_faults(ids, 0) == (None, None)
    with faultinject.inject(a, b, c, d):
        assert faultinject.enabled() and len(faultinject.specs()) == 4
        fault, t = faultinject.lane_faults(ids, 0)
        assert fault.tolist() == [odeint.FAULT_NAN, 0, odeint.FAULT_NAN,
                                  odeint.FAULT_STALL]
        assert t.tolist() == [2e-5, float("inf"), 1e-5, float("inf")]
        fault, t = faultinject.lane_faults(ids, 1)    # c healed
        assert fault.tolist() == [1, 0, 1, 0]
        fault, t = faultinject.lane_faults(ids, 2)    # a healed, b never
        assert fault.tolist() == [0, 0, 1, 0] and t[2] == 1e-5
        with faultinject.inject(faultinject.FaultSpec("newton_stall", (1,))):
            assert len(faultinject.specs()) == 5
        assert len(faultinject.specs()) == 4
    assert not faultinject.enabled()
    assert faultinject.lane_faults(None, 0) == (None, None)


def _synthetic(fixable_at):
    """A solver whose lane i is fixed from rung ``fixable_at[i]`` on."""
    calls = []

    def solve(idx, step, level):
        calls.append((step.name, idx.tolist()))
        ok = np.array([0 <= fixable_at.get(i, -1) <= level for i in idx])
        return {"status": np.where(ok, 0, int(SolveStatus.NEWTON_STALL)),
                "times": np.where(ok, 100.0 + idx, np.nan)}
    return solve, calls


def test_run_rescue_merges_fixed_lanes_and_stops(monkeypatch):
    monkeypatch.delenv("PYCHEMKIN_RESCUE", raising=False)
    monkeypatch.delenv("PYCHEMKIN_RESCUE_MAX_ATTEMPTS", raising=False)
    status = np.array([0, 2, 6, 0, 4])
    times = np.array([1.0, np.nan, np.nan, 4.0, np.nan])
    solve, calls = _synthetic({1: 1, 2: -1, 4: 2})
    res = {"status": status.copy(), "times": times.copy()}
    rep = rescue.run_rescue(solve, res)
    assert calls == [("tight_rtol", [1, 2, 4]), ("small_h0", [2, 4]),
                     ("f64_jac", [2]), ("pivoted_lu", [2])]
    assert res["times"][[0, 3]].tolist() == [1.0, 4.0]     # untouched
    assert res["times"][1] == 101.0 and res["times"][4] == 104.0
    assert np.isnan(res["times"][2])
    assert res["status"].tolist() == [0, 0, 2, 0, 0]
    assert (rep.n_failed, rep.n_rescued, rep.n_abandoned) == (3, 2, 1)
    assert [(a["n_tried"], a["n_fixed"]) for a in rep.attempts] == [
        (3, 1), (2, 1), (1, 0), (1, 0)]
    assert rep.status_counts == {"OK": 4, "NEWTON_STALL": 1}
    # every lane fixed at rung 1: the ladder stops there
    solve, calls = _synthetic({1: 1, 2: 1, 4: 1})
    rep = rescue.run_rescue(solve, {"status": status.copy(),
                                    "times": times.copy()})
    assert len(calls) == 1 and rep.n_abandoned == 0
    # off by the env knob, and capped by it
    monkeypatch.setenv("PYCHEMKIN_RESCUE", "0")
    solve, calls = _synthetic({1: 1})
    rep = rescue.run_rescue(solve, {"status": status.copy(),
                                    "times": times.copy()})
    assert not calls and rep.n_abandoned == 3 and rep.attempts == []
    monkeypatch.setenv("PYCHEMKIN_RESCUE", "1")
    monkeypatch.setenv("PYCHEMKIN_RESCUE_MAX_ATTEMPTS", "2")
    solve, calls = _synthetic({2: 4})
    rescue.run_rescue(solve, {"status": status.copy(), "times": times.copy()})
    assert [c[0] for c in calls] == ["tight_rtol", "small_h0"]
    monkeypatch.setenv("PYCHEMKIN_RESCUE_MAX_ATTEMPTS", "x")
    with pytest.raises(ValueError, match="integer"):
        rescue.run_rescue(solve, {"status": status.copy(),
                                  "times": times.copy()})


def _inputs(rec, n=8):
    return (np.linspace(1500.0, 1850.0, n), np.full(n, P_ATM),
            np.tile(stoich_h2_air(rec.species_names, rec.wt), (n, 1)),
            np.full(n, 3e-5))


@pytest.fixture(scope="module")
def h2o2():
    return jmech.load_embedded("h2o2"), tmech.load_embedded("h2o2")


SPECS = (("newton_stall", (1,), 0.0, 1), ("nan_rhs", (3,), 1e-6, 2),
         ("newton_stall", (5,), 0.0, 4), ("nan_rhs", (6,), 0.0, -1))


def test_resilient_sweep_matches_jax(h2o2, monkeypatch):
    monkeypatch.delenv("PYCHEMKIN_FAULTS", raising=False)
    monkeypatch.delenv("PYCHEMKIN_RESCUE", raising=False)
    monkeypatch.delenv("PYCHEMKIN_RESCUE_MAX_ATTEMPTS", raising=False)
    jm, rec = h2o2
    args = _inputs(rec)
    with jfi.inject(*(jfi.FaultSpec(*s) for s in SPECS)):
        tj, okj, stj, repj = jrescue.resilient_ignition_sweep(
            jm, "CONP", "ENRG", *args)
    with faultinject.inject(*(faultinject.FaultSpec(*s) for s in SPECS)):
        t, ok, st, rep = rescue.resilient_ignition_sweep(
            rec, "CONP", "ENRG", *args, device="cpu")
    np.testing.assert_array_equal(st.numpy(), np.asarray(stj))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert st.tolist()[6] == int(SolveStatus.NONFINITE)
    assert (st.numpy() == 0).sum() == 7
    tj = np.asarray(tj)
    np.testing.assert_array_equal(np.isnan(t.numpy()), np.isnan(tj))
    fin = np.isfinite(tj)
    assert np.all(np.abs(t.numpy()[fin] - tj[fin]) <= RTOL * tj[fin])

    def strip(d):
        d = dict(d)
        d["attempts"] = [{k: v for k, v in a.items() if k != "wall_s"}
                         for a in d["attempts"]]
        return d
    assert strip(rep.as_dict()) == strip(repj.as_dict())
    assert [(a["n_tried"], a["n_fixed"]) for a in rep.attempts] == [
        (4, 1), (3, 1), (2, 0), (2, 1)]
    assert rep.n_elements == 8


def _counts(prof):
    return {k: np.asarray(prof[k]) for k in ("n_steps", "n_rejected",
                                             "n_newton")}


@pytest.mark.parametrize("knob", ["pivoted_lu", "h0"])
def test_sweep_knobs_match_jax(h2o2, knob):
    jm, rec = h2o2
    args = _inputs(rec)
    if knob == "pivoted_lu":
        with jlinalg.forced_pivoted():
            want = jre.ignition_delay_sweep(jm, "CONP", "ENRG", *args,
                                            pivoted_lu=True, profile=True)
        with linalg.forced_pivoted():
            assert linalg.pivoted_forced()
            also = reactors.ignition_delay_sweep(rec, "CONP", "ENRG", *args,
                                                 device="cpu", profile=True)
        assert not linalg.pivoted_forced()
        got = reactors.ignition_delay_sweep(rec, "CONP", "ENRG", *args,
                                            pivoted_lu=True, device="cpu",
                                            profile=True)
        for a, b in zip(got[:3], also[:3]):
            assert torch.equal(a.nan_to_num(7.0) if a.is_floating_point()
                               else a, b.nan_to_num(7.0)
                               if b.is_floating_point() else b)
    else:
        want = jre.ignition_delay_sweep(jm, "CONP", "ENRG", *args, h0=1e-9,
                                        profile=True)
        got = reactors.ignition_delay_sweep(rec, "CONP", "ENRG", *args,
                                            h0=1e-9, device="cpu",
                                            profile=True)
        assert (got[3]["n_steps"] > 0).all()
    t, ok, st, prof = got
    tj, okj, stj, profj = (np.asarray(x) if not isinstance(x, dict) else x
                           for x in want)
    np.testing.assert_array_equal(st.numpy(), stj)
    assert (st.numpy() == int(SolveStatus.OK)).all()
    for k, v in _counts(profj).items():
        np.testing.assert_array_equal(prof[k].numpy(), v, err_msg=k)
    assert np.all(np.abs(t.numpy() - tj) <= RTOL * tj)


def test_unported_jacobian_mode_raises(h2o2):
    """``jac_mode="ad"``, which this test once expected to raise, now runs
    the reference's other Jacobian path (forward-mode AD of the twin RHS
    in the host-driven loop): its J equals the closed form within 1e-10
    of the lane's fastest rate, and its sweep gives the analytic sweep's
    status and ignition times within rtol. An unknown mode or ignition
    kwarg still raises."""
    _, rec = h2o2
    args = _inputs(rec, 2)
    tm = tmech.TorchMechanism(rec, "cpu")
    y = torch.cat([torch.tensor(args[2]), torch.tensor(args[0])[:, None]], 1)
    P = torch.tensor(args[1])
    for code in ("CONP", "CONV_TGIV"):
        J_ad = reactors.jacfwd_jacobian(code, tm, y, P, torch.zeros(2))
        _, J = reactors.RHS_TWINS[code][1](tm, y, P)
        scale = J.abs().amax((1, 2), keepdim=True)
        assert float(((J_ad - J).abs() / scale).max()) <= 1e-10, code
    # a short horizon (the AD Jacobian costs N forward passes a step)
    short = (args[0], args[1], args[2], np.full(2, 3e-6))
    kw = dict(ignition_kwargs={"min_slope": -1e30}, device="cpu")
    t_ad, ok_ad, st_ad = reactors.ignition_delay_sweep(
        rec, "CONP", "ENRG", *short, jac_mode="ad", **kw)
    t_an, ok_an, st_an = reactors.ignition_delay_sweep(
        rec, "CONP", "ENRG", *short, **kw)
    np.testing.assert_array_equal(st_ad.numpy(), st_an.numpy())
    assert ok_ad.all() and np.isfinite(t_ad.numpy()).all()
    np.testing.assert_allclose(t_ad.numpy(), t_an.numpy(), rtol=RTOL, atol=0)
    with pytest.raises(ValueError, match="jac_mode"):
        reactors.ignition_delay_sweep(rec, "CONP", "ENRG", *args,
                                      jac_mode="fd", device="cpu")
    with pytest.raises(TypeError, match="ignition kwarg"):
        reactors.ignition_delay_sweep(rec, "CONP", "ENRG", *args,
                                      ignition_kwargs={"T_lim": 1.0},
                                      device="cpu")
