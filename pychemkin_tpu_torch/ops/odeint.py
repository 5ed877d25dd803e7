"""SDIRK3 stiff integration over [B] lanes as masked PyTorch code around
the kernels K1-K4: the plain twin of the step-round kernel K5.

Counterpart of the JAX package's ``ops/odeint.py``: the same tableau
(Alexander's 3-stage L-stable SDIRK, with its order conditions asserted
at import), the same modified-Newton stage loop, error filter, step
controller, event accumulators and status codes. Where the reference
runs one lane per ``vmap`` element inside ``lax.while_loop``, this
module runs the batch in Python loops:

- every step attempt works on the lanes whose loop condition holds
  (gathered into a compact batch when some lanes are done), and a lane
  that has finished or stalled is left exactly as it was;
- each stage's Newton loop iterates until every lane of the batch has
  converged, diverged or used its 8 iterations, and only lanes still
  iterating are updated (one host sync per iteration for the ``any``).

The attempt calls ``ops.rhs_jac`` once (kernel K2), ``ops.factor`` once
(K3), ``ops.rhs`` once per Newton iteration (K1) and ``ops.solve`` once
per Newton iteration plus once for the error filter (K4), each RHS at
its time (the Jacobian at the step's start t, the stages at t + c_s h),
which profiles read. ``ops`` is either the kernel wrappers or the plain
twins. On the card the sweep runs :func:`sweep_round` as one kernel
instead (``kernels.sdirk_round``, K5), and this loop over the plain twins
is that kernel's reference.

:func:`odeint` is the reference's output-grid integrator: the segments
between the times ``ts`` [B, n_out], each advanced until no lane is
active (in rounds of K5 on the card), the solution stored at each time,
with the reference's per-segment budget and status
(:class:`ODESolution`, :func:`solution_stats`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import knobs, telemetry
from ..resilience.faultinject import FAULT_NAN, FAULT_STALL
from ..resilience.status import SolveStatus, status_counts

#: the switch of the per-lane solve profile (see :func:`solve_profile_enabled`)
SOLVE_PROFILE_ENV = "PYCHEMKIN_SOLVE_PROFILE"


def solve_profile_enabled() -> bool:
    """Whether the serve engines and the scheduled sweep harvest the
    per-lane solve profile (attempts, Newton iterations, dt_min,
    dt_final, and the Gershgorin stiffness at the final state). Read per
    call; the primal results are bit-identical either way."""
    return bool(knobs.value(SOLVE_PROFILE_ENV))


def gershgorin_rate(J):
    """Gershgorin bound of the spectral radius of Jacobians ``J``
    [..., N, N]: the largest row sum of |J| [...], the fastest local
    timescale's rate in 1/s (the scheduler's cost predictor reads it at
    t = 0, the solve profile at the final state). A NaN entry gives NaN,
    as the reference's ``jnp.max`` does. The plain twin of kernel K8."""
    return J.abs().sum(-1).amax(-1)

# ---------------------------------------------------------------------------
# SDIRK3 (Alexander 1977): gamma is the root of
#   g^3 - 3 g^2 + (3/2) g - 1/6 = 0  in (1/6, 1/2)  -> L-stable.
_GAMMA = 0.435866521508458999416019
_C2 = (1.0 + _GAMMA) / 2.0
_A21 = _C2 - _GAMMA
_B1 = -(6.0 * _GAMMA**2 - 16.0 * _GAMMA + 1.0) / 4.0
_B2 = (6.0 * _GAMMA**2 - 20.0 * _GAMMA + 5.0) / 4.0
_B3 = _GAMMA

_A = np.array([
    [_GAMMA, 0.0, 0.0],
    [_A21, _GAMMA, 0.0],
    [_B1, _B2, _B3],      # stiffly accurate: last row = b
])
_B = np.array([_B1, _B2, _B3])
_C = np.array([_GAMMA, _C2, 1.0])
# embedded 2nd-order weights: sum(bh) = 1, sum(bh c) = 1/2 with bh[2] = 0
_BH1 = (0.5 - _C[0]) / (_C[1] - _C[0])
_BHAT = np.array([1.0 - _BH1, _BH1, 0.0])
_ERR_W = _B - _BHAT
_ORDER = 3

assert abs(_GAMMA**3 - 3 * _GAMMA**2 + 1.5 * _GAMMA - 1.0 / 6.0) < 1e-12
assert abs(_B.sum() - 1.0) < 1e-12
assert abs((_B * _C).sum() - 0.5) < 1e-12
assert abs((_B * _C**2).sum() - 1.0 / 3.0) < 1e-12
assert abs((_B @ _A @ _C) - 1.0 / 6.0) < 1e-12
assert abs(_BHAT.sum() - 1.0) < 1e-12
assert abs((_BHAT * _C).sum() - 0.5) < 1e-12

_NEWTON_MAX = 8
_NEWTON_TOL = 0.03     # in the step-error weight norm
_MIN_FACTOR = 0.2
_MAX_FACTOR = 5.0
_SAFETY = 0.9
_MAX_CONSECUTIVE_REJECTS = 30
DT_MIN_REL = 5e-14


class Event(NamedTuple):
    """An event tracked inside the step loop: ``fn(t, y, f, lanes) -> [B]``
    with ``kind`` "max" (running maximum, refined by a quadratic through
    in-step samples) or "crossing" (first upward zero crossing)."""
    fn: Callable
    kind: str = "max"


class Lanes(NamedTuple):
    """Per-lane constants of a sweep: the constraint value [B] (pressure
    in dyne/cm^2 for CONP, density in g/cm^3 for CONV; or, for
    ``solve_batch``'s reactors, an ``ops.reactors.BatchArgs`` of profiles
    whose tensors are all [B]-leading), absolute tolerances [B, N], end
    time [B] and the event threshold [B]; with fault injection on, the
    fault bits [B] int32 (FAULT_NAN, FAULT_STALL) and the nan_rhs start
    time [B] (None when no fault is active)."""
    constraint: Any
    atol: Any
    t_end: Any
    thresh: Any
    fault: Any = None
    fault_t: Any = None


class StepState(NamedTuple):
    """Carried integrator state, one row per lane."""
    t: Any
    y: Any
    f: Any          # rhs at (t, y)
    h: Any          # controller step
    n_steps: Any
    n_rejected: Any
    n_newton: Any   # Newton iterations over all stage solves
    consec_rej: Any
    acc_t: Any      # [B, n_events]
    acc_v: Any
    stalled: Any
    status: Any     # SolveStatus code, set once on the first failure
    dt_min: Any     # smallest accepted step


class Ops(NamedTuple):
    """The four kernel functions the integrator calls, and the stiffness
    rate a solve profile samples at the final state; ``t`` [B] is the
    time of each lane's state (read by profiles)."""
    rhs: Callable          # (tm, y, constraint, t) -> f
    rhs_jac: Callable      # (tm, y, constraint, t) -> (f, J)
    factor: Callable       # (J, hg) -> factor
    solve: Callable        # (factor, r) -> x
    stiffness: Callable    # (tm, y, constraint, t) -> Gershgorin rate [B]


def _norm(x, w):
    return torch.sqrt(torch.mean((x / w) ** 2, dim=-1))


def initial_step(f0, y0, atol, rtol, t_span, h0=0.0):
    """Starting-step heuristic of the reference (scipy-style, simplified),
    or the explicit ``h0`` > 0 on every lane."""
    if h0 > 0:
        return torch.full_like(t_span, float(h0))
    w = atol + rtol * torch.abs(y0)
    d0 = _norm(y0, w)
    d1 = _norm(f0, w)
    h = 0.01 * d0 / torch.clamp(d1, min=1e-30)
    h = torch.where((d0 < 1e-6) | (d1 < 1e-6), 1e-8 * t_span, h)
    return torch.minimum(torch.maximum(h, 1e-12 * t_span), 0.1 * t_span)


def poison(lanes, t, f):
    """``f`` with the rows of the lanes whose ``nan_rhs`` fault is on at
    time ``t`` [B] set to NaN (the reference's fault-wrapped RHS)."""
    if lanes.fault is None:
        return f
    bad = ((lanes.fault & FAULT_NAN) != 0) & (t >= lanes.fault_t)
    return torch.where(bad[:, None], torch.full_like(f, float("nan")), f)


def _newton_stage(ops, tm, lanes, t_stage, y_base, z0, h, fac, w):
    """Solve z = h f(t_stage, y_base + gamma z) per lane by modified Newton
    with the factored M. Returns (z, converged, n_iters, diverged)."""
    B = z0.shape[0]
    dev = z0.device
    z = z0
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(B, dtype=torch.bool, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    prev_dn = torch.full((B,), float("inf"), dtype=z0.dtype, device=dev)
    run = torch.ones(B, dtype=torch.bool, device=dev)
    while bool(run.any()):
        g = z - h[:, None] * poison(lanes, t_stage, ops.rhs(
            tm, y_base + _GAMMA * z, lanes.constraint, t_stage))
        dz = ops.solve(fac, -g)
        dn = _norm(dz, w)
        dn = torch.where(torch.isfinite(dn), dn,
                         torch.full_like(dn, float("inf")))
        div_new = (it > 0) & (dn > 2.0 * prev_dn)
        conv_new = dn < _NEWTON_TOL
        z = torch.where(run[:, None], z + dz, z)
        converged = torch.where(run, conv_new, converged)
        diverged = torch.where(run, div_new, diverged)
        prev_dn = torch.where(run, dn, prev_dn)
        it = it + run.to(it.dtype)
        run = ~converged & ~diverged & (it < _NEWTON_MAX)
    return z, converged, it, diverged


def _quad_peak(t0, t1, t2, g0, g1, g2):
    """Maximum of the quadratic through three (t, g) samples among
    {vertex, endpoints}, per lane."""
    s1 = t1 - t0
    s2 = t2 - t0
    denom = s1 * s2 * (s2 - s1)
    denom = torch.where(torch.abs(denom) > 0, denom, torch.ones_like(denom))
    a = (s1 * (g2 - g0) - s2 * (g1 - g0)) / denom
    b = (s2 * s2 * (g1 - g0) - s1 * s1 * (g2 - g0)) / denom
    s_v = torch.where(torch.abs(a) > 0,
                      -b / torch.where(a == 0, torch.ones_like(a), 2.0 * a),
                      torch.zeros_like(a))
    s_v = torch.minimum(torch.maximum(s_v, torch.zeros_like(s_v)), s2)
    g_v = a * s_v * s_v + b * s_v + g0
    cand_t = torch.stack([t0 + s_v, t0, t2], dim=-1)
    cand_g = torch.stack([torch.where(a < 0.0, g_v,
                                      torch.full_like(g_v, -float("inf"))),
                          g0, g2], dim=-1)
    i = torch.argmax(cand_g, dim=-1, keepdim=True)
    return cand_t.gather(-1, i)[:, 0], cand_g.gather(-1, i)[:, 0]


def _update_events(events, lanes, acc_t, acc_v, samples, active):
    """Event accumulators over an accepted step; ``samples`` are
    (t, y, f) at the step start, the two inner stages and the step end."""
    if not events:
        return acc_t, acc_v
    new_t, new_v = [], []
    ts = [s[0] for s in samples]
    for i, ev in enumerate(events):
        g = [ev.fn(t, y, f, lanes) for (t, y, f) in samples]
        if ev.kind == "max":
            tp, vp = _quad_peak(ts[0], ts[2], ts[3], g[0], g[2], g[3])
            better = active & (vp > acc_v[:, i])
            new_t.append(torch.where(better, tp, acc_t[:, i]))
            new_v.append(torch.where(better, vp, acc_v[:, i]))
        elif ev.kind == "crossing":
            not_yet = ~torch.isfinite(acc_t[:, i])
            best_t = acc_t[:, i]
            best_v = acc_v[:, i]
            found = torch.zeros_like(active)
            for j in range(len(samples) - 1):
                g0, g1 = g[j], g[j + 1]
                t0, t1 = ts[j], ts[j + 1]
                crossed = active & not_yet & ~found & (g0 <= 0.0) & (g1 > 0.0)
                dg = g1 - g0
                frac = -g0 / torch.where(dg == 0, torch.ones_like(dg), dg)
                tc = t0 + torch.clamp(frac, 0.0, 1.0) * (t1 - t0)
                slope = dg / torch.clamp(t1 - t0, min=1e-300)
                best_t = torch.where(crossed, tc, best_t)
                best_v = torch.where(crossed, slope, best_v)
                found = found | crossed
            new_t.append(best_t)
            new_v.append(best_v)
        else:
            raise ValueError(f"unknown event kind {ev.kind!r}")
    return torch.stack(new_t, dim=-1), torch.stack(new_v, dim=-1)


def attempt(ops, tm, lanes, events, rtol, s: StepState) -> StepState:
    """One SDIRK3 step attempt for every lane of ``s`` (the body of the
    reference's step loop)."""
    t_end = lanes.t_end
    dt_min = DT_MIN_REL * torch.clamp(torch.abs(t_end), min=1e-30)
    active = s.t < t_end
    remaining = torch.maximum(t_end - s.t, dt_min)
    h = torch.minimum(torch.maximum(s.h, dt_min), remaining)
    clipped = s.h > remaining

    _, J = ops.rhs_jac(tm, s.y, lanes.constraint, s.t)
    fac = ops.factor(J, h * _GAMMA)
    w = lanes.atol + rtol * torch.abs(s.y)
    hc = h[:, None]

    z1, ok1, it1, dv1 = _newton_stage(ops, tm, lanes, s.t + _C[0] * h, s.y,
                                      hc * s.f, h, fac, w)
    y_base2 = s.y + _A21 * z1
    z2, ok2, it2, dv2 = _newton_stage(ops, tm, lanes, s.t + _C[1] * h,
                                      y_base2, z1, h, fac, w)
    y_base3 = s.y + _B1 * z1 + _B2 * z2
    z3, ok3, it3, dv3 = _newton_stage(ops, tm, lanes, s.t + h, y_base3, z2,
                                      h, fac, w)
    newton_ok = ok1 & ok2 & ok3
    if lanes.fault is not None:
        newton_ok = newton_ok & ((lanes.fault & FAULT_STALL) == 0)
    newton_diverged = dv1 | dv2 | dv3

    y_new = y_base3 + _B3 * z3
    e_raw = _ERR_W[0] * z1 + _ERR_W[1] * z2 + _ERR_W[2] * z3
    e = ops.solve(fac, e_raw)
    w_new = lanes.atol + rtol * torch.maximum(torch.abs(s.y),
                                              torch.abs(y_new))
    err = _norm(e, w_new)
    finite = torch.isfinite(y_new).all(dim=-1) & torch.isfinite(err)
    accept = active & newton_ok & finite & (err <= 1.0)

    err_safe = torch.clamp(err, min=1e-10)
    fac_h = _SAFETY * err_safe ** (-1.0 / _ORDER)
    fac_h = torch.where(newton_ok & finite,
                        torch.clamp(fac_h, _MIN_FACTOR, _MAX_FACTOR),
                        torch.full_like(fac_h, 0.25))
    h_next = torch.maximum(h * fac_h, dt_min)
    h_next = torch.where(accept & clipped, torch.maximum(h_next, s.h),
                         h_next)

    h_safe = torch.clamp(h, min=1e-300)[:, None]
    samples = [
        (s.t, s.y, s.f),
        (s.t + _C[0] * h, s.y + _GAMMA * z1, z1 / h_safe),
        (s.t + _C[1] * h, y_base2 + _GAMMA * z2, z2 / h_safe),
        (s.t + h, y_new, z3 / h_safe),
    ]
    acc_t, acc_v = _update_events(events, lanes, s.acc_t, s.acc_v, samples,
                                  accept)

    zero = torch.zeros_like(s.consec_rej)
    consec = torch.where(accept, zero,
                         torch.where(active, s.consec_rej + 1, s.consec_rej))
    stalled = active & (consec >= _MAX_CONSECUTIVE_REJECTS)
    fail_code = torch.where(
        ~finite, int(SolveStatus.NONFINITE),
        torch.where(newton_diverged, int(SolveStatus.NEWTON_DIVERGED),
                    int(SolveStatus.NEWTON_STALL))).to(s.status.dtype)
    status = torch.where(stalled & (s.status == int(SolveStatus.OK)),
                         fail_code, s.status)
    acc2 = accept[:, None]
    return StepState(
        t=torch.where(accept, s.t + h, s.t),
        y=torch.where(acc2, y_new, s.y),
        f=torch.where(acc2, z3 / h_safe, s.f),
        h=torch.where(active, h_next, s.h),
        n_steps=s.n_steps + accept.to(s.n_steps.dtype),
        n_rejected=s.n_rejected + (active & ~accept).to(s.n_steps.dtype),
        n_newton=s.n_newton + torch.where(active, it1 + it2 + it3,
                                          torch.zeros_like(it1)),
        consec_rej=consec,
        acc_t=acc_t, acc_v=acc_v,
        stalled=s.stalled | stalled,
        status=status,
        dt_min=torch.where(accept, torch.minimum(s.dt_min, h), s.dt_min),
    )


def sweep_start(ops, tm, lanes, y0, rtol, events, h0=0.0,
                t0=None) -> StepState:
    """Initial state of an integration of [t0, t_end] per lane (t0 [B],
    default 0): initial RHS, starting step (``h0`` > 0: that step), event
    accumulators ("max" events start at NaN/-inf, "crossing" events at
    +inf/-inf)."""
    B = y0.shape[0]
    dev, dt = y0.device, y0.dtype
    if t0 is None:
        t0 = torch.zeros(B, dtype=dt, device=dev)
    t_span = torch.clamp(lanes.t_end - t0, min=1e-30)
    f0 = poison(lanes, t0, ops.rhs(tm, y0, lanes.constraint, t0))
    h_init = initial_step(f0, y0, lanes.atol, rtol, t_span, h0)
    n_ev = max(len(events), 1)
    acc_t0 = torch.tensor([float("inf") if ev.kind == "crossing"
                           else float("nan") for ev in events]
                          or [float("nan")], dtype=dt, device=dev)
    zi = torch.zeros(B, dtype=torch.int64, device=dev)
    return StepState(
        t=t0, y=y0, f=f0, h=h_init, n_steps=zi, n_rejected=zi.clone(),
        n_newton=zi.clone(), consec_rej=zi.clone(),
        acc_t=acc_t0.expand(B, n_ev).clone(),
        acc_v=torch.full((B, n_ev), -float("inf"), dtype=dt, device=dev),
        stalled=torch.zeros(B, dtype=torch.bool, device=dev),
        status=torch.full((B,), int(SolveStatus.OK), dtype=torch.int32,
                          device=dev),
        dt_min=torch.full((B,), float("inf"), dtype=dt, device=dev))


def _take(tree, idx):
    """The rows ``idx`` of every tensor of a (nested) NamedTuple."""
    return type(tree)(*[None if x is None else
                        (_take(x, idx) if isinstance(x, tuple)
                         else x.index_select(0, idx)) for x in tree])


def _put(tree, idx, sub):
    return type(tree)(*[x.index_copy(0, idx, s) for x, s in zip(tree, sub)])


def sweep_going(state: StepState, lanes, budget):
    """[B] lanes still stepping: short of t_end, not stalled, and under
    ``budget`` attempts (the reference's loop condition)."""
    return ((state.t < lanes.t_end) & ~state.stalled
            & (state.n_steps + state.n_rejected < budget))


def sweep_round(ops, tm, lanes, events, rtol, budget, state: StepState,
                max_attempts: int | None = None) -> StepState:
    """Step every lane until it reaches t_end, stalls or uses ``budget``
    attempts, or until ``max_attempts`` attempts have been made per lane.
    Each attempt runs on the lanes still going, gathered into a compact
    batch when some lanes are done."""
    B = state.t.shape[0]
    k = 0
    while max_attempts is None or k < max_attempts:
        go = sweep_going(state, lanes, budget)
        idx = torch.nonzero(go).flatten()
        n = idx.numel()
        if n == 0:
            break
        if n == B:
            state = attempt(ops, tm, lanes, events, rtol, state)
        else:
            sub = attempt(ops, tm, _take(lanes, idx), events, rtol,
                          _take(state, idx))
            state = _put(state, idx, sub)
        k += 1
    return state


def _fail_short(state: StepState, t_end) -> StepState:
    """Lanes short of ``t_end`` are failed: BUDGET_EXHAUSTED unless their
    status already says why, and stalled."""
    short = state.t < t_end
    return state._replace(
        status=torch.where(short & (state.status == int(SolveStatus.OK)),
                           torch.full_like(state.status,
                                           int(SolveStatus.BUDGET_EXHAUSTED)),
                           state.status),
        stalled=state.stalled | short)


def _finish(state: StepState, t_end, t_span, events):
    """(event_times, success) of a finished solve: a crossing never reached
    is NaN, and a lane succeeded if it did not stall and reached
    ``t_end - 1e-12 t_span``."""
    ev_t = state.acc_t
    if events:
        is_cross = torch.tensor([ev.kind == "crossing" for ev in events],
                                device=ev_t.device)
        ev_t = torch.where(is_cross[None] & ~torch.isfinite(ev_t),
                           torch.full_like(ev_t, float("nan")), ev_t)
    t_span = torch.clamp(t_span, min=1e-30)
    return ev_t, ~state.stalled & (state.t >= t_end - 1e-12 * t_span)


def sweep_finalize(state: StepState, t_end, events):
    """Terminal classification of each lane: (event_times, event_values,
    success, status) [B, n_ev], [B, n_ev], [B], [B]."""
    state = _fail_short(state, t_end)
    ev_t, success = _finish(state, t_end, t_end, events)
    return ev_t, state.acc_v, success, state.status


# ---------------------------------------------------------------------------
# The output grid: the reference's ``odeint`` (ops/odeint.py:603) with its
# ``_solve_segment`` (:581) per output interval.

class ODESolution(NamedTuple):
    """The solution of :func:`odeint`, every field [B]-leading: the output
    times ``ts`` [B, n_out] and the state there ``ys`` [B, n_out, N], the
    event accumulators [B, n_events], the counters, ``success`` (reached
    the last time without stalling), the time at exit, the stall flag,
    the SolveStatus codes and the profile extras (smallest accepted step,
    controller step at exit)."""
    ts: Any
    ys: Any
    event_times: Any
    event_values: Any
    n_steps: Any
    n_rejected: Any
    success: Any
    t_final: Any = None
    stalled: Any = None
    n_newton: Any = None
    status: Any = None
    dt_min: Any = None
    dt_final: Any = None


def odeint(ops, tm, lanes, y0, ts, events, *, rtol, max_steps_per_segment,
           h0=0.0, rounds=None) -> ODESolution:
    """Integrate every lane from ``ts[:, 0]`` through ``ts[:, -1]`` and
    return the state at each of its output times ``ts`` [B, n_out]
    (strictly increasing per lane): the reference's output-grid
    integrator over [B] lanes.

    Segment k sets the lanes' t_end to ``ts[:, k]`` and each lane's
    attempt budget to its attempts so far plus ``max_steps_per_segment``,
    and steps until no lane is active: with ``rounds`` (a callable
    ``(lanes, state, budget) -> state`` making one round of attempts, K5
    on the card) with one host sync per round, else through the
    host-driven loop :func:`sweep_round` over ``ops``. A lane that ends a
    segment short of its time (budget exhausted or stalled) is failed
    from then on: BUDGET_EXHAUSTED unless it stalled, and it advances no
    further. The steps' time limit dt_min follows each segment's end,
    events carry across segments, and ``success`` is ``~stalled`` and
    ``t >= ts[:, -1] - 1e-12 (ts[:, -1] - ts[:, 0])``. ``ops.rhs`` gives
    the initial RHS (K1 on the card)."""
    B, n_out = ts.shape
    if n_out < 2:
        raise ValueError(f"odeint needs >= 2 output times, got {n_out}")
    if not bool((ts[:, 1:] > ts[:, :-1]).all()):
        raise ValueError("odeint output grid ts must be strictly increasing")
    t0, t_last = ts[:, 0].contiguous(), ts[:, -1].contiguous()
    state = sweep_start(ops, tm, lanes._replace(t_end=t_last), y0, rtol,
                        events, h0, t0=t0)
    # the state's y is y0 itself, which K5 advances in place
    ys = [y0.clone()]
    for k in range(1, n_out):
        lk = lanes._replace(t_end=ts[:, k].contiguous())
        budget = state.n_steps + state.n_rejected + int(max_steps_per_segment)
        if rounds is None:
            state = sweep_round(ops, tm, lk, events, rtol, budget, state)
        else:
            while bool(sweep_going(state, lk, budget).any()):
                state = rounds(lk, state, budget)
        state = _fail_short(state, lk.t_end)
        ys.append(state.y.clone())
    ev_t, success = _finish(state, t_last, t_last - t0, events)
    return ODESolution(
        ts=ts, ys=torch.stack(ys, dim=1), event_times=ev_t,
        event_values=state.acc_v, n_steps=state.n_steps,
        n_rejected=state.n_rejected, success=success, t_final=state.t,
        stalled=state.stalled, n_newton=state.n_newton, status=state.status,
        dt_min=state.dt_min, dt_final=state.h)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def solution_stats(sol, *, label: str = "", kind: str | None = None,
                   wall_s: float | None = None, recorder=None,
                   emit: bool = True) -> dict:
    """Host-side aggregate of one batched :class:`ODESolution` (or a
    ``BatchSolution`` of ``ops.reactors``, or a list or tuple of them, of
    mixed kinds) into one JSON-ready dict of per-solve counters, recorded
    as an ``odeint`` event on ``recorder`` (default: the process's
    recorder) with the reference's counters when ``emit``: ``n_elements``,
    ``n_steps``, ``n_rejected``, ``n_newton`` (None when no member tracks
    it; members that do not are counted in ``n_newton_untracked``),
    ``n_success``, ``n_stalled``, ``status_counts``, and with ``wall_s``
    the wall and steps per second."""
    if isinstance(sol, (list, tuple)) and not hasattr(sol, "n_steps"):
        sols = list(sol)
    else:
        sols = [sol]
    if not sols:
        raise ValueError("solution_stats needs at least one solution")
    n_elems = n_steps = n_rejected = n_success = n_newton = 0
    n_newton_untracked = n_stalled = 0
    newton_tracked = stalled_tracked = False
    status_arrays = []
    for s in sols:
        size = int(_host(s.n_steps).size)
        n_elems += size
        n_steps += int(_host(s.n_steps).sum())
        n_rejected += int(_host(s.n_rejected).sum())
        n_success += int(_host(s.success).sum())
        if s.n_newton is not None:
            newton_tracked = True
            n_newton += int(_host(s.n_newton).sum())
        else:
            n_newton_untracked += size
        if getattr(s, "stalled", None) is not None:
            stalled_tracked = True
            n_stalled += int(_host(s.stalled).sum())
        if s.status is not None:
            status_arrays.append(_host(s.status))
    stats = {
        "n_elements": n_elems,
        "n_steps": n_steps,
        "n_rejected": n_rejected,
        "n_newton": n_newton if newton_tracked else None,
        "n_newton_untracked": n_newton_untracked,
        "n_success": n_success,
        "n_stalled": n_stalled if stalled_tracked else None,
    }
    if kind is not None:
        stats["solve_kind"] = kind
    if status_arrays:
        stats["status_counts"] = status_counts(
            np.concatenate([a.reshape(-1) for a in status_arrays]))
    if wall_s is not None:
        stats["wall_s"] = round(float(wall_s), 6)
        if wall_s > 0:
            stats["steps_per_sec"] = round(stats["n_steps"] / wall_s, 2)
    if emit:
        rec = recorder if recorder is not None else telemetry.get_recorder()
        rec.event("odeint", label=label, **stats)
        rec.inc("odeint.solves")
        rec.inc("odeint.steps", stats["n_steps"])
        rec.inc("odeint.rejected", stats["n_rejected"])
        if newton_tracked:
            rec.inc("odeint.newton", n_newton)
            if kind is not None:
                rec.inc(f"odeint.newton.{kind}", n_newton)
        if n_newton_untracked:
            rec.inc("odeint.newton_untracked", n_newton_untracked)
        if stats["n_stalled"]:
            rec.inc("odeint.stalled", stats["n_stalled"])
        for name, n in (stats.get("status_counts") or {}).items():
            if name != "OK":
                rec.inc(f"odeint.status.{name}", n)
    return stats
