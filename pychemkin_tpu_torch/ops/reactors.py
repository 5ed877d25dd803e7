"""0-D adiabatic reactors at constant pressure or constant volume: the
CONP/ENRG and CONV/ENRG RHS (plain PyTorch twins of kernel K1) and the
batched ignition-delay sweep, the port's entry point.

Counterpart of the JAX package's ``ops/reactors.py``. The state of a
lane is y = [Y_1..Y_KK, T] (mass fractions, temperature); units are
CGS. The sweep integrates adiabatic reactors, each lane from its own
(T0, P0, Y0) to its own t_end, at the lane's constant pressure (CONP) or
at the constant density of its initial state (CONV).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import torch

from .. import kernels
from ..constants import R_GAS
from ..mechanism.record import (MechanismRecord, TorchMechanism,
                                canonical_device)
from . import jacobian, kinetics, linalg, thermo
from .jacobian import T_FLOOR
from .odeint import (Event, Lanes, Ops, sweep_finalize, sweep_going,
                     sweep_round, sweep_start)


class Profile(NamedTuple):
    """Piecewise-linear profile, flat outside its knots: x [n], y [n]."""
    x: Any
    y: Any


def constant_profile(value, device=None):
    v = torch.as_tensor(value, dtype=torch.float64, device=device)
    return Profile(x=torch.tensor([0.0, 1.0], dtype=torch.float64,
                                  device=device), y=torch.stack([v, v]))


def profile_value_slope(p: Profile, t):
    """Value and slope of the profile at times ``t`` [B] (slope 0 outside
    the knots)."""
    n = p.x.shape[0]
    i = torch.clamp(torch.searchsorted(p.x, t, right=True) - 1, 0, n - 2)
    x0, x1 = p.x[i], p.x[i + 1]
    y0, y1 = p.y[i], p.y[i + 1]
    dx = torch.clamp(x1 - x0, min=1e-300)
    slope = (y1 - y0) / dx
    inside = (t >= p.x[0]) & (t <= p.x[-1])
    val = torch.minimum(torch.maximum(y0 + slope * (t - x0),
                                      torch.minimum(y0, y1)),
                        torch.maximum(y0, y1))
    val = torch.where(t < p.x[0], p.y[0], torch.where(t > p.x[-1], p.y[-1],
                                                      val))
    return val, torch.where(inside, slope, torch.zeros_like(slope))


def conp_enrg_rhs(tm, y, P):
    """Adiabatic constant-pressure RHS with the energy equation:
    dY/dt = wdot W / rho, dT/dt = -sum_k h_k wdot_k / (rho cp).
    ``y`` [B, N], ``P`` [B] dyne/cm^2 -> [B, N]."""
    KK = tm.KK
    Y = y[:, :KK]
    T = torch.clamp(y[:, KK], min=T_FLOOR)
    rho = thermo.density(tm, T, P, Y)
    C = thermo.Y_to_C(tm, Y, rho)
    nasa = thermo.nasa7(tm, T)
    wdot = kinetics.net_production_rates(tm, T, C, nasa)
    dY = wdot * tm.wt / rho[:, None]
    cp = (Y * (nasa[0] * R_GAS / tm.wt)).sum(-1)
    h_molar = nasa[1] * (R_GAS * T)[:, None]
    dT = (-(h_molar * wdot).sum(-1) / rho) / cp
    return torch.cat([dY, dT[:, None]], dim=1)


def conv_enrg_rhs(tm, y, rho):
    """Adiabatic constant-volume RHS with the energy equation:
    dY/dt = wdot W / rho, dT/dt = -sum_k u_k wdot_k / (rho cv), with u_k
    the molar internal energies. ``rho`` [B] g/cm^3 is the lane's fixed
    density (unit volume, constant mass, so the reference's P dV/dt work
    term is zero); kinetics take no pressure, as in the reference."""
    KK = tm.KK
    Y = y[:, :KK]
    T = torch.clamp(y[:, KK], min=T_FLOOR)
    C = thermo.Y_to_C(tm, Y, rho)
    nasa = thermo.nasa7(tm, T)
    wdot = kinetics.net_production_rates(tm, T, C, nasa)
    dY = wdot * tm.wt / rho[:, None]
    cv = thermo.mixture_cv_mass(tm, T, Y, nasa)
    u_molar = thermo.u_RT(tm, T, nasa) * (R_GAS * T)[:, None]
    dT = (-(u_molar * wdot).sum(-1) / rho) / cv
    return torch.cat([dY, dT[:, None]], dim=1)


# ignition-delay definitions (reference set_ignition_delay modes)
IGN_T_INFLECTION = "T_inflection"
IGN_T_RISE = "T_rise"
#: T_rise threshold above T0 [K] (the reference's default rise)
T_RISE_DELTA = 400.0
#: a T_inflection peak dT/dt below this [K/s] is slow oxidation, not
#: ignition (the reference's default ``min_slope``)
MIN_SLOPE = 1e4


def ignition_events(mode):
    """Events for an ignition-delay definition: the max-dT/dt inflection
    point, or the first time T rises through the lane's threshold
    (T0 + T_RISE_DELTA)."""
    if mode == IGN_T_INFLECTION:
        return (Event(fn=lambda t, y, f, lanes: f[:, -1], kind="max"),)
    if mode == IGN_T_RISE:
        return (Event(fn=lambda t, y, f, lanes: y[:, -1] - lanes.thresh,
                      kind="crossing"),)
    raise ValueError(f"unsupported ignition-delay mode {mode!r}")


#: ``event_mode`` codes of kernel K5: the index of the ignition mode
IGNITION_MODES = (IGN_T_INFLECTION, IGN_T_RISE)

#: the ported (problem, energy) variants
PORTED = (("CONP", "ENRG"), ("CONV", "ENRG"))

#: plain twins of K1 and K2 by problem; the lane constraint value is the
#: pressure (CONP) or the density (CONV)
RHS_TWINS = {"CONP": (conp_enrg_rhs, jacobian.conp_enrg_rhs_jac),
             "CONV": (conv_enrg_rhs, jacobian.conv_enrg_rhs_jac)}

#: step attempts per launch of the step-round kernel K5 (the reference's
#: round_len): the sweep syncs with the host once per round
ROUND_ATTEMPTS = 512


def kernel_ops(problem) -> Ops:
    """The kernel wrappers K1-K4 for ``problem`` as integrator ops."""
    return Ops(rhs=partial(kernels.rhs, problem=problem),
               rhs_jac=partial(kernels.rhs_jac, problem=problem),
               factor=kernels.bordered_factor, solve=kernels.bordered_solve)


def plain_ops(problem) -> Ops:
    """The plain twins of K1-K4 for ``problem`` as integrator ops."""
    rhs, rhs_jac = RHS_TWINS[problem]
    return Ops(rhs=rhs, rhs_jac=rhs_jac, factor=linalg.factor_bordered,
               solve=linalg.solve_bordered)



def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller names a device; never falls back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        device = "cuda"
    return canonical_device(device)


def as_torch_mechanism(mech, device) -> TorchMechanism:
    if isinstance(mech, TorchMechanism):
        return mech if mech.device == device else mech.to(device)
    if isinstance(mech, MechanismRecord):
        return TorchMechanism(mech, device)
    raise TypeError(f"expected a MechanismRecord or TorchMechanism, got "
                    f"{type(mech).__name__}")


def broadcast_lanes(device, scalars, rows):
    """f64 tensors on ``device`` broadcast along one batch axis: each of
    ``scalars`` (name -> scalar or [B]) to [B], each of ``rows`` (name ->
    [KK] or [B, KK]) to [B, KK]. Returns (B, {name: tensor})."""
    f64 = dict(dtype=torch.float64, device=device)
    ts = {k: torch.as_tensor(v, **f64) for k, v in {**scalars,
                                                    **rows}.items()}
    sizes = [t.shape[0] for k, t in ts.items()
             if (t.ndim > 0 if k in scalars else t.ndim > 1)]
    B = max(sizes) if sizes else 1
    return B, {k: (t.expand(B) if k in scalars else t.expand(B, t.shape[-1]))
               .contiguous() for k, t in ts.items()}


def sweep_lane_args(tm, T0s, P0s, Y0s, t_ends, *, atol,
                    ignition_mode=IGN_T_INFLECTION, problem="CONP"):
    """(Lanes, y0) of a sweep: y0 = [Y0, T0], the constraint value (P0 for
    CONP; for CONV the initial density, the reference's mass of a unit
    volume), the T row's atol max(atol 1e6, 1e-8), and the T_rise
    threshold T0 + T_RISE_DELTA."""
    B = T0s.shape[0]
    if problem == "CONP":
        constraint = P0s
    elif problem == "CONV":
        constraint = thermo.density(tm, T0s, P0s, Y0s)
    else:
        raise ValueError(f"unknown problem {problem!r}")
    y0 = torch.cat([Y0s, T0s[:, None]], dim=1)
    atol_vec = torch.full((B, tm.N), atol, dtype=torch.float64,
                          device=tm.device)
    atol_vec[:, -1] = max(atol * 1e6, 1e-8)
    thresh = T0s + T_RISE_DELTA if ignition_mode == IGN_T_RISE else \
        torch.zeros_like(T0s)
    return Lanes(constraint=constraint, atol=atol_vec, t_end=t_ends,
                 thresh=thresh), y0


def _batch(T0s, P0s, Y0s, t_ends, device):
    f64 = dict(dtype=torch.float64, device=device)
    T0s, P0s, Y0s, t_ends = (torch.as_tensor(a, **f64)
                             for a in (T0s, P0s, Y0s, t_ends))
    sizes = [a.shape[0] for a in (T0s, P0s, t_ends) if a.ndim > 0]
    if Y0s.ndim > 1:
        sizes.append(Y0s.shape[0])
    B = max(sizes) if sizes else 1
    return (T0s.expand(B).contiguous(), P0s.expand(B).contiguous(),
            Y0s.expand(B, Y0s.shape[-1]).contiguous(),
            t_ends.expand(B).contiguous())


def ignition_delay_sweep(mech, problem, energy, T0s, P0s, Y0s, t_ends, *,
                         rtol=1e-6, atol=1e-12,
                         ignition_mode=IGN_T_INFLECTION,
                         max_steps_per_segment=20_000, device=None,
                         profile=False):
    """Batched ignition delays over [B] initial conditions, for
    ``(problem, energy)`` CONP/ENRG (constant pressure P0) or CONV/ENRG
    (constant volume at the initial density).

    Returns ``(times, ok, status)``, each [B] on the run's device:
    ignition times in s (NaN where not detected; for T_inflection a peak
    dT/dt below ``MIN_SLOPE`` K/s is no ignition), success flags and
    :class:`~pychemkin_tpu_torch.resilience.status.SolveStatus` codes.
    With ``profile=True`` a fourth element holds per-lane counters
    (``n_steps``, ``n_rejected``, ``n_newton``, ``dt_min``, ``dt_final``).

    Runs on ``cuda`` unless ``device`` names another device. On the card
    the initial RHS is kernel K1 and every step attempt runs inside
    kernel K5 (``kernels.sdirk_round``), launched in rounds of
    ``ROUND_ATTEMPTS`` attempts with one host sync per round; on the CPU
    the wrappers take their plain twins. Inputs broadcast along the
    leading batch axis; P0s in dyne/cm^2. Runs under
    ``torch.inference_mode`` (no autograd bookkeeping per operation).
    """
    return _sweep(None, mech, problem, energy, T0s, P0s, Y0s, t_ends,
                  rtol=rtol, atol=atol, ignition_mode=ignition_mode,
                  max_steps_per_segment=max_steps_per_segment,
                  device=device, profile=profile)


@torch.inference_mode()
def _sweep(ops, mech, problem, energy, T0s, P0s, Y0s, t_ends, *, rtol, atol,
           ignition_mode, max_steps_per_segment, device, profile):
    """:func:`ignition_delay_sweep` with its step attempts in rounds of
    kernel K5 (``ops`` None), or in the host-driven masked loop over
    ``ops`` (``kernel_ops(problem)``, the K1-K4 path a K5 check compares
    with, or ``plain_ops(problem)``, the reference run of a kernel
    check)."""
    if (problem, energy) not in PORTED:
        raise NotImplementedError(
            f"only CONP/ENRG and CONV/ENRG are ported, got "
            f"{(problem, energy)!r}")
    dev = resolve_device(device)
    tm = as_torch_mechanism(mech, dev)
    T0s, P0s, Y0s, t_ends = _batch(T0s, P0s, Y0s, t_ends, dev)
    events = ignition_events(ignition_mode)
    lanes, y0 = sweep_lane_args(tm, T0s, P0s, Y0s, t_ends, atol=atol,
                                ignition_mode=ignition_mode, problem=problem)
    budget = max_steps_per_segment
    if ops is None:
        state = sweep_start(kernel_ops(problem), tm, lanes, y0, rtol, events)
        mode = IGNITION_MODES.index(ignition_mode)
        while bool(sweep_going(state, lanes, budget).any()):
            state = kernels.sdirk_round(
                tm, lanes, state, rtol=rtol, budget=budget,
                max_attempts=ROUND_ATTEMPTS, event_mode=mode,
                problem=problem)
    else:
        state = sweep_start(ops, tm, lanes, y0, rtol, events)
        state = sweep_round(ops, tm, lanes, events, rtol, budget, state)
    ev_t, ev_v, ok, status = sweep_finalize(state, t_ends, events)
    times = ev_t[:, 0]
    if ignition_mode == IGN_T_INFLECTION:
        times = torch.where(ev_v[:, 0] >= MIN_SLOPE, times,
                            torch.full_like(times, float("nan")))
    if not profile:
        return times, ok, status
    return times, ok, status, {
        "n_steps": state.n_steps, "n_rejected": state.n_rejected,
        "n_newton": state.n_newton, "dt_min": state.dt_min,
        "dt_final": state.h}
