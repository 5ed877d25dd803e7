"""0-D reactors at constant pressure or constant volume, with the energy
equation (ENRG) or at a given temperature (TGIV): the four RHS (plain
PyTorch twins of kernel K1), the batched ignition-delay sweep and the
general batch integrator ``solve_batch``, the port's entry points.

Counterpart of the JAX package's ``ops/reactors.py``. The state of a
lane is y = [Y_1..Y_KK, T] (mass fractions, temperature); units are
CGS. The sweep integrates adiabatic reactors, each lane from its own
(T0, P0, Y0) to its own t_end, at the lane's constant pressure (CONP) or
at the constant density of its initial state (CONV). A TGIV lane's T
follows its profile, which in the sweep is constant at T0 as in the
reference: the state's T entry holds T0 (its rate is 0) and the RHS
reads it as the profile's value. Those are the RHS ``(tm, y, P)`` and
``(tm, y, rho)``.

``solve_batch`` runs the reference's reactors with piecewise-linear
profiles (:class:`BatchArgs`): P(t) (CONP) or V(t) (CONV), T(t) (TGIV),
and wall heat loss -qloss(t) + htc area(t) (tamb - T), with the solution
on an output grid. Its RHS are ``(tm, t, y, args)`` (``*_rhs_prf``; their
constant-profile special case is the sweep's RHS), on the card the PRF
instantiations of K1, K2 and K5.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import torch

from .. import kernels
from ..constants import R_GAS
from ..mechanism.record import (MechanismRecord, TorchMechanism,
                                canonical_device)
from ..resilience import faultinject
from . import jacobian, kinetics, linalg, thermo
from .jacobian import T_FLOOR
from .odeint import (Event, Lanes, ODESolution, Ops, StepState, _take,
                     gershgorin_rate, odeint, sweep_finalize, sweep_going,
                     sweep_round, sweep_start)


class Profile(NamedTuple):
    """Piecewise-linear profile, flat outside its knots: x and y [n] (one
    profile) or [B, n] (one per lane)."""
    x: Any
    y: Any


def constant_profile(value, device=None):
    """The profile of a constant ``value``: a scalar, or [B] (one per
    lane, y [B, 2])."""
    v = torch.as_tensor(value, dtype=torch.float64, device=device)
    return Profile(x=torch.tensor([0.0, 1.0], dtype=torch.float64,
                                  device=device),
                   y=torch.stack([v, v], dim=-1))


def _rows(a, i):
    """a[i] of a shared [n] row, or each lane's a[b, i_b] of [B, n] rows."""
    if a.ndim == 1:
        return a[i]
    return a.gather(1, i[:, None])[:, 0]


def profile_value_slope(p: Profile, t):
    """Value and slope of the profile at times ``t`` [B] (slope 0 outside
    the knots): the segment of searchsorted(x, t, side="right") - 1
    clipped to [0, n - 2], the value clipped to the segment's range."""
    n = p.x.shape[-1]
    if p.x.ndim == 1:
        pos = torch.searchsorted(p.x, t, right=True)
    else:
        pos = torch.searchsorted(p.x.contiguous(), t[:, None].contiguous(),
                                 right=True)[:, 0]
    i = torch.clamp(pos - 1, 0, n - 2)
    x0, x1 = _rows(p.x, i), _rows(p.x, i + 1)
    y0, y1 = _rows(p.y, i), _rows(p.y, i + 1)
    dx = torch.clamp(x1 - x0, min=1e-300)
    slope = (y1 - y0) / dx
    first_x, last_x = p.x[..., 0], p.x[..., -1]
    inside = (t >= first_x) & (t <= last_x)
    val = torch.minimum(torch.maximum(y0 + slope * (t - x0),
                                      torch.minimum(y0, y1)),
                        torch.maximum(y0, y1))
    val = torch.where(t < first_x, p.y[..., 0],
                      torch.where(t > last_x, p.y[..., -1], val))
    return val, torch.where(inside, slope, torch.zeros_like(slope))


class BatchArgs(NamedTuple):
    """Everything the profile RHS need besides (t, y), every tensor
    [B]-leading (a profile shared by the lanes is an expanded view):
    ``constraint`` the P(t) profile (CONP) or the V(t) profile (CONV),
    ``tprof`` T(t) (TGIV), ``qloss`` the heat-loss rate in erg/s, ``area``
    the heat-transfer area in cm^2, and per lane the (closed reactor's)
    gas ``mass`` in g, the wall coefficient ``htc`` in erg/(cm^2 K s) and
    the ambient ``tamb`` in K: Qdot = -qloss + htc area (tamb - T)."""
    constraint: Profile
    tprof: Profile
    qloss: Profile
    area: Profile
    mass: Any
    htc: Any
    tamb: Any


def _heat_rate(args, T, t):
    """The wall heat gain -qloss(t) + htc area(t) (tamb - T), erg/s, [B]."""
    ql, _ = profile_value_slope(args.qloss, t)
    ar, _ = profile_value_slope(args.area, t)
    return -ql + args.htc * ar * (args.tamb - T)


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
    wdot = kinetics.net_production_rates(tm, T, C, nasa, P)
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
    term is zero); kinetics take no pressure, as in the reference (PLOG
    rows read sum(C) R T)."""
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


def conp_tgiv_rhs(tm, y, P):
    """Constant-pressure RHS at the given temperature: dY/dt = wdot W /
    rho at the state's T entry (the profile's value), dT/dt = 0."""
    KK = tm.KK
    Y, T = y[:, :KK], y[:, KK]
    rho = thermo.density(tm, T, P, Y)
    C = thermo.Y_to_C(tm, Y, rho)
    wdot = kinetics.net_production_rates(tm, T, C, None, P)
    return torch.cat([wdot * tm.wt / rho[:, None],
                      torch.zeros_like(T)[:, None]], dim=1)


def conv_tgiv_rhs(tm, y, rho):
    """Constant-volume RHS at the given temperature and the fixed density
    ``rho``: dY/dt = wdot W / rho, dT/dt = 0 (PLOG rows read
    sum(C) R T)."""
    KK = tm.KK
    Y, T = y[:, :KK], y[:, KK]
    wdot = kinetics.net_production_rates(tm, T, thermo.Y_to_C(tm, Y, rho))
    return torch.cat([wdot * tm.wt / rho[:, None],
                      torch.zeros_like(T)[:, None]], dim=1)


def conp_enrg_rhs_prf(tm, t, y, args: BatchArgs):
    """Constant/given-pressure RHS with the energy equation and profiles:
    dT/dt = (Qdot/m + Pdot/rho - sum_k h_k wdot_k / rho) / cp, with P and
    Pdot of the P(t) profile at the lanes' times ``t`` [B]."""
    KK = tm.KK
    Y = y[:, :KK]
    T = torch.clamp(y[:, KK], min=T_FLOOR)
    P, Pdot = profile_value_slope(args.constraint, t)
    rho = thermo.density(tm, T, P, Y)
    C = thermo.Y_to_C(tm, Y, rho)
    nasa = thermo.nasa7(tm, T)
    wdot = kinetics.net_production_rates(tm, T, C, nasa, P)
    dY = wdot * tm.wt / rho[:, None]
    cp = (Y * (nasa[0] * R_GAS / tm.wt)).sum(-1)
    h_molar = nasa[1] * (R_GAS * T)[:, None]
    q = _heat_rate(args, T, t) / args.mass
    dT = (q + Pdot / rho - (h_molar * wdot).sum(-1) / rho) / cp
    return torch.cat([dY, dT[:, None]], dim=1)


def conv_enrg_rhs_prf(tm, t, y, args: BatchArgs):
    """Given-volume RHS with the energy equation and profiles:
    rho = mass / V(t), dT/dt = (Qdot/m - P Vdot/m - sum_k u_k wdot_k /
    rho) / cv with P = rho R T / Wbar; kinetics take no pressure (PLOG
    rows read sum(C) R T)."""
    KK = tm.KK
    Y = y[:, :KK]
    T = torch.clamp(y[:, KK], min=T_FLOOR)
    V, Vdot = profile_value_slope(args.constraint, t)
    rho = args.mass / V
    C = thermo.Y_to_C(tm, Y, rho)
    nasa = thermo.nasa7(tm, T)
    wdot = kinetics.net_production_rates(tm, T, C, nasa)
    dY = wdot * tm.wt / rho[:, None]
    P = thermo.pressure(tm, T, rho, Y)
    cv = thermo.mixture_cv_mass(tm, T, Y, nasa)
    u_molar = thermo.u_RT(tm, T, nasa) * (R_GAS * T)[:, None]
    q = _heat_rate(args, T, t) / args.mass
    dT = (q - P * Vdot / args.mass - (u_molar * wdot).sum(-1) / rho) / cv
    return torch.cat([dY, dT[:, None]], dim=1)


def conp_tgiv_rhs_prf(tm, t, y, args: BatchArgs):
    """Given pressure and temperature: the species at T(t) and P(t) of
    the profiles; the state's T entry integrates dT/dt of T(t), which the
    RHS does not read."""
    KK = tm.KK
    Y = y[:, :KK]
    T, Tdot = profile_value_slope(args.tprof, t)
    P, _ = profile_value_slope(args.constraint, t)
    rho = thermo.density(tm, T, P, Y)
    C = thermo.Y_to_C(tm, Y, rho)
    wdot = kinetics.net_production_rates(tm, T, C, None, P)
    return torch.cat([wdot * tm.wt / rho[:, None], Tdot[:, None]], dim=1)


def conv_tgiv_rhs_prf(tm, t, y, args: BatchArgs):
    """Given volume and temperature: the species at T(t) and
    rho = mass / V(t)."""
    KK = tm.KK
    Y = y[:, :KK]
    T, Tdot = profile_value_slope(args.tprof, t)
    V, _ = profile_value_slope(args.constraint, t)
    rho = args.mass / V
    wdot = kinetics.net_production_rates(tm, T, thermo.Y_to_C(tm, Y, rho))
    return torch.cat([wdot * tm.wt / rho[:, None], Tdot[:, None]], dim=1)


# ignition-delay definitions (reference set_ignition_delay modes)
IGN_T_INFLECTION = "T_inflection"
IGN_T_RISE = "T_rise"
IGN_T_IGNITION = "T_ignition"
IGN_SPECIES_PEAK = "Species_peak"
#: the reference's ``ignition_kwargs`` and their defaults: the T_rise
#: threshold above T0 [K], the T_ignition temperature [K], the species of
#: Species_peak, and the least peak dT/dt [K/s] of a T_inflection
#: ignition (below it: slow oxidation, reported NaN)
IGNITION_KWARGS = dict(delta_T=400.0, T_limit=1800.0, species_index=0,
                       min_slope=1e4)


def ignition_kwargs_of(ignition_kwargs):
    """The reference's ignition kwargs filled with their defaults; an
    unknown name raises, as the reference's ``ignition_events`` does."""
    kw = dict(IGNITION_KWARGS)
    for k, v in (ignition_kwargs or {}).items():
        if k not in IGNITION_KWARGS:
            raise TypeError(f"unknown ignition kwarg {k!r}; expected one of "
                            f"{sorted(IGNITION_KWARGS)}")
        kw[k] = v
    return kw


def ignition_events(mode, species_index=0):
    """Events for an ignition-delay definition: the max-dT/dt inflection
    point; the first time T rises through the lane's threshold
    (``Lanes.thresh``: T0 + delta_T for T_rise, T_limit for T_ignition);
    or the peak of species ``species_index``'s mass fraction."""
    if mode == IGN_T_INFLECTION:
        return (Event(fn=lambda t, y, f, lanes: f[:, -1], kind="max"),)
    if mode in (IGN_T_RISE, IGN_T_IGNITION):
        return (Event(fn=lambda t, y, f, lanes: y[:, -1] - lanes.thresh,
                      kind="crossing"),)
    if mode == IGN_SPECIES_PEAK:
        k = int(species_index)
        return (Event(fn=lambda t, y, f, lanes: y[:, k], kind="max"),)
    raise ValueError(f"unknown ignition-delay mode {mode!r}")


#: ``event_mode`` codes of kernel K5: the index of the ignition mode
IGNITION_MODES = (IGN_T_INFLECTION, IGN_T_RISE, IGN_T_IGNITION,
                  IGN_SPECIES_PEAK)

#: the reactor variants: (problem, energy) -> the kernels' problem code
VARIANTS = {("CONP", "ENRG"): "CONP", ("CONV", "ENRG"): "CONV",
            ("CONP", "TGIV"): "CONP_TGIV", ("CONV", "TGIV"): "CONV_TGIV"}

#: plain twins of K1 and K2 by problem code; the lane constraint value is
#: the pressure (CONP, CONP_TGIV) or the density (CONV, CONV_TGIV)
RHS_TWINS = {"CONP": (conp_enrg_rhs, jacobian.conp_enrg_rhs_jac),
             "CONV": (conv_enrg_rhs, jacobian.conv_enrg_rhs_jac),
             "CONP_TGIV": (conp_tgiv_rhs, jacobian.conp_tgiv_rhs_jac),
             "CONV_TGIV": (conv_tgiv_rhs, jacobian.conv_tgiv_rhs_jac)}

#: plain twins of K1 and K2 with profiles (the PRF instantiations):
#: ``(tm, t, y, args)`` with args a :class:`BatchArgs`
RHS_PRF_TWINS = {
    "CONP": (conp_enrg_rhs_prf, jacobian.conp_enrg_rhs_jac_prf),
    "CONV": (conv_enrg_rhs_prf, jacobian.conv_enrg_rhs_jac_prf),
    "CONP_TGIV": (conp_tgiv_rhs_prf, jacobian.conp_tgiv_rhs_jac_prf),
    "CONV_TGIV": (conv_tgiv_rhs_prf, jacobian.conv_tgiv_rhs_jac_prf)}

#: step attempts per launch of the step-round kernel K5 (the reference's
#: round_len): the sweep syncs with the host once per round
ROUND_ATTEMPTS = 512


def variant(problem, energy) -> str:
    """The kernels' problem code of ``(problem, energy)``."""
    try:
        return VARIANTS[(problem, energy)]
    except KeyError:
        raise ValueError(f"unknown reactor variant {(problem, energy)!r}; "
                         f"expected one of {sorted(VARIANTS)}") from None


def kernel_ops(problem) -> Ops:
    """The kernel wrappers K1-K4 for ``problem`` (a problem code) as
    integrator ops (K1 and K2 take profiles where the lanes' constraint is
    a :class:`BatchArgs`)."""
    return Ops(rhs=partial(_kernel_rhs, kernels.rhs, problem),
               rhs_jac=partial(_kernel_rhs, kernels.rhs_jac, problem),
               factor=kernels.bordered_factor, solve=kernels.bordered_solve,
               stiffness=partial(_kernel_rhs, kernels.gershgorin_rate,
                                 problem))


def _kernel_rhs(fn, problem, tm, y, c, t):
    return fn(tm, y, c, problem, t=t)


def _factor_pivoted(J, hg):
    return linalg.factor_bordered_pivoted(linalg.newton_matrix(J, hg))


def _plain(i, problem, tm, y, c, t):
    """Twin ``i`` (0 the RHS, 1 the fused (f, J)) of ``problem`` at
    (t, y): with profiles where ``c`` is a :class:`BatchArgs`, else at the
    constant constraint values ``c``."""
    if isinstance(c, torch.Tensor):
        return RHS_TWINS[problem][i](tm, y, c)
    return RHS_PRF_TWINS[problem][i](tm, t, y, c)


def _plain_stiffness(problem, tm, y, c, t):
    return gershgorin_rate(_plain(1, problem, tm, y, c, t)[1])


def plain_ops(problem, pivot=False) -> Ops:
    """The plain twins of K1-K4 and K8 for ``problem`` as integrator ops;
    with ``pivot`` the Newton matrix's species block is factored with
    partial pivoting."""
    rhs, rhs_jac = partial(_plain, 0, problem), partial(_plain, 1, problem)
    stiffness = partial(_plain_stiffness, problem)
    if pivot:
        return Ops(rhs=rhs, rhs_jac=rhs_jac, factor=_factor_pivoted,
                   solve=linalg.solve_bordered_pivoted, stiffness=stiffness)
    return Ops(rhs=rhs, rhs_jac=rhs_jac, factor=linalg.factor_bordered,
               solve=linalg.solve_bordered, stiffness=stiffness)


def _repeat_lanes(x, n):
    """Every lane of a tensor or (nested) NamedTuple repeated n times in
    place (lane b becomes lanes b n ... b n + n - 1)."""
    if isinstance(x, tuple):
        return type(x)(*[_repeat_lanes(v, n) for v in x])
    return x.repeat_interleave(n, dim=0)


def jacfwd_jacobian(problem, tm, y, c, t):
    """J = d(rhs)/dy [B, N, N] of the twin RHS of ``problem`` by
    forward-mode AD, the reference's ``jac_mode="ad"`` Jacobian
    (``_make_jac_fn``, ops/odeint.py:292): the lanes are independent, so
    one ``torch.func.jvp`` over the lanes each repeated N times, copy j
    with the tangent e_j, gives every column at once."""
    B, N = y.shape
    yr = _repeat_lanes(y, N)
    cr, tr = _repeat_lanes(c, N), _repeat_lanes(t, N)
    v = torch.eye(N, dtype=y.dtype, device=y.device).repeat(B, 1)
    # a TGIV lane's T is its profile's, not a state variable: the sweep's
    # constant-profile RHS reads it from the state, so it is held fixed
    held = problem in ("CONP_TGIV", "CONV_TGIV") and isinstance(
        c, torch.Tensor)

    def f(yy):
        if held:
            yy = torch.cat([yy[:, :-1], yr[:, -1:]], dim=1)
        return _plain(0, problem, tm, yy, cr, tr)

    cols = torch.func.jvp(f, (yr,), (v,))[1]
    return cols.reshape(B, N, N).transpose(1, 2).contiguous()


def _ad_rhs_jac(rhs, problem, tm, y, c, t):
    return rhs(tm, y, c, t), jacfwd_jacobian(problem, tm, y, c, t)


def ad_ops(problem, pivot=False) -> Ops:
    """The integrator ops of ``jac_mode="ad"``: the RHS through K1 (its
    twin on the CPU), J by forward-mode AD of the twin RHS
    (:func:`jacfwd_jacobian`), and K3/K4 (with ``pivot``: the pivoted
    twins), the reference's other Jacobian path, driven from the host."""
    base = kernel_ops(problem)
    rhs_jac = partial(_ad_rhs_jac, base.rhs, problem)
    if pivot:
        return Ops(rhs=base.rhs, rhs_jac=rhs_jac, factor=_factor_pivoted,
                   solve=linalg.solve_bordered_pivoted,
                   stiffness=base.stiffness)
    return base._replace(rhs_jac=rhs_jac)


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
                    ignition_mode=IGN_T_INFLECTION, problem="CONP",
                    ignition_kwargs=None, fault=(None, None)):
    """(Lanes, y0) of a sweep: y0 = [Y0, T0], the constraint value (P0 for
    the CONP codes; for the CONV codes the initial density, the
    reference's mass of a unit volume), the T row's atol
    max(atol 1e6, 1e-8), the crossing threshold (T0 + delta_T for T_rise,
    T_limit for T_ignition) and ``fault`` = (fault bits, nan_rhs start
    times) of :func:`..resilience.faultinject.lane_faults`."""
    B = T0s.shape[0]
    if problem in ("CONP", "CONP_TGIV"):
        constraint = P0s
    elif problem in ("CONV", "CONV_TGIV"):
        constraint = thermo.density(tm, T0s, P0s, Y0s)
    else:
        raise ValueError(f"unknown problem {problem!r}")
    kw = ignition_kwargs_of(ignition_kwargs)
    y0 = torch.cat([Y0s, T0s[:, None]], dim=1)
    atol_vec = torch.full((B, tm.N), atol, dtype=torch.float64,
                          device=tm.device)
    atol_vec[:, -1] = max(atol * 1e6, 1e-8)
    if ignition_mode == IGN_T_RISE:
        thresh = T0s + kw["delta_T"]
    elif ignition_mode == IGN_T_IGNITION:
        thresh = torch.full_like(T0s, float(kw["T_limit"]))
    else:
        thresh = torch.zeros_like(T0s)
    return Lanes(constraint=constraint, atol=atol_vec, t_end=t_ends,
                 thresh=thresh, fault=fault[0], fault_t=fault[1]), y0


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
                         ignition_mode=IGN_T_INFLECTION, ignition_kwargs=None,
                         n_out=2, max_steps_per_segment=20_000, h0=0.0,
                         f64_jac=False, pivoted_lu=False,
                         jac_mode="analytic", elem_ids=None, fault_level=0,
                         device=None, profile=False):
    """Batched ignition delays over [B] initial conditions for the reactor
    ``(problem, energy)``: CONP (constant pressure P0) or CONV (constant
    volume at the initial density), with the energy equation (ENRG) or at
    the given temperature T0 (TGIV).

    Returns ``(times, ok, status)``, each [B] on the run's device:
    ignition times in s (NaN where not detected: a crossing mode whose
    threshold is never crossed, or a T_inflection peak dT/dt below
    ``min_slope``), success flags and
    :class:`~pychemkin_tpu_torch.resilience.status.SolveStatus` codes.
    ``ignition_mode`` is one of :data:`IGNITION_MODES`, with the
    reference's ``ignition_kwargs`` (:data:`IGNITION_KWARGS`). With
    ``profile=True`` a fourth element holds per-lane counters
    (``n_steps``, ``n_rejected``, ``n_newton``, ``dt_min``, ``dt_final``)
    and ``stiffness``, the Gershgorin bound of the Jacobian at each lane's
    final state (kernel K8, one launch after the last round); the first
    three elements are bit-identical to the profile-off triple.

    The rescue ladder's knobs, as the reference's: ``h0`` > 0 is the
    initial step of every lane; ``pivoted_lu`` (or an enclosing
    :func:`..ops.linalg.forced_pivoted`) factors the Newton matrices with
    partial pivoting; ``f64_jac`` changes nothing here, the port's
    closed-form Jacobian being f64 on every path. ``jac_mode="ad"`` takes
    the reference's other Jacobian path: J by forward-mode AD of the twin
    RHS (:func:`jacfwd_jacobian`) in the host-driven loop over K1, K3 and
    K4 (:func:`ad_ops`). ``elem_ids`` [B] are the lanes' original batch
    indices for fault injection (:mod:`..resilience.faultinject`; default
    ``arange(B)`` when injection is active) and ``fault_level`` the
    rescue rung. ``n_out`` > 2 integrates over the reference's output
    grid linspace(0, t_end, n_out) (:func:`~.odeint.odeint`: the steps
    stop at each output time, which moves the ignition times within the
    tolerance), as the reference's sweep does through ``solve_batch``.

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
                  ignition_kwargs=ignition_kwargs,
                  max_steps_per_segment=max_steps_per_segment, h0=h0,
                  pivoted_lu=pivoted_lu, jac_mode=jac_mode,
                  elem_ids=elem_ids, fault_level=fault_level, device=device,
                  profile=profile, n_out=n_out)


def _check_jac_mode(jac_mode):
    if jac_mode not in ("analytic", "ad"):
        raise ValueError(f"unknown jac_mode {jac_mode!r}")


def _output_grid(t_start, t_ends, n_out):
    """[B, n_out] output times linspace(t_start, t_end, n_out) per lane, as
    jnp.linspace forms them (start (1 - k/d) + stop k/d, the last point
    the stop itself)."""
    n_out = int(n_out)
    if n_out < 2:
        raise ValueError(f"n_out must be >= 2, got {n_out}")
    d = n_out - 1
    frac = (torch.arange(d, dtype=torch.float64, device=t_ends.device)
            / float(d))[None, :]
    head = t_start[:, None] * (1 - frac) + t_ends[:, None] * frac
    return torch.cat([head, t_ends[:, None]], dim=1)


def _k5_rounds(tm, code, rtol, mode, species, pivot):
    """One K5 launch of ROUND_ATTEMPTS attempts per lane, as
    :func:`~.odeint.odeint` takes its ``rounds``."""
    def rounds(lanes, state, budget):
        return kernels.sdirk_round(
            tm, lanes, state, rtol=rtol, budget=budget,
            max_attempts=ROUND_ATTEMPTS, event_mode=mode, problem=code,
            species_index=species, pivot=pivot)
    return rounds


def _sweep_lanes(tm, code, T0s, P0s, Y0s, t_ends, elem_ids, *, atol,
                 ignition_mode, kw, fault_level):
    """(Lanes, y0) of a sweep over the batched inputs on ``tm``'s device,
    with the fault masks of ``elem_ids`` (default ``arange(B)`` when
    injection is active) at rescue level ``fault_level``."""
    dev = tm.device
    B = T0s.shape[0]
    if elem_ids is None:
        elem_ids = faultinject.sweep_elem_ids(B, dev)
    else:
        elem_ids = torch.as_tensor(elem_ids, device=dev).reshape(B)
    return sweep_lane_args(
        tm, T0s, P0s, Y0s, t_ends, atol=atol, ignition_mode=ignition_mode,
        problem=code, ignition_kwargs=kw,
        fault=faultinject.lane_faults(elem_ids, int(fault_level)))


def _ignition_times(ev_t, ev_v, ignition_mode, kw):
    times = ev_t[:, 0]
    if ignition_mode == IGN_T_INFLECTION:
        times = torch.where(ev_v[:, 0] >= kw["min_slope"], times,
                            torch.full_like(times, float("nan")))
    return times


@torch.inference_mode()
def _sweep(ops, mech, problem, energy, T0s, P0s, Y0s, t_ends, *, rtol, atol,
           ignition_mode, max_steps_per_segment, device, profile,
           ignition_kwargs=None, h0=0.0, pivoted_lu=False,
           jac_mode="analytic", elem_ids=None, fault_level=0, n_out=2):
    """:func:`ignition_delay_sweep` with its step attempts in rounds of
    kernel K5 (``ops`` None: :func:`ignition_sweep_kernel` advanced until
    every lane is done), or in the host-driven masked loop over ``ops``
    (``kernel_ops(code)``, the K1-K4 path a K5 check compares with, or
    ``plain_ops(code, pivot)``, the reference run of a kernel check;
    ``ops`` then decides the pivoting and gives the profile's
    Jacobian; ``jac_mode="ad"``: :func:`ad_ops`). ``n_out`` > 2: over the
    output grid (:func:`~.odeint.odeint`)."""
    _check_jac_mode(jac_mode)
    code = variant(problem, energy)
    pivot = bool(pivoted_lu) or linalg.pivoted_forced()
    if jac_mode == "ad" and ops is None:
        ops = ad_ops(code, pivot)
    if ops is None and int(n_out) == 2:
        kern = ignition_sweep_kernel(
            mech, problem, energy, rtol=rtol, atol=atol,
            ignition_mode=ignition_mode, ignition_kwargs=ignition_kwargs,
            max_steps_per_segment=max_steps_per_segment, h0=h0,
            pivoted_lu=pivoted_lu, jac_mode=jac_mode,
            fault_level=fault_level, profile=profile, device=device)
        carry = kern.init(T0s, P0s, Y0s, t_ends, elem_ids)
        while bool(kern.going(carry).any()):
            carry = kern.advance(carry)
        out = kern.harvest(carry)
        if not profile:
            return out["times"], out["ok"], out["status"]
        return out["times"], out["ok"], out["status"], {
            k: out[k] for k in ("n_steps", "n_rejected", "n_newton",
                                "dt_min", "dt_final", "stiffness")}
    if ignition_mode not in IGNITION_MODES:
        raise ValueError(f"unknown ignition-delay mode {ignition_mode!r}")
    kw = ignition_kwargs_of(ignition_kwargs)
    dev = resolve_device(device)
    tm = as_torch_mechanism(mech, dev)
    T0s, P0s, Y0s, t_ends = _batch(T0s, P0s, Y0s, t_ends, dev)
    events = ignition_events(ignition_mode, int(kw["species_index"]))
    lanes, y0 = _sweep_lanes(tm, code, T0s, P0s, Y0s, t_ends, elem_ids,
                             atol=atol, ignition_mode=ignition_mode, kw=kw,
                             fault_level=fault_level)
    if int(n_out) == 2:
        state = sweep_start(ops, tm, lanes, y0, rtol, events, h0)
        state = sweep_round(ops, tm, lanes, events, rtol,
                            max_steps_per_segment, state)
        ev_t, ev_v, ok, status = sweep_finalize(state, t_ends, events)
    else:
        rounds = None
        if ops is None:
            ops = kernel_ops(code)
            rounds = _k5_rounds(tm, code, rtol, IGNITION_MODES.index(
                ignition_mode), int(kw["species_index"]), pivot)
        sol = odeint(ops, tm, lanes, y0,
                     _output_grid(torch.zeros_like(t_ends), t_ends, n_out),
                     events, rtol=rtol,
                     max_steps_per_segment=max_steps_per_segment, h0=h0,
                     rounds=rounds)
        state = StepState(t=sol.t_final, y=sol.ys[:, -1].contiguous(), f=None,
                          h=sol.dt_final,
                          n_steps=sol.n_steps, n_rejected=sol.n_rejected,
                          n_newton=sol.n_newton, consec_rej=None,
                          acc_t=sol.event_times, acc_v=sol.event_values,
                          stalled=sol.stalled, status=sol.status,
                          dt_min=sol.dt_min)
        ev_t, ev_v, ok, status = (sol.event_times, sol.event_values,
                                  sol.success, sol.status)
    times = _ignition_times(ev_t, ev_v, ignition_mode, kw)
    if not profile:
        return times, ok, status
    return times, ok, status, {
        "n_steps": state.n_steps, "n_rejected": state.n_rejected,
        "n_newton": state.n_newton, "dt_min": state.dt_min,
        "dt_final": state.h,
        "stiffness": ops.stiffness(tm, state.y, lanes.constraint, state.t)}


# ---------------------------------------------------------------------------
# Resumable sweep: the init/advance/harvest triple that
# ``ignition_delay_sweep`` advances until every lane is done and the
# scheduler (schedule/compaction.py) drives in bounded rounds with
# mid-sweep compaction. ``advance`` is one launch of K5 (on the CPU its
# twin), so on the card a lane advanced in rounds of ROUND_ATTEMPTS
# attempts, in any batch and at any width, takes the steps it takes in
# ``ignition_delay_sweep`` (the CPU twins round per width).

class SweepCarry(NamedTuple):
    """The carried sweep, every tensor [B]-leading: the lanes' constants
    (:class:`~.odeint.Lanes`) and their integrator state
    (:class:`~.odeint.StepState`)."""
    lanes: Any
    state: Any


class SweepKernel(NamedTuple):
    """Entry points of a resumable sweep over a :class:`SweepCarry`:

    - ``init(T0s, P0s, Y0s, t_ends, elems=None) -> carry``;
    - ``advance(carry) -> carry``: at most ``round_len`` step attempts per
      lane (one K5 launch on the card; the state is updated in place);
    - ``going(carry) -> [B] bool``: the lanes not yet done;
    - ``harvest(carry) -> dict`` of [B] tensors ``times``, ``ok``,
      ``status``, ``done``, ``n_steps``, ``n_rejected``, ``n_newton`` and,
      with ``profile``, ``dt_min``, ``dt_final`` and ``stiffness`` (K8 at
      the lanes' states);
    - ``take(carry, idx) -> carry``: the lanes ``idx`` gathered with
      ``index_select`` on the carry's device.

    The reference's kernel passes the inputs beside its state to each
    entry point; here they live in the carry's lanes."""
    init: Any
    advance: Any
    going: Any
    harvest: Any
    take: Any
    round_len: int


def ignition_sweep_kernel(mech, problem, energy, *, rtol=1e-6, atol=1e-12,
                          ignition_mode=IGN_T_INFLECTION,
                          ignition_kwargs=None, max_steps_per_segment=20_000,
                          h0=0.0, pivoted_lu=False, jac_mode="analytic",
                          fault_level=0, round_len=ROUND_ATTEMPTS,
                          profile=False, device=None) -> SweepKernel:
    """The resumable sweep of one solver configuration, on ``cuda`` unless
    ``device`` names another device (the mechanism is moved there once).
    ``elems`` of ``init`` are the lanes' original batch indices for fault
    injection, so a cohort-permuted sweep keeps the same lanes poisoned.
    ``profile`` adds ``dt_min``, ``dt_final`` and ``stiffness`` to the
    harvest; the state and every primal output stay bit-identical."""
    _check_jac_mode(jac_mode)
    if jac_mode == "ad":
        raise NotImplementedError(
            "the resumable sweep steps in K5, whose Jacobian is the closed "
            "form; jac_mode='ad' runs in ignition_delay_sweep's and "
            "solve_batch's host-driven loop")
    code = variant(problem, energy)
    if ignition_mode not in IGNITION_MODES:
        raise ValueError(f"unknown ignition-delay mode {ignition_mode!r}")
    round_len = int(round_len)
    if round_len < 1:
        raise ValueError(f"round_len must be >= 1, got {round_len}")
    kw = ignition_kwargs_of(ignition_kwargs)
    dev = resolve_device(device)
    tm = as_torch_mechanism(mech, dev)
    species = int(kw["species_index"])
    events = ignition_events(ignition_mode, species)
    mode = IGNITION_MODES.index(ignition_mode)
    budget = int(max_steps_per_segment)

    @torch.inference_mode()
    def init(T0s, P0s, Y0s, t_ends, elems=None):
        T0s, P0s, Y0s, t_ends = _batch(T0s, P0s, Y0s, t_ends, dev)
        lanes, y0 = _sweep_lanes(tm, code, T0s, P0s, Y0s, t_ends, elems,
                                 atol=atol, ignition_mode=ignition_mode,
                                 kw=kw, fault_level=fault_level)
        return SweepCarry(lanes, sweep_start(kernel_ops(code), tm, lanes, y0,
                                             rtol, events, h0))

    @torch.inference_mode()
    def advance(carry):
        pivot = bool(pivoted_lu) or linalg.pivoted_forced()
        return carry._replace(state=kernels.sdirk_round(
            tm, carry.lanes, carry.state, rtol=rtol, budget=budget,
            max_attempts=round_len, event_mode=mode, problem=code,
            species_index=species, pivot=pivot))

    @torch.inference_mode()
    def going(carry):
        return sweep_going(carry.state, carry.lanes, budget)

    @torch.inference_mode()
    def harvest(carry):
        lanes, state = carry
        ev_t, ev_v, ok, status = sweep_finalize(state, lanes.t_end, events)
        out = {"times": _ignition_times(ev_t, ev_v, ignition_mode, kw),
               "ok": ok, "status": status, "done": ~going(carry),
               "n_steps": state.n_steps, "n_rejected": state.n_rejected,
               "n_newton": state.n_newton}
        if profile:
            out["dt_min"] = state.dt_min
            out["dt_final"] = state.h
            out["stiffness"] = kernels.gershgorin_rate(
                tm, state.y, lanes.constraint, problem=code)
        return out

    def take(carry, idx):
        return SweepCarry(_take(carry.lanes, idx), _take(carry.state, idx))

    return SweepKernel(init=init, advance=advance, going=going,
                       harvest=harvest, take=take, round_len=round_len)


# ---------------------------------------------------------------------------
# solve_batch: the reference's general 0-D batch integrator (ops/reactors.py
# :232), batch-first, with profiles, heat loss and an output grid.

class BatchSolution(NamedTuple):
    """The solution of :func:`solve_batch`, every field [B]-leading: the
    output times ``times`` [B, n_out] and at each of them ``T``, ``P``,
    ``volume`` (the mass over the density) [B, n_out] and ``Y``
    [B, n_out, KK]; ``ignition_time`` [B] (NaN where not detected); the
    counters ``n_steps``, ``n_rejected``, ``n_newton``, ``success`` and
    the SolveStatus codes ``status``; with ``profile=True`` a dict of the
    per-lane solve profile (``n_steps``, ``n_rejected``, ``n_newton``,
    ``dt_min``, ``dt_final``, ``stalled``, ``status``, ``stiffness``,
    ``rescue_rung``), else None."""
    times: Any
    T: Any
    P: Any
    volume: Any
    Y: Any
    ignition_time: Any
    n_steps: Any
    success: Any
    n_rejected: Any = None
    n_newton: Any = None
    status: Any = None
    profile: Any = None


def _lane_profile(p, B, device, name):
    """A user profile (x [n]; y [n] or [B, n]) as [B, n] rows on
    ``device`` (expanded views of a shared profile)."""
    f64 = dict(dtype=torch.float64, device=device)
    x = torch.as_tensor(p.x, **f64)
    y = torch.as_tensor(p.y, **f64)
    if x.ndim != 1 or x.shape[0] < 2 or y.shape[-1] != x.shape[0] or \
            y.ndim > 2 or (y.ndim == 2 and y.shape[0] != B):
        raise ValueError(f"{name}: expected x [n >= 2] and y [n] or "
                         f"[{B}, n], got {tuple(x.shape)}, {tuple(y.shape)}")
    if not bool((x[1:] > x[:-1]).all()):
        raise ValueError(f"{name}: knots must be strictly increasing")
    return Profile(x=x.expand(B, -1), y=y.expand(B, -1))


def _at_times(p, ts):
    """The profile's value at every output time ts [B, n_out]."""
    return torch.stack([profile_value_slope(p, ts[:, k].contiguous())[0]
                        for k in range(ts.shape[1])], dim=1)


def solve_batch(mech, problem, energy, T0s, P0s, Y0s, t_ends, *, n_out=101,
                rtol=1e-6, atol=1e-12, constraint_profile=None,
                t_profile=None, qloss_profile=None, area_profile=None,
                volume=1.0, htc=0.0, tamb=298.15, area=0.0,
                ignition_mode=IGN_T_INFLECTION, ignition_kwargs=None,
                t_start=0.0, max_steps_per_segment=20_000, h0=0.0,
                jac_mode="analytic", device=None,
                profile=False) -> BatchSolution:
    """Solve [B] closed 0-D batch reactors of ``(problem, energy)`` (CONP or
    CONV, ENRG or TGIV) from (T0s, P0s, Y0s) over [t_start, t_ends] on the
    output grid linspace(t_start, t_end, n_out): the reference's
    ``solve_batch`` (ops/reactors.py:232), every input broadcast along the
    leading batch axis.

    Profiles (:class:`Profile`, knots x [n] in s, values y [n] for every
    lane or [B, n], flat outside the knots): ``constraint_profile`` P(t)
    in dyne/cm^2 for CONP (default constant P0) or V(t) in cm^3 for CONV
    (default constant ``volume``); ``t_profile`` T(t) in K for TGIV
    (default constant T0); ``qloss_profile`` the heat-loss rate in erg/s
    (default 0) and ``area_profile`` the heat-transfer area in cm^2
    (default constant ``area``). ``htc`` [erg/(cm^2 K s)], ``tamb`` [K],
    ``volume`` [cm^3] and ``area`` are scalars or [B]. The reactor is
    closed: its mass is the density at t_start (P from the profile's
    P(t_start) for CONP) times ``volume`` (CONP) or V(t_start) (CONV). The
    ignition modes, tolerances (the T row's atol max(atol 1e6, 1e-8)),
    ``h0`` and ``max_steps_per_segment`` (per output interval) are the
    reference's. ``jac_mode="ad"`` steps in the host-driven loop with the
    forward-mode AD Jacobian (:func:`ad_ops`).

    Returns a :class:`BatchSolution`: TGIV's T is the profile's value at
    the output times; CONP's P is the profile's and V = m / rho(T, P, Y);
    CONV's V is the profile's and P = rho R T / Wbar.

    Runs on ``cuda`` unless ``device`` names another device: there the
    initial RHS is K1's PRF instantiation and every step attempt runs in
    K5's (``kernels.sdirk_round`` on lanes whose constraint is a
    :class:`BatchArgs`), one round of ``ROUND_ATTEMPTS`` attempts per
    launch and at least one launch per output interval
    (:func:`~.odeint.odeint`); on the CPU the wrappers take their plain
    twins. The pivoted and faulted rungs with profiles (the solve-batch
    rescue ladder) are not ported: under
    :func:`..ops.linalg.forced_pivoted` this raises."""
    return _solve_batch(
        None, mech, problem, energy, T0s, P0s, Y0s, t_ends, n_out=n_out,
        rtol=rtol, atol=atol, constraint_profile=constraint_profile,
        t_profile=t_profile, qloss_profile=qloss_profile,
        area_profile=area_profile, volume=volume, htc=htc, tamb=tamb,
        area=area, ignition_mode=ignition_mode,
        ignition_kwargs=ignition_kwargs, t_start=t_start,
        max_steps_per_segment=max_steps_per_segment, h0=h0,
        jac_mode=jac_mode, device=device, profile=profile)


class BatchSetup(NamedTuple):
    """What :func:`solve_batch` integrates: the mechanism on the device,
    the lanes (their constraint a :class:`BatchArgs`), the initial states
    y0 [B, N], the output grid ts [B, n_out], the events, the filled
    ignition kwargs and the profiles as [B]-leading rows."""
    tm: Any
    lanes: Any
    y0: Any
    ts: Any
    events: Any
    kw: Any
    args: Any


def batch_setup(mech, problem, energy, T0s, P0s, Y0s, t_ends, *, n_out=101,
                atol=1e-12, constraint_profile=None, t_profile=None,
                qloss_profile=None, area_profile=None, volume=1.0, htc=0.0,
                tamb=298.15, area=0.0, ignition_mode=IGN_T_INFLECTION,
                ignition_kwargs=None, t_start=0.0,
                device=None) -> BatchSetup:
    """The lanes of :func:`solve_batch` (its arguments, their defaults and
    their meaning): the profiles as [B, n] rows, the closed reactor's mass
    from the density at t_start, the tolerances, thresholds and the output
    grid."""
    code = variant(problem, energy)
    if ignition_mode not in IGNITION_MODES:
        raise ValueError(f"unknown ignition-delay mode {ignition_mode!r}")
    kw = ignition_kwargs_of(ignition_kwargs)
    dev = resolve_device(device)
    tm = as_torch_mechanism(mech, dev)
    T0s, P0s, Y0s, t_ends = _batch(T0s, P0s, Y0s, t_ends, dev)
    B = T0s.shape[0]
    _, per = broadcast_lanes(dev, dict(volume=volume, htc=htc, tamb=tamb,
                                       area=area, t_start=t_start), {})
    per = {k: (v if v.shape[0] == B else v.expand(B).contiguous())
           for k, v in per.items()}
    conp = problem == "CONP"
    if constraint_profile is None:
        constraint = constant_profile(P0s if conp else per["volume"], dev)
    else:
        constraint = constraint_profile
    tprof = t_profile if t_profile is not None else constant_profile(T0s, dev)
    qloss = (qloss_profile if qloss_profile is not None
             else constant_profile(torch.zeros_like(T0s), dev))
    area_p = (area_profile if area_profile is not None
              else constant_profile(per["area"], dev))
    constraint, tprof, qloss, area_p = (
        _lane_profile(p, B, dev, n) for p, n in (
            (constraint, "constraint_profile"), (tprof, "t_profile"),
            (qloss, "qloss_profile"), (area_p, "area_profile")))
    t_start = per["t_start"]
    c_start, _ = profile_value_slope(constraint, t_start)
    if conp:
        mass = thermo.density(tm, T0s, c_start, Y0s) * per["volume"]
    else:
        mass = thermo.density(tm, T0s, P0s, Y0s) * c_start
    args = BatchArgs(constraint=constraint, tprof=tprof, qloss=qloss,
                     area=area_p, mass=mass, htc=per["htc"],
                     tamb=per["tamb"])
    lanes, y0 = sweep_lane_args(tm, T0s, P0s, Y0s, t_ends, atol=atol,
                                ignition_mode=ignition_mode, problem=code,
                                ignition_kwargs=kw)
    return BatchSetup(
        tm=tm, lanes=lanes._replace(constraint=args), y0=y0,
        ts=_output_grid(t_start, t_ends, n_out),
        events=ignition_events(ignition_mode, int(kw["species_index"])),
        kw=kw, args=args)


@torch.inference_mode()
def _solve_batch(ops, mech, problem, energy, T0s, P0s, Y0s, t_ends, *,
                 n_out, rtol, atol, constraint_profile, t_profile,
                 qloss_profile, area_profile, volume, htc, tamb, area,
                 ignition_mode, ignition_kwargs, t_start,
                 max_steps_per_segment, h0, jac_mode, device, profile):
    """:func:`solve_batch` with its step attempts in rounds of K5 (``ops``
    None), or in the host-driven loop over ``ops`` (``kernel_ops(code)``:
    the K1-K4 path a K5 check compares with; ``plain_ops(code)``: the
    reference run of a kernel check)."""
    _check_jac_mode(jac_mode)
    code = variant(problem, energy)
    if linalg.pivoted_forced():
        raise NotImplementedError(
            "solve_batch has no pivoted rung (the solve-batch rescue ladder "
            "is not ported)")
    tm, lanes, y0, ts, events, kw, args = batch_setup(
        mech, problem, energy, T0s, P0s, Y0s, t_ends, n_out=n_out, atol=atol,
        constraint_profile=constraint_profile, t_profile=t_profile,
        qloss_profile=qloss_profile, area_profile=area_profile,
        volume=volume, htc=htc, tamb=tamb, area=area,
        ignition_mode=ignition_mode, ignition_kwargs=ignition_kwargs,
        t_start=t_start, device=device)
    B = y0.shape[0]
    conp = problem == "CONP"
    tprof, constraint, mass = args.tprof, args.constraint, args.mass
    rounds = None
    if jac_mode == "ad" and ops is None:
        ops = ad_ops(code)
    elif ops is None:
        ops = kernel_ops(code)
        rounds = _k5_rounds(tm, code, rtol, IGNITION_MODES.index(
            ignition_mode), int(kw["species_index"]), False)
    sol = odeint(ops, tm, lanes, y0, ts, events, rtol=rtol,
                 max_steps_per_segment=max_steps_per_segment, h0=h0,
                 rounds=rounds)
    ignition_time = _ignition_times(sol.event_times, sol.event_values,
                                    ignition_mode, kw)
    KK = tm.KK
    Ys = sol.ys[:, :, :KK]
    Ts = sol.ys[:, :, KK]
    if energy == "TGIV":
        Ts = _at_times(tprof, ts)
    n = ts.shape[1]
    flat = Ys.reshape(B * n, KK)
    if conp:
        Ps = _at_times(constraint, ts)
        rhos = thermo.density(tm, Ts.reshape(-1), Ps.reshape(-1),
                              flat).reshape(B, n)
        Vs = mass[:, None] / rhos
    else:
        Vs = _at_times(constraint, ts)
        rhos = mass[:, None] / Vs
        wbars = thermo.mean_molecular_weight_Y(tm, flat).reshape(B, n)
        Ps = rhos * R_GAS * Ts / wbars
    prof = None
    if profile:
        stiffness = ops.stiffness(tm, sol.ys[:, -1].contiguous(), args,
                                  sol.t_final)
        prof = {"n_steps": sol.n_steps, "n_rejected": sol.n_rejected,
                "n_newton": sol.n_newton, "dt_min": sol.dt_min,
                "dt_final": sol.dt_final, "stalled": sol.stalled,
                "status": sol.status, "stiffness": stiffness,
                "rescue_rung": torch.zeros_like(sol.status)}
    return BatchSolution(times=ts, T=Ts, P=Ps, volume=Vs, Y=Ys,
                         ignition_time=ignition_time, n_steps=sol.n_steps,
                         success=sol.success, n_rejected=sol.n_rejected,
                         n_newton=sol.n_newton, status=sol.status,
                         profile=prof)
