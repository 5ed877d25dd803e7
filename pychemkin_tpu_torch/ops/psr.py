"""Steady-state perfectly-stirred reactor (PSR), batched (plain PyTorch
twin of kernel K7).

Counterpart of the JAX package's ``ops/psr.py:55-379``: per lane, a
damped Newton on the tau-scaled steady residual from the initial guess;
on lanes it leaves unconverged, a pseudo-transient continuation
(implicit-Euler steps with an adaptive stride) and a second, polishing
Newton; then the finish (exit state, residence time, volume, residual
norm, status). The reference runs the pseudo-transient phase on every
lane and discards it where the first Newton converged, so running it
only on the others is exact.

The state of a lane is y = [Y_1..Y_KK, T]. Every Newton matrix is
bordered over the species block, which is factored with partial
pivoting (the reference's exact path); the Jacobians are the closed-form
:func:`~.jacobian.psr_rhs_jac`, where the reference takes ``jax.jacfwd``
over its closed-form kinetics rule. Lanes are batch-first: [B] scalars,
[B, KK] compositions. Units CGS.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import kernels
from ..constants import R_GAS
from ..resilience import faultinject
from ..resilience.status import SolveStatus
from . import jacobian, kinetics, linalg, thermo
from .reactors import as_torch_mechanism, broadcast_lanes, resolve_device

_TINY = 1e-30

#: temperature scale of the Newton step norm
T_SCALE = 1.0e3

MODE_TAU = "tau"      # residence time given (SetResTime)
MODE_VOLUME = "vol"   # volume given (SetVolume)
MODES = (MODE_TAU, MODE_VOLUME)
ENERGIES = ("ENRG", "TGIV")


class PSRArgs(NamedTuple):
    """The lanes of a PSR batch, each [B] (Y_in [B, KK])."""
    P: Any            # reactor pressure, dyne/cm^2
    Y_in: Any         # combined-inlet mass fractions
    h_in: Any         # combined-inlet specific enthalpy, erg/g
    tau: Any          # residence time, s ("tau" mode) or 0
    volume: Any       # reactor volume, cm^3 ("vol" mode) or 0
    mdot: Any         # total inlet mass flow, g/s
    qloss: Any        # heat-loss rate, erg/s (ENRG)
    T_fixed: Any      # reactor temperature (TGIV)


class PSRControls(NamedTuple):
    """The solver's controls (the reference's defaults)."""
    ss_atol: float = 1e-9
    ss_rtol: float = 1e-4
    n_newton: int = 50
    n_pseudo: int = 100
    pseudo_dt0: float = 1e-6
    pseudo_up: float = 2.0
    pseudo_down: float = 2.2
    pseudo_dt_min: float = 1e-10
    pseudo_dt_max: float = 1e-2
    T_max: float = 5000.0
    species_floor: float = -1e-14


class PSRSolution(NamedTuple):
    """Per-lane PSR solution."""
    T: Any
    Y: Any            # [B, KK]
    rho: Any
    tau: Any          # actual residence time
    volume: Any       # actual volume
    residual: Any     # final weighted residual norm
    converged: Any
    n_newton: Any
    n_newton_direct: Any
    n_newton_polish: Any   # > 0 exactly where the rescue path ran
    status: Any            # SolveStatus code (int32)


def _split(tm, y, args, energy):
    """(Y, T) of the state: T floored at 50 K, or T_fixed for TGIV."""
    Y = y[:, :tm.KK]
    T = args.T_fixed if energy == "TGIV" else torch.clamp(y[:, tm.KK],
                                                          min=50.0)
    return Y, T


def tau_volume(args: PSRArgs, rho, mode):
    """(tau, V) consistent with the specification mode."""
    if mode == MODE_TAU:
        return args.tau, args.tau * torch.clamp(args.mdot, min=_TINY) / rho
    return rho * args.volume / torch.clamp(args.mdot, min=_TINY), args.volume


def make_rhs(mode, energy):
    """The transient PSR RHS d[Y, T]/dt, ``rhs(tm, y, args)`` -> [B, N]:
    its root is the steady state."""

    def rhs(tm, y, args: PSRArgs):
        Y, T = _split(tm, y, args, energy)
        rho = thermo.density(tm, T, args.P, Y)
        tau, V = tau_volume(args, rho, mode)
        tau = torch.clamp(tau, min=_TINY)
        nasa = thermo.nasa7(tm, T)
        wdot = kinetics.net_production_rates(tm, T, thermo.Y_to_C(tm, Y, rho),
                                             nasa, args.P)
        dY = (args.Y_in - Y) / tau[:, None] + wdot * tm.wt / rho[:, None]
        if energy == "TGIV":
            dT = torch.zeros_like(T)
        else:
            cp = (Y * (nasa[0] * R_GAS / tm.wt)).sum(-1)
            h_k = thermo.species_enthalpy_mass(tm, T, nasa)
            h_in_term = args.h_in - (args.Y_in * h_k).sum(-1)
            q_mass = args.qloss / torch.clamp(rho * V, min=_TINY)
            dT = (h_in_term / tau - (h_k * wdot * tm.wt).sum(-1) / rho
                  - q_mass) / cp
        return torch.cat([dY, dT[:, None]], dim=1)

    return rhs


def resid(tm, y, args, mode, energy):
    """The tau-scaled steady residual rhs(y) * tau_eff, [B, N]."""
    Y, T = _split(tm, y, args, energy)
    tau, _ = tau_volume(args, thermo.density(tm, T, args.P, Y), mode)
    return make_rhs(mode, energy)(tm, y, args) * torch.clamp(
        tau, min=_TINY)[:, None]


def _sub(args, idx):
    return PSRArgs(*[a[idx] for a in args])


def _step_norm(dy, y, ctl):
    """Weighted RMS of the Newton correction, T scaled by T_SCALE, weights
    atol + rtol |y| at the new state."""
    scale = torch.ones_like(y[0])
    scale[-1] = T_SCALE
    w = ctl.ss_atol + ctl.ss_rtol * (y / scale).abs()
    return torch.sqrt((((dy / scale) / w) ** 2).mean(-1))


def _clip_state(y, ctl):
    return torch.cat([torch.clamp(y[:, :-1], ctl.species_floor, 1.0),
                      torch.clamp(y[:, -1:], 150.0, ctl.T_max)], dim=1)


def newton_phase(tm, y, args, mode, energy, ctl, fault=None):
    """Damped Newton on every lane until its step converges or
    ``n_newton`` iterations; returns (y, converged, iterations, unstable of
    the last iteration). ``fault`` [B] bool: the lanes an injected
    ``linalg_unstable`` fault poisons."""
    B, N = y.shape
    eye = torch.eye(N, dtype=y.dtype, device=y.device)
    conv = torch.zeros(B, dtype=torch.bool, device=y.device)
    unstable = torch.zeros_like(conv)
    it = torch.zeros(B, dtype=torch.int64, device=y.device)
    y = y.clone()
    for _ in range(ctl.n_newton):
        idx = (~conv).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        ya, aa = y[idx], _sub(args, idx)
        r, J = jacobian.psr_rhs_jac(tm, ya, aa, mode, energy, scaled=True)
        J = torch.where(torch.isfinite(J), J, torch.zeros_like(J)) + 1e-14 * eye
        r = torch.where(torch.isfinite(r), r, torch.full_like(r, 1e6))
        dy, uns = linalg.solve_with_info(
            J, -r, bordered=True,
            fault_mask=None if fault is None else fault[idx])
        dy = torch.where(torch.isfinite(dy), dy, torch.zeros_like(dy))
        aT = 150.0 / torch.clamp(dy[:, -1].abs(), min=_TINY)
        aY = 0.2 / torch.clamp(dy[:, :-1].abs().amax(-1), min=_TINY)
        alpha = torch.clamp(torch.minimum(aT, aY), max=1.0)
        y_new = _clip_state(ya + alpha[:, None] * dy, ctl)
        c = ((alpha >= 1.0 - 1e-12) & (_step_norm(dy, y_new, ctl) < 1.0)
             & ~uns)
        y[idx] = y_new
        conv[idx] = c
        unstable[idx] = uns
        it[idx] += 1
    return y, conv, it, unstable


def pseudo_transient_phase(tm, y, args, mode, energy, ctl):
    """``n_pseudo`` implicit-Euler steps of the transient RHS from y, each
    with 6 Newton iterations on G(y) = y - y_prev - dt rhs(y) through one
    factor of I - dt J; the stride grows by ``pseudo_up`` after a finite
    step and shrinks by ``pseudo_down`` otherwise."""
    B, N = y.shape
    rhs = make_rhs(mode, energy)
    eye = torch.eye(N, dtype=y.dtype, device=y.device)
    dt = torch.full((B,), ctl.pseudo_dt0, dtype=y.dtype, device=y.device)
    for _ in range(ctl.n_pseudo):
        _, J = jacobian.psr_rhs_jac(tm, y, args, mode, energy)
        M = eye - dt[:, None, None] * J
        fac = linalg.factor_bordered_pivoted(
            torch.where(torch.isfinite(M), M, torch.zeros_like(M)))
        yc = y
        bad = torch.zeros(B, dtype=torch.bool, device=y.device)
        for _ in range(6):
            g = yc - y - dt[:, None] * rhs(tm, yc, args)
            dy = linalg.solve_bordered_pivoted(fac, -g)
            fin = torch.isfinite(dy)
            bad = bad | ~fin.all(-1)
            yc = _clip_state(yc + torch.where(fin, dy, torch.zeros_like(dy)),
                             ctl)
        Yc = torch.clamp(yc[:, :-1], 0.0, 1.0)
        ysum = torch.clamp(Yc.sum(-1), min=_TINY)
        y_new = torch.cat([Yc / ysum[:, None], yc[:, -1:]], dim=1)
        fin = torch.isfinite(y_new).all(-1)
        ok = fin & ~bad
        y = torch.where(fin[:, None], y_new, y)
        dt = torch.clamp(torch.where(ok, dt * ctl.pseudo_up,
                                     dt / ctl.pseudo_down),
                         ctl.pseudo_dt_min, ctl.pseudo_dt_max)
    return y


def solve_psr_plain(tm, mode, energy, args: PSRArgs, y0,
                    ctl: PSRControls, fault=None) -> PSRSolution:
    """The plain twin of kernel K7: the whole solve of every lane from its
    guess y0 [B, N]; ``fault`` as :func:`newton_phase`'s, in both Newton
    phases."""
    y1, conv1, n1, unst1 = newton_phase(tm, y0, args, mode, energy, ctl,
                                        fault)
    y = y1.clone()
    n2 = torch.zeros_like(n1)
    conv = conv1.clone()
    lin_unstable = unst1.clone()
    idx = (~conv1).nonzero()[:, 0]
    if idx.numel():
        sa = _sub(args, idx)
        y_pt = pseudo_transient_phase(tm, y1[idx], sa, mode, energy, ctl)
        y2, c2, it2, u2 = newton_phase(
            tm, y_pt, sa, mode, energy, ctl,
            None if fault is None else fault[idx])
        y[idx], conv[idx], n2[idx], lin_unstable[idx] = y2, c2, it2, u2
    return finish(tm, y, conv, n1, n2, lin_unstable, args, mode, energy,
                  ctl)


def finish(tm, y, converged, n1, n2, lin_unstable, args, mode, energy, ctl):
    """Exit state, residence time, volume, residual norm (weighted at the
    un-normalised y) and status of every lane."""
    Y = torch.clamp(y[:, :-1], 0.0, 1.0)
    Y = Y / torch.clamp(Y.sum(-1), min=_TINY)[:, None]
    T = args.T_fixed if energy == "TGIV" else torch.clamp(y[:, -1], min=50.0)
    rho = thermo.density(tm, T, args.P, Y)
    tau_eff, V_eff = tau_volume(args, rho, mode)
    w = ctl.ss_atol + ctl.ss_rtol * y.abs()
    rfin = resid(tm, y, args, mode, energy)
    rnorm = torch.sqrt(((rfin / w) ** 2).mean(-1))
    finite = torch.isfinite(y).all(-1) & torch.isfinite(rnorm)

    def code(s):
        return torch.full_like(n1, int(s), dtype=torch.int32)
    status = torch.where(
        converged, code(SolveStatus.OK),
        torch.where(~finite, code(SolveStatus.NONFINITE),
                    torch.where(lin_unstable,
                                code(SolveStatus.LINALG_UNSTABLE),
                                code(SolveStatus.TOL_NOT_MET))))
    return PSRSolution(T=T, Y=Y, rho=rho, tau=tau_eff, volume=V_eff,
                       residual=rnorm, converged=converged, n_newton=n1 + n2,
                       n_newton_direct=n1, n_newton_polish=n2, status=status)


@torch.inference_mode()
def solve_psr(mech, mode, energy, *, P, Y_in, h_in, T_guess, Y_guess,
              tau=0.0, volume=0.0, mdot=0.0, qloss=0.0, T_fixed=0.0,
              ss_atol=1e-9, ss_rtol=1e-4, n_newton=50, n_pseudo=100,
              pseudo_dt0=1e-6, pseudo_up=2.0, pseudo_down=2.2,
              pseudo_dt_min=1e-10, pseudo_dt_max=1e-2, T_max=5000.0,
              species_floor=-1e-14, elem_ids=None, fault_level=0,
              device=None) -> PSRSolution:
    """PSR steady states of a batch of lanes: ``mode`` "tau" (residence
    time given) or "vol" (volume given), ``energy`` "ENRG" or "TGIV", with
    the reference's controls and defaults. Scalars or [B] for P, h_in,
    T_guess, tau, volume, mdot, qloss and T_fixed; [KK] or [B, KK] for
    Y_in and Y_guess. Returns a :class:`PSRSolution` of [B] lanes whose
    ``status`` holds the reference's SolveStatus codes. ``elem_ids`` [B]
    (the reference's ``fault_elem`` per lane) and ``fault_level`` thread
    fault injection: a lane a ``linalg_unstable`` spec poisons at that
    rescue level gets garbage Newton directions flagged unstable (on the
    card K7's FAULT instantiation).

    Runs on ``cuda`` unless ``device`` names another device: on the card
    the whole solve is one launch of kernel K7 (``kernels.psr_solve``);
    on the CPU its twin :func:`solve_psr_plain`."""
    if mode not in MODES or energy not in ENERGIES:
        raise ValueError(f"mode must be one of {MODES} and energy one of "
                         f"{ENERGIES}, got {mode!r}, {energy!r}")
    dev = resolve_device(device)
    tm = as_torch_mechanism(mech, dev)
    _, L = broadcast_lanes(
        dev, dict(P=P, h_in=h_in, T_guess=T_guess, tau=tau, volume=volume,
                  mdot=mdot, qloss=qloss, T_fixed=T_fixed),
        dict(Y_in=Y_in, Y_guess=Y_guess))
    args = PSRArgs(**{k: L[k] for k in PSRArgs._fields})
    y0 = torch.cat([L["Y_guess"], L["T_guess"][:, None]], dim=1)
    ctl = PSRControls(ss_atol, ss_rtol, int(n_newton), int(n_pseudo),
                      pseudo_dt0, pseudo_up, pseudo_down, pseudo_dt_min,
                      pseudo_dt_max, T_max, species_floor)
    fault = None
    if elem_ids is not None:
        fault = faultinject.unstable_mask(
            torch.as_tensor(elem_ids, device=dev).reshape(y0.shape[0]),
            int(fault_level))
    return kernels.psr_solve(tm, mode, energy, args, y0, ctl, fault=fault)
