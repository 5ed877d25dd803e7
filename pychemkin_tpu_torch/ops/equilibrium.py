"""Batched chemical equilibrium by element potentials (plain PyTorch twin
of kernel K6).

Counterpart of the JAX package's ``ops/equilibrium.py:40-330``: damped
Newton on z = [lambda (MM), ln nbar, ln T, ln P] with a FIXED number of
iterations (no lane exits early), from a weighted least-squares start,
with a composition-only pre-phase at the initial (T, P), for the nine
constraint pairs of the reference's EQOption table; options 6 (P, S) and
9 (V, S) nest the solve in a 20-step quasi-Newton on ln T.

Where the reference differentiates its residual with ``jax.jacfwd``,
:func:`resid_jac` writes the Jacobian out in closed form, with the clamp
indicators AD gives (zero derivative inside the entropy's
``clip(ln x, -85, 0)`` and where ``maximum(cp, 1e-30)`` clamps); kernel
K6 (``kernels/csrc/equilibrium.cu``) evaluates the same formulas.

Batch-first: T, P [B]; Y [B, KK]; z [B, MM + 3]. Units CGS: P dyne/cm^2,
v cm^3/g, h and u erg/g, s erg/(g K).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import kernels
from ..constants import P_ATM, R_GAS
from ..resilience import faultinject
from ..resilience.status import SolveStatus
from . import linalg, thermo
from .reactors import as_torch_mechanism, broadcast_lanes, resolve_device

# constraint codes (kernel K6 numbers them 0-5 in this order)
CON_T, CON_P, CON_V, CON_H, CON_U, CON_S = "T", "P", "V", "H", "U", "S"

#: reference EQOption -> constraint pair
EQ_OPTIONS = {
    1: (CON_T, CON_P),
    2: (CON_T, CON_V),
    3: (CON_T, CON_S),
    4: (CON_P, CON_V),
    5: (CON_P, CON_H),
    6: (CON_P, CON_S),
    7: (CON_V, CON_U),
    8: (CON_V, CON_H),
    9: (CON_V, CON_S),
}

_N_ITER = 80
_N_PRE = 50
_TINY = 1e-30
_X_FLOOR = 1e-35
_LN_P_ATM = math.log(P_ATM)
#: the nested (P, S) / (V, S) solve: outer ln T steps, inner and final
#: iteration counts (reference equilibrium.py:298-330)
NEST_OUTER = 20
NEST_INNER = (30, 30)
NEST_FINAL = (40, 30)


class EquilibriumResult(NamedTuple):
    """Equilibrium state per lane (per unit mass of mixture)."""
    T: Any            # [B] K
    P: Any            # [B] dyne/cm^2
    X: Any            # [B, KK] mole fractions
    Y: Any            # [B, KK] mass fractions
    nbar: Any         # [B] mol/g
    h: Any            # [B] erg/g
    u: Any            # [B] erg/g
    s: Any            # [B] erg/(g K)
    v: Any            # [B] cm^3/g
    residual: Any     # [B] final residual norm
    converged: Any    # [B] bool
    status: Any       # [B] int32 SolveStatus


def is_nested(option) -> bool:
    """Options whose solve is nested in the outer ln T loop."""
    con1, con2 = EQ_OPTIONS[int(option)]
    return con2 == CON_S and con1 in (CON_P, CON_V)


def element_moles(tm, Y):
    """Element abundances b [B, MM], mol per gram of mixture."""
    return (Y / tm.wt) @ tm.ncf


def _soft_clip(x, lo, hi):
    """Saturate into ~[lo-, hi+] with log growth outside the band."""
    d_hi = torch.clamp(x - hi, min=0.0)
    x = torch.where(x > hi, hi + torch.log1p(d_hi), x)
    d_lo = torch.clamp(lo - x, min=0.0)
    return torch.where(x < lo, lo - torch.log1p(d_lo), x)


def _soft_clip_slope(x, lo, hi):
    """d/dx of :func:`_soft_clip` (strictly positive)."""
    one = torch.ones_like(x)
    return torch.where(x > hi, 1.0 / (1.0 + (x - hi)),
                       torch.where(x < lo, 1.0 / (1.0 + (lo - x)), one))


def _mixture_props(tm, z):
    """State functions of the Newton unknowns z [B, MM + 3], with the
    per-species values the closed-form Jacobian needs."""
    MM = tm.MM
    lam, ln_n, lnT, lnP = z[:, :MM], z[:, MM], z[:, MM + 1], z[:, MM + 2]
    T = torch.exp(lnT)
    P = torch.exp(lnP)
    cp_R, h_RT, s_R = thermo.nasa7(tm, T)
    dlnP = (lnP - _LN_P_ATM)[:, None]
    ln_x_raw = lam @ tm.ncf.T - (h_RT - s_R) - dlnP
    ln_x = _soft_clip(ln_x_raw, -75.0, 40.0)
    x = torch.exp(ln_x)
    nbar = torch.exp(ln_n)
    N = nbar[:, None] * x
    RT = (R_GAS * T)[:, None]
    H = h_RT * RT
    Cp = cp_R * R_GAS
    h = (N * H).sum(-1)
    sum_x = x.sum(-1)
    u = h - nbar * R_GAS * T * sum_x
    S = (s_R - torch.clamp(ln_x, -85.0, 0.0) - dlnP) * R_GAS
    s = (N * S).sum(-1)
    cp = (N * Cp).sum(-1)
    v = nbar * R_GAS * T / P
    return dict(T=T, P=P, x=x, ln_x=ln_x, nbar=nbar, N=N, h=h, u=u, s=s,
                cp=cp, v=v, sum_x=sum_x, H=H, Cp=Cp, S=S, cp_R=cp_R,
                h_RT=h_RT, sc=_soft_clip_slope(ln_x_raw, -75.0, 40.0))


def _constraint(kind, p, target, dp=None):
    """Scaled residual of one thermodynamic constraint [B] and, with the
    derivatives ``dp`` of the properties ([B, n] each), its row [B, n]."""
    T = p["T"]
    cp = torch.clamp(p["cp"], min=_TINY)
    d = None
    if kind == CON_T:
        r = torch.log(T) - torch.log(target)
        if dp is not None:
            d = dp["lnT"]
    elif kind == CON_P:
        r = torch.log(p["P"]) - torch.log(target)
        if dp is not None:
            d = dp["lnP"]
    elif kind == CON_V:
        r = torch.log(torch.clamp(p["v"], min=_TINY)) - torch.log(target)
        if dp is not None:
            d = (p["v"] > _TINY).to(T.dtype)[:, None] * dp["lnv"]
    elif kind == CON_H:
        cT = cp * T
        r = (p["h"] - target) / cT
        if dp is not None:
            dcp = (p["cp"] > _TINY).to(T.dtype)[:, None] * dp["cp"]
            d = (dp["h"] / cT[:, None] - ((p["h"] - target) / (cT * cT))[:, None]
                 * (dcp * T[:, None] + cT[:, None] * dp["lnT"]))
    elif kind == CON_U:
        a = cp - p["nbar"] * R_GAS
        cv = torch.maximum(a, 0.1 * cp)
        cvT = cv * T
        r = (p["u"] - target) / cvT
        if dp is not None:
            dcp = (p["cp"] > _TINY).to(T.dtype)[:, None] * dp["cp"]
            dcv = torch.where((a > 0.1 * cp)[:, None],
                              dcp - (R_GAS * p["nbar"])[:, None] * dp["ln_n"],
                              0.1 * dcp)
            d = (dp["u"] / cvT[:, None] - ((p["u"] - target) / (cvT * cvT))[:, None]
                 * (dcv * T[:, None] + cvT[:, None] * dp["lnT"]))
    elif kind == CON_S:
        r = (p["s"] - target) / cp
        if dp is not None:
            dcp = (p["cp"] > _TINY).to(T.dtype)[:, None] * dp["cp"]
            d = dp["s"] / cp[:, None] - ((p["s"] - target) / (cp * cp))[:, None] * dcp
    else:
        raise ValueError(f"unknown constraint {kind!r}")
    return r, d


class _System(NamedTuple):
    """A lane's residual system: the constraint pair and targets, and the
    element balance's effective abundances and row scales [B, MM]."""
    cons: tuple
    t1: Any
    t2: Any
    b_eff: Any
    b_scale: Any


def _residual(tm, p, sys):
    """The residual [B, n] at the properties ``p``: MM element balances,
    ln(sum x), and the two constraint rows."""
    r_el = ((p["N"] @ tm.ncf) - sys.b_eff) / sys.b_scale
    r_norm = torch.log(torch.clamp(p["sum_x"], min=_TINY))
    r1, _ = _constraint(sys.cons[0], p, sys.t1)
    r2, _ = _constraint(sys.cons[1], p, sys.t2)
    return torch.cat([r_el, torch.stack([r_norm, r1, r2], dim=1)], dim=1)


def resid_jac(tm, z, sys: _System):
    """(r [B, n], J [B, n, n]) with J the closed-form d r / d z."""
    MM = tm.MM
    n = MM + 3
    B = z.shape[0]
    p = _mixture_props(tm, z)
    r = _residual(tm, p, sys)
    sc, N, x = p["sc"], p["N"], p["x"]
    KK = x.shape[1]
    # d ln x_k / d z [B, KK, n]
    dlnx = torch.cat([sc[:, :, None] * tm.ncf[None],
                      torch.zeros(B, KK, 1, dtype=z.dtype, device=z.device),
                      (sc * p["h_RT"])[:, :, None], -sc[:, :, None]], dim=2)
    e = torch.eye(n, dtype=z.dtype, device=z.device)
    e_n, e_T, e_P = e[MM], e[MM + 1], e[MM + 2]
    dN = N[:, :, None] * (dlnx + e_n)
    dx = x[:, :, None] * dlnx
    T = p["T"]
    RT = (R_GAS * T)[:, None]
    dh = ((dN * p["H"][:, :, None]).sum(1)
          + (N * p["cp_R"] * RT).sum(-1)[:, None] * e_T)
    dcpR = thermo.dcp_R_dT(tm, T)
    dcp = ((dN * p["Cp"][:, :, None]).sum(1)
           + (N * dcpR * RT).sum(-1)[:, None] * e_T)
    inside = ((p["ln_x"] > -85.0) & (p["ln_x"] < 0.0)).to(z.dtype)
    ds = ((dN * p["S"][:, :, None]).sum(1)
          + R_GAS * ((N * p["cp_R"]).sum(-1)[:, None] * e_T
                     - ((N * inside)[:, :, None] * dlnx).sum(1)
                     - N.sum(-1)[:, None] * e_P))
    dsum_x = dx.sum(1)
    du = dh - (R_GAS * p["nbar"] * T)[:, None] * (
        p["sum_x"][:, None] * (e_n + e_T) + dsum_x)
    dp = dict(h=dh, cp=dcp, s=ds, u=du, lnT=e_T.expand(B, n),
              lnP=e_P.expand(B, n), ln_n=e_n.expand(B, n),
              lnv=(e_n + e_T - e_P).expand(B, n))
    J_el = torch.einsum("km,bkj->bmj", tm.ncf, dN) / sys.b_scale[:, :, None]
    i_sum = (p["sum_x"] > _TINY).to(z.dtype)[:, None]
    J_norm = dsum_x / p["sum_x"][:, None] * i_sum
    _, J1 = _constraint(sys.cons[0], p, sys.t1, dp)
    _, J2 = _constraint(sys.cons[1], p, sys.t2, dp)
    return r, torch.cat([J_el, torch.stack([J_norm, J1, J2], dim=1)], dim=1)


def _newton(tm, z, sys, n_iter, unstable, fault=None):
    """``n_iter`` damped Newton iterations from z (no early exit); returns
    z and the last iteration's ``unstable`` flag. ``fault`` [B] bool: the
    lanes an injected ``linalg_unstable`` fault poisons."""
    MM = tm.MM
    n = MM + 3
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    lo_T, hi_T = math.log(150.0), math.log(6000.0)
    lo_P, hi_P = math.log(1e-2), math.log(1e12)
    for _ in range(n_iter):
        r, J = resid_jac(tm, z, sys)
        J = torch.where(torch.isfinite(J), J, torch.zeros_like(J)) + 1e-12 * eye
        r = torch.where(torch.isfinite(r), r, torch.full_like(r, 1e3))
        dz, unstable = linalg.solve_with_info(J, -r, row_equilibrate=True,
                                              fault_mask=fault)
        dz = torch.where(torch.isfinite(dz), dz, torch.zeros_like(dz))
        mx = dz.abs().amax(-1)
        alpha = torch.clamp(8.0 / torch.clamp(mx, min=_TINY), max=1.0)
        alpha = torch.minimum(alpha, 0.3 / torch.clamp(dz[:, MM + 1].abs(),
                                                       min=_TINY))
        alpha = torch.minimum(alpha, 0.5 / torch.clamp(dz[:, MM + 2].abs(),
                                                       min=_TINY))
        z = z + alpha[:, None] * dz
        z = torch.cat([z[:, :MM + 1], torch.clamp(z[:, MM + 1:MM + 2], lo_T, hi_T),
                       torch.clamp(z[:, MM + 2:], lo_P, hi_P)], dim=1)
    return z, unstable


def _solve(tm, b, con1, con2, target1, target2, T_init, P_init, X_init,
           n_iter=_N_ITER, n_pre=_N_PRE, fault=None) -> EquilibriumResult:
    """The reference's ``_solve`` on every lane: least-squares start,
    ``n_pre`` composition-only iterations at the initial (T, P) (none for
    the (T, P) pair), ``n_iter`` iterations on the full system; ``fault``
    as :func:`_newton`'s, in both phases."""
    MM = tm.MM
    B = b.shape[0]
    b_tot = torch.clamp(b.sum(-1), min=_TINY)
    b_eff = torch.maximum(b, 1e-25 * b_tot[:, None])
    b_scale = torch.maximum(b_eff, 1e-6 * b_tot[:, None])

    T0 = torch.clamp(T_init, 250.0, 5500.0)
    lnT0 = torch.log(T0)
    lnP0 = torch.log(P_init)
    x0 = torch.clamp(X_init, min=1e-10)
    x0 = x0 / x0.sum(-1, keepdim=True)
    ghat = thermo.g_RT(tm, T0) + (lnP0 - _LN_P_ATM)[:, None]
    t_k = ghat + torch.log(x0)
    W = torch.clamp(x0, min=0.01)
    eye = torch.eye(MM, dtype=b.dtype, device=b.device)
    AtWA = torch.einsum("km,bk,kl->bml", tm.ncf, W, tm.ncf) + 1e-8 * eye
    AtWt = (W * t_k) @ tm.ncf
    lu, perm = linalg.lu_pivot(AtWA)
    lam0 = linalg.solve_pivot(lu, perm, AtWt)
    ln_n0 = torch.log(torch.clamp(b_tot, min=_TINY))
    z = torch.cat([lam0, torch.stack([ln_n0, lnT0, lnP0], dim=1)], dim=1)

    unstable = torch.zeros(B, dtype=torch.bool, device=b.device)
    if n_pre > 0 and not (con1 == CON_T and con2 == CON_P):
        pre = _System((CON_T, CON_P), torch.exp(lnT0), P_init, b_eff, b_scale)
        z, unstable = _newton(tm, z, pre, n_pre, unstable, fault)
    sys = _System((con1, con2), target1, target2, b_eff, b_scale)
    z, unstable = _newton(tm, z, sys, n_iter, unstable, fault)

    p = _mixture_props(tm, z)
    r_fin = _residual(tm, p, sys)
    rnorm = torch.sqrt((r_fin * r_fin).mean(-1))
    x = p["x"] / torch.clamp(p["sum_x"], min=_TINY)[:, None]
    x = torch.where(x < _X_FLOOR, torch.zeros_like(x), x)
    x = x / torch.clamp(x.sum(-1), min=_TINY)[:, None]
    wbar = (x * tm.wt).sum(-1)
    Y = x * tm.wt / torch.clamp(wbar, min=_TINY)[:, None]
    converged = rnorm < 1e-7
    status = _status(converged, rnorm, unstable)
    return EquilibriumResult(T=p["T"], P=p["P"], X=x, Y=Y, nbar=p["nbar"],
                             h=p["h"], u=p["u"], s=p["s"], v=p["v"],
                             residual=rnorm, converged=converged,
                             status=status)


def _status(converged, rnorm, unstable):
    def code(s):
        return torch.full_like(rnorm, int(s), dtype=torch.int32)
    return torch.where(
        converged, code(SolveStatus.OK),
        torch.where(~torch.isfinite(rnorm), code(SolveStatus.NONFINITE),
                    torch.where(unstable, code(SolveStatus.LINALG_UNSTABLE),
                                code(SolveStatus.TOL_NOT_MET))))


def initial_state(tm, T, P, Y, option):
    """(Y normalised, b, targets by constraint, T_init, X0) of
    ``equilibrate``: the constraint targets are the initial state's."""
    con1, con2 = EQ_OPTIONS[int(option)]
    Y = Y / torch.clamp(Y.sum(-1), min=_TINY)[:, None]
    b = element_moles(tm, Y)
    wbar0 = thermo.mean_molecular_weight_Y(tm, Y)
    X0 = thermo.Y_to_X(tm, Y)
    targets = {CON_T: T, CON_P: P, CON_V: R_GAS * T / (P * wbar0),
               CON_H: thermo.mixture_enthalpy_mass(tm, T, Y),
               CON_U: thermo.mixture_internal_energy_mass(tm, T, Y),
               CON_S: thermo.mixture_entropy_molar(tm, T, P, X0) / wbar0}
    if CON_H in (con1, con2) or CON_U in (con1, con2):
        T_init = torch.clamp(T, min=2200.0)
    else:
        T_init = T
    return Y, b, targets, T_init, X0


def equilibrate_plain(tm, T, P, Y, option=1, n_iter=_N_ITER, fault=None):
    """Equilibrium of every lane holding the pair of state variables of
    ``option`` (1-9) at their initial-state values: the plain twin of
    kernel K6. T, P [B]; Y [B, KK]; ``fault`` [B] bool: the lanes an
    injected ``linalg_unstable`` fault poisons (as the reference, the
    nested options' final solve only)."""
    con1, con2 = EQ_OPTIONS[int(option)]
    Y, b, targets, T_init, X0 = initial_state(tm, T, P, Y, option)
    if not is_nested(option):
        return _solve(tm, b, con1, con2, targets[con1], targets[con2],
                      T_init, P, X0, n_iter=n_iter, fault=fault)
    # (P, S) and (V, S): quasi-Newton on ln T around (T, P/V) solves
    s_target, mech_target = targets[CON_S], targets[con1]
    lnT, P_ws, X_ws = torch.log(T_init), P, X0
    lo, hi = math.log(200.0), math.log(5800.0)
    for _ in range(NEST_OUTER):
        Tn = torch.exp(lnT)
        res = _solve(tm, b, CON_T, con1, Tn, mech_target, Tn, P_ws, X_ws,
                     n_iter=NEST_INNER[0], n_pre=NEST_INNER[1])
        cp = torch.clamp(thermo.mixture_cp_mass(tm, res.T, res.Y), min=_TINY)
        dlnT = torch.clamp((s_target - res.s) / cp, -0.4, 0.4)
        lnT = torch.clamp(lnT + dlnT, lo, hi)
        P_ws, X_ws = res.P, res.X
    Tf = torch.exp(lnT)
    res = _solve(tm, b, CON_T, con1, Tf, mech_target, Tf, P_ws, X_ws,
                 n_iter=NEST_FINAL[0], n_pre=NEST_FINAL[1], fault=fault)
    cp = torch.clamp(thermo.mixture_cp_mass(tm, res.T, res.Y), min=_TINY)
    s_ok = (res.s - s_target).abs() / cp < 1e-7
    status = torch.where((res.status == int(SolveStatus.OK)) & ~s_ok,
                         torch.full_like(res.status,
                                         int(SolveStatus.TOL_NOT_MET)),
                         res.status)
    return res._replace(converged=res.converged & s_ok, status=status)


@torch.inference_mode()
def equilibrate(mech, T, P, Y, option=1, *, n_iter=_N_ITER, elem_ids=None,
                fault_level=0, device=None):
    """Equilibrium of each lane from its initial state (T in K, P in
    dyne/cm^2, mass fractions Y), holding the pair of state variables of
    ``option`` (the reference's EQOption 1-9) at their initial values.
    T and P are scalars or [B], Y is [KK] or [B, KK]; returns an
    :class:`EquilibriumResult` of [B] lanes. ``elem_ids`` [B] (the
    reference's ``fault_elem`` per lane) and ``fault_level`` thread fault
    injection: a lane a ``linalg_unstable`` spec poisons at that rescue
    level gets garbage Newton directions flagged unstable.

    Runs on ``cuda`` unless ``device`` names another device: on the card
    the whole solve is one launch of kernel K6 (``kernels.equil_solve``;
    its FAULT instantiation where a lane is poisoned); on the CPU its twin
    :func:`equilibrate_plain`."""
    dev = resolve_device(device)
    tm = as_torch_mechanism(mech, dev)
    B, lanes = broadcast_lanes(dev, dict(T=T, P=P), dict(Y=Y))
    fault = None
    if elem_ids is not None:
        fault = faultinject.unstable_mask(
            torch.as_tensor(elem_ids, device=dev).reshape(B),
            int(fault_level))
    return kernels.equil_solve(tm, lanes["T"], lanes["P"], lanes["Y"],
                               int(option), int(n_iter), fault=fault)
