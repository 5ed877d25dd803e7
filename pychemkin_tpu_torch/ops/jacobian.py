"""Closed-form kinetics Jacobian and the fused (f, J) of the four batch
reactors CONP/CONV x ENRG/TGIV, batch-first (plain PyTorch twins of
kernel K2).

Counterpart of the JAX package's ``ops/jacobian.py``:
``kinetics_derivatives`` on the staged sparse path (with the
fractional-order floor patches and, where P is rebuilt from C, the
dP/dC = RT and dP/dT = sum(C) R chain terms), the rate-constant
derivatives of ``_rate_constant_derivatives`` and the four branches of
``_batch_jac_core(..., with_rhs=True)``. Where the reference takes the
falloff blend's d/dT and d/d[M], and the PLOG rows' d/dT and d/dP, with
a two-wide ``jacfwd``, this module writes the derivatives out in closed
form (the CUDA kernel needs them so), with the same clamp indicators AD
propagates: 0 where a ``clip``/floor is active, 1 inside.

Shapes: T [B], C [B, KK], y [B, N] with N = KK + 1, J [B, N, N].
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..constants import R_GAS
from ..mechanism.record import FALLOFF_SRI, FALLOFF_TROE
from . import kinetics, thermo
from .kinetics import _LN10, _TINY, _arrhenius, _ind, _safe_exp

#: temperature floor of the RHS state split (reference T_FLOOR)
T_FLOOR = 50.0


def _arrhenius_dT(A, beta, Ea_R, T, lnT, k):
    """d/dT of :func:`kinetics._arrhenius` given its value ``k`` [B, n]."""
    T = T[:, None]
    arg = (torch.log(torch.clamp(torch.abs(A), min=_TINY))
           + beta * lnT[:, None] - Ea_R / T)
    return k * (beta / T + Ea_R / (T * T)) * _ind(arg)


def falloff_blend_derivs(T, lnT, M, ki, dki, k0, dk0, ftype, is_chem_act,
                         troe, sri):
    """d/dT and d/d[M] of :func:`kinetics.falloff_blend` on the falloff
    rows, in closed form: ``ki``/``k0`` are the high- and low-pressure
    Arrhenius values, ``dki``/``dk0`` their T-derivatives, all [B, nf]."""
    Tc = T[:, None]
    lnTc = lnT[:, None]
    kic = torch.clamp(ki, min=_TINY)
    i_ki = (ki > _TINY).to(ki.dtype)
    raw = k0 * M / kic
    Pr = torch.clamp(raw, min=1e-35)
    i_pr = (raw > 1e-35).to(ki.dtype)
    dPr_T = i_pr * M * (dk0 * kic - k0 * i_ki * dki) / (kic * kic)
    dPr_M = i_pr * k0 / kic
    lP = torch.log(Pr) / _LN10
    dlP_T = dPr_T / (Pr * _LN10)
    dlP_M = dPr_M / (Pr * _LN10)

    # Troe broadening
    a, T3, T1, T2 = troe[:, 0], troe[:, 1], troe[:, 2], troe[:, 3]
    has_T2 = torch.isfinite(T2)
    T2s = torch.where(has_T2, T2, torch.zeros_like(T2))
    x2 = -T2s / Tc
    term2 = torch.where(has_T2, _safe_exp(x2), torch.zeros_like(x2))
    dterm2 = torch.where(has_T2, term2 * (T2s / (Tc * Tc)) * _ind(x2),
                         torch.zeros_like(x2))
    T3c = torch.clamp(T3, min=1e-30)
    T1c = torch.clamp(T1, min=1e-30)
    x3 = -Tc / T3c
    x1 = -Tc / T1c
    e3 = _safe_exp(x3)
    e1 = _safe_exp(x1)
    Fraw = (1.0 - a) * e3 + a * e1 + term2
    dFraw = ((1.0 - a) * e3 * (-1.0 / T3c) * _ind(x3)
             + a * e1 * (-1.0 / T1c) * _ind(x1) + dterm2)
    Fc = torch.clamp(Fraw, min=1e-30)
    dFc = (Fraw > 1e-30).to(Fc.dtype) * dFraw
    L = torch.log(Fc) / _LN10
    dL = dFc / (Fc * _LN10)
    c_t = -0.4 - 0.67 * L
    n_t = 0.75 - 1.27 * L
    x = lP + c_t
    den = n_t - 0.14 * x
    f1 = x / den
    s = 1.0 + f1 * f1
    lF = L / s
    argF = _LN10 * lF
    Ft = _safe_exp(argF)
    gF = Ft * _LN10 * _ind(argF)

    def troe_d(dlP, dLx):
        dx = dlP - 0.67 * dLx
        dden = -1.27 * dLx - 0.14 * dx
        df1 = (dx * den - x * dden) / (den * den)
        return gF * (dLx / s - L * 2.0 * f1 * df1 / (s * s))

    dFt_T = troe_d(dlP_T, dL)
    dFt_M = troe_d(dlP_M, torch.zeros_like(dL))

    # SRI broadening
    sa, sb, sc, sd, se = (sri[:, 0], sri[:, 1], sri[:, 2], sri[:, 3],
                          sri[:, 4])
    q = 1.0 + lP * lP
    xs = 1.0 / q
    xb = -sb / Tc
    eb = _safe_exp(xb)
    scc = torch.clamp(sc, min=1e-30)
    xc = -Tc / scc
    ec = _safe_exp(xc)
    braw = sa * eb + ec
    base = torch.clamp(braw, min=_TINY)
    dbase = (braw > _TINY).to(base.dtype) * (
        sa * eb * (sb / (Tc * Tc)) * _ind(xb) + ec * (-1.0 / scc) * _ind(xc))
    lb = torch.log(base)
    a1 = xs * lb
    s1 = _safe_exp(a1)
    a2 = se * lnTc
    s2 = _safe_exp(a2)
    Fs = sd * s1 * s2

    def sri_d(dlP, dlb, da2):
        dxs = -2.0 * lP * dlP / (q * q)
        ds1 = s1 * _ind(a1) * (dxs * lb + xs * dlb)
        ds2 = s2 * _ind(a2) * da2
        return sd * (ds1 * s2 + s1 * ds2)

    dFs_T = sri_d(dlP_T, dbase / base, se / Tc)
    dFs_M = sri_d(dlP_M, torch.zeros_like(lb), torch.zeros_like(lb))

    is_troe = ftype == FALLOFF_TROE
    is_sri = ftype == FALLOFF_SRI
    one = torch.ones_like(Ft)
    zero = torch.zeros_like(Ft)
    F = torch.where(is_troe, Ft, torch.where(is_sri, Fs, one))
    dF_T = torch.where(is_troe, dFt_T, torch.where(is_sri, dFs_T, zero))
    dF_M = torch.where(is_troe, dFt_M, torch.where(is_sri, dFs_M, zero))

    chem = is_chem_act != 0
    opr = 1.0 + Pr
    bl = torch.where(chem, k0 / opr, ki * Pr / opr)
    dbl_T = torch.where(chem, dk0 / opr - k0 * dPr_T / (opr * opr),
                        dki * Pr / opr + ki * dPr_T / (opr * opr))
    dbl_M = torch.where(chem, -k0 * dPr_M / (opr * opr),
                        ki * dPr_M / (opr * opr))
    return dbl_T * F + bl * dF_T, dbl_M * F + bl * dF_M


class RateConstDerivs(NamedTuple):
    """d(kf)/dT, d(kf)/d[M], d(kr)/dT, d(kr)/d[M], [B, II] each (the [M]
    derivatives are the diagonal d k_i / d M_i), and d(kf)/dP, d(kr)/dP
    (nonzero on PLOG rows only; None without PLOG rows)."""
    dkf_dT: Any
    dkf_dM: Any
    dkr_dT: Any
    dkr_dM: Any
    dkf_dP: Any = None
    dkr_dP: Any = None


def rate_constant_derivatives(tm, T, M, kf, nasa=None,
                              P=None) -> RateConstDerivs:
    """Closed-form derivatives of (kf, kr) wrt (T, [M], P), branch by
    branch as the primal ladder of :mod:`.kinetics`; ``nasa`` is
    :func:`thermo.nasa7` at T when the caller has it, ``P`` [B] the
    pressure the PLOG rows read."""
    lnT = torch.log(T)
    k_inf = _arrhenius(tm.A, tm.beta, tm.Ea_R, T, lnT)
    dkf_dT = _arrhenius_dT(tm.A, tm.beta, tm.Ea_R, T, lnT, k_inf)
    dkf_dM = torch.zeros_like(kf)
    if tm.fo_rows.numel():
        fo = tm.ix("fo_rows")
        k0 = _arrhenius(tm.fo_lowA, tm.fo_lowb, tm.fo_lowE, T, lnT)
        dk0 = _arrhenius_dT(tm.fo_lowA, tm.fo_lowb, tm.fo_lowE, T, lnT, k0)
        dT_fo, dM_fo = falloff_blend_derivs(
            T, lnT, M[:, fo], k_inf[:, fo], dkf_dT[:, fo], k0, dk0,
            tm.fo_type, tm.fo_chem, tm.fo_troe, tm.fo_sri)
        dkf_dT[:, fo] = dT_fo
        dkf_dM[:, fo] = dM_fo
    dkf_dP = dkr_dP = None
    if tm.n_plog:
        pl = tm.ix("plog_idx")
        _, dT_pl, dP_pl = kinetics.plog_rate(tm, T, lnT, P, with_derivs=True)
        dkf_dT[:, pl] = dT_pl
        dkf_dM[:, pl] = 0.0
        dkf_dP = torch.zeros_like(kf)
        dkf_dP[:, pl] = dP_pl
        dkr_dP = torch.zeros_like(kf)

    dkr_dT = torch.zeros_like(kf)
    dkr_dM = torch.zeros_like(kf)
    if tm.rev_rows.numel():
        rev = tm.ix("rev_rows")
        ln_kc, dln_kc = kinetics.ln_kc_reversible(tm, T, nasa, with_dT=True)
        kf_rev = kf[:, rev]
        kf_cr = torch.clamp(kf_rev, min=_TINY)
        i_kfr = (kf_rev > _TINY).to(kf.dtype)
        ln_kr = torch.log(kf_cr) - ln_kc
        cg = _ind(ln_kr) * _safe_exp(ln_kr)
        dT_rev = cg * (i_kfr * dkf_dT[:, rev] / kf_cr - dln_kc)
        dM_rev = cg * i_kfr * dkf_dM[:, rev] / kf_cr
        kr_exp = _arrhenius(tm.rev_A, tm.rev_beta, tm.rev_Ea_R, T, lnT)
        dkr_exp = _arrhenius_dT(tm.rev_A, tm.rev_beta, tm.rev_Ea_R, T, lnT,
                                kr_exp)
        hasp = tm.rev_hasp != 0
        dkr_dT[:, rev] = torch.where(hasp, dkr_exp, dT_rev)
        dkr_dM[:, rev] = torch.where(hasp, torch.zeros_like(dM_rev), dM_rev)
        if dkf_dP is not None:
            dP_rev = cg * i_kfr * dkf_dP[:, rev] / kf_cr
            dkr_dP[:, rev] = torch.where(hasp, torch.zeros_like(dP_rev),
                                         dP_rev)
    return RateConstDerivs(dkf_dT=dkf_dT, dkf_dM=dkf_dM, dkr_dT=dkr_dT,
                           dkr_dM=dkr_dM, dkf_dP=dkf_dP, dkr_dP=dkr_dP)


class KineticsDerivatives(NamedTuple):
    """wdot [B, KK], dwdot/dC [B, KK, KK], dwdot/dT [B, KK]."""
    wdot: Any
    dwdot_dC: Any
    dwdot_dT: Any


def _dln(C, floor):
    """d ln max(C, floor) / dC: 1/C above the floor, 0 below it."""
    return torch.where(C > floor, 1.0 / torch.clamp(C, min=floor),
                       torch.zeros_like(C))


def kinetics_derivatives(tm, T, C, nasa=None, P=None) -> KineticsDerivatives:
    """Analytical (wdot, dwdot/dC, dwdot/dT): the triple-product segment
    sum into [KK, KK], the column scaling by d(lnC)/dC (by the floored
    d(lnC)/dC on fractional-order entries), and the third-body/falloff
    correction over the third-body rows. ``P`` as
    :func:`kinetics.rop_intermediates`: where it is rebuilt from C the
    PLOG rows add dP/dC_k = R T to every column and dP/dT = sum(C) R to
    the T derivative."""
    B, KK = C.shape
    r = kinetics.rop_intermediates(tm, T, C, nasa, P)
    dk = rate_constant_derivatives(tm, T, r.M, r.kf, nasa, r.P)
    qf_g = r.qf * _ind(r.arg_f)
    qr_g = r.qr * _ind(r.arg_r)
    dln = _dln(C, _TINY)
    dkf_dT, dkr_dT = dk.dkf_dT, dk.dkr_dT
    if r.P_from_C:
        dP_dT = (C.sum(-1) * R_GAS)[:, None]
        dkf_dT = dkf_dT + dk.dkf_dP * dP_dT
        dkr_dT = dkr_dT + dk.dkr_dP * dP_dT
    dq_dT = r.tb_mult * (dkf_dT * r.prod_f - dkr_dT * r.prod_r)

    rx = tm.ix("jac_rxn")
    seg = tm.ix("jac_seg")
    vf = qf_g[:, rx] * tm.jac_cf
    vr = qr_g[:, rx] * tm.jac_cr
    if tm.any_frac:
        ff, rf = tm.jac_ff != 0, tm.jac_rf != 0
        zero = torch.zeros_like(vf)
        lo = torch.where(ff, zero, vf) - torch.where(rf, zero, vr)
        hi = torch.where(ff, vf, zero) - torch.where(rf, vr, zero)
        D = (kinetics._seg_sum(lo, seg, KK * KK).reshape(B, KK, KK)
             * dln[:, None, :]
             + kinetics._seg_sum(hi, seg, KK * KK).reshape(B, KK, KK)
             * _dln(C, kinetics.FRAC_ORDER_FLOOR)[:, None, :])
    else:
        D = kinetics._seg_sum(vf - vr, seg, KK * KK).reshape(B, KK, KK)
        D = D * dln[:, None, :]
    w_T = kinetics._nu_T_contract(tm, dq_dT)
    if tm.tb_rows.numel():
        tb = tm.ix("tb_rows")
        G = (torch.where(tm.plain_tb[tb], r.kf[:, tb] * r.prod_f[:, tb]
                         - r.kr[:, tb] * r.prod_r[:, tb],
                         torch.zeros_like(r.kf[:, tb]))
             + r.tb_mult[:, tb] * (dk.dkf_dM[:, tb] * r.prod_f[:, tb]
                                   - dk.dkr_dM[:, tb] * r.prod_r[:, tb]))
        D = D + (tm.nu[tb].T[None] * G[:, None, :]) @ tm.tb_eff
    if r.P_from_C:
        vP = kinetics._nu_T_contract(
            tm, r.tb_mult * (dk.dkf_dP * r.prod_f - dk.dkr_dP * r.prod_r))
        D = D + vP[:, :, None] * (R_GAS * T)[:, None, None]
    wdot = kinetics._nu_T_contract(tm, r.qf - r.qr)
    return KineticsDerivatives(wdot=wdot, dwdot_dC=D, dwdot_dT=w_T)


def _conp_species(tm, Y, T, P):
    """The CONP species block at (Y, T, P): (C, nasa, kinetics
    derivatives, rho, dY/dt, D C, rw = (Wbar/W_j) i_s, J_YY), with
    C = rho(T, P, Y) Y / W."""
    wt = tm.wt
    rho = thermo.density(tm, T, P, Y)
    C = thermo.Y_to_C(tm, Y, rho)
    nasa = thermo.nasa7(tm, T)
    d = kinetics_derivatives(tm, T, C, nasa, P)
    rho_ = rho[:, None]
    dYdt = d.wdot * wt / rho_
    Wbar = thermo.mean_molecular_weight_Y(tm, Y)
    s = (Y / wt).sum(-1)
    i_s = (s > 1e-30).to(Y.dtype)
    rw = Wbar[:, None] / wt * i_s[:, None]
    DC = (d.dwdot_dC @ C[:, :, None])[..., 0]
    J_YY = (d.dwdot_dC * (wt[:, None] / wt[None, :])[None]
            + (dYdt - wt * DC / rho_)[:, :, None] * rw[:, None, :])
    return C, nasa, d, rho, dYdt, DC, rw, J_YY


def _assemble(J_YY, J_YT, J_TY, J_TT, dYdt, dTdt):
    """(f, J) from the species and T blocks."""
    top = torch.cat([J_YY, J_YT[:, :, None]], dim=2)
    bot = torch.cat([J_TY, J_TT[:, None]], dim=1)[:, None, :]
    return (torch.cat([dYdt, dTdt[:, None]], dim=1),
            torch.cat([top, bot], dim=1))


def conp_enrg_rhs_jac(tm, y, P):
    """Fused CONP/ENRG (f, J) for an adiabatic constant-pressure reactor:
    ``y`` [B, N] = [Y, T], ``P`` [B] in dyne/cm^2. The exact chain rule
    of the RHS, with the T-floor indicator on the T column."""
    KK = tm.KK
    wt = tm.wt
    Y = y[:, :KK]
    T = torch.clamp(y[:, KK], min=T_FLOOR)
    mT = (y[:, KK] > T_FLOOR).to(y.dtype)
    C, nasa, d, rho, dYdt, DC, rw, J_YY = _conp_species(tm, Y, T, P)
    wdot, D, w_T = d.wdot, d.dwdot_dC, d.dwdot_dT
    rho_ = rho[:, None]
    T_ = T[:, None]
    dw_dT = w_T - DC / T_
    J_YT = (wt / rho_) * dw_dT + dYdt / T_

    cpk = nasa[0] * R_GAS / wt
    cp = (Y * cpk).sum(-1)
    h = nasa[1] * (R_GAS * T_)
    cp_molar = nasa[0] * R_GAS
    hD = (h[:, None, :] @ D)[:, 0, :]
    hDC = (h * DC).sum(-1)
    hw = (h * wdot).sum(-1)
    dTdt = (-hw / rho) / cp
    dN_dY = (-hw + hDC)[:, None] * rw / rho_ - hD / wt
    J_TY = dN_dY / cp[:, None] - dTdt[:, None] * cpk / cp[:, None]
    dN_dT = (-((cp_molar * wdot).sum(-1) + (h * dw_dT).sum(-1)) / rho
             - hw / (rho * T))
    dcp_dT = (Y * (thermo.dcp_R_dT(tm, T) * R_GAS / wt)).sum(-1)
    J_TT = (dN_dT - dTdt * dcp_dT) / cp
    return _assemble(J_YY, J_YT * mT[:, None], J_TY, J_TT * mT, dYdt, dTdt)


def conv_enrg_rhs_jac(tm, y, rho):
    """Fused CONV/ENRG (f, J) for an adiabatic reactor at the fixed
    density ``rho`` [B] g/cm^3 (unit volume, constant mass): the CONV
    branch of the reference's chain rule. C = rho Y / W does not depend
    on T, so J_YY = D (W_i / W_j) and J_YT = (W / rho) dwdot/dT; the T row
    uses cv and the molar internal energies u = (h/RT - 1) R T (the
    P dV/dt work term vanishes at constant volume). PLOG rows read
    P = sum(C) R T."""
    KK = tm.KK
    wt = tm.wt
    Y = y[:, :KK]
    T = torch.clamp(y[:, KK], min=T_FLOOR)
    mT = (y[:, KK] > T_FLOOR).to(y.dtype)
    C = thermo.Y_to_C(tm, Y, rho)
    nasa = thermo.nasa7(tm, T)
    d = kinetics_derivatives(tm, T, C, nasa)
    wdot, D, w_T = d.wdot, d.dwdot_dC, d.dwdot_dT
    rho_ = rho[:, None]
    dYdt = wdot * wt / rho_
    J_YY = D * (wt[:, None] / wt[None, :])[None]
    J_YT = (wt / rho_) * w_T

    cv_molar = thermo.cv_R(tm, T, nasa) * R_GAS
    cvk = cv_molar / wt
    cv = thermo.mixture_cv_mass(tm, T, Y, nasa)
    u = thermo.u_RT(tm, T, nasa) * (R_GAS * T[:, None])
    uD = (u[:, None, :] @ D)[:, 0, :]
    uw = (u * wdot).sum(-1)
    dTdt = (-uw / rho) / cv
    J_TY = (-uD / wt) / cv[:, None] - dTdt[:, None] * cvk / cv[:, None]
    dN_dT = -((cv_molar * wdot).sum(-1) + (u * w_T).sum(-1)) / rho
    dcv_dT = (Y * (thermo.dcp_R_dT(tm, T) * R_GAS / wt)).sum(-1)
    J_TT = (dN_dT - dTdt * dcv_dT) / cv
    return _assemble(J_YY, J_YT * mT[:, None], J_TY, J_TT * mT, dYdt, dTdt)


def _tgiv(J_YY, dYdt):
    """(f, J) of a TGIV reactor: T follows its profile (constant in a
    sweep), so f_T = 0 and J's T row and column are zero."""
    z = torch.zeros_like(dYdt)
    zb = torch.zeros_like(dYdt[:, 0])
    return _assemble(J_YY, z, z, zb, dYdt, zb)


def conp_tgiv_rhs_jac(tm, y, P):
    """Fused CONP/TGIV (f, J): T is the state's own T entry (held at T0 by
    its zero rate, the sweep's constant profile, read without the 50 K
    floor as the reference reads its profile), the species block as
    CONP/ENRG at (T, P)."""
    KK = tm.KK
    _, _, _, _, dYdt, _, _, J_YY = _conp_species(tm, y[:, :KK], y[:, KK], P)
    return _tgiv(J_YY, dYdt)


def conv_tgiv_rhs_jac(tm, y, rho):
    """Fused CONV/TGIV (f, J): the species block of CONV/ENRG at the
    state's T and the fixed density; PLOG rows read P = sum(C) R T."""
    KK = tm.KK
    wt = tm.wt
    Y, T = y[:, :KK], y[:, KK]
    C = thermo.Y_to_C(tm, Y, rho)
    d = kinetics_derivatives(tm, T, C, thermo.nasa7(tm, T))
    dYdt = d.wdot * wt / rho[:, None]
    return _tgiv(d.dwdot_dC * (wt[:, None] / wt[None, :])[None], dYdt)


def _profiles(args, t):
    """The profile terms of the reference's _batch_jac_core at the lanes'
    times: the constraint's value and slope, the heat loss and area."""
    from . import reactors
    c, cdot = reactors.profile_value_slope(args.constraint, t)
    ql, _ = reactors.profile_value_slope(args.qloss, t)
    ar, _ = reactors.profile_value_slope(args.area, t)
    return c, cdot, ql, ar


def conp_enrg_rhs_jac_prf(tm, t, y, args):
    """Fused CONP/ENRG (f, J) with profiles (the PRF twin of K2): the
    adiabatic terms of :func:`conp_enrg_rhs_jac` at P(t), plus the wall
    heat q = (-qloss + htc area (tamb - T)) / m with dq/dT = -htc area / m
    and the Pdot/rho term with its +Pdot/(rho T) in dN/dT, as the
    reference's ``_batch_jac_core`` (ops/jacobian.py:644-666)."""
    KK = tm.KK
    wt = tm.wt
    Y = y[:, :KK]
    T = torch.clamp(y[:, KK], min=T_FLOOR)
    mT = (y[:, KK] > T_FLOOR).to(y.dtype)
    P, Pdot, ql, ar = _profiles(args, t)
    C, nasa, d, rho, dYdt, DC, rw, J_YY = _conp_species(tm, Y, T, P)
    wdot, D, w_T = d.wdot, d.dwdot_dC, d.dwdot_dT
    rho_ = rho[:, None]
    T_ = T[:, None]
    dw_dT = w_T - DC / T_
    J_YT = (wt / rho_) * dw_dT + dYdt / T_

    q = (-ql + args.htc * ar * (args.tamb - T)) / args.mass
    dq_dT = -args.htc * ar / args.mass
    cpk = nasa[0] * R_GAS / wt
    cp = (Y * cpk).sum(-1)
    h = nasa[1] * (R_GAS * T_)
    cp_molar = nasa[0] * R_GAS
    hD = (h[:, None, :] @ D)[:, 0, :]
    hDC = (h * DC).sum(-1)
    hw = (h * wdot).sum(-1)
    dTdt = (q + Pdot / rho - hw / rho) / cp
    dN_dY = (Pdot - hw + hDC)[:, None] * rw / rho_ - hD / wt
    J_TY = dN_dY / cp[:, None] - dTdt[:, None] * cpk / cp[:, None]
    dN_dT = (dq_dT + Pdot / (rho * T)
             - ((cp_molar * wdot).sum(-1) + (h * dw_dT).sum(-1)) / rho
             - hw / (rho * T))
    dcp_dT = (Y * (thermo.dcp_R_dT(tm, T) * R_GAS / wt)).sum(-1)
    J_TT = (dN_dT - dTdt * dcp_dT) / cp
    return _assemble(J_YY, J_YT * mT[:, None], J_TY, J_TT * mT, dYdt, dTdt)


def conv_enrg_rhs_jac_prf(tm, t, y, args):
    """Fused CONV/ENRG (f, J) with profiles (the PRF twin of K2):
    rho = mass / V(t); the T row gains q, dq/dT and the work term
    -P Vdot/m with dP/dY_j = rho R T / W_j and dP/dT = rho R sum(Y/W), as
    the reference's ``_batch_jac_core`` (ops/jacobian.py:667-689)."""
    KK = tm.KK
    wt = tm.wt
    Y = y[:, :KK]
    T = torch.clamp(y[:, KK], min=T_FLOOR)
    mT = (y[:, KK] > T_FLOOR).to(y.dtype)
    V, Vdot, ql, ar = _profiles(args, t)
    rho = args.mass / V
    C = thermo.Y_to_C(tm, Y, rho)
    nasa = thermo.nasa7(tm, T)
    d = kinetics_derivatives(tm, T, C, nasa)
    wdot, D, w_T = d.wdot, d.dwdot_dC, d.dwdot_dT
    rho_ = rho[:, None]
    T_ = T[:, None]
    dYdt = wdot * wt / rho_
    J_YY = D * (wt[:, None] / wt[None, :])[None]
    J_YT = (wt / rho_) * w_T

    q = (-ql + args.htc * ar * (args.tamb - T)) / args.mass
    dq_dT = -args.htc * ar / args.mass
    cv_molar = thermo.cv_R(tm, T, nasa) * R_GAS
    cvk = cv_molar / wt
    cv = thermo.mixture_cv_mass(tm, T, Y, nasa)
    u = thermo.u_RT(tm, T, nasa) * (R_GAS * T_)
    uD = (u[:, None, :] @ D)[:, 0, :]
    uw = (u * wdot).sum(-1)
    P = thermo.pressure(tm, T, rho, Y)
    s = (Y / wt).sum(-1)
    i_s = (s > 1e-30).to(Y.dtype)
    vm = Vdot / args.mass
    dTdt = (q - P * Vdot / args.mass - uw / rho) / cv
    dN_dY = (-vm[:, None] * rho_ * R_GAS * T_ * i_s[:, None] / wt
             - uD / wt)
    J_TY = dN_dY / cv[:, None] - dTdt[:, None] * cvk / cv[:, None]
    dP_dT = rho * R_GAS * s * i_s
    dN_dT = (dq_dT - vm * dP_dT
             - ((cv_molar * wdot).sum(-1) + (u * w_T).sum(-1)) / rho)
    dcv_dT = (Y * (thermo.dcp_R_dT(tm, T) * R_GAS / wt)).sum(-1)
    J_TT = (dN_dT - dTdt * dcv_dT) / cv
    return _assemble(J_YY, J_YT * mT[:, None], J_TY, J_TT * mT, dYdt, dTdt)


def _tgiv_prf(J_YY, dYdt, Tdot):
    """(f, J) of a TGIV reactor with a T(t) profile: f_T = dT/dt of the
    profile, J's T row and column zero."""
    z = torch.zeros_like(dYdt)
    zb = torch.zeros_like(dYdt[:, 0])
    return _assemble(J_YY, z, z, zb, dYdt, Tdot)


def conp_tgiv_rhs_jac_prf(tm, t, y, args):
    """Fused CONP/TGIV (f, J) with profiles: the species block of
    CONP/ENRG at T(t) and P(t), f_T = dT/dt of T(t)."""
    from . import reactors
    T, Tdot = reactors.profile_value_slope(args.tprof, t)
    P, _ = reactors.profile_value_slope(args.constraint, t)
    _, _, _, _, dYdt, _, _, J_YY = _conp_species(tm, y[:, :tm.KK], T, P)
    return _tgiv_prf(J_YY, dYdt, Tdot)


def conv_tgiv_rhs_jac_prf(tm, t, y, args):
    """Fused CONV/TGIV (f, J) with profiles: the species block at T(t)
    and rho = mass / V(t), f_T = dT/dt of T(t)."""
    from . import reactors
    wt = tm.wt
    T, Tdot = reactors.profile_value_slope(args.tprof, t)
    V, _ = reactors.profile_value_slope(args.constraint, t)
    rho = args.mass / V
    C = thermo.Y_to_C(tm, y[:, :tm.KK], rho)
    d = kinetics_derivatives(tm, T, C, thermo.nasa7(tm, T))
    dYdt = d.wdot * wt / rho[:, None]
    return _tgiv_prf(d.dwdot_dC * (wt[:, None] / wt[None, :])[None], dYdt,
                     Tdot)


def psr_rhs_jac(tm, y, args, mode, energy, *, scaled=False):
    """(f, J) of the transient PSR RHS (``scaled`` False: what the
    pseudo-transient phase integrates) or of the tau-scaled steady
    residual f tau (``scaled`` True: what the Newton solves), y [B, N],
    for ``mode`` "tau"/"vol" x ``energy`` "ENRG"/"TGIV"; ``args`` is an
    :class:`~.psr.PSRArgs` of [B] lanes.

    The chemistry is CONP's (:func:`conp_enrg_rhs_jac` at the lane's P;
    for TGIV at T_fixed). The flow shell adds (Y_in - Y)/tau to the
    species rows and (h_in - Y_in . h_k(T))/tau - Qloss/(rho V), over cp,
    to the T row, with their derivatives: -1/tau on the species diagonal,
    d(Y_in . h_k)/dT = Y_in . cp_k and d cp/d(Y, T) in the T row, and for
    "vol" mode the product rule through tau = rho V / mdot and
    rho(T, Y). TGIV has a zero T row and column."""
    from .psr import MODE_TAU, _TINY, tau_volume
    KK = tm.KK
    wt = tm.wt
    tgiv = energy == "TGIV"
    Y = y[:, :KK]
    if tgiv:
        T = args.T_fixed
        y_eval = torch.cat([Y, T[:, None]], dim=1)
        mT = torch.zeros_like(T)
    else:
        T = torch.clamp(y[:, KK], min=T_FLOOR)
        y_eval = y
        mT = (y[:, KK] > T_FLOOR).to(y.dtype)
    f, J = conp_enrg_rhs_jac(tm, y_eval, args.P)
    rho = thermo.density(tm, T, args.P, Y)
    tau, V = tau_volume(args, rho, mode)
    tau_c = torch.clamp(tau, min=_TINY)
    # d ln rho / d y [B, N]: rho = P Wbar / (R T)
    s = (Y / wt).sum(-1)
    Wbar = 1.0 / torch.clamp(s, min=1e-30)
    dlnrho = torch.cat([-(Wbar * (s > 1e-30).to(y.dtype))[:, None] / wt,
                        (-mT / T)[:, None]], dim=1)
    if mode == MODE_TAU:
        dtau = torch.zeros_like(dlnrho)
    else:
        dtau = ((tau > _TINY).to(y.dtype) * tau)[:, None] * dlnrho
    dY_flow = args.Y_in - Y
    f = f.clone()
    f[:, :KK] += dY_flow / tau_c[:, None]
    J = J.clone()
    J[:, :KK, :KK] -= torch.diag_embed((1.0 / tau_c)[:, None].expand(-1, KK))
    J[:, :KK, :] -= (dY_flow / (tau_c * tau_c)[:, None])[:, :, None] * dtau[:, None, :]
    if tgiv:
        f[:, KK] = 0.0
        J[:, KK, :] = 0.0
        J[:, :, KK] = 0.0
    else:
        nasa = thermo.nasa7(tm, T)
        h_k = thermo.species_enthalpy_mass(tm, T, nasa)
        cp_k = nasa[0] * R_GAS / wt
        cp = (Y * cp_k).sum(-1)
        h_in_term = args.h_in - (args.Y_in * h_k).sum(-1)
        rhoV = rho * V
        q = args.qloss / torch.clamp(rhoV, min=_TINY)
        F = h_in_term / tau_c - q
        f[:, KK] += F / cp
        dF = -(h_in_term / (tau_c * tau_c))[:, None] * dtau
        dF[:, KK] -= (args.Y_in * cp_k).sum(-1) * mT / tau_c
        if mode != MODE_TAU:
            dF += (q * (rhoV > _TINY).to(y.dtype))[:, None] * dlnrho
        dcp = torch.cat([cp_k, ((Y * thermo.dcp_R_dT(tm, T) * R_GAS / wt)
                                .sum(-1) * mT)[:, None]], dim=1)
        J[:, KK, :] += dF / cp[:, None] - (F / (cp * cp))[:, None] * dcp
    if not scaled:
        return f, J
    J = tau_c[:, None, None] * J + f[:, :, None] * dtau[:, None, :]
    return f * tau_c[:, None], J
