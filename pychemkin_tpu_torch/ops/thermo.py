"""NASA-7 thermodynamic properties, batch-first (plain PyTorch).

Counterpart of the JAX package's ``ops/thermo.py``. ``tm`` is a
:class:`~pychemkin_tpu_torch.mechanism.record.TorchMechanism`; T is
[B], mass fractions Y are [B, KK], species outputs are [B, KK]. Units
are CGS + mol + K. The CUDA kernels evaluate the same polynomials in
``kernels/csrc/chem.cuh``.
"""

from __future__ import annotations

import torch

from ..constants import P_ATM, R_GAS


def _select_coeffs(tm, T):
    """Per-lane, per-species NASA-7 coefficients: [B, KK, 7]."""
    low = (T[:, None] < tm.t_mid[None, :])[..., None]
    return torch.where(low, tm.nasa_lo[None], tm.nasa_hi[None])


def cp_R(tm, T):
    """Species molar heat capacity Cp/R, [B, KK]."""
    return nasa7(tm, T)[0]


def h_RT(tm, T):
    """Species molar enthalpy h/(RT), [B, KK]."""
    return nasa7(tm, T)[1]


def s_R(tm, T):
    """Species molar entropy s/R at standard pressure, [B, KK]."""
    return nasa7(tm, T)[2]


def g_RT(tm, T):
    """Species standard-state Gibbs energy g/(RT), [B, KK]."""
    _, h, s = nasa7(tm, T)
    return h - s


def nasa7(tm, T):
    """(cp/R, h/RT, s/R), each [B, KK], from one coefficient selection
    (power sums instead of Horner: fewer tensor operations)."""
    a = _select_coeffs(tm, T)
    Tc = T[:, None]
    p = torch.stack([torch.ones_like(T), T, T * T, T * T * T,
                     T * T * T * T], dim=-1)[:, None, :]      # [B, 1, 5]
    cp = (a[..., :5] * p).sum(-1)
    div = p.new_tensor([1.0, 1 / 2, 1 / 3, 1 / 4, 1 / 5])
    h = (a[..., :5] * (p * div)).sum(-1) + a[..., 5] / Tc
    s = (a[..., 0] * torch.log(Tc) + (a[..., 1:5] * (p[..., 1:] * div[:4]))
         .sum(-1) + a[..., 6])
    return cp, h, s


def cv_R(tm, T, nasa=None):
    """Species molar heat capacity Cv/R (ideal gas), [B, KK]; ``nasa`` is
    :func:`nasa7` at T where the caller already has it."""
    return (nasa7(tm, T) if nasa is None else nasa)[0] - 1.0


def u_RT(tm, T, nasa=None):
    """Species molar internal energy u/(RT), [B, KK]; ``nasa`` as in
    :func:`cv_R`."""
    return (nasa7(tm, T) if nasa is None else nasa)[1] - 1.0


def dcp_R_dT(tm, T):
    """d(Cp/R)/dT, [B, KK] (1/K)."""
    a = _select_coeffs(tm, T)
    T = T[:, None]
    return a[..., 1] + T * (2.0 * a[..., 2] + T * (3.0 * a[..., 3]
                                                   + T * 4.0 * a[..., 4]))


def species_enthalpy_mass(tm, T, nasa=None):
    """Species specific enthalpies h_k / W_k, erg/g, [B, KK]; ``nasa`` as
    in :func:`cv_R`."""
    h = (nasa7(tm, T) if nasa is None else nasa)[1]
    return h * (R_GAS * T[:, None]) / tm.wt


def mean_molecular_weight_X(tm, X):
    """Mean molar mass from mole fractions [B, KK], g/mol."""
    return (X * tm.wt).sum(-1)


def mean_molecular_weight_Y(tm, Y):
    """Mean molar mass from mass fractions [B, KK], g/mol; guarded
    against all-zero Y like the reference."""
    return 1.0 / torch.clamp((Y / tm.wt).sum(-1), min=1e-30)


def X_to_Y(tm, X):
    """Mole fractions -> mass fractions, [B, KK]."""
    wx = X * tm.wt
    return wx / wx.sum(-1, keepdim=True)


def Y_to_X(tm, Y):
    """Mass fractions -> mole fractions, [B, KK]."""
    n = Y / tm.wt
    return n / n.sum(-1, keepdim=True)


def Y_to_C(tm, Y, rho):
    """Mass fractions + density [B] -> molar concentrations, mol/cm^3."""
    return rho[:, None] * Y / tm.wt


def density(tm, T, P, Y):
    """Mass density rho = P Wbar / (R T), g/cm^3, [B]."""
    return P * mean_molecular_weight_Y(tm, Y) / (R_GAS * T)


def pressure(tm, T, rho, Y):
    """Pressure from density (ideal gas), dyne/cm^2, [B]."""
    return rho * R_GAS * T / mean_molecular_weight_Y(tm, Y)


def mixture_cp_mass(tm, T, Y):
    """Mixture specific heat at constant pressure, erg/(g K), [B]."""
    return (Y * (cp_R(tm, T) * R_GAS / tm.wt)).sum(-1)


def mixture_cv_mass(tm, T, Y, nasa=None):
    """Mixture specific heat at constant volume, erg/(g K), [B]; ``nasa``
    as in :func:`cv_R`."""
    return (Y * (cv_R(tm, T, nasa) * R_GAS / tm.wt)).sum(-1)


def mixture_enthalpy_mass(tm, T, Y):
    """Mixture specific enthalpy, erg/g, [B]."""
    return (Y * species_enthalpy_mass(tm, T)).sum(-1)


def mixture_internal_energy_mass(tm, T, Y):
    """Mixture specific internal energy, erg/g, [B]."""
    return (Y * (u_RT(tm, T) * (R_GAS * T[:, None]) / tm.wt)).sum(-1)


def mixture_entropy_molar(tm, T, P, X):
    """Mixture molar entropy with the mixing terms, erg/(mol K), [B]:
    ln X floored at ln 1e-30 as in the reference."""
    s_mix = (s_R(tm, T) - torch.log(torch.clamp(X, min=1e-30))
             - torch.log(P / P_ATM)[:, None])
    return (X * s_mix).sum(-1) * R_GAS
