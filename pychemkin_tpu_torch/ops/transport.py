"""Pure-species and mixture-averaged transport, batch-first (plain
PyTorch twin of kernel K9).

Counterpart of the JAX package's ``ops/transport.py``: Lennard-Jones /
Stockmayer collision integrals (Neufeld fits with the Brokaw dipole
term), Chapman-Enskog species viscosities, the Warnatz split of the
species conductivities with the Parker Zrot(T), binary diffusion with the
polar/nonpolar induction correction, the Wilke viscosity, the
combination-averaged conductivity, the mixture-averaged diffusion
coefficients with their pure-species limit and the light-species thermal
diffusion ratios. The Stefan-Maxwell (MULT) fluxes are not ported.

``tm`` is a :class:`~pychemkin_tpu_torch.mechanism.record.TorchMechanism`
with transport data; T and P are [B], X [B, KK]; species outputs are
[B, KK] and pair outputs [B, KK, KK]. CGS units: viscosity g/(cm s),
conductivity erg/(cm K s), diffusion cm^2/s. The floors are written as
``torch.maximum`` with a constant tensor so that forward-mode AD takes
the one-sided value at a tie as ``jax.jacfwd`` does; the CUDA kernels
(``kernels/csrc/transport.cuh``) evaluate the same formulas.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import AVOGADRO, BOLTZMANN, R_GAS
from . import thermo

GEOM_ATOM = 0
GEOM_LINEAR = 1
GEOM_NONLINEAR = 2

_PI = math.pi
_DEBYE = 1.0e-18         # esu cm per Debye
_ANGSTROM = 1.0e-8       # cm per Angstrom


def fmax(x, c):
    """max(x, c) for a constant c, with jax.jacfwd's derivative at the tie
    (half the slope)."""
    return torch.maximum(x, x.new_tensor(c))


def fmin(x, c):
    """min(x, c) for a constant c (see :func:`fmax`)."""
    return torch.minimum(x, x.new_tensor(c))


def _omega22(t_star, delta_star):
    """Collision integral Omega^(2,2)* (Neufeld fit + Brokaw dipole term)."""
    ts = fmax(t_star, 1e-3)
    base = (1.16145 * ts ** -0.14874 + 0.52487 * torch.exp(-0.77320 * ts)
            + 2.16178 * torch.exp(-2.43787 * ts))
    return base + 0.2 * delta_star ** 2 / ts


def _omega11(t_star, delta_star):
    """Collision integral Omega^(1,1)* (Neufeld fit + Brokaw dipole term)."""
    ts = fmax(t_star, 1e-3)
    base = (1.06036 * ts ** -0.15610 + 0.19300 * torch.exp(-0.47635 * ts)
            + 1.03587 * torch.exp(-1.52996 * ts)
            + 1.76474 * torch.exp(-3.89411 * ts))
    return base + 0.19 * delta_star ** 2 / ts


def _reduced_dipole(tm):
    """delta*_k = mu_k^2 / (2 eps_k sigma_k^3), dimensionless, [KK]."""
    mu2 = (tm.dipole * _DEBYE) ** 2
    eps = tm.eps_k * BOLTZMANN
    sig3 = (tm.sigma * _ANGSTROM) ** 3
    return mu2 / fmax(2.0 * eps * sig3, 1e-300)


def species_viscosities(tm, T):
    """Pure-species dynamic viscosities [B, KK], g/(cm s)."""
    m = tm.wt / AVOGADRO                        # g per molecule
    sigma = tm.sigma * _ANGSTROM
    Tc = T[:, None]
    om22 = _omega22(Tc / tm.eps_k, _reduced_dipole(tm))
    return (5.0 / 16.0) * torch.sqrt(_PI * m * BOLTZMANN * Tc) / (
        _PI * sigma ** 2 * om22)


def _parker_F(tm, Tq):
    e = tm.eps_k / Tq
    return (1.0 + 0.5 * _PI ** 1.5 * torch.sqrt(e)
            + (0.25 * _PI ** 2 + 2.0) * e + _PI ** 1.5 * e ** 1.5)


def _parker_zrot(tm, T):
    """Parker rotational relaxation: Zrot(T) = Zrot(298) F(298) / F(T),
    [B, KK]."""
    f298 = _parker_F(tm, torch.full_like(tm.eps_k, 298.0))
    return tm.zrot * f298 / _parker_F(tm, T[:, None])


def _cv_rot_R(tm):
    return torch.where(tm.geom == GEOM_LINEAR, 1.0,
                       torch.where(tm.geom == GEOM_NONLINEAR, 1.5, 0.0)
                       ).to(tm.wt.dtype)


def species_conductivities(tm, T, mu=None):
    """Pure-species thermal conductivities [B, KK], erg/(cm K s):
    translational, rotational and vibrational parts with the
    self-diffusion coupling; ``mu`` is :func:`species_viscosities` at T
    where the caller has it."""
    if mu is None:
        mu = species_viscosities(tm, T)
    m = tm.wt / AVOGADRO
    sigma = tm.sigma * _ANGSTROM
    Tc = T[:, None]
    om11 = _omega11(Tc / tm.eps_k, _reduced_dipole(tm))
    rhoD = (3.0 / 8.0) * torch.sqrt(_PI * m * BOLTZMANN * Tc) / (
        _PI * sigma ** 2 * om11)

    cv_R = thermo.cv_R(tm, T)
    cv_rot_R = _cv_rot_R(tm)
    cv_tr_R = 1.5
    cv_vib_R = fmax(cv_R - cv_tr_R - cv_rot_R, 0.0)

    f_vib = rhoD / fmax(mu, 1e-300)
    A = 2.5 - f_vib
    zrot = _parker_zrot(tm, T)
    B = zrot + (2.0 / _PI) * ((5.0 / 3.0) * cv_rot_R + f_vib)
    f_tr = 2.5 * (1.0 - (2.0 / _PI) * (cv_rot_R / cv_tr_R) * (A / B))
    f_rot = f_vib * (1.0 + (2.0 / _PI) * (A / B))
    has_rot = cv_rot_R > 0.0
    f_tr = torch.where(has_rot, f_tr, 2.5)
    f_rot = torch.where(has_rot, f_rot, 0.0)
    return (mu / tm.wt) * R_GAS * (
        f_tr * cv_tr_R + f_rot * cv_rot_R + f_vib * cv_vib_R)


class PairParams(NamedTuple):
    """Mechanism-only pair parameters [KK, KK]: combined sigma (cm) and
    eps (K) with the induction correction, reduced mass (g) and the pair
    reduced dipole."""
    sigma: torch.Tensor
    eps: torch.Tensor
    m_red: torch.Tensor
    delta: torch.Tensor


def pair_params(tm) -> PairParams:
    """Combined pair LJ parameters with the TRANLIB polar/nonpolar
    induction correction xi, and the pair reduced dipole (zero unless
    both species are polar); cached on the mechanism."""
    pp = tm.__dict__.get("_pair_params")
    if pp is not None:
        return pp
    sigma = tm.sigma * _ANGSTROM
    eps = tm.eps_k
    polar = tm.dipole > 0.0
    alpha_r = tm.polar / fmax(tm.sigma, 1e-30) ** 3
    mu_r2 = ((tm.dipole * _DEBYE) ** 2
             / fmax(eps * BOLTZMANN * sigma ** 3, 1e-300))
    pj = polar[:, None]
    pk = polar[None, :]
    xi_jk = 1.0 + 0.25 * alpha_r[None, :] * mu_r2[:, None] * torch.sqrt(
        eps[:, None] / fmax(eps[None, :], 1e-30))
    xi_kj = 1.0 + 0.25 * alpha_r[:, None] * mu_r2[None, :] * torch.sqrt(
        eps[None, :] / fmax(eps[:, None], 1e-30))
    one = torch.ones_like(xi_jk)
    xi = torch.where(pj & ~pk, xi_jk, torch.where(~pj & pk, xi_kj, one))
    eps_jk = torch.sqrt(eps[:, None] * eps[None, :]) * xi ** 2
    sigma_jk = 0.5 * (sigma[:, None] + sigma[None, :]) * xi ** (-1.0 / 6.0)
    m = tm.wt / AVOGADRO
    m_red = m[:, None] * m[None, :] / (m[:, None] + m[None, :])
    delta = _reduced_dipole(tm)
    delta_jk = torch.sqrt(fmax(delta[:, None] * delta[None, :], 0.0))
    pp = PairParams(sigma_jk.contiguous(), eps_jk.contiguous(),
                    m_red.contiguous(), delta_jk.contiguous())
    tm._pair_params = pp
    return pp


def binary_diffusion_coefficients(tm, T, P):
    """Binary diffusion coefficients [B, KK, KK], cm^2/s."""
    pp = pair_params(tm)
    Tc = T[:, None, None]
    om11 = _omega11(Tc / pp.eps, pp.delta)
    return (3.0 / 16.0) * torch.sqrt(
        2.0 * _PI * (BOLTZMANN * Tc) ** 3 / pp.m_red) / (
        P[:, None, None] * _PI * pp.sigma ** 2 * om11)


def mixture_viscosity(tm, T, X, mu=None):
    """Wilke mixture-averaged viscosity [B], g/(cm s)."""
    if mu is None:
        mu = species_viscosities(tm, T)
    w = tm.wt
    ratio_mu = mu[:, :, None] / fmax(mu[:, None, :], 1e-300)
    ratio_w = w[None, :] / w[:, None]
    phi = (1.0 + torch.sqrt(ratio_mu) * ratio_w ** 0.25) ** 2 / torch.sqrt(
        8.0 * (1.0 + 1.0 / ratio_w))
    x = fmax(X, 1e-30)
    denom = (phi * x[:, None, :]).sum(-1)
    return (x * mu / fmax(denom, 1e-300)).sum(-1)


def _normalized(X):
    x = fmax(X, 1e-30)
    return x / x.sum(-1, keepdim=True)


def mixture_conductivity(tm, T, X, lam=None):
    """Combination-averaged mixture conductivity [B], erg/(cm K s):
    0.5 (sum x_k lam_k + 1 / sum(x_k / lam_k))."""
    if lam is None:
        lam = species_conductivities(tm, T)
    x = _normalized(X)
    return 0.5 * ((x * lam).sum(-1)
                  + 1.0 / (x * (1.0 / fmax(lam, 1e-300))).sum(-1))


def mixture_diffusion_coefficients(tm, T, P, X, Djk=None):
    """Mixture-averaged diffusion coefficients D_km [B, KK], cm^2/s:
    (1 - Y_k) / sum_{j != k} x_j / D_jk, or D_kk where that sum is below
    1e-30 (the pure-species limit)."""
    if Djk is None:
        Djk = binary_diffusion_coefficients(tm, T, P)
    x = _normalized(X)
    Y = thermo.X_to_Y(tm, x)
    inv = x[:, None, :] / Djk
    diag = torch.diagonal(inv, dim1=-2, dim2=-1)
    off_sum = inv.sum(-1) - diag
    return torch.where(off_sum > 1e-30, (1.0 - Y) / fmax(off_sum, 1e-300),
                       torch.diagonal(Djk, dim1=-2, dim2=-1))


def thermal_diffusion_ratios(tm, T, X):
    """Light-species thermal diffusion ratios Theta_k [B, KK]: the
    first-order Chapman-Enskog form over binary pairs with the LJ plateau
    values B* = 1.11 and C* = 0.93, zero for W_k > 5."""
    pp = pair_params(tm)
    t_star = T[:, None, None] / pp.eps
    om11 = _omega11(t_star, pp.delta)
    om22 = _omega22(t_star, pp.delta)
    a_star = om22 / om11
    b_star = 1.11
    c_star = 0.93
    w = tm.wt
    factor = (15.0 / 2.0) * (2.0 * a_star + 5.0) * (6.0 * c_star - 5.0) / (
        a_star * (16.0 * a_star - 12.0 * b_star + 55.0))
    dm = (w[:, None] - w[None, :]) / (w[:, None] + w[None, :])
    x = _normalized(X)
    theta = (factor * dm * x[:, None, :]).sum(-1) * x
    return torch.where(w <= 5.0, theta, torch.zeros_like(theta))


class TransportProps(NamedTuple):
    """What K9 computes per state: species viscosities and
    conductivities [B, KK], the mixture viscosity and conductivity [B],
    the mixture-averaged diffusion coefficients and the thermal diffusion
    ratios [B, KK], and the binary diffusion coefficients [B, KK, KK]."""
    mu_k: torch.Tensor
    lam_k: torch.Tensor
    mu: torch.Tensor
    lam: torch.Tensor
    D_km: torch.Tensor
    theta: torch.Tensor
    Djk: torch.Tensor


def transport_props(tm, T, P, X) -> TransportProps:
    """Every transport property of K9 at the states (T, P, X): the twin
    of ``kernels.transport_props``."""
    mu_k = species_viscosities(tm, T)
    lam_k = species_conductivities(tm, T, mu_k)
    Djk = binary_diffusion_coefficients(tm, T, P)
    return TransportProps(
        mu_k=mu_k, lam_k=lam_k, mu=mixture_viscosity(tm, T, X, mu_k),
        lam=mixture_conductivity(tm, T, X, lam_k),
        D_km=mixture_diffusion_coefficients(tm, T, P, X, Djk),
        theta=thermal_diffusion_ratios(tm, T, X), Djk=Djk)
