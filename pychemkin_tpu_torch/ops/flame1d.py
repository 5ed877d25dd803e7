"""1-D premixed laminar flame: residual, block Jacobian, damped Newton with
the pseudo-transient fallback, and the regridding loop.

Counterpart of the JAX package's ``ops/flame1d.py``, the same algorithm
and the same numbers:

- unknowns per grid point u = [T, Mdot, Y_1..Y_KK] (M = KK + 2); for the
  freely propagating flame Mdot is the flame-speed eigenvalue, with
  dMdot/dx = 0 away from the pinned point and T(x_fix) = T_fix there;
- the energy row is divided by rho cp (K/s) and the species rows by rho
  (1/s), which keeps the block elimination well conditioned;
- each row comes from a 3-point stencil, so dF/du is block tridiagonal
  (B, A, C) [N, M, M];
- the damped Newton accepts the first damping factor whose next Newton
  step is smaller, recomputing the Jacobian at every trial point; a
  backward-Euler pseudo-transient takes over where it stalls;
- a fixed-temperature burner solve on the initial ramp runs first unless
  ``skip_fixed_T``; GRAD/CURV regridding runs on the host between solves.

Transport: mixture-averaged (MIX), fixed Lewis number (LEWIS), optional
Soret term (TDIF). The Stefan-Maxwell (MULT) transport is not ported and
raises :class:`NotImplementedError`.

The residual, the Jacobian blocks and the block-tridiagonal solve are
kernels K10, K11 and K12 on the card (:mod:`..kernels.flame`); the plain
versions here (:func:`make_residual`, :func:`..ops.blocktridiag.solve`)
are their twins, and the wrappers run them for CPU tensors. The twin of
the Jacobian blocks is the kernel's decomposition: forward-mode AD of the
flame's own terms (every point repeated 3M times, copy j with the unit
tangent e_j on (u_{i-1}, u_i, u_{i+1}), in :class:`~.dual.Dual` numbers)
plus the chemistry terms' closed-form CONP Jacobian
(:func:`..ops.jacobian.conp_enrg_rhs_jac`) chained through Y's clip;
the tests hold it to ``jax.jacfwd`` of the reference's stencil. The
reference's ``lax.while_loop`` Newton becomes a host loop with one host
sync per Newton iteration and one per damping probe.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import telemetry
from ..constants import R_GAS
from ..resilience.status import SolveStatus, name_of
from . import jacobian, kinetics, thermo, transport
from .dual import Dual
from .transport import fmax, fmin

_T_MIN = 200.0
_T_MAX = 5000.0
_Y_FLOOR = -1.0e-4     # transient species floor (PREMIX SFLR-style)
_M_MIN = 1.0e-8

#: the transport models of the port (MULT, the Stefan-Maxwell solve, is
#: ROADMAP queue B's B14 remainder)
TRANSPORT_MODELS = ("MIX", "LEWIS")
MULT_TODO = ("MULT (multicomponent Stefan-Maxwell) transport is not ported "
             "to the PyTorch/CUDA package (ROADMAP queue B, item B14: "
             "stefan_maxwell_fluxes)")


@dataclasses.dataclass(frozen=True)
class FlameConfig:
    """Static configuration of one flame problem."""
    energy: str = "ENRG"          # "ENRG" | "TGIV"
    free_flame: bool = True       # True: Mdot is the eigenvalue (FREE)
    upwind: bool = True           # WDIF (True) vs CDIF
    transport: str = "MIX"        # "MIX" | "LEWIS"
    lewis: float = 1.0
    soret: bool = False           # TDIF
    species_flux_bc: bool = True  # FLUX (True) vs COMP inlet species BC
    n_newton: int = 40
    n_damp: int = 8
    ss_rtol: float = 1.0e-4
    ss_atol: float = 1.0e-9

    def __post_init__(self):
        if self.transport == "MULT":
            raise NotImplementedError(MULT_TODO)
        if self.transport not in TRANSPORT_MODELS:
            raise ValueError(f"transport must be one of {TRANSPORT_MODELS}, "
                             f"got {self.transport!r}")
        if self.energy not in ("ENRG", "TGIV"):
            raise ValueError(f"energy must be 'ENRG' or 'TGIV', got "
                             f"{self.energy!r}")


class FlameData(NamedTuple):
    """Per-solve data: the grid x [N] (cm), the pressure (dyne/cm^2), the
    inlet T and Y [KK], the known mass flux (burner) or its guess (free),
    the pinned temperature and index (free flame) and the given
    temperature profile T_given [N] (TGIV); tensors on the solve's
    device."""
    x: Any
    P: float
    T_in: float
    Y_in: Any
    mdot_in: float
    T_fix: float
    i_fix: int
    T_given: Any


def pack(T, M, Y):
    return torch.cat([T[..., None], M[..., None], Y], dim=-1)


def unpack(u):
    return u[..., 0], u[..., 1], u[..., 2:]


def clip01(Y):
    """clip(Y, 0, 1) with jax.jacfwd's derivative (half the slope at
    either bound)."""
    return fmin(fmax(Y, 0.0), 1.0)


def _face(tm, cfg: FlameConfig, P, u_l, u_r, x_l, x_r):
    """Fluxes at the faces between the points u_l and u_r [B, M] at x_l
    and x_r [B]: (q_cond [B] erg/cm^2-s, j [B, KK] g/cm^2-s), positive
    in +x."""
    T_l, _, Y_l = unpack(u_l)
    T_r, _, Y_r = unpack(u_r)
    h = x_r - x_l
    T_f = 0.5 * (T_l + T_r)
    Y_f = 0.5 * (Y_l + Y_r)
    Y_f_c = clip01(Y_f)
    X_f = thermo.Y_to_X(tm, Y_f_c)
    X_l = thermo.Y_to_X(tm, clip01(Y_l))
    X_r = thermo.Y_to_X(tm, clip01(Y_r))
    wbar = thermo.mean_molecular_weight_X(tm, X_f)
    Pf = torch.full_like(T_f, P)
    rho_f = thermo.density(tm, T_f, Pf, Y_f_c)
    lam = transport.mixture_conductivity(tm, T_f, X_f)

    dTdx = (T_r - T_l) / h
    dXdx = (X_r - X_l) / h[:, None]
    if cfg.transport == "LEWIS":
        cp_f = thermo.mixture_cp_mass(tm, T_f, Y_f_c)
        D_k = (lam / (rho_f * cp_f * cfg.lewis))[:, None].expand_as(X_f)
    else:
        D_k = transport.mixture_diffusion_coefficients(tm, T_f, Pf, X_f)
    rw = rho_f[:, None] * (tm.wt / wbar[:, None])
    # mixture-averaged Fickian flux j_k = -rho (W_k/Wbar) D_k dX_k/dx
    j = -rw * D_k * dXdx
    if cfg.soret:
        theta = transport.thermal_diffusion_ratios(tm, T_f, X_f)
        j = j - rw * D_k * theta * dTdx[:, None] / T_f[:, None]
    # correction flux: sum_k j_k = 0
    j = j - Y_f_c * j.sum(-1, keepdim=True)
    q_cond = -lam * dTdx
    return q_cond, j


def make_residual(tm, cfg: FlameConfig):
    """(residual(u [N, M], data) -> F [N, M], jacobian_blocks(u, data) ->
    (B, A, C) [N, M, M]): the plain twins of K10 and K11. Rows are
    ordered like u: energy (or T - T_given), continuity / eigenvalue,
    species."""

    def interior(i, u_m, u_c, u_p, x_m, x_c, x_p, data: FlameData,
                 faces, chem=True):
        """The interior rows at the points u_c between u_m and u_p, with
        the fluxes ``faces`` = ((q_l, j_l), (q_r, j_r)) of their left and
        right faces; ``chem`` False leaves out the chemistry terms (wdot W
        in the species rows, sum h wdot W in the energy row), whose
        derivatives the Jacobian takes in closed form."""
        T_c, M_c, Y_c = unpack(u_c)
        T_m, M_m, Y_m = unpack(u_m)
        T_p, M_p, Y_p = unpack(u_p)
        P = torch.full_like(T_c, data.P)
        dxc = 0.5 * (x_p - x_m)
        (q_l, j_l), (q_r, j_r) = faces

        Y_cc = clip01(Y_c)
        rho = thermo.density(tm, T_c, P, Y_cc)
        if chem:
            C = thermo.Y_to_C(tm, Y_cc, rho)
            wdot_W = kinetics.net_production_rates(tm, T_c, C, P=P) * tm.wt

        if cfg.upwind:                 # flow in +x: backward differences
            dTdx = (T_c - T_m) / (x_c - x_m)
            dYdx = (Y_c - Y_m) / (x_c - x_m)[:, None]
        else:
            dTdx = (T_p - T_m) / (x_p - x_m)
            dYdx = (Y_p - Y_m) / (x_p - x_m)[:, None]

        F_Y = M_c[:, None] * dYdx + (j_r - j_l) / dxc[:, None]
        if chem:
            F_Y = F_Y - wdot_W
        F_Y = F_Y / rho[:, None]
        if cfg.energy == "TGIV":
            F_T = T_c - data.T_given[i]
        else:
            cp = thermo.mixture_cp_mass(tm, T_c, Y_cc)
            cp_k = thermo.cp_R(tm, T_c) * R_GAS / tm.wt
            j_avg = 0.5 * (j_l + j_r)
            F_T = (M_c * cp * dTdx
                   + (q_r - q_l) / dxc
                   + (j_avg * cp_k).sum(-1) * dTdx)
            if chem:
                h_k = thermo.species_enthalpy_mass(tm, T_c)
                F_T = F_T + (h_k * wdot_W).sum(-1)
            F_T = F_T / (rho * cp)
        if cfg.free_flame:
            F_M = torch.where(
                i == data.i_fix, T_c - data.T_fix,
                torch.where(i < data.i_fix, M_c - M_p, M_c - M_m))
        else:
            F_M = M_c - data.mdot_in
        return pack(F_T, F_M, F_Y)

    def left_bc(u_0, u_1, data: FlameData, j_r):
        """The inlet rows, with ``j_r`` the diffusive fluxes of the first
        face (u_0, u_1)."""
        T_0, M_0, Y_0 = unpack(u_0)
        F_T = T_0 - data.T_in
        if cfg.species_flux_bc:
            # M (Y_k - Y_k,in) + j_k = 0 at the inlet face, over M
            F_Y = (Y_0 - data.Y_in) + j_r / fmax(M_0, _M_MIN)[:, None]
        else:
            F_Y = Y_0 - data.Y_in
        if cfg.free_flame:
            F_M = M_0 - u_1[:, 1]
        else:
            F_M = M_0 - data.mdot_in
        return pack(F_T, F_M, F_Y)

    def right_bc(u_a, u_b, data: FlameData):
        T_a, M_a, Y_a = unpack(u_a)
        T_b, M_b, Y_b = unpack(u_b)
        if cfg.energy == "TGIV":
            F_T = T_b - data.T_given[-1]
        else:
            F_T = T_b - T_a                       # zero gradient
        F_Y = Y_b - Y_a
        if cfg.free_flame:
            F_M = M_b - M_a
        else:
            F_M = M_b - data.mdot_in
        return pack(F_T, F_M, F_Y)

    def residual(u, data: FlameData):
        x = data.x
        N = u.shape[0]
        idx = torch.arange(1, N - 1, device=u.device)
        # every face once: face f lies between points f and f + 1
        q, j = _face(tm, cfg, data.P, u[:-1], u[1:], x[:-1], x[1:])
        F_int = interior(idx, u[:-2], u[1:-1], u[2:], x[:-2], x[1:-1],
                         x[2:], data, ((q[:-1], j[:-1]), (q[1:], j[1:])))
        F0 = left_bc(u[:1], u[1:2], data, j[:1])
        Fn = right_bc(u[-2:-1], u[-1:], data)
        return torch.cat([F0, F_int, Fn], dim=0)

    def _seeded(parts):
        """The lanes of ``parts`` (each [L, M]) repeated n = len(parts) M
        times as Duals, copy j of a lane carrying the unit tangent e_j on
        the concatenated unknowns: ([L n, M] Duals, n)."""
        L, M = parts[0].shape
        n = len(parts) * M
        U = torch.cat(parts, dim=1).repeat_interleave(n, dim=0)
        V = torch.eye(n, dtype=U.dtype, device=U.device).repeat(L, 1)
        Ud = Dual(U, V)
        return [Ud[:, k * M:(k + 1) * M] for k in range(len(parts))], n

    def _spread(face, first, shift, n, M):
        """Face Duals (2M tangents per face, lanes face f copy t) onto the
        stencil's layout (n = 3M tangents per point, lanes point p copy
        t): point p reads face first + p, its tangent t being the face's
        tangent t - shift, zero outside [0, 2M)."""
        P = face.v.shape[0] // (2 * M) - 1      # interior points
        pts = torch.arange(P, device=face.v.device)
        t = torch.arange(n, device=face.v.device) - shift
        ok = (t >= 0) & (t < 2 * M)
        rows = ((first + pts)[:, None] * (2 * M)
                + t.clamp(0, 2 * M - 1)[None, :]).reshape(-1)
        tv = face.t[rows]
        mask = ok.repeat(P).to(tv.dtype)
        mask = mask.reshape(-1, *([1] * (tv.ndim - 1)))
        return Dual(face.v[rows], tv * mask)

    def _chem_columns(u_c, P):
        """d(chemistry terms)/du_c [L, M, M] of the interior rows: the
        closed-form CONP Jacobian of (wdot W / rho, -sum h wdot W /
        (rho cp)) in (Y, T) at clip(Y), chained through the clip (half the
        slope at a bound, as jax.jacfwd takes jnp.clip), with the sign of
        the rows (-f)."""
        L, M = u_c.shape
        KK = M - 2
        Y = u_c[:, 2:]
        y = torch.cat([clip01(Y), u_c[:, :1]], dim=1)
        _, J = jacobian.conp_enrg_rhs_jac(tm, y, torch.full_like(y[:, 0], P))
        slope = torch.where((Y > 0.0) & (Y < 1.0), 1.0,
                            torch.where((Y == 0.0) | (Y == 1.0), 0.5,
                                        0.0)).to(Y.dtype)
        cols = torch.cat([J[:, :, KK:], torch.zeros_like(J[:, :, :1]),
                          J[:, :, :KK] * slope[:, None, :]], dim=2)
        out = torch.zeros(L, M, M, dtype=u_c.dtype, device=u_c.device)
        out[:, 2:] = -cols[:, :KK]
        if cfg.energy != "TGIV":
            out[:, 0] = -cols[:, KK]
        return out

    def jacobian_blocks(u, data: FlameData):
        """(B, A, C): sub/diag/super blocks [N, M, M] of dF/du."""
        x = data.x
        N, M = u.shape
        idx = torch.arange(1, N - 1, device=u.device)
        # every face once, with its 2M tangents on (u_f, u_{f+1})
        (ul, ur), nf = _seeded((u[:-1], u[1:]))
        q, j = _face(tm, cfg, data.P, ul, ur,
                     x[:-1].repeat_interleave(nf), x[1:].repeat_interleave(nf))
        # the interior stencils, 3M tangents on (u_{i-1}, u_i, u_{i+1});
        # point i (i = 1..N-2) reads faces i - 1 and i
        (um, uc, up), n = _seeded((u[:-2], u[1:-1], u[2:]))
        faces = ((_spread(q, 0, 0, n, M), _spread(j, 0, 0, n, M)),
                 (_spread(q, 1, M, n, M), _spread(j, 1, M, n, M)))
        rep = [t.repeat_interleave(n) for t in (idx, x[:-2], x[1:-1], x[2:])]
        F = interior(rep[0], um, uc, up, *rep[1:], data, faces, chem=False)
        J = F.t.reshape(N - 2, n, M).transpose(1, 2)
        A_int = J[:, :, M:2 * M] + _chem_columns(u[1:-1], data.P)
        # the inlet rows: face 0's lanes carry (u_0, u_1)'s tangents
        J0 = left_bc(ul[:nf], ur[:nf], data, j[:nf]).t.reshape(
            1, nf, M).transpose(1, 2)
        (ua, ub), _ = _seeded((u[-2:-1], u[-1:]))
        Jn = right_bc(ua, ub, data).t.reshape(1, nf, M).transpose(1, 2)
        zero = torch.zeros(1, M, M, dtype=u.dtype, device=u.device)
        Bb = torch.cat([zero, J[:, :, :M], Jn[:, :, :M]], dim=0)
        Ab = torch.cat([J0[:, :, :M], A_int, Jn[:, :, M:]], dim=0)
        Cb = torch.cat([J0[:, :, M:], J[:, :, 2 * M:], zero], dim=0)
        return Bb.contiguous(), Ab.contiguous(), Cb.contiguous()

    return residual, jacobian_blocks


def _clip_state(u):
    T, M, Y = unpack(u)
    return pack(torch.clamp(T, _T_MIN, _T_MAX), fmax(M, _M_MIN),
                torch.clamp(Y, _Y_FLOOR, 1.0))


#: per-iteration caps: max temperature change [K] and max relative change
#: of the mass-flux eigenvalue
_DT_CAP = 250.0
_DM_REL_CAP = 0.5
_M_MAX = 1.0e3


def _lambda_bound(u, du):
    """Largest damping factor that keeps u + lam du inside the physical
    bounds and within the per-iteration trust caps, in [1e-6, 1] (a 0-d
    tensor). Components already parked at a bound and moving outward are
    left to :func:`_clip_state`."""
    T, M, Y = unpack(u)
    dT, dM, dY = unpack(du)
    big = torch.tensor(1e30, dtype=u.dtype, device=u.device)

    def ratio(uv, dv, lo, hi):
        eps = 1e-9 * (hi - lo)
        head_hi = hi - uv
        head_lo = uv - lo
        r_hi = torch.where((dv > 0) & (head_hi > eps),
                           head_hi / torch.where(dv > 0, dv, 1.0), big)
        r_lo = torch.where((dv < 0) & (head_lo > eps),
                           -head_lo / torch.where(dv < 0, dv, -1.0), big)
        return torch.minimum(r_hi, r_lo)

    lam = torch.minimum(ratio(T, dT, _T_MIN, _T_MAX).min(),
                        ratio(Y, dY, _Y_FLOOR, 1.0).min())
    lam = torch.minimum(lam, ratio(M, dM, _M_MIN, _M_MAX).min())
    lam = torch.minimum(lam, _DT_CAP / fmax(dT.abs().max(), 1e-300))
    rel_M = (dM.abs() / (M.abs() + 1e-6)).max()
    lam = torch.minimum(lam, _DM_REL_CAP / fmax(rel_M, 1e-300))
    return torch.clamp(lam, 1e-6, 1.0)


def _c_row(u, c_T):
    """Differential-row mask of the backward-Euler term: the T row
    (unless TGIV) and the Y rows at interior points."""
    N, M = u.shape
    c = torch.ones(N, M, dtype=u.dtype, device=u.device)
    c[0] = 0.0
    c[-1] = 0.0
    c[:, 0] *= c_T
    c[:, 1] = 0.0
    return c


class Newton(NamedTuple):
    """One Newton solve's outcome: the state, converged (and not
    stalled), the iterations, the last step norm, the stalled flag and
    each iteration's accepted damping factor (None where none was)."""
    u: Any
    converged: bool
    n_it: int
    last_norm: float
    stalled: bool
    lams: tuple = ()


def make_newton(tm, cfg: FlameConfig, transient=False):
    """The damped Newton over a fixed grid: newton(u0, data, u_old=None,
    dt=None) -> :class:`Newton`. With ``transient`` it solves the
    backward-Euler system F(u) + c (u - u_old) / dt = 0 (c: 1 on the
    differential rows, 0 on the algebraic ones). Each Newton direction is
    K11 (the blocks), K10 (the residual) and K12 (the solve) through
    :mod:`..kernels.flame` (their twins for CPU tensors)."""
    from ..kernels import flame as kf

    c_T = 0.0 if cfg.energy == "TGIV" else 1.0

    def step_norm(du, u):
        w = cfg.ss_atol + cfg.ss_rtol * u.abs()
        return torch.sqrt(((du / w) ** 2).mean())

    def newton(u0, data: FlameData, u_old=None, dt=None) -> Newton:
        c = _c_row(u0, c_T) if transient else None

        def solve_step(u):
            Bb, Ab, Cb = kf.flame_jac(tm, cfg, u, data)
            F = kf.flame_residual(tm, cfg, u, data)
            if transient:
                F = F + c * (u - u_old) / dt
                Ab = Ab + torch.diag_embed(c / dt)
            return kf.block_thomas(Bb, Ab, Cb, (-F).contiguous())

        def finite_norm(n):
            return n if np.isfinite(n) else float("inf")

        u = _clip_state(u0)
        converged = stalled = False
        it = 0
        last_norm = float("inf")
        lams = []
        while not converged and not stalled and it < cfg.n_newton:
            du = solve_step(u)
            n0_t, lam_t = step_norm(du, u), _lambda_bound(u, du)
            n0, lam = (float(v) for v in torch.stack([n0_t, lam_t]).tolist())
            n0 = finite_norm(n0)
            converged = n0 < 1.0
            # damped search from the bound-respecting lambda: the first
            # lambda whose next Newton step (Jacobian at the trial point)
            # is smaller is accepted
            best_u, best_n, found = u, n0, False
            for _ in range(cfg.n_damp):
                u_try = _clip_state(u + lam * du)
                n_try = finite_norm(float(step_norm(solve_step(u_try),
                                                    u_try)))
                if n_try < n0:
                    best_u, best_n, found = u_try, n_try, True
                    break
                lam *= 0.5
            lams.append(lam if found else None)
            u_next = best_u if found else u
            n_next = best_n if found else n0
            finite = bool(torch.isfinite(u_next).all()) and np.isfinite(n0)
            failed = (not found) and (not converged)
            if finite:
                u = u_next
            last_norm = n_next
            it += 1
            stalled = stalled or failed or not finite
        return Newton(u, converged and not stalled, it, last_norm, stalled,
                      tuple(lams))

    return newton


def _programs(tm, cfg: FlameConfig):
    """(newton, timestep) of one problem: the steady Newton and n_steps
    backward-Euler steps of dt, each a transient Newton of at most 12
    iterations (the transient keeps the full residual, eigenvalue and pin
    rows included)."""
    newton = make_newton(tm, cfg)
    ts_newton = make_newton(tm, dataclasses.replace(cfg, n_newton=12),
                            transient=True)

    def timestep(u, data, dt, n_steps):
        n_ok = 0
        for _ in range(n_steps):
            res = ts_newton(u, data, u_old=u, dt=dt)
            if res.converged:
                u = res.u
                n_ok += 1
        return u, n_ok

    return newton, timestep


class FlameSolution(NamedTuple):
    x: Any           # [N] final grid (numpy)
    T: Any           # [N]
    Y: Any           # [N, KK]
    mdot: Any        # mass flux eigenvalue / burner flux, g/cm^2-s
    flame_speed: Any  # cm/s = mdot / rho_unburnt (free flame); nan unless
    #                  converged
    converged: Any
    n_points: int
    n_regrids: int
    n_newton: Any
    u: Any = None    # packed state [N, M] for continuation restarts
    status: Any = None   # SolveStatus code
    report: Any = None   # per-solve telemetry dict (see solve_flame)


def initial_profile(tm, x, P, T_in, Y_in, xcen, wmix, *, energy="ENRG",
                    T_given=None, mdot_guess=None, su_guess=40.0):
    """PREMIX-style starting estimate [N, M] on the grid x [N] (a tensor
    on the mechanism's device): HP-equilibrium products (K6, option 5) on
    the hot side, a linear ramp of width ``wmix`` centred at ``xcen``."""
    from .equilibrium import equilibrate
    dev = tm.device
    f64 = dict(dtype=torch.float64, device=dev)
    Y_in = torch.as_tensor(np.asarray(Y_in, dtype=np.float64), **f64)
    eq = equilibrate(tm, float(T_in), float(P), Y_in, option=5, device=dev)
    T_b = fmax(eq.T[0], T_in + 400.0)
    Y_b = eq.Y[0]
    xi = torch.clamp((x - (xcen - 0.5 * wmix)) / wmix, 0.0, 1.0)
    if T_given is not None:
        T = torch.as_tensor(np.asarray(T_given, dtype=np.float64), **f64)
    else:
        T = T_in + (T_b - T_in) * xi
    Y = Y_in[None, :] + (Y_b - Y_in)[None, :] * xi[:, None]
    if mdot_guess is None:
        rho_u = thermo.density(tm, torch.tensor([float(T_in)], **f64),
                               torch.tensor([float(P)], **f64), Y_in[None])
        mdot_guess = float(rho_u[0]) * su_guess
    M = torch.full(x.shape, float(mdot_guess), **f64)
    return pack(T, M, Y)


def _interp_profile(x_old, u_old, x_new):
    """Each column of u_old [N, M] (numpy) interpolated onto x_new."""
    return np.stack([np.interp(x_new, x_old, u_old[:, k])
                     for k in range(u_old.shape[1])], axis=1)


def refine_grid(x, u, *, grad=0.1, curv=0.5, nadp=10, ntot=250,
                min_dx=1e-5, keep=()):
    """GRAD/CURV grid adaption on the host (numpy): flag an interval when
    any component's jump exceeds ``grad`` times its range, or its slope
    jump exceeds ``curv`` times the slope range; split flagged intervals
    at their midpoint (at most ``nadp`` new points, total capped at
    ``ntot``). Returns the new grid or None when no refinement is
    needed."""
    x = np.asarray(x)
    u = np.asarray(u)
    N = x.shape[0]
    if N >= ntot:
        return None
    T = u[:, 0]
    comps = [T] + [u[:, 2 + k] for k in range(u.shape[1] - 2)
                   if np.ptp(u[:, 2 + k]) > 1e-6]
    score = np.zeros(N - 1)
    for phi in comps:
        rng = np.ptp(phi)
        if rng <= 0:
            continue
        jump = np.abs(np.diff(phi))
        score = np.maximum(score, jump / (grad * rng))
        d = np.diff(phi) / np.diff(x)
        drng = np.ptp(d)
        # a slope range at rounding-noise level (a linear profile) must
        # not trigger curvature refinement
        if drng > 1e-8 * max(np.max(np.abs(d)), 1e-300) and N > 2:
            djump = np.abs(np.diff(d))
            s2 = djump / (curv * drng)
            score[:-1] = np.maximum(score[:-1], s2)
            score[1:] = np.maximum(score[1:], s2)
    flagged = np.where((score > 1.0) & (np.diff(x) > 2 * min_dx))[0]
    if flagged.size == 0:
        return None
    order = np.argsort(score[flagged])[::-1]
    budget = min(nadp, ntot - N)
    flagged = flagged[order][:budget]
    new_pts = 0.5 * (x[flagged] + x[flagged + 1])
    return np.sort(np.unique(np.concatenate([x, new_pts, np.asarray(
        keep, dtype=x.dtype)])))


def _distinct(x, tol):
    """The sorted nodes of x with every node closer than ``tol`` to the
    one before it dropped. The reference builds its initial grid with
    np.unique, which keeps a linspace node and a ramp node one ulp apart
    (1.2000000000000002 beside 1.2 on the default 0-2 cm grid): an
    interval of 2.2e-16 cm that puts 1e19 entries into the Jacobian.
    The blocks there are still right to rounding, but the Newton systems
    reach condition numbers of 1e26-1e41, and moving each block entry by
    one ulp moves the Newton direction by 2e-4 to 6 in the Newton's
    weighted norm (1e-13 on this grid; tests/test_torch_flame.py::
    test_blocks_on_the_reference_default_grid)."""
    x = np.sort(np.asarray(x, dtype=np.float64))
    keep = np.concatenate([[True], np.diff(x) > tol])
    return x[keep]


def _pin_index(x, T_prof, T_fix):
    """Interior grid index whose temperature is closest to T_fix, clamped
    to [1, N-2] (a boundary pin would leave the eigenvalue without an
    equation)."""
    N = len(x)
    return int(np.clip(np.argmin(np.abs(np.asarray(T_prof) - T_fix)),
                       1, N - 2))


def _march(newton, timestep, u, data, *, dt0, ts_steps, max_rounds,
           verbose=False, timers=None, prefix="", counts=None):
    """Newton with pseudo-transient rescue rounds: (u, converged,
    total_newton, dt_last, stalled), ``stalled`` the final Newton's
    damped-stall flag. ``timers`` accumulates wall seconds into
    ``<prefix>newton_s`` / ``<prefix>transient_s``; ``counts`` the
    transient steps taken (``ts_steps``)."""
    def _charge(name, t0):
        if timers is not None:
            key = prefix + name
            timers[key] = timers.get(key, 0.0) + (time.perf_counter() - t0)

    total_newton = 0
    dt = dt0
    for round_i in range(max_rounds):
        t0 = time.perf_counter()
        res = newton(u, data)
        total_newton += res.n_it
        _charge("newton_s", t0)
        if verbose:
            print(f"  [flame] newton round {round_i}: ok={res.converged} "
                  f"its={res.n_it} norm={res.last_norm:.3e} "
                  f"Tmax={float(res.u[:, 0].max()):.0f}")
        if res.converged:
            return res.u, True, total_newton, dt, False
        t0 = time.perf_counter()
        u, n_ok = timestep(u, data, dt, ts_steps)
        if counts is not None:
            counts["ts_steps"] = counts.get("ts_steps", 0) + ts_steps
        _charge("transient_s", t0)
        if verbose:
            print(f"  [flame] transient round {round_i}: dt={dt:.2e} "
                  f"ok {n_ok}/{ts_steps} Tmax={float(u[:, 0].max()):.0f}"
                  f" M={float(u[0, 1]):.4f}")
        if n_ok >= int(0.8 * ts_steps):
            dt = min(dt * 5.0, 1e-3)
        elif n_ok <= int(0.2 * ts_steps):
            dt = max(dt * 0.2, 1e-9)
    t0 = time.perf_counter()
    res = newton(u, data)
    total_newton += res.n_it
    _charge("newton_s", t0)
    if verbose:
        print(f"  [flame] final newton: ok={res.converged} "
              f"norm={res.last_norm:.3e}")
    return ((res.u if res.converged else u), res.converged, total_newton, dt,
            res.stalled)


def solve_flame(tm, *, P, T_in, Y_in, x_start, x_end, energy="ENRG",
                free_flame=True, mdot=None, T_fix=400.0, su_guess=40.0,
                T_given_fn=None, n_initial=12, xcen=None, wmix=None,
                grad=0.1, curv=0.5, nadp=10, ntot=250, max_regrids=12,
                upwind=True, transport_model="MIX", lewis=1.0,
                soret=False, species_flux_bc=True, ss_rtol=1e-4,
                ss_atol=1e-9, ts_dt=1e-6, ts_steps=30, max_ts_rounds=12,
                skip_fixed_T=False, u0=None, x0=None, x_init=None,
                T_init_fn=None, verbose=False):
    """Solve a premixed 1-D flame with adaptive regridding on the device
    of ``tm`` (a :class:`~..mechanism.TorchMechanism`): Newton solves per
    grid size, GRAD/CURV refinement between them. For ``free_flame`` the
    returned ``flame_speed`` is Su = mdot / rho_unburnt, nan unless
    ``converged``. ``skip_fixed_T`` skips the fixed-temperature burner
    solve on the initial ramp (NOFT); ``u0``/``x0`` restart from a
    previous solution (CNTN); ``x_init`` imposes the initial mesh and
    ``T_init_fn`` an initial temperature estimate for ENRG solves."""
    cfg = FlameConfig(energy=energy, free_flame=free_flame, upwind=upwind,
                      transport=transport_model, lewis=lewis, soret=soret,
                      species_flux_bc=species_flux_bc,
                      ss_rtol=ss_rtol, ss_atol=ss_atol)
    if not tm.has_transport:
        raise ValueError("flames need transport data: load the mechanism "
                         "with a transport file")
    dev = tm.device
    f64 = dict(dtype=torch.float64, device=dev)
    P = float(P)
    T_in = float(T_in)
    Y_in = np.array(Y_in, dtype=np.float64)
    L = x_end - x_start
    if xcen is None:
        xcen = x_start + 0.35 * L
    if wmix is None:
        wmix = 0.5 * L
    if energy == "TGIV" and T_given_fn is None:
        raise ValueError("TGIV flame needs a temperature profile")

    rho_u = float(thermo.density(tm, torch.tensor([T_in], **f64),
                                 torch.tensor([P], **f64),
                                 torch.as_tensor(Y_in[None], **f64))[0])
    mdot_in = float(mdot) if mdot is not None else rho_u * su_guess

    def _estimate(x_arr):
        if energy == "TGIV":
            return np.asarray([T_given_fn(xi) for xi in x_arr])
        if T_init_fn is not None:
            return np.asarray([T_init_fn(xi) for xi in x_arr])
        return None

    def _initial(x_arr, T_given):
        return initial_profile(tm, torch.as_tensor(x_arr, **f64), P, T_in,
                               Y_in, xcen, wmix, energy=energy,
                               T_given=T_given, mdot_guess=mdot_in,
                               su_guess=su_guess)

    if u0 is not None:
        if x0 is None:
            raise ValueError("continuation restart needs x0 alongside u0")
        x = np.asarray(x0, dtype=np.float64)
        u = torch.as_tensor(np.array(u0, dtype=np.float64), **f64)
    else:
        if x_init is not None:
            x = np.asarray(x_init, dtype=np.float64)
        else:
            x = np.linspace(x_start, x_end, n_initial)
            ramp = np.linspace(xcen - 0.5 * wmix, xcen + 0.5 * wmix, 9)
            x = _distinct(np.concatenate([x, ramp]), 1e-10 * L)
        u = _initial(x, _estimate(x))
        if free_flame:
            # a grid point exactly where the initial ramp crosses T_fix,
            # so that the pin is consistent with the starting guess
            T_prof0 = u[:, 0].cpu().numpy()
            if T_prof0[-1] > T_fix > T_prof0[0]:
                x_cross = float(np.interp(T_fix, T_prof0, x))
                x = np.sort(np.unique(np.append(x, x_cross)))
                u = _initial(x, _estimate(x))

    T_prof = u[:, 0].cpu().numpy()
    if free_flame:
        i_fix = _pin_index(x, T_prof, T_fix)
        x_fix = float(x[i_fix])
    else:
        i_fix = 1
        x_fix = float(x[0])

    def make_data(x_arr, i_fix_v, T_given_arr):
        N = len(x_arr)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64), **f64)
        return FlameData(
            x=t(x_arr), P=P, T_in=T_in, Y_in=t(Y_in), mdot_in=mdot_in,
            T_fix=T_fix, i_fix=int(i_fix_v),
            T_given=(t(T_given_arr) if T_given_arr is not None
                     else torch.zeros(N, **f64)))

    total_newton = 0
    recorder = telemetry.get_recorder()
    timers: dict = {}
    counts: dict = {}
    t_solve0 = time.perf_counter()
    programs0 = recorder.counters.get("flame.programs_built", 0)

    # stage A: fixed-temperature burner solve on the initial ramp; each
    # problem on each grid size counts as one of the reference's compiled
    # program pairs (``flame.programs_built``)
    if energy == "ENRG" and not skip_fixed_T and u0 is None:
        cfg_ft = dataclasses.replace(cfg, energy="TGIV", free_flame=False)
        newton_ft, timestep_ft = _programs(tm, cfg_ft)
        recorder.inc("flame.programs_built")
        data_ft = make_data(x, i_fix, u[:, 0].cpu().numpy())
        u_ft, ok, n_it, _, _ = _march(newton_ft, timestep_ft, u, data_ft,
                                      dt0=ts_dt, ts_steps=ts_steps,
                                      max_rounds=2, verbose=verbose,
                                      timers=timers, prefix="fixT_",
                                      counts=counts)
        total_newton += n_it
        if ok:
            u = u_ft

    # stage B: the target problem, with regridding
    n_regrids = 0
    converged = False
    stalled_last = False
    newton, timestep = _programs(tm, cfg)
    for _round in range(max_regrids + 1):
        data = make_data(x, i_fix, _estimate(x))
        recorder.inc("flame.programs_built")      # a new grid size a round
        u, ok, n_it, ts_dt, stalled_last = _march(
            newton, timestep, u, data, dt0=ts_dt, ts_steps=ts_steps,
            max_rounds=max_ts_rounds, verbose=verbose, timers=timers,
            counts=counts)
        total_newton += n_it
        if not ok:
            converged = False
            break
        converged = True
        u_host = u.cpu().numpy()
        x_new = refine_grid(x, u_host, grad=grad, curv=curv, nadp=nadp,
                            ntot=ntot, keep=(x_fix,))
        if x_new is None:
            break
        u = torch.as_tensor(_interp_profile(x, u_host, x_new), **f64)
        x = x_new
        n_regrids += 1
        if free_flame:
            # keep the pin anchored at the same physical location
            i_fix = int(np.clip(np.argmin(np.abs(x - x_fix)), 1,
                                len(x) - 2))

    u_np = u.cpu().numpy()
    T_out, M_out, Y_out = u_np[:, 0], u_np[:, 1], u_np[:, 2:]
    mdot_out = float(M_out[0]) if free_flame else mdot_in
    su = mdot_out / rho_u if converged else float("nan")
    if converged:
        status = int(SolveStatus.OK)
    elif not bool(np.all(np.isfinite(u_np))):
        status = int(SolveStatus.NONFINITE)
    elif stalled_last:
        status = int(SolveStatus.NEWTON_STALL)
    else:
        status = int(SolveStatus.TOL_NOT_MET)
    report = {
        "wall_s": round(time.perf_counter() - t_solve0, 6),
        "n_newton": int(total_newton),
        "n_regrids": int(n_regrids),
        "n_points": int(x.shape[0]),
        "n_ts_steps": int(counts.get("ts_steps", 0)),
        "programs_built": recorder.counters.get(
            "flame.programs_built", 0) - programs0,
        "converged": bool(converged),
        "status": status,
        "status_name": name_of(status),
    }
    report.update({k: round(v, 6) for k, v in sorted(timers.items())})
    recorder.event("flame", energy=energy, free_flame=bool(free_flame),
                   **report)
    recorder.inc("flame.solves")
    return FlameSolution(
        x=np.asarray(x), T=T_out, Y=np.clip(Y_out, 0.0, 1.0), mdot=mdot_out,
        flame_speed=su, converged=converged, n_points=int(x.shape[0]),
        n_regrids=n_regrids, n_newton=total_newton, u=u_np, status=status,
        report=report)
