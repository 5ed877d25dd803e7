"""Bordered factorisation of the Newton matrix and the one-shot solves of
the steady-state Newtons, batch-first (plain PyTorch twins of kernels K3
and K4, and of the linear algebra inside K6 and K7).

Counterpart of the JAX package's ``ops/linalg.py``: ``_lu_nopivot``,
``_solve_nopivot``, ``factor_bordered`` and ``_solve_bordered_once``,
and the exact f64 path of ``factor``/``solve``/``solve_with_info``
(partial pivoting, as LAPACK ``getrf``).

Every Newton matrix of the 0-D solver is M = I - h*gamma*J with the
state [Y_1..Y_KK, T], so M is bordered: the KK x KK species block A is
factored pivot-free (Doolittle, diagonal clamped away from zero) and the
T row/column is eliminated through the Schur complement
d_schur = clamp(d - c . A^-1 b). Each solve is then one pair of
triangular sweeps on A plus two dot products.

The packed L\\U is row-major with the unit lower diagonal implicit, as
the reference's. Shapes: J/M [B, N, N], lu [B, KK, KK], vectors [B, N].

The steady-state solvers (equilibrium, PSR) factor general Newton
matrices, not I - hg J: there the LU pivots by rows (:func:`lu_pivot`)
and :func:`solve_with_info` checks the residual against the full matrix.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

#: diagonal clamp of the pivot-free factorisation
_DIAG_EPS = 1e-30

#: escalation flag read by the ignition sweep: True inside
#: :func:`forced_pivoted` (the rescue ladder's last rung)
_FORCE_PIVOTED = [False]


@contextlib.contextmanager
def forced_pivoted():
    """Make every ignition sweep started inside the block factor its
    Newton matrices with partial pivoting (:func:`factor_bordered_pivoted`,
    on the card the PIVOT instantiation of kernel K5) instead of the
    pivot-free default."""
    _FORCE_PIVOTED.append(True)
    try:
        yield
    finally:
        _FORCE_PIVOTED.pop()


def pivoted_forced() -> bool:
    return _FORCE_PIVOTED[-1]


def _clamp(d):
    """Keep a pivot at least 1e-30 away from zero, keeping its sign."""
    eps = d.new_tensor(_DIAG_EPS)
    return torch.where(torch.abs(d) > _DIAG_EPS, d,
                       torch.where(d >= 0, eps, -eps))


def lu_nopivot(A):
    """Pivot-free Doolittle LU of A [B, n, n]: N rank-1 Schur updates of
    the trailing block; returns the packed L\\U."""
    M = A.clone()
    n = M.shape[-1]
    for k in range(n - 1):
        piv = _clamp(M[:, k, k])
        l_col = M[:, k + 1:, k] / piv[:, None]
        M[:, k + 1:, k + 1:] -= l_col[:, :, None] * M[:, k, None, k + 1:]
        M[:, k + 1:, k] = l_col
    return M


def solve_nopivot(lu, b):
    """Solve from a :func:`lu_nopivot` factor: the unit-L forward sweep,
    then the U backward sweep with the clamped diagonal. b [B, n]."""
    y = torch.linalg.solve_triangular(lu, b[..., None], upper=False,
                                      unitriangular=True)
    U = torch.triu(lu, 1) + torch.diag_embed(
        _clamp(torch.diagonal(lu, dim1=-2, dim2=-1)))
    return torch.linalg.solve_triangular(U, y, upper=True)[..., 0]


class BorderedFactor(NamedTuple):
    """Factor of M = [[A, b], [c^T, d]]: packed L\\U of A [B, KK, KK],
    v = A^-1 b [B, KK], the border row c [B, KK] and the clamped Schur
    scalar [B]."""
    lu: Any
    v: Any
    c: Any
    d_schur: Any


def newton_matrix(J, hg):
    """M = I - hg J for per-lane hg [B]."""
    n = J.shape[-1]
    eye = torch.eye(n, dtype=J.dtype, device=J.device)
    return eye - hg[:, None, None] * J


def factor_bordered(J, hg) -> BorderedFactor:
    """Form M = I - hg J and factor it by block elimination of the last
    row/column over a pivot-free LU of the leading block."""
    M = newton_matrix(J, hg)
    A = M[:, :-1, :-1]
    b = M[:, :-1, -1]
    c = M[:, -1, :-1].contiguous()
    d = M[:, -1, -1]
    lu = lu_nopivot(A)
    v = solve_nopivot(lu, b)
    d_schur = _clamp(d - (c * v).sum(-1))
    return BorderedFactor(lu=lu, v=v, c=c, d_schur=d_schur)


def solve_bordered(fac: BorderedFactor, r):
    """Solve M x = r from :func:`factor_bordered`: u = A^-1 r_Y, then
    x_T = (r_T - c . u) / d_schur and x_Y = u - x_T v."""
    u = solve_nopivot(fac.lu, r[:, :-1])
    x_T = (r[:, -1] - (fac.c * u).sum(-1)) / fac.d_schur
    return torch.cat([u - x_T[:, None] * fac.v, x_T[:, None]], dim=1)


# -- partial pivoting (the reference's exact f64 path) ----------------------

#: relative residual above which :func:`solve_with_info` flags a solve
_INFO_RTOL = 1e-4


def lu_pivot(A):
    """LU with partial pivoting of A [B, n, n], LAPACK ``getrf``'s choice:
    in column k the row of largest |a| at or below the diagonal, the first
    one on ties. Returns (packed L\\U, perm [B, n] int64) with row i of
    the factored matrix being row perm[i] of A."""
    M = A.clone()
    B, n, _ = M.shape
    lanes = torch.arange(B, device=A.device)
    perm = torch.arange(n, device=A.device).repeat(B, 1)
    for k in range(n):
        p = k + torch.argmax(M[:, k:, k].abs(), dim=1)
        row_k, row_p = M[lanes, k].clone(), M[lanes, p].clone()
        M[lanes, k], M[lanes, p] = row_p, row_k
        i_k, i_p = perm[lanes, k].clone(), perm[lanes, p].clone()
        perm[lanes, k], perm[lanes, p] = i_p, i_k
        if k == n - 1:
            break
        piv = M[:, k, k]
        # a zero pivot means a zero column: getrf leaves it unscaled
        piv = torch.where(piv == 0, torch.ones_like(piv), piv)
        l_col = M[:, k + 1:, k] / piv[:, None]
        M[:, k + 1:, k + 1:] -= l_col[:, :, None] * M[:, k, None, k + 1:]
        M[:, k + 1:, k] = l_col
    return M, perm


def solve_pivot(lu, perm, b, *, clamp=False):
    """Solve from :func:`lu_pivot`: b [B, n] permuted, the unit-L forward
    sweep and the U backward sweep. ``clamp`` keeps the diagonal 1e-30
    away from zero, as the reference's bordered path does (its
    ``getrs``-based one-shot solve does not)."""
    pb = torch.gather(b, 1, perm)
    if clamp:
        return solve_nopivot(lu, pb)
    y = torch.linalg.solve_triangular(lu, pb[..., None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(torch.triu(lu), y,
                                         upper=True)[..., 0]


class PivotedBorderedFactor(NamedTuple):
    """Factor of a bordered M = [[A, b], [c^T, d]] with A pivoted by rows:
    packed L\\U of PA [B, KK, KK], perm [B, KK], v = A^-1 b, c and the
    clamped Schur scalar."""
    lu: Any
    perm: Any
    v: Any
    c: Any
    d_schur: Any


def factor_bordered_pivoted(M) -> PivotedBorderedFactor:
    """Factor the given bordered matrix M [B, N, N] (not I - hg J) by block
    elimination of the last row/column over a pivoted LU of the leading
    block: the reference's ``factor_bordered`` on its exact path."""
    lu, perm = lu_pivot(M[:, :-1, :-1])
    c = M[:, -1, :-1].contiguous()
    v = solve_pivot(lu, perm, M[:, :-1, -1].contiguous(), clamp=True)
    d_schur = _clamp(M[:, -1, -1] - (c * v).sum(-1))
    return PivotedBorderedFactor(lu=lu, perm=perm, v=v, c=c, d_schur=d_schur)


def solve_bordered_pivoted(fac: PivotedBorderedFactor, r):
    """Solve M x = r [B, N] from :func:`factor_bordered_pivoted`."""
    u = solve_pivot(fac.lu, fac.perm, r[:, :-1].contiguous(), clamp=True)
    x_T = (r[:, -1] - (fac.c * u).sum(-1)) / fac.d_schur
    return torch.cat([u - x_T[:, None] * fac.v, x_T[:, None]], dim=1)


def solve_with_info(A, b, *, row_equilibrate=False, bordered=False,
                    fault_mask=None):
    """One-shot A x = b [B, n] with the reference's exact-path contract:
    returns (x, unstable), ``unstable`` True where the residual of the
    FULL system fails ||b - A x|| <= 1e-4 ||b|| + 1e-300 (a NaN fails).
    ``row_equilibrate`` scales each row of (A, b) to unit max first (the
    check then runs on the scaled system, as the reference's does);
    ``bordered`` eliminates the last row/column through
    :func:`factor_bordered_pivoted`, else A is factored whole by
    :func:`lu_pivot`. ``fault_mask`` [B] bool (an injected
    ``linalg_unstable`` fault, or None): on those lanes x is scaled by 1e8
    after the check and ``unstable`` is forced, as the reference's
    injection makes the direction garbage (ops/linalg.py:479-487)."""
    if row_equilibrate:
        rs = 1.0 / torch.clamp(A.abs().amax(-1), min=1e-300)
        A = A * rs[:, :, None]
        b = b * rs
    if bordered:
        x = solve_bordered_pivoted(factor_bordered_pivoted(A), b)
    else:
        lu, perm = lu_pivot(A)
        x = solve_pivot(lu, perm, b)
    r = b - (A @ x[:, :, None])[..., 0]
    rn = torch.sqrt((r * r).sum(-1))
    bn = torch.sqrt((b * b).sum(-1))
    unstable = ~(rn <= _INFO_RTOL * bn + 1e-300)
    if fault_mask is not None:
        x = torch.where(fault_mask[:, None], x * 1e8, x)
        unstable = unstable | fault_mask
    return x, unstable
