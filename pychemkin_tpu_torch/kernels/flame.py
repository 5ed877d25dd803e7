"""Wrappers of the premixed flame's CUDA kernels.

- :func:`transport_props` (K9, ``csrc/transport.cu``): every transport
  property of B states (T, P [B], X [B, KK]);
- :func:`flame_residual` (K10, ``csrc/flame_residual.cu``): the flame's
  residual F [N, M] at the packed state u [N, M];
- :func:`flame_jac` (K11, ``csrc/flame_jac.cu``): the blocks (B, A, C)
  [N, M, M] of dF/du;
- :func:`block_thomas` (K12, ``csrc/block_thomas.cu``): the
  block-tridiagonal solve x [N, M].

K10 and K11 run the chemistry lane body of K1/K2: the XK body for a
mechanism with PLOG rows or fractional orders, counted as
"flame_residual_xk" / "flame_jac_xk" in :data:`~.LAUNCHES`. As for K1-K8,
CPU tensors go to the plain twins (:mod:`..ops.transport`,
:mod:`..ops.flame1d`, :mod:`..ops.blocktridiag`), CUDA tensors launch the
kernel on the current stream or raise, and each launch adds one to its
entry of :data:`~.LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, _check, _check_mech, _raise_on, _route, _stream,
               build, extended, launch_name, mech_view)


class TransView(ctypes.Structure):
    """Mirror of ``chem::TransView`` (csrc/transport.cuh)."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "geom", "eps_k", "sigma", "zrot", "delta", "psig", "peps", "pmred",
        "pdelta")]


class TransportCall(ctypes.Structure):
    """Mirror of ``chem::TransportCall`` (csrc/transport.cuh)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "T", "P", "X", "mu_k", "lam_k", "mu", "lam", "D", "theta", "Djk",
        "ws")]
                + [("B", ctypes.c_int), ("stream", ctypes.c_void_p)])


class FlameArgs(ctypes.Structure):
    """Mirror of ``chem::FlameArgs`` (csrc/flame.cuh)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "u", "x", "T_given", "Y_in", "F", "Bb", "Ab", "Cb", "ws")]
                + [(n, ctypes.c_double) for n in (
                    "P", "T_in", "mdot_in", "T_fix", "lewis")]
                + [(n, ctypes.c_int) for n in (
                    "N", "i_fix", "tgiv", "free_flame", "upwind", "lewis_tr",
                    "soret", "flux_bc")])


def trans_view(tm) -> TransView:
    """The kernels' view of the mechanism's transport data, with the pair
    parameters and the species reduced dipole computed once by the plain
    twin's formulas (cached on the mechanism with the tensors it points
    to)."""
    view = tm.__dict__.get("_trans_view")
    if view is not None:
        return view
    if not tm.has_transport:
        raise ValueError("the mechanism has no transport data")
    from ..ops import transport
    pp = transport.pair_params(tm)
    delta = transport._reduced_dipole(tm).contiguous()
    tm._trans_keep = (delta, pp)
    view = TransView(
        geom=tm.geom.data_ptr(), eps_k=tm.eps_k.data_ptr(),
        sigma=tm.sigma.data_ptr(), zrot=tm.zrot.data_ptr(),
        delta=delta.data_ptr(), psig=pp.sigma.data_ptr(),
        peps=pp.eps.data_ptr(), pmred=pp.m_red.data_ptr(),
        pdelta=pp.delta.data_ptr())
    tm._trans_view = view
    return view


def transport_props(tm, T, P, X):
    """K9: the transport properties of the states (T, P [B], X [B, KK]):
    an :class:`~..ops.transport.TransportProps` (species viscosities and
    conductivities, mixture viscosity and conductivity, D_km, Theta and
    the binary diffusion coefficients)."""
    from ..ops import transport
    B = T.shape[0]
    _check("T", T, (B,))
    _check("P", P, (B,))
    _check("X", X, (B, tm.KK))
    if not _route(T, P, X):
        return transport.transport_props(tm, T, P, X)
    _check_mech(tm, X)
    opt = dict(dtype=torch.float64, device=X.device)
    out = {n: torch.empty(B, tm.KK, **opt) for n in ("mu_k", "lam_k", "D",
                                                     "theta")}
    mu = torch.empty(B, **opt)
    lam = torch.empty(B, **opt)
    Djk = torch.empty(B, tm.KK, tm.KK, **opt)
    ws = torch.empty(B * 2 * tm.KK, **opt)
    call = TransportCall(T=T.data_ptr(), P=P.data_ptr(), X=X.data_ptr(),
                         **{n: t.data_ptr() for n, t in out.items()},
                         mu=mu.data_ptr(), lam=lam.data_ptr(),
                         Djk=Djk.data_ptr(), ws=ws.data_ptr(), B=B,
                         stream=_stream(X.device))
    _raise_on(build.library().chem_transport_props(
        ctypes.byref(mech_view(tm)), ctypes.byref(trans_view(tm)),
        ctypes.byref(call)), "transport_props")
    LAUNCHES["transport_props"] += 1
    return transport.TransportProps(mu_k=out["mu_k"], lam_k=out["lam_k"],
                                    mu=mu, lam=lam, D_km=out["D"],
                                    theta=out["theta"], Djk=Djk)


def _flame_checks(tm, u, data):
    N, M = u.shape
    if M != tm.KK + 2:
        raise ValueError(f"u: expected {tm.KK + 2} columns, got {M}")
    if N < 3:
        raise ValueError(f"u: the flame needs >= 3 grid points, got {N}")
    _check("u", u, (N, M))
    _check("x", data.x, (N,))
    _check("T_given", data.T_given, (N,))
    _check("Y_in", data.Y_in, (tm.KK,))
    return N, M


def _flame_args(tm, cfg, u, data, ws, **out):
    return FlameArgs(
        u=u.data_ptr(), x=data.x.data_ptr(), T_given=data.T_given.data_ptr(),
        Y_in=data.Y_in.data_ptr(), ws=ws.data_ptr(),
        **{n: t.data_ptr() for n, t in out.items()},
        P=float(data.P), T_in=float(data.T_in), mdot_in=float(data.mdot_in),
        T_fix=float(data.T_fix), lewis=float(cfg.lewis), N=u.shape[0],
        i_fix=int(data.i_fix), tgiv=int(cfg.energy == "TGIV"),
        free_flame=int(cfg.free_flame), upwind=int(cfg.upwind),
        lewis_tr=int(cfg.transport == "LEWIS"), soret=int(cfg.soret),
        flux_bc=int(cfg.species_flux_bc))


def _flame_ws(tm, N, jac, device):
    n = build.library().chem_flame_ws_doubles(tm.KK, N, int(jac))
    return torch.empty(n, dtype=torch.float64, device=device)


def flame_residual(tm, cfg, u, data):
    """K10: the residual F [N, M] of the flame problem ``cfg`` (an
    :class:`~..ops.flame1d.FlameConfig`) at the packed state u [N, M] with
    the :class:`~..ops.flame1d.FlameData` ``data`` (tensors on u's
    device)."""
    N, M = _flame_checks(tm, u, data)
    tensors = (u, data.x, data.T_given, data.Y_in)
    if not _route(*tensors):
        from ..ops.flame1d import make_residual
        return make_residual(tm, cfg)[0](u, data)
    _check_mech(tm, u)
    F = torch.empty_like(u)
    ws = _flame_ws(tm, N, False, u.device)
    args = _flame_args(tm, cfg, u, data, ws, F=F)
    _raise_on(build.library().chem_flame_residual(
        ctypes.byref(mech_view(tm)), ctypes.byref(trans_view(tm)),
        ctypes.byref(args), _stream(u.device)), "flame_residual")
    LAUNCHES[launch_name("flame_residual", xk=extended(tm))] += 1
    return F


def flame_jac(tm, cfg, u, data):
    """K11: the blocks (B, A, C) [N, M, M] of dF/du (B_0 = C_{N-1} = 0),
    the arguments as :func:`flame_residual`'s."""
    N, M = _flame_checks(tm, u, data)
    tensors = (u, data.x, data.T_given, data.Y_in)
    if not _route(*tensors):
        from ..ops.flame1d import make_residual
        return make_residual(tm, cfg)[1](u, data)
    _check_mech(tm, u)
    blocks = [torch.empty(N, M, M, dtype=u.dtype, device=u.device)
              for _ in range(3)]
    ws = _flame_ws(tm, N, True, u.device)
    args = _flame_args(tm, cfg, u, data, ws, Bb=blocks[0], Ab=blocks[1],
                       Cb=blocks[2])
    _raise_on(build.library().chem_flame_jac(
        ctypes.byref(mech_view(tm)), ctypes.byref(trans_view(tm)),
        ctypes.byref(args), _stream(u.device)), "flame_jac")
    LAUNCHES[launch_name("flame_jac", xk=extended(tm))] += 1
    return tuple(blocks)


def block_thomas(B, A, C, d):
    """K12: x [N, M] of the block-tridiagonal system (B, A, C [N, M, M],
    d [N, M]); partial pivoting in each diagonal block's factor."""
    N, M = d.shape
    for name, t in (("B", B), ("A", A), ("C", C)):
        _check(name, t, (N, M, M))
    _check("d", d, (N, M))
    if not _route(B, A, C, d):
        from ..ops.blocktridiag import solve
        return solve(B, A, C, d)
    if M > 128:
        raise ValueError(f"block_thomas takes M <= 128, got {M}")
    x = torch.empty_like(d)
    ws = torch.empty(N * M * M + N * M, dtype=d.dtype, device=d.device)
    _raise_on(build.library().chem_block_thomas(
        B.data_ptr(), A.data_ptr(), C.data_ptr(), d.data_ptr(), x.data_ptr(),
        ws.data_ptr(), N, M, _stream(d.device)), "block_thomas")
    LAUNCHES["block_thomas"] += 1
    return x
