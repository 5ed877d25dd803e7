"""Wrappers of the hand-written CUDA kernels of the ignition-delay sweep.

- :func:`rhs` (K1, ``csrc/rhs.cu``): the RHS f = dy/dt, [B, N] -> [B, N];
- :func:`rhs_jac` (K2, ``csrc/rhs_jac.cu``): the fused (f, J);
- :func:`bordered_factor` (K3, ``csrc/bordered_factor.cu``): forms
  M = I - hg J and factors it (pivot-free LU of the species block, Schur
  elimination of the T border);
- :func:`bordered_solve` (K4, ``csrc/bordered_solve.cu``): x = M^-1 r;
- :func:`sdirk_round` (K5, ``csrc/sdirk_round.cu``): up to R SDIRK3 step
  attempts per lane in one launch, built from the lane bodies of K1-K4;
- :func:`equil_solve` (K6, ``csrc/equilibrium.cu``): a whole chemical
  equilibrium per lane (one warp), all iterations in one launch;
- :func:`psr_solve` (K7, ``csrc/psr_solve.cu``): a whole PSR steady-state
  solve per lane (one block), Newton, pseudo-transient rescue and polish.

K1, K2 and K5 take the reactor's ``problem``: "CONP" (the lane's
constraint value is its pressure) or "CONV" (its density); each problem
is its own instantiation of one lane body, counted under its own name in
:data:`LAUNCHES` ("rhs", "rhs_conv", ...).

A tensor on the CPU goes to the kernel's plain PyTorch twin in
:mod:`pychemkin_tpu_torch.ops`; a CUDA tensor launches the kernel on the
current stream, or the wrapper raises. Each wrapper checks device, dtype,
shape and contiguity, allocates its outputs, raises if the C launcher
returns a CUDA error, and adds one to its entry of :data:`LAUNCHES` per
launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import P_ATM, R_GAS
from ..ops.linalg import BorderedFactor
from . import build

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"rhs": 0, "rhs_conv": 0, "rhs_jac": 0, "rhs_jac_conv": 0,
            "bordered_factor": 0, "bordered_solve": 0, "sdirk_round": 0,
            "sdirk_round_conv": 0, "equil_solve": 0, "psr_solve": 0}

#: kernel code of each problem (the template parameter PROB of chem.cuh)
PROBLEMS = {"CONP": 0, "CONV": 1}

#: K6's limits: n = MM + 3 unknowns, KK <= 32 * EQ_MAX_SPT species
EQ_MAX_N = 12
EQ_MAX_SPT = 4
#: K7's solve keeps up to SOLVE_MAXR_PSR species a thread of warp 0
SOLVE_MAXR_PSR = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_PTR_FIELDS = (
    "wt", "nasa_lo", "nasa_hi", "t_mid", "A", "beta", "Ea_R", "plain_tb_i",
    "fo_rows", "fo_lowA", "fo_lowb", "fo_lowE", "fo_type", "fo_chem",
    "fo_troe", "fo_sri", "tb_rows", "tb_eff", "rev_rows", "rev_dnu",
    "rev_hasp", "rev_A", "rev_beta", "rev_Ea_R", "kc_ptr", "kc_sp",
    "kc_coef", "of_ptr", "of_sp", "of_coef", "or_ptr", "or_sp", "or_coef",
    "nus_ptr", "nus_rxn", "nus_coef", "jac_ptr", "jac_rxn", "jac_cf",
    "jac_cr", "tbs_ptr", "tbs_row", "tbs_nu", "ncf")


class MechView(ctypes.Structure):
    """Mirror of ``chem::MechView`` (csrc/chem.cuh)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [("r_gas", ctypes.c_double), ("p_atm", ctypes.c_double)]
                + [(n, ctypes.c_int) for n in ("KK", "II", "n_fo", "n_tb",
                                               "n_rev", "MM")])


def mech_view(tm) -> MechView:
    """The kernels' view of a TorchMechanism (cached on it; the tensors
    it points to live as long as the mechanism)."""
    view = getattr(tm, "_kernel_view", None)
    if view is not None:
        return view
    ptrs = {}
    for n in _PTR_FIELDS:
        t = getattr(tm, n)
        if not t.is_contiguous():
            raise ValueError(f"mechanism tensor {n} is not contiguous")
        ptrs[n] = t.data_ptr() if t.numel() else None
    view = MechView(**ptrs, r_gas=R_GAS, p_atm=P_ATM, KK=tm.KK, II=tm.II,
                    n_fo=tm.fo_rows.numel(), n_tb=tm.tb_rows.numel(),
                    n_rev=tm.rev_rows.numel(), MM=tm.MM)
    tm._kernel_view = view
    return view


class SdirkArgs(ctypes.Structure):
    """Mirror of ``SdirkArgs`` (csrc/sdirk_round.cu): the lanes and the
    carried step state of :mod:`..ops.odeint`, then the scalars."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "constraint", "atol", "t_end", "thresh", "t", "y", "f", "h",
        "n_steps", "n_rejected", "n_newton", "consec_rej", "acc_t", "acc_v",
        "stalled", "status", "dt_min")]
                + [("rtol", ctypes.c_double), ("budget", ctypes.c_longlong),
                   ("max_attempts", ctypes.c_int),
                   ("event_mode", ctypes.c_int)])


class EquilArgs(ctypes.Structure):
    """Mirror of ``EquilArgs`` (csrc/equilibrium.cu): the lanes' initial
    states, the result fields of ``ops.equilibrium.EquilibriumResult``,
    then the option and the main iteration count."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "T", "P", "Y", "T_out", "P_out", "X", "Y_out", "nbar", "h", "u", "s",
        "v", "residual", "converged", "status")]
                + [("option", ctypes.c_int), ("n_iter", ctypes.c_int)])


class PsrArgs(ctypes.Structure):
    """Mirror of ``PsrArgs`` (csrc/psr_solve.cu): the lanes of
    ``ops.psr.PSRArgs`` and the guess, the ``PSRSolution`` fields, then the
    controls of ``ops.psr.PSRControls``, the mode and the energy."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "P", "Y_in", "h_in", "tau", "volume", "mdot", "qloss", "T_fixed",
        "y0", "T", "Y", "rho", "tau_out", "volume_out", "residual",
        "converged", "n_newton", "n_direct", "n_polish", "status")]
                + [(n, ctypes.c_double) for n in (
                    "ss_atol", "ss_rtol", "dt0", "up", "down", "dt_min",
                    "dt_max", "T_max", "species_floor")]
                + [(n, ctypes.c_int) for n in (
                    "n_newton_max", "n_pseudo", "mode", "energy")])


def _check(name, t, shape, dtype=torch.float64):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain twin); raises for mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel: CUDA error {rc}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# -- wrappers ----------------------------------------------------------------

def _check_mech(tm, y):
    if tm.device != y.device:
        raise ValueError(f"mechanism on {tm.device}, state on {y.device}")


def _problem(problem) -> int:
    if problem not in PROBLEMS:
        raise ValueError(f"unknown problem {problem!r}: expected one of "
                         f"{sorted(PROBLEMS)}")
    return PROBLEMS[problem]


def launch_name(kernel, problem="CONP"):
    """The :data:`LAUNCHES` entry of ``kernel`` for ``problem``."""
    return kernel if problem == "CONP" else f"{kernel}_{problem.lower()}"


def rhs(tm, y, c, problem="CONP"):
    """K1: the ENRG RHS of ``problem``, ``y`` [B, N] and the constraint
    value ``c`` [B] (pressure for CONP, density for CONV) -> f [B, N]."""
    code = _problem(problem)
    B = y.shape[0]
    _check("y", y, (B, tm.N))
    _check("c", c, (B,))
    if not _route(y, c):
        from ..ops.reactors import RHS_TWINS
        return RHS_TWINS[problem][0](tm, y, c)
    _check_mech(tm, y)
    f = torch.empty_like(y)
    _raise_on(build.library().chem_rhs(
        ctypes.byref(mech_view(tm)), y.data_ptr(), c.data_ptr(),
        f.data_ptr(), B, code, _stream(y.device)), "rhs")
    LAUNCHES[launch_name("rhs", problem)] += 1
    return f


def rhs_jac(tm, y, c, problem="CONP"):
    """K2: the fused ENRG (f [B, N], J [B, N, N]) of ``problem``."""
    code = _problem(problem)
    B, N = y.shape[0], tm.N
    _check("y", y, (B, N))
    _check("c", c, (B,))
    if not _route(y, c):
        from ..ops.reactors import RHS_TWINS
        return RHS_TWINS[problem][1](tm, y, c)
    _check_mech(tm, y)
    f = torch.empty_like(y)
    J = torch.empty(B, N, N, dtype=y.dtype, device=y.device)
    _raise_on(build.library().chem_rhs_jac(
        ctypes.byref(mech_view(tm)), y.data_ptr(), c.data_ptr(),
        f.data_ptr(), J.data_ptr(), B, code, _stream(y.device)), "rhs_jac")
    LAUNCHES[launch_name("rhs_jac", problem)] += 1
    return f, J


def bordered_factor(J, hg):
    """K3: factor M = I - hg J, ``J`` [B, N, N], ``hg`` [B]."""
    B, N = J.shape[0], J.shape[-1]
    _check("J", J, (B, N, N))
    _check("hg", hg, (B,))
    if not _route(J, hg):
        from ..ops.linalg import factor_bordered
        return factor_bordered(J, hg)
    n = N - 1
    opt = dict(dtype=J.dtype, device=J.device)
    lu = torch.empty(B, n, n, **opt)
    v = torch.empty(B, n, **opt)
    c = torch.empty(B, n, **opt)
    dsch = torch.empty(B, **opt)
    _raise_on(build.library().chem_bordered_factor(
        J.data_ptr(), hg.data_ptr(), lu.data_ptr(), v.data_ptr(),
        c.data_ptr(), dsch.data_ptr(), B, N, _stream(J.device)),
        "bordered_factor")
    LAUNCHES["bordered_factor"] += 1
    return BorderedFactor(lu=lu, v=v, c=c, d_schur=dsch)


def bordered_solve(fac: BorderedFactor, r):
    """K4: solve M x = r from :func:`bordered_factor`, ``r`` [B, N]."""
    B, N = r.shape
    n = N - 1
    _check("r", r, (B, N))
    _check("lu", fac.lu, (B, n, n))
    _check("v", fac.v, (B, n))
    _check("c", fac.c, (B, n))
    _check("d_schur", fac.d_schur, (B,))
    if not _route(r, fac.lu, fac.v, fac.c, fac.d_schur):
        from ..ops.linalg import solve_bordered
        return solve_bordered(fac, r)
    x = torch.empty_like(r)
    _raise_on(build.library().chem_bordered_solve(
        fac.lu.data_ptr(), fac.v.data_ptr(), fac.c.data_ptr(),
        fac.d_schur.data_ptr(), r.data_ptr(), x.data_ptr(), B, N,
        _stream(r.device)), "bordered_solve")
    LAUNCHES["bordered_solve"] += 1
    return x


def sdirk_round(tm, lanes, state, *, rtol, budget, max_attempts,
                event_mode, problem):
    """K5: up to ``max_attempts`` SDIRK3 step attempts on every lane of
    ``state`` (an :class:`~..ops.odeint.StepState`) that is short of its
    t_end, not stalled and under ``budget`` attempts; ``lanes`` is the
    sweep's :class:`~..ops.odeint.Lanes`, ``event_mode`` the index of the
    ignition mode in ``ops.reactors.IGNITION_MODES`` (0 T_inflection,
    1 T_rise). Returns the advanced state: on the card the state's
    tensors are updated in place (one launch, one block per lane); on the
    CPU its twin, :func:`..ops.odeint.sweep_round` over the plain ops,
    returns a new state."""
    code = _problem(problem)
    if event_mode not in (0, 1):
        raise ValueError(f"event_mode must be 0 or 1, got {event_mode!r}")
    if int(max_attempts) < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts!r}")
    B, N = state.y.shape
    if N != tm.N:
        raise ValueError(f"state.y: expected {tm.N} columns, got {N}")
    f64, i64 = torch.float64, torch.int64
    for name, shape, dtype in (
            ("t", (B,), f64), ("y", (B, N), f64), ("f", (B, N), f64),
            ("h", (B,), f64), ("n_steps", (B,), i64),
            ("n_rejected", (B,), i64), ("n_newton", (B,), i64),
            ("consec_rej", (B,), i64), ("acc_t", (B, 1), f64),
            ("acc_v", (B, 1), f64), ("stalled", (B,), torch.bool),
            ("status", (B,), torch.int32), ("dt_min", (B,), f64)):
        _check(name, getattr(state, name), shape, dtype)
    for name, shape in (("constraint", (B,)), ("atol", (B, N)),
                        ("t_end", (B,)), ("thresh", (B,))):
        _check(name, getattr(lanes, name), shape)
    if not _route(*state, *lanes):
        from ..ops.odeint import sweep_round
        from ..ops.reactors import IGNITION_MODES, ignition_events, plain_ops
        return sweep_round(plain_ops(problem), tm, lanes,
                           ignition_events(IGNITION_MODES[event_mode]),
                           rtol, budget, state,
                           max_attempts=int(max_attempts))
    _check_mech(tm, state.y)
    args = SdirkArgs(**{n: getattr(lanes, n).data_ptr() for n in
                        ("constraint", "atol", "t_end", "thresh")},
                     **{n: getattr(state, n).data_ptr() for n in (
                         "t", "y", "f", "h", "n_steps", "n_rejected",
                         "n_newton", "consec_rej", "acc_t", "acc_v",
                         "stalled", "status", "dt_min")},
                     rtol=float(rtol), budget=int(budget),
                     max_attempts=int(max_attempts),
                     event_mode=int(event_mode))
    _raise_on(build.library().chem_sdirk_round(
        ctypes.byref(mech_view(tm)), ctypes.byref(args), B, code,
        _stream(state.y.device)), "sdirk_round")
    LAUNCHES[launch_name("sdirk_round", problem)] += 1
    return state


def equil_solve(tm, T, P, Y, option, n_iter):
    """K6: the equilibrium of every lane from its initial state ``T``,
    ``P`` [B] and ``Y`` [B, KK] holding the pair of ``option`` (1-9), with
    ``n_iter`` main iterations: an
    :class:`~..ops.equilibrium.EquilibriumResult`. One warp per lane runs
    the whole solve (start, pre-phase, main iterations, the nested ln T
    loop of options 6 and 9, the finish); the CPU twin is
    :func:`..ops.equilibrium.equilibrate_plain`."""
    from ..ops import equilibrium
    if int(option) not in equilibrium.EQ_OPTIONS:
        raise ValueError(f"option must be one of 1-9, got {option!r}")
    if int(n_iter) < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter!r}")
    B = T.shape[0]
    _check("T", T, (B,))
    _check("P", P, (B,))
    _check("Y", Y, (B, tm.KK))
    if not _route(T, P, Y):
        return equilibrium.equilibrate_plain(tm, T, P, Y, int(option),
                                             int(n_iter))
    _check_mech(tm, Y)
    if tm.MM + 3 > EQ_MAX_N or tm.KK > 32 * EQ_MAX_SPT:
        raise ValueError(f"equil_solve takes MM <= {EQ_MAX_N - 3} and KK <= "
                         f"{32 * EQ_MAX_SPT}, got {tm.MM}, {tm.KK}")
    f64 = dict(dtype=torch.float64, device=Y.device)
    out = {n: torch.empty(B, **f64) for n in (
        "T", "P", "nbar", "h", "u", "s", "v", "residual")}
    X = torch.empty(B, tm.KK, **f64)
    Yo = torch.empty(B, tm.KK, **f64)
    conv = torch.empty(B, dtype=torch.bool, device=Y.device)
    status = torch.empty(B, dtype=torch.int32, device=Y.device)
    args = EquilArgs(T=T.data_ptr(), P=P.data_ptr(), Y=Y.data_ptr(),
                     T_out=out["T"].data_ptr(), P_out=out["P"].data_ptr(),
                     X=X.data_ptr(), Y_out=Yo.data_ptr(),
                     **{n: out[n].data_ptr() for n in (
                         "nbar", "h", "u", "s", "v", "residual")},
                     converged=conv.data_ptr(), status=status.data_ptr(),
                     option=int(option), n_iter=int(n_iter))
    _raise_on(build.library().chem_equil_solve(
        ctypes.byref(mech_view(tm)), ctypes.byref(args), B,
        _stream(Y.device)), "equil_solve")
    LAUNCHES["equil_solve"] += 1
    return equilibrium.EquilibriumResult(
        T=out["T"], P=out["P"], X=X, Y=Yo, nbar=out["nbar"], h=out["h"],
        u=out["u"], s=out["s"], v=out["v"], residual=out["residual"],
        converged=conv, status=status)


def psr_solve(tm, mode, energy, args, y0, ctl):
    """K7: the whole PSR solve of every lane, ``args`` an
    :class:`~..ops.psr.PSRArgs` of [B] lanes, ``y0`` [B, N] the guess,
    ``ctl`` the :class:`~..ops.psr.PSRControls`: a
    :class:`~..ops.psr.PSRSolution`. One thread block per lane runs the
    direct Newton, and on a lane it leaves unconverged the
    pseudo-transient phase and the polish, then the finish; the CPU twin
    is :func:`..ops.psr.solve_psr_plain`."""
    from ..ops import psr
    if mode not in psr.MODES or energy not in psr.ENERGIES:
        raise ValueError(f"mode must be one of {psr.MODES} and energy one "
                         f"of {psr.ENERGIES}, got {mode!r}, {energy!r}")
    B, N = y0.shape
    if N != tm.N:
        raise ValueError(f"y0: expected {tm.N} columns, got {N}")
    _check("y0", y0, (B, N))
    for name in psr.PSRArgs._fields:
        _check(name, getattr(args, name),
               (B, tm.KK) if name == "Y_in" else (B,))
    if int(ctl.n_newton) < 1 or int(ctl.n_pseudo) < 0:
        raise ValueError("n_newton must be >= 1 and n_pseudo >= 0")
    if not _route(y0, *args):
        return psr.solve_psr_plain(tm, mode, energy, args, y0, ctl)
    _check_mech(tm, y0)
    if tm.KK > 32 * SOLVE_MAXR_PSR:
        raise ValueError(f"psr_solve takes KK <= {32 * SOLVE_MAXR_PSR}")
    dev = y0.device
    f64 = dict(dtype=torch.float64, device=dev)
    out = {n: torch.empty(B, **f64) for n in (
        "T", "rho", "tau_out", "volume_out", "residual")}
    Y = torch.empty(B, tm.KK, **f64)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    counts = {n: torch.empty(B, dtype=torch.int64, device=dev)
              for n in ("n_newton", "n_direct", "n_polish")}
    status = torch.empty(B, dtype=torch.int32, device=dev)
    a = PsrArgs(**{n: getattr(args, n).data_ptr() for n in psr.PSRArgs._fields},
                y0=y0.data_ptr(), Y=Y.data_ptr(),
                **{n: t.data_ptr() for n, t in out.items()},
                converged=conv.data_ptr(),
                **{n: t.data_ptr() for n, t in counts.items()},
                status=status.data_ptr(),
                ss_atol=float(ctl.ss_atol), ss_rtol=float(ctl.ss_rtol),
                dt0=float(ctl.pseudo_dt0), up=float(ctl.pseudo_up),
                down=float(ctl.pseudo_down), dt_min=float(ctl.pseudo_dt_min),
                dt_max=float(ctl.pseudo_dt_max), T_max=float(ctl.T_max),
                species_floor=float(ctl.species_floor),
                n_newton_max=int(ctl.n_newton), n_pseudo=int(ctl.n_pseudo),
                mode=psr.MODES.index(mode), energy=psr.ENERGIES.index(energy))
    _raise_on(build.library().chem_psr_solve(
        ctypes.byref(mech_view(tm)), ctypes.byref(a), B, _stream(dev)),
        "psr_solve")
    LAUNCHES["psr_solve"] += 1
    return psr.PSRSolution(
        T=out["T"], Y=Y, rho=out["rho"], tau=out["tau_out"],
        volume=out["volume_out"], residual=out["residual"], converged=conv,
        n_newton=counts["n_newton"], n_newton_direct=counts["n_direct"],
        n_newton_polish=counts["n_polish"], status=status)


__all__ = ["LAUNCHES", "PROBLEMS", "bordered_factor", "bordered_solve",
           "equil_solve", "launch_name", "psr_solve", "reset_launches",
           "rhs", "rhs_jac", "sdirk_round"]
