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
  solve per lane (one block), Newton, pseudo-transient rescue and polish;
- :func:`gershgorin_rate` (K8, ``csrc/gershgorin.cu``): the Gershgorin
  bound max_i sum_j |J_ij| of the reactor's closed-form Jacobian at each
  lane's state, [B, N] -> [B] (the scheduler's stiffness proxy and the
  solve profile's ``stiffness``);
- the premixed flame's kernels, in :mod:`.flame`: ``transport_props``
  (K9), ``flame_residual`` (K10), ``flame_jac`` (K11) and
  ``block_thomas`` (K12).

K1, K2, K5 and K8 take the reactor's ``problem`` code (:data:`PROBLEMS`):
"CONP" and "CONP_TGIV" (the lane's constraint value is its pressure),
"CONV" and "CONV_TGIV" (its density), with the energy equation or at the
state's own temperature. Each code is its own instantiation of one lane
body, and K5 has a PIVOT instantiation (partial pivoting in the Newton
matrix's factor) and a FAULT one (per-lane injected faults) of each. A
mechanism with PLOG rows or fractional FORD/RORD orders runs the lane
body that computes them (XK); the others run the body without them, the
same code as before those were ported. Every instantiation is counted
under its own name in :data:`LAUNCHES` (:func:`launch_name`: "rhs",
"rhs_conv_xk", "sdirk_round_conp_tgiv_pivot", ...).

Two more template flags, each its own instantiation:

- PRF ("_prf"): K1, K2, K5 and K8 for ``solve_batch``'s reactors, whose
  constraint value (P(t), or rho = mass / V(t)), given temperature T(t)
  and wall heat loss come from piecewise-linear profiles at each RHS's
  time (:class:`~..ops.reactors.BatchArgs` in place of the [B] constraint
  values; the lanes' times ``t``);
- GM ("_gm"): K1, K2, K5, K6, K7 and K8 with each lane's working set in
  its slice of a device-memory workspace the wrapper allocates from
  PyTorch's caching allocator, for mechanisms whose lane does not fit in
  the card's opt-in shared memory (:func:`storage` decides from the
  mechanism's sizes and the limit the card reports; K6 first puts fewer
  lanes in a block). :data:`WORKSPACE_BYTES` holds each GM launch's
  workspace.

K6 and K7 also have a FAULT instantiation ("_fault"): per-lane
``linalg_unstable`` flags from :mod:`..resilience.faultinject`.

A tensor on the CPU goes to the kernel's plain PyTorch twin in
:mod:`pychemkin_tpu_torch.ops`; a CUDA tensor launches the kernel on the
current stream, or the wrapper raises. Each wrapper checks device, dtype,
shape and contiguity, allocates its outputs, raises if the C launcher
returns a CUDA error, and adds one to its entry of :data:`LAUNCHES` per
launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..constants import P_ATM, R_GAS
from ..ops.linalg import BorderedFactor
from . import build

#: kernel code of each problem (the template parameter PROB of chem.cuh)
PROBLEMS = {"CONP": 0, "CONV": 1, "CONP_TGIV": 2, "CONV_TGIV": 3}


def launch_name(kernel, problem="CONP", pivot=False, fault=False, xk=False,
                prf=False, gm=False):
    """The :data:`LAUNCHES` entry of ``kernel``'s instantiation for
    ``problem`` (and, for K5, ``pivot``; for K5, K6 and K7, ``fault``);
    ``xk``: the lane body with PLOG rows and fractional orders (K1, K2,
    K5, K7, K8); ``prf``: profiles (K1, K2, K5, K8); ``gm``: the lane in a
    device-memory workspace."""
    name = kernel if problem == "CONP" else f"{kernel}_{problem.lower()}"
    return (name + ("_pivot" if pivot else "") + ("_fault" if fault else "")
            + ("_prf" if prf else "") + ("_gm" if gm else "")
            + ("_xk" if xk else ""))


def extended(tm) -> bool:
    """The mechanism has PLOG rows or fractional orders (the XK body)."""
    return tm.n_plog > 0 or tm.any_frac


#: launches per kernel instantiation since the last :func:`reset_launches`
_TF = (False, True)
LAUNCHES = {n: 0 for n in (
    [launch_name(k, p, xk=x, prf=pr, gm=g) for k in ("rhs", "rhs_jac")
     for p in PROBLEMS for x in _TF for pr in _TF for g in _TF]
    + [launch_name(k, gm=g) for k in ("bordered_factor", "bordered_solve")
       for g in _TF]
    + [launch_name("sdirk_round", p, pv, fl, x, gm=g) for p in PROBLEMS
       for pv in _TF for fl in _TF for x in _TF for g in _TF]
    + [launch_name("sdirk_round", p, xk=x, prf=True, gm=g) for p in PROBLEMS
       for x in _TF for g in _TF]
    + [launch_name("equil_solve", fault=fl, gm=g) for fl in _TF for g in _TF]
    + [launch_name("psr_solve", fault=fl, xk=x, gm=g) for fl in _TF
       for x in _TF for g in _TF]
    + [launch_name("gershgorin_rate", p, xk=x, prf=pr, gm=g)
       for p in PROBLEMS for x in _TF for pr in _TF for g in _TF]
    + ["transport_props", "block_thomas"]
    + [launch_name(k, xk=x) for k in ("flame_residual", "flame_jac")
       for x in _TF])}

#: K6's limit: n = MM + 3 unknowns
EQ_MAX_N = 12
#: K6's most lanes (warps) a block
EQ_WARPS = 4
#: rows a thread of K4's register-held solve keeps (csrc/linalg.cuh):
#: species blocks beyond 32 * SOLVE_MAXR rows take the GM solve
SOLVE_MAXR = 4
#: the workspace bytes of the last GM launch of each instantiation
WORKSPACE_BYTES: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- lane storage ------------------------------------------------------------

def lane_doubles(kernel, KK, II, n_tb, n_plog, MM=0, pivot=False) -> int:
    """Doubles of one lane's working set of ``kernel`` ("rhs",
    "rhs_jac", "sdirk_round" (``pivot``: with the row order),
    "gershgorin_rate", "psr_solve", "bordered_factor"; "equil_solve": one
    warp's) for a
    mechanism of KK species, II reactions, n_tb third-body rows, n_plog
    PLOG rows and MM elements: the layouts of csrc/chem.cuh
    ``lane_smem_doubles``, sdirk_round.cuh ``sdirk_lane_doubles``,
    gershgorin.cuh, psr_solve.cuh ``psr_lane_doubles`` and equilibrium.cu
    ``eq_lane_doubles`` (the library's ``chem_*lane_doubles`` answer the
    same on the card)."""
    N = KK + 1
    lane = 13 * KK + 13 * II + n_tb + (3 * n_plog + KK if n_plog else 0) + 32
    jac = lane + KK * KK
    if kernel == "rhs":
        return lane
    if kernel == "rhs_jac":
        return jac
    if kernel == "bordered_factor":
        return KK * KK + 3 * KK + 32
    if kernel == "sdirk_round":
        return jac + 13 * N + 3 * KK + 4 + ((KK + 33) // 2 if pivot else 0)
    if kernel == "gershgorin_rate":
        return jac + N * N + N + 32
    if kernel == "psr_solve":
        return jac + N * N + 7 * N + 5 * KK + 64
    if kernel == "equil_solve":
        n = MM + 3
        return 11 * KK + (MM + 4) * (n + 1) + 2 * n * n + 3 * n + 3 * MM + n
    raise ValueError(f"unknown kernel {kernel!r}")


class Storage(NamedTuple):
    """Where a kernel keeps a lane: ``kind`` "shared" (the block's dynamic
    shared memory) or "global" (a device-memory workspace, the GM
    instantiation); ``lane_bytes`` one lane's working set; ``lanes`` the
    lanes a block holds (K6's warps; 1 for the others)."""
    kind: str
    lane_bytes: int
    lanes: int


def storage(kernel, tm, limit, pivot=False) -> Storage:
    """The size chooser: shared memory while one lane's working set of
    ``kernel`` (:func:`lane_doubles`) fits in ``limit`` bytes (the card's
    opt-in shared memory per block, :func:`smem_limit`), else the
    device-memory workspace. K6 holds up to EQ_WARPS lanes a block and
    first gives up lanes: it goes to the workspace only where not even
    one fits."""
    nb = 8 * lane_doubles(kernel, tm.KK, tm.II, tm.tb_rows.numel(),
                          tm.n_plog, tm.MM, pivot)
    if kernel == "equil_solve":
        lanes = min(EQ_WARPS, int(limit) // nb)
        return (Storage("shared", nb, lanes) if lanes >= 1
                else Storage("global", nb, EQ_WARPS))
    return Storage("shared" if nb <= int(limit) else "global", nb, 1)


_SMEM_LIMIT: dict = {}


def smem_limit(device) -> int:
    """The opt-in shared memory per block of the CUDA ``device``, in
    bytes, as the card reports it (cudaDevAttrMaxSharedMemoryPerBlockOptin,
    through the kernel library)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMEM_LIMIT:
        v = ctypes.c_int(0)
        _raise_on(build.library().chem_smem_optin(idx, ctypes.byref(v)),
                  "smem_optin")
        _SMEM_LIMIT[idx] = int(v.value)
    return _SMEM_LIMIT[idx]


def _workspace(tm, kernel, B, device, pivot=False):
    """(storage, workspace tensor or None) of a launch of ``kernel`` over
    B lanes on ``device``: the GM workspace holds the library's own lane
    size (``chem_*lane_doubles``) for each of the B lanes. The decision and
    the lane size are cached on the mechanism (per kernel, pivoting and
    device)."""
    cache = tm.__dict__.setdefault("_kernel_storage", {})
    key = (kernel, bool(pivot), str(device))
    if key not in cache:
        st = storage(kernel, tm, smem_limit(device), pivot)
        per = 0
        if st.kind == "global":
            lib, view = build.library(), ctypes.byref(mech_view(tm))
            if kernel == "psr_solve":
                per = lib.chem_psr_lane_doubles(view)
            elif kernel == "equil_solve":
                per = lib.chem_equil_lane_doubles(view)
            else:
                per = lib.chem_lane_doubles(view, _LANE_IDS[kernel],
                                            int(pivot))
            if per <= 0:
                raise RuntimeError(f"{kernel}: no lane size for the "
                                   "workspace")
        cache[key] = (st, per)
    st, per = cache[key]
    if st.kind == "shared":
        return st, None
    return st, torch.empty(B * per, dtype=torch.float64, device=device)


_LANE_IDS = {"rhs": 1, "rhs_jac": 2, "sdirk_round": 5, "gershgorin_rate": 8}


def _note_workspace(name, ws):
    if ws is not None:
        WORKSPACE_BYTES[name] = ws.numel() * 8


_PTR_FIELDS = (
    "wt", "nasa_lo", "nasa_hi", "t_mid", "A", "beta", "Ea_R", "plain_tb_i",
    "fo_rows", "fo_lowA", "fo_lowb", "fo_lowE", "fo_type", "fo_chem",
    "fo_troe", "fo_sri", "tb_rows", "tb_eff", "rev_rows", "rev_dnu",
    "rev_hasp", "rev_A", "rev_beta", "rev_Ea_R", "kc_ptr", "kc_sp",
    "kc_coef", "of_ptr", "of_sp", "of_coef", "or_ptr", "or_sp", "or_coef",
    "nus_ptr", "nus_rxn", "nus_coef", "jac_ptr", "jac_rxn", "jac_cf",
    "jac_cr", "tbs_ptr", "tbs_row", "tbs_nu", "ncf", "of_frac", "or_frac",
    "jac_ff", "jac_rf", "plog_idx", "plog_pos", "plog_n_levels",
    "plog_ln_P", "plog_A", "plog_beta", "plog_Ea_R")


class MechView(ctypes.Structure):
    """Mirror of ``chem::MechView`` (csrc/chem.cuh)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [("r_gas", ctypes.c_double), ("p_atm", ctypes.c_double)]
                + [(n, ctypes.c_int) for n in (
                    "KK", "II", "n_fo", "n_tb", "n_rev", "MM", "n_plog",
                    "plog_L", "plog_Tm", "any_frac")])


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
                    n_rev=tm.rev_rows.numel(), MM=tm.MM, n_plog=tm.n_plog,
                    plog_L=tm.plog_L, plog_Tm=tm.plog_Tm,
                    any_frac=int(tm.any_frac))
    tm._kernel_view = view
    return view


class ProfileView(ctypes.Structure):
    """Mirror of ``chem::ProfileView`` (csrc/chem.cuh): knots and values of
    the four profiles of a :class:`~..ops.reactors.BatchArgs`, the lanes'
    mass, htc and tamb, the knot counts, then each array's row stride per
    lane (0: shared by every lane)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "cx", "cy", "tx", "ty", "qx", "qy", "ax", "ay", "mass", "htc",
        "tamb")]
                + [(n, ctypes.c_int) for n in (
                    "cn", "tn", "qn", "an", "cxs", "cys", "txs", "tys", "qxs",
                    "qys", "axs", "ays")])


def _profile_rows(name, t, B):
    """(data pointer, row stride) of a profile array: [n] (shared) or
    [B, n] rows with unit inner stride (an expanded row has stride 0)."""
    if t.dtype != torch.float64:
        raise TypeError(f"{name}: expected torch.float64, got {t.dtype}")
    if t.ndim == 1:
        return t.data_ptr(), 0
    if t.ndim != 2 or t.shape[0] != B or t.stride(1) != 1:
        raise ValueError(f"{name}: expected [n] or [{B}, n] with unit "
                         f"inner stride, got shape {tuple(t.shape)}")
    return t.data_ptr(), t.stride(0)


def profile_view(prf, B) -> ProfileView:
    """The kernels' view of the profiles ``prf`` (a BatchArgs) of B lanes;
    the tensors must outlive the launch."""
    ptr, n, st = {}, {}, {}
    for key, p in zip("ctqa", (prf.constraint, prf.tprof, prf.qloss,
                               prf.area)):
        nk = p.x.shape[-1]
        if nk < 2 or p.y.shape[-1] != nk:
            raise ValueError(f"profile {key}: needs >= 2 knots with one "
                             f"value each, got {tuple(p.x.shape)}, "
                             f"{tuple(p.y.shape)}")
        ptr[key + "x"], st[key + "xs"] = _profile_rows(key + "x", p.x, B)
        ptr[key + "y"], st[key + "ys"] = _profile_rows(key + "y", p.y, B)
        n[key + "n"] = nk
    for name in ("mass", "htc", "tamb"):
        _check(name, getattr(prf, name), (B,))
    return ProfileView(**ptr, mass=prf.mass.data_ptr(),
                       htc=prf.htc.data_ptr(), tamb=prf.tamb.data_ptr(),
                       **n, **st)


def _profile_tensors(prf):
    return [*prf.constraint, *prf.tprof, *prf.qloss, *prf.area, prf.mass,
            prf.htc, prf.tamb]


class SdirkArgs(ctypes.Structure):
    """Mirror of ``SdirkArgs`` (csrc/sdirk_round.cuh): the lanes and the
    carried step state of :mod:`..ops.odeint`, the lanes' attempt caps and
    the workspace, then the scalars and the profiles."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "constraint", "atol", "t_end", "thresh", "fault", "fault_t", "t",
        "y", "f", "h", "n_steps", "n_rejected", "n_newton", "consec_rej",
        "acc_t", "acc_v", "stalled", "status", "dt_min", "budget", "ws")]
                + [("rtol", ctypes.c_double),
                   ("max_attempts", ctypes.c_int),
                   ("event_mode", ctypes.c_int),
                   ("species", ctypes.c_int),
                   ("prf", ProfileView)])


class EquilArgs(ctypes.Structure):
    """Mirror of ``EquilArgs`` (csrc/equilibrium.cu): the lanes' initial
    states, the result fields of ``ops.equilibrium.EquilibriumResult``,
    then the option and the main iteration count."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "T", "P", "Y", "T_out", "P_out", "X", "Y_out", "nbar", "h", "u", "s",
        "v", "residual", "converged", "status", "fault", "ws")]
                + [("option", ctypes.c_int), ("n_iter", ctypes.c_int)])


class PsrArgs(ctypes.Structure):
    """Mirror of ``PsrArgs`` (csrc/psr_solve.cu): the lanes of
    ``ops.psr.PSRArgs`` and the guess, the ``PSRSolution`` fields, then the
    controls of ``ops.psr.PSRControls``, the mode and the energy."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "P", "Y_in", "h_in", "tau", "volume", "mdot", "qloss", "T_fixed",
        "y0", "T", "Y", "rho", "tau_out", "volume_out", "residual",
        "converged", "n_newton", "n_direct", "n_polish", "status", "fault",
        "ws")]
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


def _rhs_tensors(kernel, tm, y, c, problem, t):
    """Check K1/K2's arguments; returns (profiles?, the tensors that
    decide the route)."""
    _problem(problem)
    B = y.shape[0]
    _check("y", y, (B, tm.N))
    if isinstance(c, torch.Tensor):
        _check("c", c, (B,))
        return False, (y, c)
    if t is None:
        raise ValueError(f"{kernel}: profiles need the lanes' times t")
    _check("t", t, (B,))
    return True, (y, t, *_profile_tensors(c))


def _twin(i, tm, y, c, problem, t, prf):
    from ..ops.reactors import RHS_PRF_TWINS, RHS_TWINS
    if prf:
        return RHS_PRF_TWINS[problem][i](tm, t, y, c)
    return RHS_TWINS[problem][i](tm, y, c)


def _chem_call(kernel, tm, y, c, problem, t, prf, f, J=None):
    """Launch K1 (J None) or K2 of ``problem`` on the card: constant
    constraint values ``c`` [B] or (``prf``) profiles at the lanes' times
    ``t``, the lanes in shared memory or the GM workspace."""
    B = y.shape[0]
    _, ws = _workspace(tm, kernel, B, y.device)
    head = (ctypes.byref(mech_view(tm)), y.data_ptr(),
            None if prf else c.data_ptr(), f.data_ptr())
    tail = (B, _problem(problem), t.data_ptr() if prf else None,
            ctypes.byref(profile_view(c, B)) if prf else None,
            None if ws is None else ws.data_ptr(), _stream(y.device))
    lib = build.library()
    rc = (lib.chem_rhs(*head, *tail) if J is None
          else lib.chem_rhs_jac(*head, J.data_ptr(), *tail))
    _raise_on(rc, kernel)
    name = launch_name(kernel, problem, xk=extended(tm), prf=prf,
                       gm=ws is not None)
    _note_workspace(name, ws)
    LAUNCHES[name] += 1


def rhs(tm, y, c, problem="CONP", t=None):
    """K1: the RHS of ``problem``, ``y`` [B, N] and the constraint value
    ``c`` [B] (pressure for the CONP codes, density for the CONV codes)
    -> f [B, N]. With ``c`` a :class:`~..ops.reactors.BatchArgs` (the
    PRF instantiation) the constraint, T and heat loss come from its
    profiles at the lanes' times ``t`` [B]."""
    prf, tensors = _rhs_tensors("rhs", tm, y, c, problem, t)
    if not _route(*tensors):
        return _twin(0, tm, y, c, problem, t, prf)
    _check_mech(tm, y)
    f = torch.empty_like(y)
    _chem_call("rhs", tm, y, c, problem, t, prf, f)
    return f


def rhs_jac(tm, y, c, problem="CONP", t=None):
    """K2: the fused (f [B, N], J [B, N, N]) of ``problem``; ``c`` and
    ``t`` as :func:`rhs`'s."""
    prf, tensors = _rhs_tensors("rhs_jac", tm, y, c, problem, t)
    if not _route(*tensors):
        return _twin(1, tm, y, c, problem, t, prf)
    _check_mech(tm, y)
    B, N = y.shape[0], tm.N
    f = torch.empty_like(y)
    J = torch.empty(B, N, N, dtype=y.dtype, device=y.device)
    _chem_call("rhs_jac", tm, y, c, problem, t, prf, f, J)
    return f, J


def gershgorin_rate(tm, y, c, problem="CONP", t=None):
    """K8: the Gershgorin bound max_i sum_j |J_ij| [B] of the closed-form
    Jacobian J = d(rhs)/dy of ``problem`` at the states ``y`` [B, N], with
    the constraint value ``c`` [B] (pressure for the CONP codes, density
    for the CONV codes; a TGIV lane's T is its state's T entry), or with
    ``c`` a :class:`~..ops.reactors.BatchArgs` (the PRF instantiation) at
    the lanes' times ``t`` [B], as :func:`rhs_jac` takes them. NaN
    anywhere in a lane's J gives NaN. On the CPU: K2's twin, then
    :func:`..ops.odeint.gershgorin_rate`."""
    prf, tensors = _rhs_tensors("gershgorin_rate", tm, y, c, problem, t)
    if not _route(*tensors):
        from ..ops.odeint import gershgorin_rate as plain
        return plain(_twin(1, tm, y, c, problem, t, prf)[1])
    _check_mech(tm, y)
    B = y.shape[0]
    rate = torch.empty(B, dtype=y.dtype, device=y.device)
    _, ws = _workspace(tm, "gershgorin_rate", B, y.device)
    _raise_on(build.library().chem_gershgorin(
        ctypes.byref(mech_view(tm)), y.data_ptr(),
        None if prf else c.data_ptr(), rate.data_ptr(), B,
        _problem(problem), t.data_ptr() if prf else None,
        ctypes.byref(profile_view(c, B)) if prf else None,
        None if ws is None else ws.data_ptr(), _stream(y.device)),
        "gershgorin_rate")
    name = launch_name("gershgorin_rate", problem, xk=extended(tm), prf=prf,
                       gm=ws is not None)
    _note_workspace(name, ws)
    LAUNCHES[name] += 1
    return rate


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
    # a species block too large for shared memory is factored in place in
    # lu (GM)
    gm = 8 * lane_doubles("bordered_factor", n, 0, 0, 0) > smem_limit(
        J.device)
    _raise_on(build.library().chem_bordered_factor(
        J.data_ptr(), hg.data_ptr(), lu.data_ptr(), v.data_ptr(),
        c.data_ptr(), dsch.data_ptr(), B, N, int(gm), _stream(J.device)),
        "bordered_factor")
    LAUNCHES[launch_name("bordered_factor", gm=gm)] += 1
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
    # beyond K4's register rows the kernel sweeps in x (GM)
    LAUNCHES[launch_name("bordered_solve", gm=n > 32 * SOLVE_MAXR)] += 1
    return x


def sdirk_round(tm, lanes, state, *, rtol, budget, max_attempts,
                event_mode, problem, species_index=0, pivot=False):
    """K5: up to ``max_attempts`` SDIRK3 step attempts on every lane of
    ``state`` (an :class:`~..ops.odeint.StepState`) that is short of its
    t_end, not stalled and under its ``budget`` attempts (an int for every
    lane, or [B] int64 caps); ``lanes`` is the sweep's
    :class:`~..ops.odeint.Lanes`, ``event_mode`` the index of the
    ignition mode in ``ops.reactors.IGNITION_MODES`` (0 T_inflection,
    1 T_rise, 2 T_ignition, 3 Species_peak of species
    ``species_index``). ``pivot`` factors the Newton matrix's species
    block with partial pivoting; lanes with ``lanes.fault`` set run the
    FAULT instantiation; lanes whose ``constraint`` is a
    :class:`~..ops.reactors.BatchArgs` run the PRF instantiation (their
    profiles at each RHS's time; no PIVOT or FAULT rung with profiles);
    a mechanism too large for shared memory runs GM. Returns the advanced
    state: on the card the state's tensors are updated in place (one
    launch, one block per lane); on the CPU its twin,
    :func:`..ops.odeint.sweep_round` over the plain ops, returns a new
    state."""
    code = _problem(problem)
    if event_mode not in (0, 1, 2, 3):
        raise ValueError(f"event_mode must be 0-3, got {event_mode!r}")
    if int(max_attempts) < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts!r}")
    B, N = state.y.shape
    if N != tm.N:
        raise ValueError(f"state.y: expected {tm.N} columns, got {N}")
    if not 0 <= int(species_index) < tm.KK:
        raise ValueError(f"species_index must be in [0, {tm.KK}), got "
                         f"{species_index!r}")
    f64, i64 = torch.float64, torch.int64
    for name, shape, dtype in (
            ("t", (B,), f64), ("y", (B, N), f64), ("f", (B, N), f64),
            ("h", (B,), f64), ("n_steps", (B,), i64),
            ("n_rejected", (B,), i64), ("n_newton", (B,), i64),
            ("consec_rej", (B,), i64), ("acc_t", (B, 1), f64),
            ("acc_v", (B, 1), f64), ("stalled", (B,), torch.bool),
            ("status", (B,), torch.int32), ("dt_min", (B,), f64)):
        _check(name, getattr(state, name), shape, dtype)
    prf = not isinstance(lanes.constraint, torch.Tensor)
    for name, shape in ((("atol", (B, N)), ("t_end", (B,)), ("thresh", (B,)))
                        + (() if prf else (("constraint", (B,)),))):
        _check(name, getattr(lanes, name), shape)
    fault = lanes.fault is not None
    if fault:
        _check("fault", lanes.fault, (B,), torch.int32)
        _check("fault_t", lanes.fault_t, (B,))
    if prf and (pivot or fault):
        raise NotImplementedError(
            "sdirk_round: the pivoted and faulted rungs with profiles are "
            "not instantiated (solve_batch's rescue ladder is not ported)")
    if isinstance(budget, torch.Tensor):
        _check("budget", budget, (B,), i64)
    lane_tensors = [x for x in lanes if isinstance(x, torch.Tensor)]
    if prf:
        lane_tensors += _profile_tensors(lanes.constraint)
    if not _route(*state, *lane_tensors,
                  *((budget,) if isinstance(budget, torch.Tensor) else ())):
        from ..ops.odeint import sweep_round
        from ..ops.reactors import IGNITION_MODES, ignition_events, plain_ops
        return sweep_round(plain_ops(problem, pivot), tm, lanes,
                           ignition_events(IGNITION_MODES[event_mode],
                                           species_index),
                           rtol, budget, state,
                           max_attempts=int(max_attempts))
    _check_mech(tm, state.y)
    if not isinstance(budget, torch.Tensor):
        budget = torch.full((B,), int(budget), dtype=i64, device=state.y.device)
    _, ws = _workspace(tm, "sdirk_round", B, state.y.device, bool(pivot))
    args = SdirkArgs(**{n: getattr(lanes, n).data_ptr() for n in
                        ("atol", "t_end", "thresh")},
                     constraint=None if prf else lanes.constraint.data_ptr(),
                     fault=lanes.fault.data_ptr() if fault else None,
                     fault_t=lanes.fault_t.data_ptr() if fault else None,
                     **{n: getattr(state, n).data_ptr() for n in (
                         "t", "y", "f", "h", "n_steps", "n_rejected",
                         "n_newton", "consec_rej", "acc_t", "acc_v",
                         "stalled", "status", "dt_min")},
                     budget=budget.data_ptr(),
                     ws=None if ws is None else ws.data_ptr(),
                     rtol=float(rtol), max_attempts=int(max_attempts),
                     event_mode=int(event_mode), species=int(species_index),
                     prf=profile_view(lanes.constraint, B) if prf
                     else ProfileView())
    _raise_on(build.library().chem_sdirk_round(
        ctypes.byref(mech_view(tm)), ctypes.byref(args), B, code,
        int(bool(pivot)), int(prf), _stream(state.y.device)), "sdirk_round")
    name = launch_name("sdirk_round", problem, bool(pivot), fault,
                       extended(tm), prf=prf, gm=ws is not None)
    _note_workspace(name, ws)
    LAUNCHES[name] += 1
    return state


def _fault_flags(fault, B, device):
    """The per-lane int32 linalg_unstable flags of K6/K7 from a [B] bool
    mask (None: no fault active)."""
    if fault is None:
        return None
    _check("fault", fault, (B,), torch.bool)
    return fault.to(device=device, dtype=torch.int32).contiguous()


def equil_solve(tm, T, P, Y, option, n_iter, fault=None):
    """K6: the equilibrium of every lane from its initial state ``T``,
    ``P`` [B] and ``Y`` [B, KK] holding the pair of ``option`` (1-9), with
    ``n_iter`` main iterations: an
    :class:`~..ops.equilibrium.EquilibriumResult`. One warp per lane runs
    the whole solve (start, pre-phase, main iterations, the nested ln T
    loop of options 6 and 9, the finish); the CPU twin is
    :func:`..ops.equilibrium.equilibrate_plain`. ``fault`` [B] bool: the
    lanes whose Newton solves an injected ``linalg_unstable`` fault
    poisons (the FAULT instantiation; None: no fault active)."""
    from ..ops import equilibrium
    if int(option) not in equilibrium.EQ_OPTIONS:
        raise ValueError(f"option must be one of 1-9, got {option!r}")
    if int(n_iter) < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter!r}")
    B = T.shape[0]
    _check("T", T, (B,))
    _check("P", P, (B,))
    _check("Y", Y, (B, tm.KK))
    if not _route(T, P, Y, *(() if fault is None else (fault,))):
        return equilibrium.equilibrate_plain(tm, T, P, Y, int(option),
                                             int(n_iter), fault=fault)
    _check_mech(tm, Y)
    if tm.MM + 3 > EQ_MAX_N:
        raise ValueError(f"equil_solve takes MM <= {EQ_MAX_N - 3}, got "
                         f"{tm.MM}")
    flags = _fault_flags(fault, B, Y.device)
    st, ws = _workspace(tm, "equil_solve", B, Y.device)
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
                     fault=None if flags is None else flags.data_ptr(),
                     ws=None if ws is None else ws.data_ptr(),
                     option=int(option), n_iter=int(n_iter))
    _raise_on(build.library().chem_equil_solve(
        ctypes.byref(mech_view(tm)), ctypes.byref(args), B, st.lanes,
        _stream(Y.device)), "equil_solve")
    name = launch_name("equil_solve", fault=flags is not None,
                       gm=ws is not None)
    _note_workspace(name, ws)
    LAUNCHES[name] += 1
    return equilibrium.EquilibriumResult(
        T=out["T"], P=out["P"], X=X, Y=Yo, nbar=out["nbar"], h=out["h"],
        u=out["u"], s=out["s"], v=out["v"], residual=out["residual"],
        converged=conv, status=status)


def psr_solve(tm, mode, energy, args, y0, ctl, fault=None):
    """K7: the whole PSR solve of every lane, ``args`` an
    :class:`~..ops.psr.PSRArgs` of [B] lanes, ``y0`` [B, N] the guess,
    ``ctl`` the :class:`~..ops.psr.PSRControls`: a
    :class:`~..ops.psr.PSRSolution`. One thread block per lane runs the
    direct Newton, and on a lane it leaves unconverged the
    pseudo-transient phase and the polish, then the finish; the CPU twin
    is :func:`..ops.psr.solve_psr_plain`. ``fault`` [B] bool: the lanes
    whose Newton solves an injected ``linalg_unstable`` fault poisons (the
    FAULT instantiation; None: no fault active)."""
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
    if not _route(y0, *args, *(() if fault is None else (fault,))):
        return psr.solve_psr_plain(tm, mode, energy, args, y0, ctl,
                                   fault=fault)
    _check_mech(tm, y0)
    dev = y0.device
    flags = _fault_flags(fault, B, dev)
    _, ws = _workspace(tm, "psr_solve", B, dev)
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
                fault=None if flags is None else flags.data_ptr(),
                ws=None if ws is None else ws.data_ptr(),
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
    name = launch_name("psr_solve", fault=flags is not None, xk=extended(tm),
                       gm=ws is not None)
    _note_workspace(name, ws)
    LAUNCHES[name] += 1
    return psr.PSRSolution(
        T=out["T"], Y=Y, rho=out["rho"], tau=out["tau_out"],
        volume=out["volume_out"], residual=out["residual"], converged=conv,
        n_newton=counts["n_newton"], n_newton_direct=counts["n_direct"],
        n_newton_polish=counts["n_polish"], status=status)


from .flame import (block_thomas, flame_jac, flame_residual,  # noqa: E402
                    transport_props)

__all__ = ["LAUNCHES", "PROBLEMS", "Storage", "WORKSPACE_BYTES",
           "block_thomas", "bordered_factor", "bordered_solve", "equil_solve",
           "extended", "flame_jac", "flame_residual", "gershgorin_rate",
           "lane_doubles", "launch_name", "psr_solve", "reset_launches", "rhs",
           "rhs_jac", "sdirk_round", "smem_limit", "storage",
           "transport_props"]
