"""Per-kind solve engines: the bridge from request payloads to the
batched solvers on the server's device (the port's counterpart of the
JAX package's ``serve/engines.py`` for the ``ignition``, ``equilibrium``
and ``psr`` kinds).

A batch is stacked and edge-padded to its bucket with numpy, moved to
the device in one copy, solved by the port's entry point
(:func:`~..ops.reactors.ignition_delay_sweep` over K1/K5,
:func:`~..ops.equilibrium.equilibrate` on K6,
:func:`~..ops.psr.solve_psr` on K7) and brought back in one copy
(:func:`~..ops.transfer.to_host`); the server demultiplexes numpy.

"Compiles": the reference counts ``serve.compiles`` and
``serve.compiles.<kind>`` when a jitted program traces. The port has no
trace (its CUDA kernels are built once per process, at the first launch
or in :meth:`~.server.ChemServer.warmup`); it counts the first dispatch
of each (group key, profile flag, bucket) instead, the port's
counterpart of a traced program, so "zero compiles after warmup" keeps
its meaning: live traffic dispatches no shape warmup did not.

Engines also own the off-hot-path rescue: ``rescue_one`` re-solves one
failed request under the per-kind escalation of rung ``level`` (the
ignition engine walks the rescue ladder's knobs; the fixed-iteration
Newton kinds grow their iteration budgets). Fault injection
(:mod:`..resilience.faultinject`) reaches every kind as in the reference:
lanes carry their position in the batch as the fault element id, and a
rescue re-solves the original lane with the rung as ``fault_level``: the
ignition sweep's NaN-RHS and Newton-stall faults (K5's FAULT
instantiation), and the equilibrium and PSR solvers' ``linalg_unstable``
(K6's and K7's).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import knobs, telemetry
from ..obs import programs as obs_programs
from ..ops import equilibrium as eq_ops
from ..ops import psr as psr_ops
from ..ops import reactors as reactor_ops
from ..ops import thermo
from ..ops.odeint import solve_profile_enabled
from ..ops.transfer import to_host
from ..resilience import faultinject
from ..resilience.rescue import DEFAULT_LADDER
from .buckets import pad_indices


def _f64(x) -> np.ndarray:
    return np.asarray(x, np.float64)


#: per-lane solver-physics keys an engine's batch output carries when the
#: solve profile (PYCHEMKIN_SOLVE_PROFILE) is on; :meth:`Engine.profile_at`
#: demuxes whichever are present
PROFILE_KEYS = ("n_steps", "n_rejected", "n_newton", "dt_min",
                "dt_final", "stiffness")


class Engine:
    """Shared scaffolding: payload stacking, first-dispatch counting, solve
    timing. Subclasses define the payload schema and the solvers."""

    kind = "?"
    #: payload fields stacked along the batch axis, in order
    fields: Tuple[str, ...] = ()
    max_rescue_rungs = 2
    #: whether this kind builds with no ``engine_config`` entry
    zero_config = True

    @contextlib.contextmanager
    def suppress_accounting(self):
        """Dispatches inside this block are not traffic (warmup): no wall
        histogram and no model FLOPs in the program registry."""
        saved = self._warming
        self._warming = True
        try:
            yield
        finally:
            self._warming = saved

    def __init__(self, mech, recorder=None, *, device=None):
        self.device = reactor_ops.resolve_device(device)
        #: the mechanism's tensors on the device (built once)
        self.tm = reactor_ops.as_torch_mechanism(mech, self.device)
        #: the mechanism record (schema and identity)
        self.mech = self.tm.record
        self._rec = (recorder if recorder is not None
                     else telemetry.get_recorder())
        #: (group key, profile flag, bucket) dispatched at least once
        self._dispatched: set = set()
        self._pid_cache: Dict[Tuple, str] = {}
        self._cache_lock = threading.Lock()
        self._warming = False

    # -- payload ---------------------------------------------------------
    def normalize(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Validate and coerce one request's payload at the submit call
        site, so a malformed request raises to its caller."""
        raise NotImplementedError

    def group_key(self, payload: Dict[str, Any]) -> Tuple:
        """Static solver settings that must not be mixed in one batch."""
        return ()

    def dummy_payload(self) -> Dict[str, Any]:
        """A representative payload for ladder warmup."""
        raise NotImplementedError

    # -- program identity ------------------------------------------------
    def _config_extras(self) -> Dict[str, Any]:
        """Kind-specific solver knobs joining the program identity."""
        return {}

    def _resolved_config(self, key: Tuple) -> Dict[str, Any]:
        """The config keying this engine's programs: the port's kernels
        run the staged (sparse) rate of progress and the fused (f, J);
        the solve-profile flag, the schedule mode and the subclass's
        solver knobs."""
        cfg: Dict[str, Any] = {
            "rop_mode": "sparse", "fuse_mode": "fused",
            "profile": bool(solve_profile_enabled()),
            "schedule": knobs.value("PYCHEMKIN_SCHEDULE"),
        }
        if key:
            cfg["group_key"] = list(key)
        cfg.update(self._config_extras())
        return cfg

    def program_id(self, bucket: int, key: Tuple) -> str:
        """The stable identity of this engine's solve at ``bucket`` for
        ``key`` (registered with the program registry on first sight),
        memoized per (group key, profile flag, bucket)."""
        pid_key = (key, solve_profile_enabled(), int(bucket))
        with self._cache_lock:
            pid = self._pid_cache.get(pid_key)
        if pid is None:
            cfg = self._resolved_config(key)
            sig = obs_programs.mech_signature(self.mech)
            pid = obs_programs.program_id(sig, self.kind, (int(bucket),),
                                          cfg)
            obs_programs.get_registry().register(pid)
            with self._cache_lock:
                self._pid_cache[pid_key] = pid
        return pid

    def _first_dispatch(self, key: Tuple, bucket: int) -> bool:
        """Count the first dispatch of (key, profile flag, bucket) under
        ``serve.compiles`` and ``serve.compiles.<kind>``; True if this is
        it."""
        dkey = (key, solve_profile_enabled(), int(bucket))
        with self._cache_lock:
            if dkey in self._dispatched:
                return False
            self._dispatched.add(dkey)
        self._rec.inc("serve.compiles")
        self._rec.inc(f"serve.compiles.{self.kind}")
        return True

    def profile_at(self, out: Dict[str, np.ndarray],
                   i: int) -> Optional[Dict[str, Any]]:
        """Lane ``i``'s solver-physics profile as JSON-safe scalars (a
        non-finite float becomes None), or None when the output carries
        no profile."""
        prof: Dict[str, Any] = {}
        for k in PROFILE_KEYS:
            if k in out:
                v = np.asarray(out[k][i])
                if np.issubdtype(v.dtype, np.integer) or \
                        np.issubdtype(v.dtype, np.bool_):
                    prof[k] = int(v)
                else:
                    f = float(v)
                    prof[k] = f if np.isfinite(f) else None
        return prof or None

    # -- batched solve ---------------------------------------------------
    def _solve_batch(self, key: Tuple, *cols) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def stack(self, payloads: List[Dict[str, Any]],
              bucket: int) -> List[torch.Tensor]:
        """Stack payloads into bucket-shaped tensors on the device
        (edge-padded with numpy, moved in one host-to-device copy)."""
        idx = pad_indices(len(payloads), bucket)
        cols = [np.stack([_f64(p[f]) for p in payloads])[idx]
                for f in self.fields]
        flat = torch.as_tensor(np.concatenate(
            [c.reshape(bucket, -1) for c in cols], 1)).to(self.device)
        out, o = [], 0
        for c in cols:
            w = int(np.prod(c.shape[1:], dtype=np.int64))
            out.append(flat[:, o:o + w].reshape(c.shape).contiguous())
            o += w
        return out

    def solve(self, payloads: List[Dict[str, Any]], bucket: int,
              key: Tuple) -> Tuple[Dict[str, np.ndarray], float]:
        """Solve one padded micro-batch; returns (result arrays at bucket
        shape, seconds from the host-to-device copy to the results on the
        host). Every dispatch is banked with the program registry."""
        t0 = time.perf_counter()
        args = self.stack(payloads, bucket)
        pid = self.program_id(bucket, key)
        first = self._first_dispatch(key, bucket)
        out = to_host(self._solve_batch(key, *args))
        solve_s = time.perf_counter() - t0
        obs_programs.get_registry().record_dispatch(
            pid, solve_s * 1e3, compiled=first, recorder=self._rec,
            accounted=not self._warming)
        return out, solve_s

    def value_at(self, out: Dict[str, np.ndarray],
                 i: int) -> Dict[str, Any]:
        """Demultiplex element ``i``'s result fields."""
        raise NotImplementedError

    # -- rescue (off the hot path) --------------------------------------
    def rescue_one(self, payload: Dict[str, Any], key: Tuple,
                   level: int, elem_id: int
                   ) -> Tuple[Dict[str, np.ndarray], int]:
        """Re-solve ONE request under rung ``level``; returns (bucket-1
        result arrays, status). ``elem_id`` is the request's lane in the
        failed batch, so injected faults track their element."""
        raise NotImplementedError


def _elems(n: int, elem_id=None):
    """The fault element ids of a solve while injection is on (the lanes'
    positions in the batch, or the rescued request's lane), else None."""
    if not faultinject.enabled():
        return None
    return list(range(n)) if elem_id is None else [elem_id]


class IgnitionEngine(Engine):
    """Ignition delay through :func:`~..ops.reactors.ignition_delay_sweep`
    (K1 once, then K5 in rounds of 512 attempts on the card).

    Payload: ``T0`` [K], ``P0`` [dyne/cm^2], ``Y0`` [KK mass fractions],
    ``t_end`` [s]. Value: ``ignition_delay_ms`` (nan when not detected),
    ``ignition_time_s``."""

    kind = "ignition"
    fields = ("T0", "P0", "Y0", "t_end")
    max_rescue_rungs = len(DEFAULT_LADDER)

    def __init__(self, mech, recorder=None, *, device=None, problem="CONP",
                 energy="ENRG", rtol=1e-6, atol=1e-12,
                 max_steps_per_segment=20_000,
                 ignition_mode=reactor_ops.IGN_T_INFLECTION,
                 ignition_kwargs=None):
        super().__init__(mech, recorder, device=device)
        reactor_ops.variant(problem, energy)
        self.problem, self.energy = problem, energy
        self.rtol, self.atol = rtol, atol
        self.max_steps = max_steps_per_segment
        self.ignition_mode = ignition_mode
        self.ignition_kwargs = ignition_kwargs

    def normalize(self, payload):
        Y0 = _f64(payload["Y0"])
        if Y0.shape != (self.mech.n_species,):
            raise ValueError(f"Y0 must have shape ({self.mech.n_species},), "
                             f"got {Y0.shape}")
        return {"T0": float(payload["T0"]), "P0": float(payload["P0"]),
                "Y0": Y0, "t_end": float(payload["t_end"])}

    def dummy_payload(self):
        KK = self.mech.n_species
        return {"T0": 1200.0, "P0": 1.01325e6,
                "Y0": np.full(KK, 1.0 / KK), "t_end": 1e-5}

    def _config_extras(self):
        return {"problem": self.problem, "energy": self.energy,
                "rtol": self.rtol, "atol": self.atol,
                "max_steps": self.max_steps,
                "ignition_mode": str(self.ignition_mode),
                "jac_mode": "analytic"}

    def _sweep(self, T0s, P0s, Y0s, t_ends, **kw):
        kw.setdefault("rtol", self.rtol)
        kw.setdefault("max_steps_per_segment", self.max_steps)
        return reactor_ops.ignition_delay_sweep(
            self.tm, self.problem, self.energy, T0s, P0s, Y0s, t_ends,
            atol=self.atol, ignition_mode=self.ignition_mode,
            ignition_kwargs=self.ignition_kwargs, device=self.device, **kw)

    def _solve_batch(self, key, T0s, P0s, Y0s, t_ends):
        if solve_profile_enabled():
            # primal outputs are bit-identical; the lane physics (and K8's
            # stiffness at the final state) ride as extra arrays
            times, ok, status, prof = self._sweep(T0s, P0s, Y0s, t_ends,
                                                  profile=True)
            return {"times": times, "ok": ok, "status": status, **prof}
        times, ok, status = self._sweep(T0s, P0s, Y0s, t_ends)
        return {"times": times, "ok": ok, "status": status}

    def value_at(self, out, i):
        t = float(out["times"][i])
        return {"ignition_time_s": t, "ignition_delay_ms": t * 1e3}

    def rescue_one(self, payload, key, level, elem_id):
        step = DEFAULT_LADDER[level - 1]
        h0 = step.h0_rel * payload["t_end"] if step.h0_rel else 0.0
        if h0:
            h0 = float(f"{h0:.0e}")    # one significant figure, as the
            #                            reference rounds its memo key
        T0s, P0s, Y0s, t_ends = (
            torch.as_tensor(np.asarray(payload[f], np.float64)[None],
                            device=self.device) for f in self.fields)
        times, ok, status = self._sweep(
            T0s, P0s, Y0s, t_ends, rtol=self.rtol * step.rtol_factor,
            max_steps_per_segment=int(self.max_steps
                                      * step.max_steps_factor),
            h0=h0, f64_jac=step.f64_jac, pivoted_lu=step.pivoted_lu,
            elem_ids=[elem_id] if faultinject.enabled() else None,
            fault_level=level)
        out = to_host({"times": times, "ok": ok, "status": status})
        return out, int(out["status"][0])


class EquilibriumEngine(Engine):
    """Constrained equilibrium through :func:`~..ops.equilibrium.equilibrate`
    (one K6 launch on the card).

    Payload: ``T`` [K], ``P`` [dyne/cm^2], ``Y`` [KK]; the constraint
    ``option`` (1-9) is a static group key. Value: equilibrium ``T``,
    ``P``, ``X``, ``Y``, ``h``, ``converged``."""

    kind = "equilibrium"
    fields = ("T", "P", "Y")

    def __init__(self, mech, recorder=None, *, device=None, n_iter=80):
        super().__init__(mech, recorder, device=device)
        self.n_iter = n_iter

    def _config_extras(self):
        return {"n_iter": self.n_iter}

    def normalize(self, payload):
        Y = _f64(payload["Y"])
        if Y.shape != (self.mech.n_species,):
            raise ValueError(f"Y must have shape ({self.mech.n_species},), "
                             f"got {Y.shape}")
        option = int(payload.get("option", 1))
        if option not in eq_ops.EQ_OPTIONS:
            raise ValueError(f"unknown equilibrium option {option}")
        return {"T": float(payload["T"]), "P": float(payload["P"]),
                "Y": Y, "option": option}

    def group_key(self, payload):
        return (payload["option"],)

    def dummy_payload(self):
        KK = self.mech.n_species
        return {"T": 1500.0, "P": 1.01325e6, "Y": np.full(KK, 1.0 / KK),
                "option": 1}

    def _solve(self, Ts, Ps, Ys, option, n_iter, *, elem_id=None, level=0):
        res = eq_ops.equilibrate(self.tm, Ts, Ps, Ys, option=option,
                                 n_iter=n_iter,
                                 elem_ids=_elems(Ts.shape[0], elem_id),
                                 fault_level=level, device=self.device)
        return {"T": res.T, "P": res.P, "X": res.X, "Y": res.Y, "h": res.h,
                "converged": res.converged, "status": res.status}

    def _solve_batch(self, key, Ts, Ps, Ys):
        option, = key
        return self._solve(Ts, Ps, Ys, option, self.n_iter)

    def value_at(self, out, i):
        # copies, not views: a retained result pins one lane only
        return {"T": float(out["T"][i]), "P": float(out["P"][i]),
                "X": np.array(out["X"][i]), "Y": np.array(out["Y"][i]),
                "h": float(out["h"][i]),
                "converged": bool(out["converged"][i])}

    def rescue_one(self, payload, key, level, elem_id):
        option, = key
        cols = [torch.as_tensor(np.asarray(payload[f], np.float64)[None],
                                device=self.device) for f in self.fields]
        # escalation: the iteration budget, the knob that fixes a
        # TOL_NOT_MET of the fixed-iteration Newton
        out = to_host(self._solve(*cols, option, self.n_iter * 2 ** level,
                                  elem_id=elem_id, level=level))
        return out, int(out["status"][0])


class PSREngine(Engine):
    """Perfectly-stirred-reactor steady state through
    :func:`~..ops.psr.solve_psr` in residence-time mode (one K7 launch on
    the card).

    Payload: ``tau`` [s], ``P`` [dyne/cm^2], ``Y_in`` [KK], ``h_in``
    [erg/g] (or ``T_in`` [K], converted at submit), optional
    ``T_guess``/``Y_guess``. Value: steady ``T``, ``Y``, ``residual``,
    ``converged``."""

    kind = "psr"
    fields = ("tau", "P", "Y_in", "h_in", "T_guess", "Y_guess")

    def __init__(self, mech, recorder=None, *, device=None, energy="ENRG",
                 n_newton=50, n_pseudo=100, **solver_kwargs):
        super().__init__(mech, recorder, device=device)
        self.energy = energy
        self.n_newton = n_newton
        self.n_pseudo = n_pseudo
        self.solver_kwargs = solver_kwargs
        self._tm_host = None

    def _config_extras(self):
        return {"energy": self.energy, "n_newton": self.n_newton,
                "n_pseudo": self.n_pseudo}

    def _inlet_enthalpy(self, T_in, Y_in) -> float:
        """h(T_in, Y_in) [erg/g] on the host (no device sync per submit)."""
        if self._tm_host is None:
            self._tm_host = reactor_ops.as_torch_mechanism(self.mech, "cpu")
        return float(thermo.mixture_enthalpy_mass(
            self._tm_host, torch.tensor([float(T_in)], dtype=torch.float64),
            torch.as_tensor(Y_in[None]))[0])

    def normalize(self, payload):
        Y_in = _f64(payload["Y_in"])
        if Y_in.shape != (self.mech.n_species,):
            raise ValueError(f"Y_in must have shape ({self.mech.n_species},),"
                             f" got {Y_in.shape}")
        if "h_in" in payload:
            h_in = float(payload["h_in"])
        elif "T_in" in payload:
            h_in = self._inlet_enthalpy(payload["T_in"], Y_in)
        else:
            raise ValueError("PSR payload needs h_in or T_in")
        Y_guess = _f64(payload.get("Y_guess", Y_in))
        if Y_guess.shape != (self.mech.n_species,):
            raise ValueError(f"Y_guess must have shape "
                             f"({self.mech.n_species},), got "
                             f"{Y_guess.shape}")
        return {"tau": float(payload["tau"]), "P": float(payload["P"]),
                "Y_in": Y_in, "h_in": h_in,
                "T_guess": float(payload.get("T_guess", 1800.0)),
                "Y_guess": Y_guess}

    def dummy_payload(self):
        KK = self.mech.n_species
        return {"tau": 1e-3, "P": 1.01325e6, "Y_in": np.full(KK, 1.0 / KK),
                "T_in": 1000.0}

    def _solve(self, taus, Ps, Y_ins, h_ins, T_gs, Y_gs, *, n_newton,
               n_pseudo, elem_id=None, level=0):
        sol = psr_ops.solve_psr(
            self.tm, psr_ops.MODE_TAU, self.energy, P=Ps, Y_in=Y_ins,
            h_in=h_ins, T_guess=T_gs, Y_guess=Y_gs, tau=taus,
            n_newton=n_newton, n_pseudo=n_pseudo,
            elem_ids=_elems(taus.shape[0], elem_id), fault_level=level,
            device=self.device, **self.solver_kwargs)
        d = {"T": sol.T, "Y": sol.Y, "residual": sol.residual,
             "converged": sol.converged, "status": sol.status}
        if solve_profile_enabled():
            # the PSR Newton's profile: its iteration count
            d["n_newton"] = sol.n_newton
        return d

    def _solve_batch(self, key, *cols):
        return self._solve(*cols, n_newton=self.n_newton,
                           n_pseudo=self.n_pseudo)

    def value_at(self, out, i):
        return {"T": float(out["T"][i]), "Y": np.array(out["Y"][i]),
                "residual": float(out["residual"][i]),
                "converged": bool(out["converged"][i])}

    def rescue_one(self, payload, key, level, elem_id):
        cols = [torch.as_tensor(np.asarray(payload[f], np.float64)[None],
                                device=self.device) for f in self.fields]
        # escalation: more damped-Newton room and a longer pseudo-transient
        # phase per rung
        out = to_host(self._solve(*cols, n_newton=self.n_newton * (level + 1),
                                  n_pseudo=self.n_pseudo * 2 ** level,
                                  elem_id=elem_id, level=level))
        return out, int(out["status"][0])


class DuplicateEngineKindError(ValueError):
    """A second engine registered an already-taken request kind; pass
    ``replace=True`` to :func:`register_engine` only when shadowing is
    intended."""


#: engine registry: request kind -> constructor, read by ChemServer
ENGINE_TYPES: Dict[str, Any] = {}


def register_engine(kind: str, ctor, *, replace: bool = False) -> None:
    """Register an engine constructor for request kind ``kind``, called as
    ``ctor(mech, recorder, device=..., **engine_config)``."""
    if not kind or not isinstance(kind, str):
        raise ValueError(f"engine kind must be a non-empty string, got "
                         f"{kind!r}")
    if not replace and kind in ENGINE_TYPES:
        raise DuplicateEngineKindError(
            f"engine kind {kind!r} is already registered "
            f"({ENGINE_TYPES[kind]!r}); pass replace=True to shadow it")
    ENGINE_TYPES[kind] = ctor


def registered_kinds() -> Tuple[str, ...]:
    """Every registered request kind, sorted."""
    return tuple(sorted(ENGINE_TYPES))


def zero_config_kinds() -> Tuple[str, ...]:
    """Registered kinds constructible with no ``engine_config`` entry
    (ChemServer.warmup's default set)."""
    return tuple(sorted(kind for kind, ctor in ENGINE_TYPES.items()
                        if getattr(ctor, "zero_config", True)))


for _cls in (IgnitionEngine, EquilibriumEngine, PSREngine):
    register_engine(_cls.kind, _cls)
