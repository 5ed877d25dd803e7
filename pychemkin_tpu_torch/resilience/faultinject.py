"""Deterministic fault injection: the port's copy of the JAX package's
``resilience/faultinject.py``, so the rescue ladder can be walked on
chosen lanes without real failures.

A :class:`FaultSpec` names a mode, the ORIGINAL batch indices it poisons
and the rescue level ``heal_at`` from which it clears (< 0: never). The
active specs are those of the :func:`inject` context manager, then those
of the env var ``PYCHEMKIN_FAULTS`` (a JSON object or list of objects,
e.g. ``[{"mode": "nan_rhs", "elements": [3], "heal_at": 1}]``), read on
every call. The ignition sweep honours two modes:

- ``nan_rhs``: the lane's RHS returns NaN from ``t_min`` on (classified
  NONFINITE);
- ``newton_stall``: every stage Newton of the lane reports
  non-convergence (classified NEWTON_STALL).

``linalg_unstable`` belongs to the steady-state solvers (equilibrium and
PSR): every Newton direction of a poisoned lane is scaled by 1e8 and its
solve reported unstable (:func:`unstable_mask`; on the card the FAULT
instantiations of kernels K6 and K7).

With no spec active nothing changes: :func:`lane_faults` returns
``(None, None)`` and the sweep runs its fault-free kernel. Otherwise the
masks are per-lane tensors on the run's device (``Lanes.fault``,
``Lanes.fault_t``), and an unpoisoned lane computes exactly what it
computes without injection.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import List, NamedTuple, Optional, Tuple

import torch

_ENV = "PYCHEMKIN_FAULTS"

MODES = ("nan_rhs", "newton_stall", "linalg_unstable")

#: bits of the per-lane fault code ``Lanes.fault`` (ops/odeint.py): the
#: lane's RHS returns NaN from ``Lanes.fault_t`` on (``nan_rhs``); its
#: stage Newtons never converge (``newton_stall``)
FAULT_NAN = 1
FAULT_STALL = 2
_BITS = {"nan_rhs": FAULT_NAN, "newton_stall": FAULT_STALL}


class FaultSpec(NamedTuple):
    """One deterministic fault. ``heal_at < 0`` means the fault never
    heals (the element must be reported abandoned)."""
    mode: str
    elements: Tuple[int, ...]
    t_min: float = 0.0       # nan_rhs only: poison for t >= t_min
    heal_at: int = -1        # rescue level at which the fault clears

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        mode = d["mode"]
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r}; "
                             f"expected one of {MODES}")
        return cls(mode=mode, elements=tuple(int(e) for e in d["elements"]),
                   t_min=float(d.get("t_min", 0.0)),
                   heal_at=int(d.get("heal_at", -1)))


#: programmatic spec stack (the :func:`inject` context manager)
_active: List[FaultSpec] = []


def _env_specs() -> List[FaultSpec]:
    raw = os.environ.get(_ENV)
    if not raw:
        return []
    data = json.loads(raw)
    if isinstance(data, dict):
        data = [data]
    return [FaultSpec.from_dict(d) for d in data]


def specs(mode: Optional[str] = None) -> Tuple[FaultSpec, ...]:
    """Active fault specs (programmatic first, then env), optionally
    filtered by mode."""
    out = list(_active) + _env_specs()
    if mode is not None:
        out = [s for s in out if s.mode == mode]
    return tuple(out)


def enabled() -> bool:
    """Whether any fault spec is active."""
    return bool(specs())


@contextlib.contextmanager
def inject(*fault_specs: FaultSpec):
    """Activate fault specs for the dynamic extent of the block."""
    _active.extend(fault_specs)
    try:
        yield
    finally:
        del _active[len(_active) - len(fault_specs):]


def sweep_elem_ids(B: int, device=None) -> Optional[torch.Tensor]:
    """Original-index tensor [B] for a batched sweep, or None when no
    injection is active."""
    if not enabled():
        return None
    return torch.arange(B, device=device)


def lane_mask(spec: FaultSpec, elem_ids, level: int) -> torch.Tensor:
    """[B] bool: the lane (original index ``elem_ids``) is poisoned by
    ``spec`` at rescue level ``level``."""
    targets = torch.tensor(spec.elements, dtype=elem_ids.dtype,
                           device=elem_ids.device)
    sel = torch.isin(elem_ids, targets)
    if spec.heal_at >= 0 and level >= spec.heal_at:
        sel = torch.zeros_like(sel)
    return sel


def unstable_mask(elem_ids, level: int):
    """[B] bool: the lanes with original indices ``elem_ids`` that a
    ``linalg_unstable`` spec poisons at rescue level ``level`` (the
    reference's ``linalg_unstable_mask``, per lane); None when
    ``elem_ids`` is None or no lane is poisoned."""
    if elem_ids is None:
        return None
    sel = torch.zeros(elem_ids.shape, dtype=torch.bool,
                      device=elem_ids.device)
    for s in specs("linalg_unstable"):
        sel = sel | lane_mask(s, elem_ids, level)
    if not bool(sel.any()):
        return None
    return sel


def lane_faults(elem_ids, level: int):
    """(fault int32 [B], fault_t f64 [B]) of a sweep over the lanes with
    original indices ``elem_ids`` at rescue level ``level``: the OR of
    the ``nan_rhs`` and ``newton_stall`` bits of the specs that poison
    each lane, and the earliest ``t_min`` of its ``nan_rhs`` specs (inf
    where none). ``(None, None)`` when ``elem_ids`` is None or no lane is
    poisoned."""
    if elem_ids is None:
        return None, None
    dev = elem_ids.device
    fault = torch.zeros(elem_ids.shape, dtype=torch.int32, device=dev)
    fault_t = torch.full(elem_ids.shape, float("inf"), dtype=torch.float64,
                         device=dev)
    for s in specs():
        if s.mode not in _BITS:
            continue
        m = lane_mask(s, elem_ids, level)
        fault = torch.where(m, fault | _BITS[s.mode], fault)
        if s.mode == "nan_rhs":
            fault_t = torch.where(m, torch.clamp(fault_t, max=s.t_min),
                                  fault_t)
    if not bool((fault != 0).any()):
        return None, None
    return fault, fault_t
