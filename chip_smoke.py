#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pychemkin_tpu_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (exit code != 0):

1. build the seven CUDA kernels from ``pychemkin_tpu_torch/kernels/csrc``
   and print each kernel's registers and spills;
2. at grisyn shapes (KK=53, II=325, N=54) and B lanes, call each kernel
   through the wrapper the sweep calls, hold it against its plain
   PyTorch twin on the card and time both, with the least time the card
   could take (bytes over 3.35 TB/s, or FP64 operations over 34 TFLOP/s,
   whichever is larger) and, for K3/K4, one PyTorch library call
   computing the same function as a yardstick: K1/K2 for CONP and CONV;
   K3/K4; K5 (one round of 20 step attempts at 256 lanes: T_inflection
   from a sweep's start state, T_rise from each lane's last state before
   its crossing) against the masked loop over the plain twins, for CONP
   and CONV;
2c. the steady-state kernels against their twins on the card: K6
   (equilibrium) at grisyn B=4096 for options 1 and 5 and at h2o2 B=256
   for all nine options; K7 (PSR) at grisyn B=256 from cold inlets whose
   solves converge, some through the pseudo-transient phase, and at h2o2
   B=256 for each of tau/vol x ENRG/TGIV: the same status and Newton
   counts as the twin on 99 % of the lanes, not counting those where the
   two differ and the twin's own outcome moves when the guess moves by
   1e-15 (rounding-chaotic rescue lanes, counted and reported); values
   within the CPU tests' tolerances on the lanes OK in both;
3. the main path: ``ignition_delay_sweep`` on grisyn, CONP/ENRG, B lanes,
   T0 evenly over 1000-1400 K, 1 atm, stoichiometric H2/air, t_end 0.05 s,
   rtol 1e-6, atol 1e-12, through K1 and K5, with the launch counters
   read around it; then the same sweep through the host-driven loop over
   K1-K4, which must give the same status codes, ignition times within
   1e-6 relative and attempt and Newton totals within 1 %; every lane
   OK with a finite ignition time, and 8 lanes rerun through the plain
   twins on the card within 1e-6 relative;
3b. the same for CONV/ENRG at 10 atm (a reflected-shock condition);
4. ``torch.profiler`` over the first 20 attempts of the main-path sweep:
   device time by kernel and the device's idle share;
5. the steady-state path: the h2o2 PSR stability map (4096 lanes: 8
   equivalence ratios x 8 inlet temperatures x 64 residence times, 1 atm,
   SetResTime/ENRG): ``equilibrate(option=5)`` of each inlet through K6
   for the guess, then ``solve_psr`` through K7, with the launch counters
   read around each; then the same map through the plain twins on the
   card, which must give the same status on 99 % of the lanes, and on the
   lanes OK in both T within 1e-6 relative, Y within 1e-9 and the same
   Newton counts on 99 %; 80 % of the lanes OK, both branches present.

The last lines are the kernel table as one JSON object, the card's name
and power limit from nvidia-smi, and ``{"ok": true, "device": ...}``.

Run from the repository root: ``python3 chip_smoke.py`` (``--batch`` and
``--t-end`` shrink phases 2-4 for a quick check).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP64_FLOP_PER_S = 34e12      # H100 SXM data sheet, FP64 without tensor cores
TRANSCENDENTAL = 20.0        # flops charged per exp/log (repo cost model)
PROFILE_ATTEMPTS = 20        # step attempts in the profiled window
K5_BATCH = 256               # lanes of the K5 check against its twin
K5_ATTEMPTS = 20             # step attempts of that round
P_ATM = 1.01325e6
#: (problem, P0) of the two sweeps: 1 atm at constant pressure, 10 atm
#: at constant volume (behind a reflected shock)
SWEEPS = (("CONP", P_ATM), ("CONV", 10 * P_ATM))


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up,
    from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rate_rel(a, b, T, KK):
    """Scale-relative error of an RHS [B, N] or Jacobian [B, N, N] with
    T nondimensionalised by the lane's temperature (f_T / T; J's T row
    / T and T column * T), so that every entry is a rate in 1/s: per
    lane max |a - b| over max |b|, then the max over lanes."""
    def scaled(x):
        x = x.clone()
        if x.dim() == 2:
            x[:, KK] /= T
        else:
            x[:, KK, :] /= T[:, None]
            x[:, :, KK] *= T[:, None]
        return x.flatten(1)
    a, b = scaled(a), scaled(b)
    num = (a - b).abs().amax(1)
    den = b.abs().amax(1).clamp_min(1e-300)
    return float((num / den).max())


def _states(tm, B, seed, realistic):
    """Valid lane states [B, N] and pressures [B]: random compositions
    (kinetics checks) or stoichiometric H2/air with a radical pool
    (linear-algebra checks)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    KK = tm.KK
    if realistic:
        Y = np.tile(_stoich_Y(tm), (B, 1)) + 10 ** rng.uniform(-8, -3,
                                                               (B, KK))
        T = rng.uniform(1000.0, 2500.0, B)
        P = np.full(B, 1.01325e6)
    else:
        Y = rng.random((B, KK)) ** 3
        T = rng.uniform(800.0, 2500.0, B)
        P = rng.uniform(0.5, 20.0, B) * 1.01325e6
    Y /= Y.sum(1, keepdims=True)
    y = np.concatenate([Y, T[:, None]], 1)
    return (torch.tensor(y, device=tm.device),
            torch.tensor(P, device=tm.device))


def _stoich_Y(tm):
    import numpy as np
    names = [s.upper() for s in tm.record.species_names]
    wt = np.asarray(tm.record.wt)
    X = np.zeros(len(names))
    X[names.index("H2")] = 2.0
    X[names.index("O2")] = 1.0
    X[names.index("N2")] = 3.76
    Y = X * wt
    return Y / Y.sum()


def _mech_bytes(tm):
    from pychemkin_tpu_torch.kernels import _PTR_FIELDS
    return sum(getattr(tm, n).numel() * getattr(tm, n).element_size()
               for n in _PTR_FIELDS)


def _rate_flops(tm, jac, problem="CONP"):
    """FP64 operations one lane of K1 (jac=False) or K2 must do, counted
    from this mechanism's index sets. An exp or log is charged
    TRANSCENDENTAL flops, and only where the function needs one: log|A|
    is a constant of the mechanism, so Arrhenius costs one exp; the
    reverse rate and the reverse concentration product exist only on the
    reversible rows; each falloff row pays for its own form (Lindemann,
    Troe with two or three Fcent terms, SRI); the derivatives of K2 reuse
    the exps of the rates; at constant volume C does not depend on T, so
    there is no D C."""
    from pychemkin_tpu_torch.mechanism.record import FALLOFF_SRI, FALLOFF_TROE
    t = TRANSCENDENTAL
    KK, II, N = tm.KK, tm.II, tm.N
    n_fo, n_tb, n_rev = (tm.fo_rows.numel(), tm.tb_rows.numel(),
                         tm.rev_rows.numel())
    ftype = tm.fo_type.cpu()
    troe = ftype == FALLOFF_TROE
    n_troe = int(troe.sum())
    n_troe_t2 = int((troe & tm.fo_troe[:, 3].isfinite().cpu()).sum())
    n_sri = int((ftype == FALLOFF_SRI).sum())
    nnz_ord = tm.of_sp.numel() + tm.or_sp.numel()
    n_nus = tm.nus_rxn.numel()
    ops = (t                                     # ln T
           + KK * (t + 34)                       # C, ln C, NASA-7 cp h s g
           + II * (t + 6)                        # Arrhenius: one exp
           + n_tb * 2 * KK                       # [M]
           + n_fo * (t + 10)                     # k0, Pr, blend
           + n_troe * (4 * t + 20) + n_troe_t2 * t   # log Pr, Fcent, F
           + n_sri * (6 * t + 20)                # log Pr, X, F
           + 2 * tm.kc_sp.numel() + n_rev * (t + 8)  # ln Kc, kr
           + 2 * nnz_ord + II * (t + 4) + n_rev * t  # products, q
           + 2 * n_nus + 8 * KK)                 # wdot, dT/dt
    if jac:
        ops += (II * 6 + n_fo * 60 + n_rev * 12  # dk/dT, dk/d[M]
                + 2 * tm.kc_sp.numel()           # sum nu h for d ln Kc/dT
                + II * 8 + n_tb * 8              # dq/dT, gated q, G
                + 2 * n_nus                      # dwdot/dT = nu^T dq/dT
                + 4 * tm.jac_rxn.numel() + 2 * KK * KK   # dwdot/dC
                + 4 * tm.tbs_row.numel() * KK    # third-body correction
                + (4 if problem == "CONP" else 2) * KK * KK   # D C, h D
                + 16 * KK                        # sums
                + 8 * N * N)                     # chain rule to J
    return float(ops)


def _bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP64_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _lane_work(tm, problem):
    """(bytes, FP64 operations) of one lane's call of K1-K4: each input
    read once and each output written once, the mechanism's tables not
    counted (they are read once per launch, whatever B)."""
    N, n = tm.N, tm.N - 1
    return {
        "rhs": ((2 * N + 1) * 8, _rate_flops(tm, False, problem)),
        "rhs_jac": ((N + 1 + N + N * N) * 8, _rate_flops(tm, True, problem)),
        "bordered_factor": ((N * N + 1 + n * n + 2 * n + 1) * 8,
                            2.0 * N * N + 2.0 * n ** 3 / 3 + 2.0 * n * n
                            + 2 * n),
        "bordered_solve": ((n * n + 2 * n + 1 + 2 * N) * 8,
                           2.0 * n * n + 4 * n)}


def _k5_state_bytes(tm):
    """Bytes one lane moves in a K5 launch in which it steps: its
    constants read once (constraint, atol [N], t_end, thresh) and its
    carried state read once and written once (t, y [N], f [N], h, four
    int64 counters, the two event accumulators, stalled, status,
    dt_min)."""
    N = tm.N
    state = (2 * N + 2) * 8 + 4 * 8 + 2 * 8 + 1 + 4 + 8
    return (N + 3) * 8 + 2 * state


#: bytes a lane that is already done reads in a K5 launch to find that
#: out: t, t_end, stalled, n_steps, n_rejected
K5_DONE_LANE_BYTES = 4 * 8 + 1


def _k5_bound(tm, problem, launches, B, lane_launches, attempts, newton):
    """Least time of K5's work, the larger of two times: the bytes it must
    move over the memory rate, and the operations of the lane bodies it
    runs over the FP64 rate. Bytes: the mechanism's tables once per
    launch, ``_k5_state_bytes`` for each of the ``lane_launches`` (lane,
    launch) pairs in which a lane stepped, and K5_DONE_LANE_BYTES for each
    other pair; J and the LU live in shared memory and are not counted.
    Operations: per attempt one K2 and one K3 body, per Newton iteration
    one K1 and one K4 body, and one more K4 body for the error filter.
    Returns (bound ms, "bytes" or "operations", the sum of the K1-K4
    per-call bounds over those calls: the same work as separate launches,
    with J and the LU through device memory)."""
    work = _lane_work(tm, problem)
    calls = {"rhs_jac": attempts, "bordered_factor": attempts,
             "rhs": newton, "bordered_solve": newton + attempts}
    nbytes = (launches * _mech_bytes(tm) + lane_launches * _k5_state_bytes(tm)
              + (launches * B - lane_launches) * K5_DONE_LANE_BYTES)
    flops = sum(c * work[k][1] for k, c in calls.items())
    bms, by = _bound_ms(nbytes, flops)
    per_call = sum(c * _bound_ms(*work[k])[0] for k, c in calls.items())
    return bms, by, per_call


def _launched(name, fn):
    """Call kernel wrapper ``fn`` once, synchronise, and check that it
    launched its kernel (its count grew by one) rather than its twin;
    ``name`` is the kernel's entry of ``kernels.LAUNCHES``."""
    import torch
    from pychemkin_tpu_torch import kernels
    n = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n + 1, f"{name} did not launch"
    return out


def _row(name, source, replaces, **kw):
    return dict(name=name, route="cuda",
                source="pychemkin_tpu_torch/kernels/csrc/" + source,
                replaces="pychemkin_tpu/" + replaces, **kw)


def check_kernels(tm, B, reps):
    """Phase 2, K1-K4: every kernel against its plain twin at B lanes."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import jacobian, linalg, reactors, thermo
    KK, N = tm.KK, tm.N
    rows = []
    mech_b = _mech_bytes(tm)

    # K1 / K2 on random states, for both constraints; the CONV lanes sit at
    # the density of their own (T, P, Y)
    y, P = _states(tm, B, 0, realistic=False)
    T = y[:, KK]
    for problem in ("CONP", "CONV"):
        c = P if problem == "CONP" else thermo.density(tm, T, P, y[:, :KK])
        rhs_t, jac_t = reactors.RHS_TWINS[problem]
        tag = "" if problem == "CONP" else " (CONV)"
        name = kernels.launch_name("rhs", problem)
        f_k = _launched(name, lambda: kernels.rhs(tm, y, c, problem=problem))
        f_t = rhs_t(tm, y, c)
        torch.cuda.synchronize()
        e1 = _rate_rel(f_k, f_t, T, KK)
        assert torch.isfinite(f_k).all(), f"K1{tag} produced non-finite values"
        assert e1 <= 1e-12, f"K1{tag} vs twin: scale-relative {e1:.3e} > 1e-12"
        ms = _time_ms(lambda: kernels.rhs(tm, y, c, problem=problem), reps)
        pms = _time_ms(lambda: rhs_t(tm, y, c), max(reps // 10, 2))
        nbytes = B * (2 * N + 1) * 8 + mech_b
        bms, by = _bound_ms(nbytes, B * _rate_flops(tm, False, problem))
        rows.append(_row(name, "rhs.cu",
                         "ops/reactors.py:100" if problem == "CONP"
                         else "ops/reactors.py:132",
                         max_abs_err=float((f_k - f_t).abs().max()),
                         scale_rel_err=e1, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None))

        name = kernels.launch_name("rhs_jac", problem)
        f_k, J_k = _launched(name, lambda: kernels.rhs_jac(tm, y, c,
                                                           problem=problem))
        f_t, J_t = jac_t(tm, y, c)
        torch.cuda.synchronize()
        e2f = _rate_rel(f_k, f_t, T, KK)
        e2 = _rate_rel(J_k, J_t, T, KK)
        assert torch.isfinite(J_k).all(), f"K2{tag} produced non-finite values"
        assert e2f <= 1e-12, f"K2{tag} f vs twin: {e2f:.3e} > 1e-12"
        assert e2 <= 1e-11, \
            f"K2{tag} J vs twin: scale-relative {e2:.3e} > 1e-11"
        ms = _time_ms(lambda: kernels.rhs_jac(tm, y, c, problem=problem),
                      reps)
        pms = _time_ms(lambda: jac_t(tm, y, c), max(reps // 10, 2))
        nbytes = B * (N + 1 + N + N * N) * 8 + mech_b
        bms, by = _bound_ms(nbytes, B * _rate_flops(tm, True, problem))
        rows.append(_row(name, "rhs_jac.cu",
                         "ops/jacobian.py:710" if problem == "CONP"
                         else "ops/jacobian.py:558 (CONV branch, via :710)",
                         max_abs_err=float((J_k - J_t).abs().max()),
                         scale_rel_err=e2, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None))

    # K3 / K4 on realistic states, h log-uniform over 1e-9..1e-4 s
    y, P = _states(tm, B, 1, realistic=True)
    _, J = jacobian.conp_enrg_rhs_jac(tm, y, P)
    g = torch.Generator(device="cpu").manual_seed(2)
    h = 10 ** (torch.rand(B, generator=g, dtype=torch.float64) * 5 - 9)
    hg = (h * 0.435866521508458999416019).to(tm.device)
    r = torch.randn(B, N, generator=g, dtype=torch.float64).to(tm.device)
    fac_k = _launched("bordered_factor",
                      lambda: kernels.bordered_factor(J, hg))
    fac_t = linalg.factor_bordered(J, hg)
    torch.cuda.synchronize()
    e3 = max(float(((a - b).abs().flatten(1).amax(1)
                    / b.abs().flatten(1).amax(1).clamp_min(1e-300)).max())
             if a.dim() > 1 else
             float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())
             for a, b in zip(fac_k, fac_t))
    x_k = _launched("bordered_solve", lambda: kernels.bordered_solve(fac_k, r))
    x_t = linalg.solve_bordered(fac_t, r)
    torch.cuda.synchronize()
    M = linalg.newton_matrix(J, hg)
    res = (torch.bmm(M, x_k[:, :, None])[..., 0] - r).abs().amax(1)
    back = float((res / (M.abs().sum(2).amax(1) * x_k.abs().amax(1)
                         + r.abs().amax(1))).max())
    e4 = float(((x_k - x_t).abs().amax(1)
                / x_t.abs().amax(1).clamp_min(1e-300)).max())
    assert torch.isfinite(x_k).all(), "K4 produced non-finite values"
    assert back <= 1e-10, f"K3+K4 relative residual {back:.3e} > 1e-10"
    assert e3 <= 1e-10, f"K3 vs twin {e3:.3e} > 1e-10"
    assert e4 <= 1e-10, f"K3+K4 vs twin {e4:.3e} > 1e-10"
    n = N - 1
    ms = _time_ms(lambda: kernels.bordered_factor(J, hg), reps)
    pms = _time_ms(lambda: linalg.factor_bordered(J, hg), 2)
    lms = _time_ms(lambda: torch.linalg.lu_factor_ex(M), reps)
    nbytes = B * (N * N + 1 + n * n + 2 * n + 1) * 8
    flops = B * (2.0 * N * N + 2.0 * n ** 3 / 3 + 2.0 * n * n + 2 * n)
    bms, by = _bound_ms(nbytes, flops)
    rows.append(_row("bordered_factor", "bordered_factor.cu",
                     "ops/linalg.py:249",
                     max_abs_err=float(max((a - b).abs().max()
                                           for a, b in zip(fac_k, fac_t))),
                     scale_rel_err=e3, ms=ms, plain_ms=pms, bound_ms=bms,
                     bound_by=by, library_ms=lms,
                     library_call="torch.linalg.lu_factor_ex(M)"))
    ms = _time_ms(lambda: kernels.bordered_solve(fac_k, r), reps)
    pms = _time_ms(lambda: linalg.solve_bordered(fac_t, r), 5)
    LU, piv, _ = torch.linalg.lu_factor_ex(M)
    rr = r[:, :, None].contiguous()
    lms = _time_ms(lambda: torch.linalg.lu_solve(LU, piv, rr), reps)
    nbytes = B * (n * n + 2 * n + 1 + 2 * N) * 8
    flops = B * (2.0 * n * n + 4 * n)
    bms, by = _bound_ms(nbytes, flops)
    rows.append(_row("bordered_solve", "bordered_solve.cu",
                     "ops/linalg.py:285",
                     max_abs_err=float((x_k - x_t).abs().max()),
                     scale_rel_err=e4, residual=back, ms=ms, plain_ms=pms,
                     bound_ms=bms, bound_by=by, library_ms=lms,
                     library_call="torch.linalg.lu_solve(LU, piv, r)"))
    for row in rows:
        _print_row(row)
    return rows


def _print_row(row):
    print(f"kernel {row['name']}: {row['ms']:.4f} ms (twin "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"by {row['bound_by']}, library {row['library_ms']}), "
          f"scale-rel err {row['scale_rel_err']:.3e}", flush=True)


def _sweep_start(tm, problem, P0, B, t_end, mode):
    """(lanes, events, start state) of a grisyn sweep over B lanes: T0
    evenly over 1000-1400 K at P0, stoichiometric H2/air, ignition mode
    ``mode``."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch.ops import odeint, reactors
    f64 = dict(dtype=torch.float64, device=tm.device)
    T0 = torch.tensor(np.linspace(1000.0, 1400.0, B), **f64)
    Y0 = torch.tensor(np.tile(_stoich_Y(tm), (B, 1)), **f64)
    lanes, y0 = reactors.sweep_lane_args(
        tm, T0, torch.full((B,), P0, **f64), Y0,
        torch.full((B,), t_end, **f64), atol=1e-12, ignition_mode=mode,
        problem=problem)
    events = reactors.ignition_events(mode)
    with torch.inference_mode():
        s0 = odeint.sweep_start(reactors.kernel_ops(problem), tm, lanes, y0,
                                1e-6, events)
    return lanes, events, s0


def _clone(s):
    return type(s)(*[x.clone() for x in s])


def _k5_vs_twin(tm, problem, lanes, events, s0, mode):
    """One round of K5_ATTEMPTS attempts from ``s0`` through
    ``kernels.sdirk_round`` and through the masked loop over the plain
    twins (``odeint.sweep_round``). Checks: every carried field finite
    where the twin's is; equal status codes on every lane; the twin's
    attempt and Newton counts on at least 99 % of the lanes, and on them
    t, y, h and the event accumulators within 1e-8 relative (an event
    time not yet found must be unfound in both); attempt and Newton
    totals within 1 %. Returns (kernel state, twin state, twin ms,
    statistics)."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import odeint, reactors
    B, R = s0.t.shape[0], K5_ATTEMPTS
    tag = f"K5 {problem} {reactors.IGNITION_MODES[mode]}"
    name = kernels.launch_name("sdirk_round", problem)
    with torch.inference_mode():
        sk = _launched(name, lambda: kernels.sdirk_round(
            tm, lanes, _clone(s0), rtol=1e-6, budget=20_000,
            max_attempts=R, event_mode=mode, problem=problem))
        t1 = time.perf_counter()
        st = odeint.sweep_round(reactors.plain_ops(problem), tm, lanes,
                                events, 1e-6, 20_000, _clone(s0),
                                max_attempts=R)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t1) * 1e3
    for f, a, b in zip(odeint.StepState._fields, sk, st):
        if a.is_floating_point():
            assert bool((a.isfinite() | ~b.isfinite()).all()), \
                f"{tag}: {f} not finite where the twin's is"
    assert torch.equal(sk.status, st.status), f"{tag}: status codes"
    # the counts of this round: the state carries the totals since t = 0
    att0 = s0.n_steps + s0.n_rejected
    att_k = sk.n_steps + sk.n_rejected - att0
    att_t = st.n_steps + st.n_rejected - att0
    new_k, new_t = sk.n_newton - s0.n_newton, st.n_newton - s0.n_newton
    same = (att_k == att_t) & (new_k == new_t)
    n_same = int(same.sum())
    assert n_same >= 0.99 * B, \
        f"{tag}: only {n_same}/{B} lanes with the twin's counts"

    def rel(a, b):
        a, b = a.reshape(B, -1)[same], b.reshape(B, -1)[same]
        found = b.isfinite()
        assert torch.equal(a.isfinite(), found), f"{tag}: finite pattern"
        d = (a - b).abs() / b.abs().clamp_min(1e-300)
        return float(d[found].max()) if bool(found.any()) else 0.0
    y_scale = st.y.abs().amax(1)
    err = dict(t=rel(sk.t, st.t), h=rel(sk.h, st.h),
               y=float(((sk.y - st.y).abs().amax(1) / y_scale)[same].max()),
               acc_t=rel(sk.acc_t, st.acc_t), acc_v=rel(sk.acc_v, st.acc_v))
    tot = {k: (int(a.sum()), int(b.sum())) for k, a, b in (
        ("attempts", att_k, att_t), ("newton", new_k, new_t))}
    found = int((st.acc_t[:, 0].isfinite() & ~s0.acc_t[:, 0].isfinite())
                .sum())
    print(f"{tag} vs twin, B={B}, {R} attempts: {n_same}/{B} lanes with "
          f"equal counts; on them relative errors "
          f"{ {k: f'{v:.2e}' for k, v in err.items()} }; totals (kernel, "
          f"twin) {tot}; the twin found the event time on {found} lanes "
          f"in this round", flush=True)
    assert max(err.values()) <= 1e-8, f"{tag} vs twin beyond 1e-8: {err}"
    for k, (a, b) in tot.items():
        assert abs(a - b) <= 0.01 * b, f"{tag}: {k} totals {a} vs {b}"
    stats = dict(lanes_equal_counts=n_same, totals=tot, rel_err=err,
                 events_found=found)
    return sk, st, pms, stats


def _before_crossing(tm, problem, lanes, s0, step):
    """Per lane, the last state before its T_rise crossing: K5 advances
    ``s0`` in rounds of ``step`` attempts, and each lane keeps the state it
    had at the start of the round in which its crossing time was found.
    So the next round of K5_ATTEMPTS >= ``step`` attempts from it crosses
    on every lane (where the twin takes the same steps)."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import odeint
    pre, cur = _clone(s0), _clone(s0)
    with torch.inference_mode():
        while bool(odeint.sweep_going(cur, lanes, 20_000).any()):
            before = _clone(cur)
            kernels.sdirk_round(tm, lanes, cur, rtol=1e-6, budget=20_000,
                                max_attempts=step, event_mode=1,
                                problem=problem)
            now = cur.acc_t[:, 0].isfinite()
            fresh = now & ~before.acc_t[:, 0].isfinite()
            pre = type(s0)(*[torch.where(fresh.view(-1, *[1] * (p.dim() - 1)),
                                         b, p) for p, b in zip(pre, before)])
            if bool(now.all()):
                break
    return pre


def check_k5(tm, problem, P0, t_end, reps):
    """Phase 2, K5: one round of K5_ATTEMPTS step attempts at K5_BATCH
    lanes through ``kernels.sdirk_round`` and through the masked loop over
    the plain twins: T_inflection (event_mode 0) from a sweep's start
    state, and T_rise (event_mode 1, threshold T0 + 400 K) from each lane's
    last state before its crossing, so that the crossing branch runs on
    every lane; then K5's time per launch of the first."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import reactors
    B, R = K5_BATCH, K5_ATTEMPTS
    lanes, events, s0 = _sweep_start(tm, problem, P0, B, t_end,
                                     reactors.IGN_T_INFLECTION)
    sk, st, pms, stats = _k5_vs_twin(tm, problem, lanes, events, s0, 0)

    lanes_r, events_r, s0_r = _sweep_start(tm, problem, P0, B, t_end,
                                           reactors.IGN_T_RISE)
    pre = _before_crossing(tm, problem, lanes_r, s0_r, R // 2)
    sk_r, st_r, _, stats_r = _k5_vs_twin(tm, problem, lanes_r, events_r, pre,
                                         1)
    assert stats_r["events_found"] == B, \
        f"K5 {problem} T_rise: crossing found on {stats_r['events_found']}" \
        f"/{B} lanes of the twin"

    # time per launch, each launch from the same start state
    kw = dict(rtol=1e-6, budget=20_000, max_attempts=R, event_mode=0,
              problem=problem)
    starts = [_clone(s0) for _ in range(reps + 1)]
    with torch.inference_mode():
        kernels.sdirk_round(tm, lanes, starts[-1], **kw)
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for (e0, e1), s in zip(ev, starts):
            e0.record()
            kernels.sdirk_round(tm, lanes, s, **kw)
            e1.record()
        torch.cuda.synchronize()
    ms = float(np.mean([e0.elapsed_time(e1) for e0, e1 in ev]))
    att, newton = stats["totals"]["attempts"][0], stats["totals"]["newton"][0]
    bms, by, per_call = _k5_bound(tm, problem, 1, B, B, att, newton)
    row = _row(kernels.launch_name("sdirk_round", problem), "sdirk_round.cu",
               "ops/odeint.py:451 (_segment_fns; :322, :355, :377, :787)",
               max_abs_err=float((sk.y - st.y).abs().max()),
               scale_rel_err=max(stats["rel_err"].values()), ms=ms,
               plain_ms=pms, bound_ms=bms, bound_by=by,
               per_call_bound_sum_ms=per_call, library_ms=None, batch=B,
               attempts=R, **stats,
               t_rise=dict(stats_r, max_abs_err_acc_t=float(
                   (sk_r.acc_t - st_r.acc_t).abs().max())))
    _print_row(row)
    print(f"  K5 {problem}: per-call bound sum {per_call:.4f} ms", flush=True)
    return row


def sweep_phase(tm, problem, P0, B, t_end):
    """Phase 3 (CONP, the main path) or 3b (CONV): the grisyn sweep
    through K1 and K5 (``ignition_delay_sweep``), then through the
    host-driven loop over K1-K4, each with the launch counters set to 0
    just before it and read just after; then 8 lanes through the plain
    twins on the card."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import reactors
    from pychemkin_tpu_torch.resilience.status import SolveStatus
    T0 = np.linspace(1000.0, 1400.0, B)
    Y0 = _stoich_Y(tm)
    args = (tm, problem, "ENRG", T0, P0, Y0, t_end)
    kw = dict(rtol=1e-6, atol=1e-12, ignition_mode=reactors.IGN_T_INFLECTION,
              max_steps_per_segment=20_000, device="cuda")
    name = {k: kernels.launch_name(k, problem)
            for k in ("rhs", "rhs_jac", "sdirk_round")}
    runs = {}
    for path, ops in (("k5", None),
                      ("host_loop", reactors.kernel_ops(problem))):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        times, ok, status, prof = reactors._sweep(ops, *args, **kw,
                                                  profile=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        att = prof["n_steps"] + prof["n_rejected"]
        runs[path] = dict(
            times=times.cpu().numpy(), ok=ok.cpu().numpy(),
            status=status.cpu().numpy(), wall_s=wall,
            ignitions_per_s=B / wall, attempts=int(att.sum()),
            max_attempts=int(att.max()), newton=int(prof["n_newton"].sum()),
            lane_rounds=int(((att + reactors.ROUND_ATTEMPTS - 1)
                             // reactors.ROUND_ATTEMPTS).sum()),
            launches=launches)
        print(f"sweep grisyn {problem}/ENRG P0={P0:.6g} B={B} t_end={t_end} "
              f"via {path}: wall {wall:.3f} s, {B / wall:.2f} ignitions/s, "
              f"attempts {runs[path]['attempts']} (max per lane "
              f"{runs[path]['max_attempts']}), Newton iterations "
              f"{runs[path]['newton']}, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    k5, host = runs["k5"], runs["host_loop"]
    lk, lh = k5["launches"], host["launches"]
    # the sweep's attempts ran only inside K5, one launch per round
    assert lk[name["rhs"]] > 0 and lk[name["sdirk_round"]] > 0, lk
    assert lk[name["rhs_jac"]] == lk["bordered_factor"] \
        == lk["bordered_solve"] == 0, lk
    assert lh[name["sdirk_round"]] == 0 and all(
        lh[k] > 0 for k in (name["rhs"], name["rhs_jac"], "bordered_factor",
                            "bordered_solve")), lh
    st = k5["status"]
    assert (st == int(SolveStatus.OK)).all(), \
        f"status codes {np.unique(st, return_counts=True)}"
    assert bool(k5["ok"].all()), "some lanes did not succeed"
    assert np.isfinite(k5["times"]).all(), "non-finite ignition times"
    assert (st == host["status"]).all(), "K5 and host-loop status codes"
    rel_host = float(np.max(np.abs(k5["times"] - host["times"])
                            / np.abs(host["times"])))
    for k in ("attempts", "newton"):
        assert abs(k5[k] - host[k]) <= 0.01 * host[k], \
            f"{k}: K5 {k5[k]} vs host loop {host[k]}"
    assert rel_host <= 1e-6, f"K5 vs host-loop ignition times {rel_host}"
    # a lane steps in ceil(attempts / ROUND_ATTEMPTS) of the K5 launches
    bound, by, per_call = _k5_bound(tm, problem, lk[name["sdirk_round"]], B,
                                    k5["lane_rounds"], k5["attempts"],
                                    k5["newton"])
    print(f"  K5 vs host loop: ignition times within {rel_host:.3e} "
          f"relative, attempts {k5['attempts']} vs {host['attempts']}, "
          f"Newton {k5['newton']} vs {host['newton']}; K5 rounds "
          f"{lk[name['sdirk_round']]}; the K5 work's bound {bound:.2f} ms "
          f"by {by} (as separate K1-K4 launches: {per_call:.2f} ms)",
          flush=True)
    times_np = k5["times"]
    print(f"  ignition times [s]: min {times_np.min():.6e} max "
          f"{times_np.max():.6e}", flush=True)

    pick = np.unique(np.linspace(0, B - 1, min(8, B)).round().astype(int))
    t1 = time.perf_counter()
    ref, _, st_r = reactors._sweep(
        reactors.plain_ops(problem), tm, problem, "ENRG", T0[pick], P0, Y0,
        t_end, **kw, profile=False)
    torch.cuda.synchronize()
    ref = ref.cpu().numpy()
    rel = np.abs(times_np[pick] - ref) / np.abs(ref)
    print(f"  plain-twin rerun of lanes {pick.tolist()}: max relative "
          f"difference {rel.max():.3e} ({time.perf_counter() - t1:.1f} s)",
          flush=True)
    assert (st_r.cpu().numpy() == int(SolveStatus.OK)).all()
    assert rel.max() <= 1e-6, f"kernel vs twin ignition times {rel.max()}"
    summary = dict(
        problem=problem, P0=P0, B=B, t_end=t_end,
        wall_s=k5["wall_s"], ignitions_per_s=k5["ignitions_per_s"],
        attempts=k5["attempts"], max_attempts=k5["max_attempts"],
        newton=k5["newton"], k5_rounds=lk[name["sdirk_round"]],
        k5_bound_ms=bound, k5_bound_by=by,
        k5_per_call_bound_sum_ms=per_call,
        host_loop_wall_s=host["wall_s"],
        host_loop_ignitions_per_s=host["ignitions_per_s"],
        host_loop_attempts=host["attempts"], host_loop_newton=host["newton"],
        max_rel_vs_host_loop=rel_host, max_rel_vs_plain=float(rel.max()))
    return {"k5": lk, "host_loop": lh}, summary


def profile_window(tm, B):
    """Where the time goes: ``torch.profiler`` over the first
    PROFILE_ATTEMPTS step attempts of the main-path sweep (lanes stop at
    that budget), which runs them in one launch of K5. Device-busy time
    is the union of the intervals of the device's own events (kernels,
    copies, sets), so a host operation's share of its kernels is not
    counted again. Returns wall and
    device-busy milliseconds, the device's idle share and the largest
    device entries, or None when the trace holds no device event."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pychemkin_tpu_torch.ops.reactors import ignition_delay_sweep
    T0 = np.linspace(1000.0, 1400.0, B)
    args = (tm, "CONP", "ENRG", T0, 1.01325e6, _stoich_Y(tm), 0.05)
    kw = dict(rtol=1e-6, atol=1e-12, device="cuda",
              max_steps_per_segment=PROFILE_ATTEMPTS)
    ignition_delay_sweep(*args, **dict(kw, max_steps_per_segment=2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ignition_delay_sweep(*args, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (b - a) / 1e3, n + 1)
    if not spans:
        return None
    spans.sort()
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy_us += hi - lo
    busy = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(attempts=PROFILE_ATTEMPTS, B=B, wall_ms=wall_ms,
                device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                device_events=len(spans),
                top=[dict(name=k[:60], ms=ms, count=n)
                     for k, (ms, n) in top])


# -- phase 2c and 5: the steady-state kernels K6 and K7 -----------------------

PSR_P = P_ATM
PSR_MDOT = 10.0          # g/s, as the reference's PSR tests
EQ_TOL = dict(T=1e-9, X=1e-11, h=1e-9, s=1e-9, v=1e-9)   # the CPU tests'
PSR_TOL = dict(T=1e-8, Y=1e-10)                          # the CPU tests'
MAP_TOL = dict(T=1e-6, Y=1e-9)
SAME_SHARE = 0.99        # lanes that must agree in status and counts


def _h2_air(tm, phi):
    """H2/air mass fractions [len(phi), KK] at equivalence ratios phi."""
    import numpy as np
    names = [s.upper() for s in tm.record.species_names]
    wt = np.asarray(tm.record.wt)
    X = np.zeros((len(phi), len(names)))
    X[:, names.index("H2")] = 2.0 * np.asarray(phi)
    X[:, names.index("O2")] = 1.0
    X[:, names.index("N2")] = 3.76
    Y = X * wt
    return Y / Y.sum(1, keepdims=True)


def _eq_states(tm, B, seed):
    """(T, P, Y) of B equilibrium lanes: T 300-1500 K, H2/air at phi
    0.5-2, 1-10 atm."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=tm.device)
    T = rng.uniform(300.0, 1500.0, B)
    P = rng.uniform(1.0, 10.0, B) * P_ATM
    Y = _h2_air(tm, rng.uniform(0.5, 2.0, B))
    return (torch.tensor(T, **f64), torch.tensor(P, **f64),
            torch.tensor(Y, **f64))


def _equil_flops(tm, option, n_iter=80):
    """FP64 operations of one lane of K6 for ``option``, counted from the
    iterations the solve makes (the same on every lane): per Newton
    iteration the species loop, the (MM + 4)(n + 1) sums over the
    species, the two constraint rows, the row equilibration, the LU and
    the solve with its residual check; per solve the least-squares start
    and the final evaluation."""
    from pychemkin_tpu_torch.ops import equilibrium
    t = TRANSCENDENTAL
    KK, MM = tm.KK, tm.MM
    n = MM + 3
    species = KK * (40 + 2 * MM + 3 * t)        # NASA-7, ln x, clip, x, S
    it = (species + (MM + 4) * (n + 1) * KK * 6 + 20 * n + 3 * n * n
          + 2.0 * n ** 3 / 3 + 4 * n * n + 10 * n + 2 * t)
    final = species + (MM + 4) * KK * 3 + 4 * KK
    init = KK * (30 + 2 * t) + 2 * MM * (MM + 1) * KK + 2.0 * MM ** 3 / 3

    def solve(n_main, n_pre, pair_TP):
        return init + (n_main + (0 if pair_TP else n_pre)) * it + final

    con1, con2 = equilibrium.EQ_OPTIONS[option]
    start = KK * (60 + 2 * t)                  # targets of the initial state
    if not equilibrium.is_nested(option):
        return float(start + solve(n_iter, 50, (con1, con2) == ("T", "P")))
    inner = solve(30, 30, con1 == "P")
    final_solve = solve(40, 30, con1 == "P")
    return float(start + 20 * (inner + 2 * KK + 10) + final_solve + 2 * KK)


def _eq_bytes(tm):
    """Bytes one lane of K6 moves: T, P, Y in; the result fields out."""
    KK = tm.KK
    return (2 + KK) * 8 + (8 + 2 * KK) * 8 + 1 + 4


def _compare_eq(tag, k, q):
    """K6 result ``k`` against its twin's ``q``: the same status on
    SAME_SHARE of the lanes the twin solves; on the lanes OK in both, T
    and v within EQ_TOL relative, X absolute, and h and s relative to
    max(|value|, its thermal scale nbar R T or nbar R): an enthalpy near
    zero is a difference of species terms 1e7 times larger, so plain
    relative error there measures cancellation, not the solve. Returns
    (errors, lanes the twin solves, lanes with equal status)."""
    import torch
    from pychemkin_tpu_torch.constants import R_GAS
    B = q.T.shape[0]
    ok_t = q.status == 0
    bad = ok_t & (k.status != q.status)
    n_bad = int(bad.sum())
    for i in bad.nonzero()[:, 0][:5].tolist():
        print(f"  {tag}: lane {i}: kernel status {int(k.status[i])} residual "
              f"{float(k.residual[i]):.3e}, twin residual "
              f"{float(q.residual[i]):.3e}, T {float(q.T[i]):.2f}",
              flush=True)
    assert n_bad <= (1.0 - SAME_SHARE) * B, \
        f"{tag}: status differs on {n_bad} lanes the twin solves"
    ok = ok_t & (k.status == 0)
    err = dict(T=0.0, X=0.0, h=0.0, s=0.0, v=0.0)
    if bool(ok.any()):
        def rel(f, scale=None):
            a, b = getattr(k, f)[ok], getattr(q, f)[ok]
            den = b.abs() if scale is None else torch.maximum(b.abs(),
                                                              scale[ok])
            return float(((a - b).abs() / den.clamp_min(1e-300)).max())
        err = dict(T=rel("T"), v=rel("v"), h=rel("h", q.nbar * R_GAS * q.T),
                   s=rel("s", q.nbar * R_GAS),
                   X=float((k.X - q.X).abs()[ok].max()))
    for f, tol in EQ_TOL.items():
        assert err[f] <= tol, f"{tag}: {f} error {err[f]:.3e} > {tol}"
    return err, int(ok_t.sum()), int((k.status == q.status).sum())


def check_equilibrium(tm_g, tm_h, B_g, reps):
    """Phase 2c, K6: ``kernels.equil_solve`` against
    ``equilibrium.equilibrate_plain`` on the card, grisyn B_g lanes for
    options 1 and 5, h2o2 256 lanes for all nine options. Returns the
    statistics of every case."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import equilibrium
    cases = []
    for tm, B, options in ((tm_g, B_g, (1, 5)), (tm_h, 256, range(1, 10))):
        T, P, Y = _eq_states(tm, B, 3)
        for opt in options:
            tag = f"K6 {len(tm.record.species_names)} species option {opt}"
            k = _launched("equil_solve",
                          lambda: kernels.equil_solve(tm, T, P, Y, opt, 80))
            t1 = time.perf_counter()
            q = equilibrium.equilibrate_plain(tm, T, P, Y, opt)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t1) * 1e3
            err, n_ok, n_same = _compare_eq(tag, k, q)
            ms = _time_ms(lambda: kernels.equil_solve(tm, T, P, Y, opt, 80),
                          reps)
            bms, by = _bound_ms(B * _eq_bytes(tm),
                                B * _equil_flops(tm, opt))
            print(f"{tag}, B={B}: {ms:.3f} ms (twin {pms:.1f} ms, bound "
                  f"{bms:.4f} ms by {by}); twin OK on {n_ok}/{B}, status "
                  f"equal on {n_same}/{B}; errors "
                  f"{ {f: f'{v:.2e}' for f, v in err.items()} }", flush=True)
            cases.append(dict(mech=tm.KK, option=opt, B=B, ms=ms,
                              plain_ms=pms, bound_ms=bms, bound_by=by,
                              ok_lanes=n_ok, same_status=n_same, err=err))
    return cases


def _psr_work(tm, sol, n_pseudo=100):
    """(bytes, FP64 operations) of K7 over the lanes of ``sol``, counted
    from the iterations each lane made: per Newton iteration one K2 body,
    the flow shell, the pivoted bordered factor, one solve and the
    full-matrix residual check; per pseudo-transient step (on the lanes
    whose polish count is > 0) one K2 body, the factor and 6 x (K1 body +
    solve); per lane the finish (one K1 body)."""
    KK, N = tm.KK, tm.N
    n = KK
    k1 = _rate_flops(tm, False)
    k2 = _rate_flops(tm, True)
    shell = 12 * KK + 10 * N * N
    factor = 2.0 * n ** 3 / 3 + 2.0 * n * n + 4 * n + 2 * N * N
    solve = 2.0 * n * n + 4 * n
    newton = k2 + shell + factor + solve + 2 * N * N + 12 * N
    pt_step = k2 + shell + N * N + factor + 6 * (k1 + 4 * KK + solve + 6 * N)
    its = int((sol.n_newton_direct + sol.n_newton_polish).sum())
    pt_lanes = int((sol.n_newton_polish > 0).sum())
    B = sol.T.shape[0]
    flops = its * newton + pt_lanes * n_pseudo * pt_step + B * (k1 + 4 * KK)
    nbytes = B * ((2 * KK + 9) * 8 + (KK + 5) * 8 + 1 + 3 * 8 + 4) \
        + _mech_bytes(tm)
    return nbytes, float(flops)


def _psr_lanes(tm, B, seed, energy, cold=False):
    """(args, y0) of B PSR lanes on the card: H2/air at phi 0.5-2, inlets
    at 298-900 K, tau 1e-6-1 s, volumes 1e-2-1e4 cm^3 at 10 g/s (for "vol"
    mode); ``cold``: stoichiometric H2/air with inlets at 298.15 and 700 K,
    each over B/2 residence times geometric over 1e-4-1 s. The guess is the
    inlet's HP equilibrium from the twin (ENRG) or the inlet at T_fixed,
    800-2000 K (TGIV)."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch.ops import equilibrium, psr, thermo
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=tm.device)
    if cold:
        T_in = np.repeat([298.15, 700.0], B // 2)
        tau = np.tile(np.geomspace(1e-4, 1.0, B // 2), 2)
        phi = np.ones(B)
    else:
        T_in = rng.uniform(298.15, 900.0, B)
        tau = 10 ** rng.uniform(-6.0, 0.0, B)
        phi = rng.uniform(0.5, 2.0, B)
    Y_in = torch.tensor(_h2_air(tm, phi), **f64)
    T_in = torch.tensor(T_in, **f64)
    Pv = torch.full((B,), PSR_P, **f64)
    T_fixed = torch.tensor(rng.uniform(800.0, 2000.0, B), **f64)
    args = psr.PSRArgs(
        P=Pv, Y_in=Y_in, h_in=thermo.mixture_enthalpy_mass(tm, T_in, Y_in),
        tau=torch.tensor(tau, **f64),
        volume=torch.tensor(10 ** rng.uniform(-2.0, 4.0, B), **f64),
        mdot=torch.full((B,), PSR_MDOT, **f64), qloss=torch.zeros(B, **f64),
        T_fixed=T_fixed)
    if energy == "TGIV":
        y0 = torch.cat([Y_in, T_fixed[:, None]], 1)
    else:
        g = equilibrium.equilibrate_plain(tm, T_in, Pv, Y_in, 5)
        y0 = torch.cat([g.Y, g.T[:, None]], 1)
    return args, y0.contiguous()


def _perturbed(y0, seed):
    """The guess with every entry moved by +-1e-15 relative (a random sign
    per entry): a rerun of the twin from it shows which lanes' outcome
    depends on rounding."""
    import numpy as np
    import torch
    sign = np.random.default_rng(seed).choice([-1.0, 1.0], tuple(y0.shape))
    return (y0 * (1.0 + 1e-15 * torch.tensor(sign, dtype=y0.dtype,
                                             device=y0.device))).contiguous()


def _compare_psr(tag, k, q, rerun, tol, overall=False):
    """K7 result ``k`` against its twin's ``q``. Where they differ in
    status or Newton counts, ``rerun(lanes)`` runs the twin again on those
    lanes from the guess moved by 1e-15 (``_perturbed``): a lane whose twin
    outcome moves too is rounding-chaotic (a pseudo-transient trajectory
    that swings between the T clamps), and any two roundings, the kernel's
    and the twin's among them, may end it apart. Checks: the same status
    and counts as the twin on SAME_SHARE of the other (stable) lanes
    (``overall``: of all lanes); on the lanes OK in both with equal
    counts, T and Y within ``tol``. Returns statistics."""
    import torch
    B = q.T.shape[0]

    def same(a, b):
        return ((a.status == b.status) & (a.n_newton_direct == b.n_newton_direct)
                & (a.n_newton_polish == b.n_newton_polish))
    agree = same(k, q)
    apart = (~agree).nonzero()[:, 0]
    stable = torch.ones_like(agree)
    if apart.numel():
        stable[apart] = same(type(q)(*[x[apart] for x in q]), rerun(apart))
    for i in apart[:8].tolist():
        print(f"  {tag}: lane {i}{'' if bool(stable[i]) else ' (chaotic)'}: "
              f"kernel status {int(k.status[i])} counts "
              f"{int(k.n_newton_direct[i])}+{int(k.n_newton_polish[i])} T "
              f"{float(k.T[i]):.2f}; twin status {int(q.status[i])} counts "
              f"{int(q.n_newton_direct[i])}+{int(q.n_newton_polish[i])} T "
              f"{float(q.T[i]):.2f}", flush=True)
    n_stable = int(stable.sum())
    n_agree_stable = int((agree & stable).sum())
    assert n_agree_stable >= SAME_SHARE * n_stable, \
        f"{tag}: kernel = twin on {n_agree_stable}/{n_stable} stable lanes"
    n_st = int((k.status == q.status).sum())
    if overall:
        assert n_st >= SAME_SHARE * B, f"{tag}: status equal on {n_st}/{B}"
        assert int(agree.sum()) >= SAME_SHARE * B, \
            f"{tag}: Newton counts equal on {int(agree.sum())}/{B}"
    both = (k.status == 0) & (q.status == 0) & agree
    eT = float(((k.T - q.T).abs() / q.T.abs())[both].max()) \
        if bool(both.any()) else 0.0
    eY = float((k.Y - q.Y).abs()[both].max()) if bool(both.any()) else 0.0
    assert eT <= tol["T"] and eY <= tol["Y"], \
        f"{tag}: T {eT:.3e} / Y {eY:.3e} beyond {tol}"
    return dict(B=B, same_status=n_st, same_status_and_counts=int(agree.sum()),
                stable=n_stable, agree_on_stable=n_agree_stable,
                chaotic=B - n_stable, ok_both=int(both.sum()),
                ok_kernel=int((k.status == 0).sum()),
                ok_twin=int((q.status == 0).sum()), err_T=eT, err_Y=eY)


def _rerun(tm, mode, energy, args, y0, ctl, seed):
    """``rerun(lanes)`` of ``_compare_psr``: the twin on those lanes from
    the guess moved by 1e-15."""
    from pychemkin_tpu_torch.ops import psr

    def run(lanes):
        sub = type(args)(*[a[lanes].contiguous() for a in args])
        return psr.solve_psr_plain(tm, mode, energy, sub,
                                   _perturbed(y0[lanes], seed), ctl)
    return run


def check_psr(tm_g, tm_h):
    """Phase 2c, K7: ``kernels.psr_solve`` against ``psr.solve_psr_plain``
    on the card: grisyn 256 lanes from cold inlets (tau/ENRG), h2o2 256
    lanes for each of tau/vol x ENRG/TGIV. Returns the statistics."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import psr
    ctl = psr.PSRControls()
    cases = []
    for tm, mode, energy in ((tm_g, "tau", "ENRG"), (tm_h, "tau", "ENRG"),
                             (tm_h, "vol", "ENRG"), (tm_h, "tau", "TGIV"),
                             (tm_h, "vol", "TGIV")):
        cold = tm is tm_g
        args, y0 = _psr_lanes(tm, 256, 5, energy, cold=cold)
        tag = f"K7 {tm.KK} species {mode}/{energy}"
        t0 = time.perf_counter()
        k = _launched("psr_solve", lambda: kernels.psr_solve(
            tm, mode, energy, args, y0, ctl))
        ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        q = psr.solve_psr_plain(tm, mode, energy, args, y0, ctl)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t1) * 1e3
        st = _compare_psr(tag, k, q, _rerun(tm, mode, energy, args, y0, ctl,
                                            7), PSR_TOL)
        nbytes, flops = _psr_work(tm, k)
        bms, by = _bound_ms(nbytes, flops)
        pt = int((k.n_newton_polish > 0).sum())
        print(f"{tag}, B=256: {ms:.2f} ms (twin {pms:.0f} ms, bound "
              f"{bms:.4f} ms by {by}); {st}; pseudo-transient lanes {pt}",
              flush=True)
        if cold:
            assert st["ok_twin"] >= 0.9 * 256 and pt > 0, \
                f"{tag}: the grisyn check needs converging lanes and " \
                f"pseudo-transient lanes: {st}, {pt}"
        cases.append(dict(mech=tm.KK, mode=mode, energy=energy, ms=ms,
                          plain_ms=pms, bound_ms=bms, bound_by=by,
                          pt_lanes=pt, **st))
    return cases


def _map_lanes(tm):
    """The h2o2 PSR stability map: 8 phi (geometric 0.5-2) x 8 inlet
    temperatures (298.15-900 K) x 64 residence times (geometric
    1e-6-1 s), 4096 lanes, 1 atm."""
    import numpy as np
    import torch
    f64 = dict(dtype=torch.float64, device=tm.device)
    phi = np.geomspace(0.5, 2.0, 8)
    T_in = np.linspace(298.15, 900.0, 8)
    tau = np.geomspace(1e-6, 1.0, 64)
    P_, T_, t_ = np.meshgrid(phi, T_in, tau, indexing="ij")
    return (torch.tensor(_h2_air(tm, P_.ravel()), **f64),
            torch.tensor(T_.ravel(), **f64), torch.tensor(t_.ravel(), **f64))


def psr_map_phase(tm, reps):
    """Phase 5: the h2o2 PSR stability map through K6 (the guess) and K7,
    the launch counters set to 0 just before and read just after each
    step; then through the twins on the card. Returns (launches, summary,
    kernel rows' timings)."""
    import numpy as np
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import equilibrium, psr, thermo
    from pychemkin_tpu_torch.resilience.status import SolveStatus
    Y_in, T_in, tau = _map_lanes(tm)
    B = T_in.shape[0]
    h_in = thermo.mixture_enthalpy_mass(tm, T_in, Y_in)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.equilibrate(tm, T_in, PSR_P, Y_in, option=5, device="cuda")
    torch.cuda.synchronize()
    wall_eq = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    t1 = time.perf_counter()
    sol = ptt.solve_psr(tm, "tau", "ENRG", P=PSR_P, Y_in=Y_in, h_in=h_in,
                        T_guess=g.T, Y_guess=g.Y, tau=tau, mdot=PSR_MDOT,
                        device="cuda")
    torch.cuda.synchronize()
    wall_psr = time.perf_counter() - t1
    for k, v in kernels.LAUNCHES.items():
        launches[k] += v
    assert launches["equil_solve"] > 0 and launches["psr_solve"] > 0, launches
    st = sol.status.cpu().numpy()
    counts = {SolveStatus(int(c)).name: int(n)
              for c, n in zip(*np.unique(st, return_counts=True))}
    T = sol.T.cpu().numpy()
    pt = int((sol.n_newton_polish > 0).sum())
    summary = dict(
        B=B, wall_equilibrium_s=wall_eq, wall_psr_s=wall_psr,
        psr_solves_per_s=B / wall_psr, status=counts,
        n_newton_direct=int(sol.n_newton_direct.sum()),
        n_newton_polish=int(sol.n_newton_polish.sum()),
        pseudo_transient_lanes=pt, T_min=float(T.min()), T_max=float(T.max()),
        guess_status={SolveStatus(int(c)).name: int(n) for c, n in zip(
            *np.unique(g.status.cpu().numpy(), return_counts=True))},
        launches={k: v for k, v in launches.items() if v})
    print(f"PSR map h2o2 B={B}: equilibrium {wall_eq:.3f} s, PSR "
          f"{wall_psr:.3f} s, {B / wall_psr:.1f} PSR solves/s; status "
          f"{counts}; Newton direct {summary['n_newton_direct']}, polish "
          f"{summary['n_newton_polish']}; pseudo-transient lanes {pt}; exit "
          f"T {T.min():.2f}-{T.max():.2f} K; launches {summary['launches']}",
          flush=True)
    n_ok = counts.get("OK", 0)
    assert n_ok >= 0.8 * B, f"only {n_ok}/{B} lanes OK"
    ok = st == 0
    cold = np.abs(T - T_in.cpu().numpy()) < 1.0
    assert (ok & cold).any() and (ok & (T > 2000.0)).any(), \
        "the map lacks the cold or the burning branch"

    # the same map through the twins on the card
    t2 = time.perf_counter()
    gq = equilibrium.equilibrate_plain(tm, T_in, torch.full_like(T_in, PSR_P),
                                       Y_in, 5)
    torch.cuda.synchronize()
    eq_pms = (time.perf_counter() - t2) * 1e3
    eq_err, _, _ = _compare_eq("K6 map guess", g, gq)
    args = psr.PSRArgs(P=torch.full_like(T_in, PSR_P), Y_in=Y_in, h_in=h_in,
                       tau=tau, volume=torch.zeros_like(T_in),
                       mdot=torch.full_like(T_in, PSR_MDOT),
                       qloss=torch.zeros_like(T_in),
                       T_fixed=torch.zeros_like(T_in))
    y0 = torch.cat([gq.Y, gq.T[:, None]], 1).contiguous()
    t3 = time.perf_counter()
    q = psr.solve_psr_plain(tm, "tau", "ENRG", args, y0, psr.PSRControls())
    torch.cuda.synchronize()
    psr_pms = (time.perf_counter() - t3) * 1e3
    cmp = _compare_psr("K7 map", sol, q,
                       _rerun(tm, "tau", "ENRG", args, y0, psr.PSRControls(),
                              8), MAP_TOL, overall=True)
    print(f"  map vs twins: {cmp}; equilibrium guess errors "
          f"{ {f: f'{v:.2e}' for f, v in eq_err.items()} }; twin walls "
          f"{eq_pms:.0f} / {psr_pms:.0f} ms", flush=True)
    summary.update(vs_twin=cmp, guess_err=eq_err)

    # per-launch times at the map's shapes
    Pv = torch.full_like(T_in, PSR_P)
    eq_ms = _time_ms(lambda: kernels.equil_solve(tm, T_in, Pv, Y_in, 5, 80),
                     reps)
    ctl = psr.PSRControls()
    psr_ms = _time_ms(lambda: kernels.psr_solve(tm, "tau", "ENRG", args, y0,
                                                ctl), max(reps // 4, 1))
    eq_b, eq_f = B * _eq_bytes(tm), B * _equil_flops(tm, 5)
    ps_b, ps_f = _psr_work(tm, sol)
    rows = [
        _row("equil_solve", "equilibrium.cu",
             "ops/equilibrium.py:150 (_solve; :258 equilibrate)",
             max_abs_err=float((g.T - gq.T).abs().max()),
             scale_rel_err=eq_err["T"], ms=eq_ms, plain_ms=eq_pms,
             **dict(zip(("bound_ms", "bound_by"), _bound_ms(eq_b, eq_f))),
             library_ms=None, batch=B, option=5),
        _row("psr_solve", "psr_solve.cu",
             "ops/psr.py:273 (solve_psr; :148, :225)",
             max_abs_err=float((sol.T - q.T).abs()[(sol.status == 0)
                                                   & (q.status == 0)].max()),
             scale_rel_err=cmp["err_T"], ms=psr_ms, plain_ms=psr_pms,
             **dict(zip(("bound_ms", "bound_by"), _bound_ms(ps_b, ps_f))),
             library_ms=None, batch=B)]
    for row in rows:
        _print_row(row)
    return launches, summary, rows


def _build_report():
    """Registers, spills and stack of every kernel, from ptxas -v."""
    import re
    from pychemkin_tpu_torch.kernels import build
    out, name = {}, None
    for line in build.BUILD_INFO.get("log", "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([A-Za-z0-9_]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        elif name and "spill" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                out[name].update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        elif name and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


#: the path each kernel's launches are read from: K1 and K5 run on the
#: sweeps through K5, K2-K4 on the host-driven loops
_HOME = {"rhs": ("CONP", "k5"), "rhs_conv": ("CONV", "k5"),
         "sdirk_round": ("CONP", "k5"), "sdirk_round_conv": ("CONV", "k5"),
         "rhs_jac": ("CONP", "host_loop"),
         "rhs_jac_conv": ("CONV", "host_loop"),
         "bordered_factor": ("CONP", "host_loop"),
         "bordered_solve": ("CONP", "host_loop"),
         "equil_solve": ("PSR", "map"), "psr_solve": ("PSR", "map")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--t-end", type=float, default=0.05)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pychemkin_tpu_torch.kernels import build
    from pychemkin_tpu_torch.mechanism import TorchMechanism, load_embedded

    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({build.BUILD_INFO.get('path')})", flush=True)
    ptxas = _build_report()
    for fn, info in ptxas.items():
        print(f"  ptxas {fn}: {info}", flush=True)
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if "error" in line or "warning" in line:
            print("  " + line.strip(), flush=True)
    build.library()

    torch.backends.cuda.matmul.allow_tf32 = False
    tm = TorchMechanism(load_embedded("grisyn"), "cuda")
    tm_h = TorchMechanism(load_embedded("h2o2"), "cuda")
    rows = check_kernels(tm, args.batch, args.reps)
    with torch.inference_mode():
        steady = dict(equilibrium=check_equilibrium(tm, tm_h, args.batch,
                                                    max(args.reps // 4, 2)),
                      psr=check_psr(tm, tm_h))
    for problem, P0 in SWEEPS:
        row = check_k5(tm, problem, P0, args.t_end, max(args.reps // 4, 2))
        row["ptxas"] = next((v for k, v in ptxas.items()
                             if "sdirk_round_kernel" in k
                             and f"ILi{0 if problem == 'CONP' else 1}E" in k),
                            None)
        rows.append(row)
    launches, summaries = {}, []
    for problem, P0 in SWEEPS:
        launches[problem], summary = sweep_phase(tm, problem, P0, args.batch,
                                                 args.t_end)
        summaries.append(summary)
    prof = profile_window(tm, args.batch)
    print(json.dumps({"profile": prof if prof is not None else
                      "not measured: no device time in the trace"}),
          flush=True)
    with torch.inference_mode():
        map_launches, map_summary, map_rows = psr_map_phase(
            tm_h, max(args.reps // 4, 2))
    launches["PSR"] = {"map": map_launches}
    for row in map_rows:
        row["ptxas"] = next((v for k, v in ptxas.items()
                             if {"equil_solve": "equil_kernel",
                                 "psr_solve": "psr_kernel"}[row["name"]] in k),
                            None)
    rows.extend(map_rows)
    for row in rows:
        problem, path = _HOME[row["name"]]
        row["launches"] = launches[problem][path][row["name"]]
        row["launches_by_path"] = {f"{p}_{q}": launches[p][q][row["name"]]
                                   for p in launches for q in launches[p]}
        assert row["launches"] > 0, f"{row['name']} not launched on its path"
    smi = _nvidia_smi()
    print(json.dumps({"sweeps": summaries, "psr_map": map_summary,
                      "steady_checks": steady, "card": smi}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
