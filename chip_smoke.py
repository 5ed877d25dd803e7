#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pychemkin_tpu_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (exit code != 0):

1. build the CUDA kernels from ``pychemkin_tpu_torch/kernels/csrc`` (one
   nvcc per source, in parallel) and print the build time and each
   instantiation's registers and spills;
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
   twins within 1e-6 relative (on the CPU, in parallel processes after
   the timed phases: ``run_twin_jobs``);
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

6. TGIV reactors, PLOG rows, fractional orders, pivoting and the rescue
   ladder:
6a. the new instantiations against their twins on the card: K1/K2 for
   CONP/TGIV and CONV/TGIV on grisyn; K1/K2 with the PLOG and
   fractional-order lane body (XK) on ch4global (CONP) and on h2o2_plog
   (h2o2 with its falloff row as a 4-level PLOG table; CONP, and CONV,
   where the PLOG rows read P = sum(C) R T); K5 (K5_ATTEMPTS attempts at
   K5_BATCH lanes) for CONP/TGIV and CONV/TGIV in Species_peak mode, on
   ch4global (CONP) and h2o2_plog (CONP, CONV), pivoted (the twin's counts
   on every lane) and with injected faults, pivot-free and pivoted;
6b. through K1 and K5 and through the host loop, each with an 8-lane
   rerun through the twins: grisyn CONP/TGIV (1 atm) and CONV/TGIV
   (10 atm), Species_peak of OH; ch4global CONP/ENRG (stoichiometric
   CH4/air, 1 atm, T0 1100-1700 K, t_end 1 ms); h2o2_plog CONP/ENRG and
   CONV/ENRG at 1-10 atm; ``solve_psr`` on ch4global (K5_BATCH lanes)
   through K7's XK body against its twin; the grisyn CONP/ENRG sweep under
   ``linalg.forced_pivoted()`` against phase 3;
6c. ``resilient_ignition_sweep`` on phase 3's inputs with faults on 64
   lanes (16 Newton stalls healing at rung 1, 16 NaN RHS healing at rung
   2, 16 stalls healing at rung 4, the pivoted rung, 16 NaN RHS that never
   heal): the healthy lanes bit-identical to phase 3, the rungs'
   (n_tried, n_fixed) (64, 16), (48, 16), (32, 0), (32, 16), 16 lanes
   abandoned NONFINITE.

7. The serving layer and the scheduler (``pychemkin_tpu_torch.serve``,
   ``.schedule``) and kernel K8 (the Gershgorin stiffness rate):
7a. K8 against its twin for its eight instantiations (grisyn for the four
   reactors, h2o2_plog for the four with the XK body, and ch4global) on
   phase 2's random states with a NaN lane and on the sweeps' initial
   states, within 1e-12 of each lane's rate; then ``stiffness_costs``
   once per instantiation;
7b. grisyn served by ``ChemServer(max_batch_size=128, max_delay_ms=2,
   schedule="adaptive")``: 512 ignition requests in four bursts of 128
   with 128 equilibrium requests interleaved, then 128 again with the
   solve profile on: every request OK, no first dispatch after warmup,
   sampled lanes bitwise equal to ``solve_direct``, the profiled primal
   values bitwise equal to the unprofiled ones and their stiffness within
   1e-12 of K8's twin at the final states; requests/s, p50/p99 latency,
   occupancy, and the share of dispatched lanes that are padding;
7c. 256 lanes of the h2o2 PSR map served as ``psr`` requests, the
   hot-path lanes bitwise equal to ``solve_psr``;
7d. a Newton-stall fault on one request of a bucket-8 batch, healed by
   the rescue thread, its companions bitwise equal to the clean batch;
7e. phase 3's sweep through ``compacted_ignition_sweep`` in the order of
   ``plan_cohorts(stiffness_costs(...))``, in rounds of 512 attempts and
   again in rounds of 64 (which must compact: survivors gathered into
   narrower rungs), each bitwise equal to phase 3 in caller order;
7f. a ``linalg_unstable`` fault healing at rung 1 on one request of a
   bucket-8 batch of grisyn equilibrium requests and of h2o2 PSR
   requests: K6 and K7 FAULT on the hot path, the lane healed at rung 1,
   its 7 companions bitwise equal to the clean batch; the FAULT
   instantiations against their twins.

8. ``solve_batch`` (profiles, heat loss, the output grid) on grisyn,
   B lanes, n_out = 101, rtol 1e-6, atol 1e-12, through K1 and K5's PRF
   instantiations: 8a a rapid compression machine (CONV/ENRG, V(t)
   1 -> 0.1 cm^3 over 20 ms, wall loss htc 5e5 erg/(cm^2 K s), area
   1 cm^2, tamb 300 K); 8b CONP/ENRG with P(t) 1 -> 2 atm over t_end and a
   constant heat-loss rate; 8c CONP/TGIV with T(t) 900 -> 1400 K over
   10 ms, Species_peak of OH. Each against the host loop over K1-K4 PRF
   and 8 lanes through the twins (T, P and V at every output time within
   1e-6; on the CPU with the other reruns), with K1, K2 and K5 PRF held
   against their twins on the card;
   the constant-profile ``solve_batch(n_out=2)`` bitwise equal to phase
   3's sweep.

9. the 8-copy synthetic grisyn (424 species, 2600 reactions,
   tests/torch_port_cases.py), too large for shared memory: the size
   chooser's storage of each kernel; K1, K2, K8 against their twins on
   64 states, K5 over one 20-attempt round on 64 lanes, K7 on 16 lanes
   from K6's guess (its twin on the CPU with the deferred reruns), and a
   128-lane CONP/ENRG sweep with every lane OK, all
   through the GM instantiations (each lane in a device-memory workspace).

10. the premixed flame through the object model (kernels K9-K12):
   10a K9 (transport) against its twin on 4096 seeded states of h2o2 and
   ch4global, its home run ``Mixture``'s transport getters then those
   states; K10 (the flame residual) and K11 (its Jacobian blocks) against
   their twins at the initial, a mid-solve and the converged state of
   10b's and 10c's own solves for MIX, LEWIS, TDIF, central differencing,
   the TGIV burner and each state's own configuration, and K12 (the
   block-Thomas solve) on each state's Newton system, its yardstick one
   dense ``torch.linalg.solve``; 10b ``Chemistry``, ``Stream`` and
   ``FreelyPropagating`` on h2o2 stoichiometric H2/air at 1 atm, 298 K,
   0-2 cm, the model's default grid controls: it must converge with Su and
   T_max within 0.5 % of the JAX package's recorded values and Su within
   15 % of 210 cm/s; the twins on the CPU check the card's Newton
   direction at the initial and mid-solve states and the Newton criterion
   at the converged one (deferred reruns); 10c ch4global: the free flame
   gives the JAX package's outcome (no convergence) and the
   burner-stabilized flame at a given temperature converges, its exit CO2
   within 1 % of the JAX package's; 10d the burner TGIV flame of
   tests/test_flame1d.py:266 and 10b's flame continued at 2 atm (Su within
   1 % of the JAX package's).

Every row of the kernel table reads its launches from the main-path run
of its instantiation (``home``), and every kernel that a main-path run
launched has a row. The last lines are the kernel table as one JSON
object, the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": ...}``.

Run from the repository root: ``python3 chip_smoke.py`` (``--batch`` and
``--t-end`` shrink phases 2-4 and 8 for a quick check; ``--phases 7`` runs
the build, phase 3's CONP sweep and phase 7 only; ``--phases 7f``,
``8`` (with phase 3's CONP sweep), ``9`` and ``10`` that phase only).
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
    Troe with two or three Fcent terms, SRI); a PLOG row pays for the
    terms of its two bracketing levels, ln P and the interpolation; a
    fractional-order entry for its floored ln C; the derivatives of K2
    reuse the exps of the rates; at constant volume C does not depend on
    T, so there is no D C; the CONV codes rebuild P for PLOG rows (one
    sum, and dwdot/dP into every column of dwdot/dC); the TGIV codes have
    no energy row."""
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
    n_pl, Tm = tm.n_plog, tm.plog_Tm
    n_frac = int(tm.of_frac.sum() + tm.or_frac.sum())
    conp = problem in ("CONP", "CONP_TGIV")
    tgiv = problem.endswith("TGIV")
    p_from_c = n_pl > 0 and not conp
    ops = (t                                     # ln T
           + KK * (t + 34)                       # C, ln C, NASA-7 cp h s g
           + II * (t + 6)                        # Arrhenius: one exp
           + n_tb * 2 * KK                       # [M]
           + n_fo * (t + 10)                     # k0, Pr, blend
           + n_troe * (4 * t + 20) + n_troe_t2 * t   # log Pr, Fcent, F
           + n_sri * (6 * t + 20)                # log Pr, X, F
           + n_pl * (2 * Tm * (t + 6) + 4 * t + 20)  # PLOG rows
           + (2 * KK if p_from_c else 0)         # P = sum(C) R T
           + 2 * tm.kc_sp.numel() + n_rev * (t + 8)  # ln Kc, kr
           + 2 * nnz_ord + II * (t + 4) + n_rev * t  # products, q
           + n_frac * (t + 2)                    # floored ln C
           + 2 * n_nus + (3 if tgiv else 8) * KK)    # wdot, dT/dt
    if jac:
        ops += (II * 6 + n_fo * 60 + n_rev * 12  # dk/dT, dk/d[M]
                + n_pl * (2 * Tm * 12 + 30)      # PLOG dk/dT, dk/dP
                + 2 * tm.kc_sp.numel()           # sum nu h for d ln Kc/dT
                + II * 8 + n_tb * 8              # dq/dT, gated q, G
                + 2 * n_nus                      # dwdot/dT = nu^T dq/dT
                + 4 * tm.jac_rxn.numel() + 2 * KK * KK   # dwdot/dC
                + 4 * tm.tbs_row.numel() * KK    # third-body correction
                + ((2 * n_nus + 2 * KK * KK) if p_from_c else 0)  # dP/dC
                + (2 if conp else 0) * KK * KK   # D C
                + (0 if tgiv else 2 * KK * KK + 16 * KK)  # h D, sums
                + (4 * KK * KK if tgiv else 8 * N * N))   # chain rule to J
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


def _row(name, source, replaces, home=None, mech="grisyn", **kw):
    """A row of the kernels line: ``name`` is the instantiation's
    ``kernels.LAUNCHES`` entry, ``home`` the label of the main-path run
    whose launch counts it reads (``main`` fills ``launches``), ``mech``
    the mechanism of its check."""
    return dict(name=name, route="cuda",
                source="pychemkin_tpu_torch/kernels/csrc/" + source,
                replaces="pychemkin_tpu/" + replaces, mech=mech, home=home,
                **kw)


#: the reference's RHS (K1) and fused (f, J) (K2) of each reactor code
K1_REPLACES = {"CONP": "ops/reactors.py:100", "CONV": "ops/reactors.py:132",
               "CONP_TGIV": "ops/reactors.py:118",
               "CONV_TGIV": "ops/reactors.py:151"}
K2_REPLACES = {"CONP": "ops/jacobian.py:710",
               "CONV": "ops/jacobian.py:558 (CONV branch, via :710)",
               "CONP_TGIV": "ops/jacobian.py:585 (TGIV branch of :558, "
                            "via :710)",
               "CONV_TGIV": "ops/jacobian.py:621 (TGIV branch of :558, "
                            "via :710)"}


def _rhs_rows(tm, B, reps, problems, mech="grisyn", home=None,
              replaces_note="", f_tol=1e-12):
    """K1 and K2 of each code of ``problems`` on B random states of
    ``tm`` against their plain twins (CONV codes at the density of each
    lane's own (T, P, Y)): f within ``f_tol`` and J within 1e-11
    scale-relative, T nondimensionalised. Returns the rows; ``home`` maps
    a code to the (K1 run, K2 run) labels its launches are read from."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import reactors, thermo
    KK, N = tm.KK, tm.N
    rows = []
    mech_b = _mech_bytes(tm)
    y, P = _states(tm, B, 0, realistic=False)
    T = y[:, KK]
    for problem in problems:
        c = P if problem.startswith("CONP") else thermo.density(
            tm, T, P, y[:, :KK])
        rhs_t, jac_t = reactors.RHS_TWINS[problem]
        tag = f"{mech} {problem}"
        xk = kernels.extended(tm)
        name = kernels.launch_name("rhs", problem, xk=xk)
        f_k = _launched(name, lambda: kernels.rhs(tm, y, c, problem=problem))
        f_t = rhs_t(tm, y, c)
        torch.cuda.synchronize()
        e1 = _rate_rel(f_k, f_t, T, KK)
        assert torch.isfinite(f_k).all(), f"K1 {tag}: non-finite values"
        assert e1 <= f_tol, f"K1 {tag} vs twin: {e1:.3e} > {f_tol}"
        ms = _time_ms(lambda: kernels.rhs(tm, y, c, problem=problem), reps)
        pms = _time_ms(lambda: rhs_t(tm, y, c), max(reps // 10, 2))
        nbytes = B * (2 * N + 1) * 8 + mech_b
        bms, by = _bound_ms(nbytes, B * _rate_flops(tm, False, problem))
        h1, h2 = (home or {}).get(problem, (None, None))
        rows.append(_row(name, "rhs.cu", K1_REPLACES[problem] + replaces_note,
                         mech=mech, batch=B, home=h1,
                         max_abs_err=float((f_k - f_t).abs().max()),
                         scale_rel_err=e1, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None))

        name = kernels.launch_name("rhs_jac", problem, xk=xk)
        f_k, J_k = _launched(name, lambda: kernels.rhs_jac(tm, y, c,
                                                           problem=problem))
        f_t, J_t = jac_t(tm, y, c)
        torch.cuda.synchronize()
        e2f = _rate_rel(f_k, f_t, T, KK)
        e2 = _rate_rel(J_k, J_t, T, KK)
        assert torch.isfinite(J_k).all(), f"K2 {tag} produced non-finite values"
        assert e2f <= f_tol, f"K2 {tag} f vs twin: {e2f:.3e} > {f_tol}"
        assert e2 <= 1e-11, \
            f"K2 {tag} J vs twin: scale-relative {e2:.3e} > 1e-11"
        ms = _time_ms(lambda: kernels.rhs_jac(tm, y, c, problem=problem),
                      reps)
        pms = _time_ms(lambda: jac_t(tm, y, c), max(reps // 10, 2))
        nbytes = B * (N + 1 + N + N * N) * 8 + mech_b
        bms, by = _bound_ms(nbytes, B * _rate_flops(tm, True, problem))
        rows.append(_row(name, "rhs_jac.cu", K2_REPLACES[problem]
                         + replaces_note, mech=mech, batch=B, home=h2,
                         max_abs_err=float((J_k - J_t).abs().max()),
                         scale_rel_err=e2, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None))
    for row in rows:
        _print_row(row)
    return rows


def check_kernels(tm, B, reps):
    """Phase 2, K1-K4: every kernel against its plain twin at B lanes."""
    rows = _rhs_rows(tm, B, reps, ("CONP", "CONV"), home={
        "CONP": ("conp_k5", "conp_host_loop"),
        "CONV": ("conv_k5", "conv_host_loop")})
    rows.extend(_k34_rows(tm, B, reps, "conp_host_loop"))
    return rows


def _k34_rows(tm, B, reps, home, mech="grisyn"):
    """K3 and K4 against their twins on B realistic states of ``tm``, h
    log-uniform over 1e-9..1e-4 s, in the instantiations the mechanism's
    size picks (GM past shared memory): rows whose launches ``home`` reads."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import jacobian, linalg
    N = tm.N
    n = N - 1
    gm3 = 8 * kernels.lane_doubles("bordered_factor", n, 0, 0, 0) > \
        kernels.smem_limit("cuda")
    name3 = kernels.launch_name("bordered_factor", gm=gm3)
    name4 = kernels.launch_name("bordered_solve",
                                gm=n > 32 * kernels.SOLVE_MAXR)
    rows = []
    y, P = _states(tm, B, 1, realistic=True)
    _, J = jacobian.conp_enrg_rhs_jac(tm, y, P)
    g = torch.Generator(device="cpu").manual_seed(2)
    h = 10 ** (torch.rand(B, generator=g, dtype=torch.float64) * 5 - 9)
    hg = (h * 0.435866521508458999416019).to(tm.device)
    r = torch.randn(B, N, generator=g, dtype=torch.float64).to(tm.device)
    fac_k = _launched(name3, lambda: kernels.bordered_factor(J, hg))
    fac_t = linalg.factor_bordered(J, hg)
    torch.cuda.synchronize()
    e3 = max(float(((a - b).abs().flatten(1).amax(1)
                    / b.abs().flatten(1).amax(1).clamp_min(1e-300)).max())
             if a.dim() > 1 else
             float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())
             for a, b in zip(fac_k, fac_t))
    x_k = _launched(name4, lambda: kernels.bordered_solve(fac_k, r))
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
    ms = _time_ms(lambda: kernels.bordered_factor(J, hg), reps)
    pms = _time_ms(lambda: linalg.factor_bordered(J, hg), 2)
    lms = _time_ms(lambda: torch.linalg.lu_factor_ex(M), reps)
    nbytes = B * (N * N + 1 + n * n + 2 * n + 1) * 8
    flops = B * (2.0 * N * N + 2.0 * n ** 3 / 3 + 2.0 * n * n + 2 * n)
    bms, by = _bound_ms(nbytes, flops)
    rows.append(_row(name3, "bordered_factor.cu",
                     "ops/linalg.py:249", home=home, mech=mech, batch=B,
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
    rows.append(_row(name4, "bordered_solve.cu",
                     "ops/linalg.py:285", home=home, mech=mech, batch=B,
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


def _sweep_start(tm, problem, P0, B, t_end, mode, T0=(1000.0, 1400.0),
                 Y0=None, kw=None, fault=(None, None)):
    """(lanes, events, start state) of a sweep over B lanes: T0 evenly
    over the range ``T0`` at P0, composition ``Y0`` (default
    stoichiometric H2/air), ignition mode ``mode`` with the reference's
    ignition kwargs ``kw``, and optional per-lane faults."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch.ops import odeint, reactors
    f64 = dict(dtype=torch.float64, device=tm.device)
    T0 = torch.tensor(np.linspace(T0[0], T0[1], B), **f64)
    Y0 = torch.tensor(np.tile(_stoich_Y(tm) if Y0 is None else Y0, (B, 1)),
                      **f64)
    lanes, y0 = reactors.sweep_lane_args(
        tm, T0, torch.full((B,), P0, **f64), Y0,
        torch.full((B,), t_end, **f64), atol=1e-12, ignition_mode=mode,
        problem=problem, ignition_kwargs=kw, fault=fault)
    events = reactors.ignition_events(
        mode, reactors.ignition_kwargs_of(kw)["species_index"])
    with torch.inference_mode():
        s0 = odeint.sweep_start(reactors.kernel_ops(problem), tm, lanes, y0,
                                1e-6, events)
    return lanes, events, s0


def _clone(s):
    return type(s)(*[x.clone() for x in s])


def _k5_vs_twin(tm, problem, lanes, events, s0, mode, pivot=False,
                species=0, share=0.99, prf=False, gm=False):
    """One round of K5_ATTEMPTS attempts from ``s0`` through
    ``kernels.sdirk_round`` and through the masked loop over the plain
    twins (``odeint.sweep_round``). Checks: every carried field finite
    where the twin's is; equal status codes on every lane; the twin's
    attempt and Newton counts on at least ``share`` of the lanes, and on
    them t, y, h and the event accumulators within 1e-8 relative (an
    event time not yet found must be unfound in both); attempt and Newton
    totals within 1 %. ``prf``: the lanes carry profiles; ``gm``: the
    mechanism runs K5's GM instantiation. Returns (kernel state, twin
    state, twin ms, statistics)."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import odeint, reactors
    B, R = s0.t.shape[0], K5_ATTEMPTS
    fault = lanes.fault is not None
    tag = (f"K5 {tm.KK} species {problem} {reactors.IGNITION_MODES[mode]}"
           f"{' pivoted' if pivot else ''}{' with faults' if fault else ''}")
    name = kernels.launch_name("sdirk_round", problem, pivot, fault,
                               kernels.extended(tm), prf=prf, gm=gm)
    with torch.inference_mode():
        sk = _launched(name, lambda: kernels.sdirk_round(
            tm, lanes, _clone(s0), rtol=1e-6, budget=20_000,
            max_attempts=R, event_mode=mode, problem=problem,
            species_index=species, pivot=pivot))
        t1 = time.perf_counter()
        st = odeint.sweep_round(reactors.plain_ops(problem, pivot), tm, lanes,
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
    assert n_same >= share * B, \
        f"{tag}: only {n_same}/{B} lanes with the twin's counts"

    def rel(a, b):
        a, b = a.reshape(B, -1)[same], b.reshape(B, -1)[same]
        found = b.isfinite()
        assert torch.equal(a.isfinite(), found), f"{tag}: finite pattern"
        d = (a - b).abs() / b.abs().clamp_min(1e-300)
        return float(d[found].max()) if bool(found.any()) else 0.0
    y_scale = st.y.abs().amax(1)
    ok_y = same & torch.isfinite(st.y).all(1)
    err = dict(t=rel(sk.t, st.t), h=rel(sk.h, st.h),
               y=float(((sk.y - st.y).abs().amax(1) / y_scale)[ok_y].max())
               if bool(ok_y.any()) else 0.0,
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


def _k5_ms(tm, lanes, s0, reps, **kw):
    """K5's mean time per launch of K5_ATTEMPTS attempts (CUDA events),
    each launch from its own copy of the start state ``s0``; ``kw`` are
    ``kernels.sdirk_round``'s event, problem and pivot arguments."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels
    kw = dict(rtol=1e-6, budget=20_000, max_attempts=K5_ATTEMPTS, **kw)
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
    return float(np.mean([e0.elapsed_time(e1) for e0, e1 in ev]))


def check_k5(tm, problem, P0, t_end, reps):
    """Phase 2, K5: one round of K5_ATTEMPTS step attempts at K5_BATCH
    lanes through ``kernels.sdirk_round`` and through the masked loop over
    the plain twins: T_inflection (event_mode 0) from a sweep's start
    state, with K5's time per launch, and T_rise (event_mode 1, threshold
    T0 + 400 K) from each lane's last state before its crossing, so that
    the crossing branch runs on every lane."""
    from pychemkin_tpu_torch.ops import reactors
    B, R = K5_BATCH, K5_ATTEMPTS
    lanes, events, s0 = _sweep_start(tm, problem, P0, B, t_end,
                                     reactors.IGN_T_INFLECTION)
    row = _k5_row(tm, problem, lanes, events, s0, 0, reps, mech="grisyn",
                  home=f"{problem.lower()}_k5",
                  replaces="ops/odeint.py:451 (_segment_fns; :322, :355, "
                           ":377, :787)")
    lanes_r, events_r, s0_r = _sweep_start(tm, problem, P0, B, t_end,
                                           reactors.IGN_T_RISE)
    pre = _before_crossing(tm, problem, lanes_r, s0_r, R // 2)
    sk_r, st_r, _, stats_r = _k5_vs_twin(tm, problem, lanes_r, events_r, pre,
                                         1)
    assert stats_r["events_found"] == B, \
        f"K5 {problem} T_rise: crossing found on {stats_r['events_found']}" \
        f"/{B} lanes of the twin"
    row["t_rise"] = dict(stats_r, max_abs_err_acc_t=float(
        (sk_r.acc_t - st_r.acc_t).abs().max()))
    return row


# -- the plain-twin reruns, deferred and run in parallel processes ---------

#: (job, check(result, seconds)) of every twin rerun of the sweeps and of
#: phase 9's PSR solve; they run after the timed phases
#: (``run_twin_jobs``), each in its own process on the CPU: the twins are
#: many tiny operations, which the CPU runs twice as fast as the card
#: launches them, and processes on the CPU run side by side where
#: processes on one card take turns (on the card, in parallel processes,
#: they took 357 s and the script 1175 s of its 1200)
_TWIN_JOBS = []
TWIN_WORKERS = 8


def _mech_spec(tm):
    """What a worker process needs to rebuild ``tm`` on the card: its
    record (numpy arrays)."""
    return tm.record


def _defer_twin(job, check):
    _TWIN_JOBS.append((job, check))


def _twin_worker(job):
    """One deferred twin rerun, in a worker process on the CPU: ("sweep",
    record, problem, energy, T0s, P0s, Y0, t_end, kw) through
    ``reactors._sweep(plain_ops)`` -> (times, status); ("batch", record,
    problem, energy, T0s, P0s, Y0, t_ends, kw) through
    ``reactors._solve_batch(plain_ops)`` -> T, P, volume and status at the
    output times; ("psr", record, mode, energy, args, y0, None, None, None)
    through ``psr.solve_psr_plain`` -> the PSRSolution's fields. Returns
    (result as numpy, seconds)."""
    import torch
    from pychemkin_tpu_torch.mechanism import TorchMechanism
    from pychemkin_tpu_torch.ops import psr, reactors
    torch.set_num_threads(1)
    kind, record, problem, energy, T0s, P0s, Y0, t_end, kw = job
    t0 = time.perf_counter()
    if kind == "flame":
        with torch.inference_mode():
            out = _flame_twin_job(record, T0s)
        return out, time.perf_counter() - t0
    tm = TorchMechanism(record, "cpu")
    with torch.inference_mode():
        if kind == "psr":
            args = psr.PSRArgs(*(torch.as_tensor(a) for a in T0s))
            sol = psr.solve_psr_plain(tm, problem, energy, args,
                                      torch.as_tensor(P0s), psr.PSRControls())
            out = {f: getattr(sol, f).numpy() for f in sol._fields}
        elif kind == "sweep":
            code = reactors.variant(problem, energy)
            times, _, status = reactors._sweep(
                reactors.plain_ops(code), tm, problem, energy, T0s, P0s, Y0,
                t_end, **kw, device="cpu", profile=False)
            out = (times.numpy(), status.numpy())
        else:
            code = reactors.variant(problem, energy)
            full = dict(constraint_profile=None, t_profile=None,
                        qloss_profile=None, area_profile=None, volume=1.0,
                        htc=0.0, tamb=298.15, area=0.0, t_start=0.0,
                        max_steps_per_segment=20_000, h0=0.0,
                        jac_mode="analytic", profile=False)
            full.update(_profiles_on(kw, "cpu"), device="cpu")
            sol = reactors._solve_batch(reactors.plain_ops(code), tm, problem,
                                        energy, T0s, P0s, Y0, t_end, **full)
            out = {f: getattr(sol, f).numpy()
                   for f in ("T", "P", "volume", "status")}
            if full["profile"]:
                out["stiffness"] = sol.profile["stiffness"].numpy()
    return out, time.perf_counter() - t0


def _batch_twin_check(tag, pick, mine):
    """The check of a deferred phase 8 twin rerun: the same status, T, P
    and V at every output time within 1e-6 relative, and the stiffness
    rate at t_final (K8 PRF against the twin's, at final states that
    differ by the trajectories' roundoff) within STIFF_TOL relative."""
    import numpy as np

    def check(res, seconds):
        err = {f: float(np.max(np.abs(mine[f] - res[f])
                               / np.maximum(np.abs(res[f]), 1e-300)))
               for f in ("T", "P", "volume", "stiffness")}
        e_stiff = err.pop("stiffness")
        print(f"{tag}: plain-twin rerun of lanes {pick.tolist()} "
              f"({seconds:.1f} s): T, P, V at every output time within "
              f"{err}", flush=True)
        print(f"  stiffness at t_final within {e_stiff:.3e}", flush=True)
        assert np.array_equal(res["status"], mine["status"]), \
            f"{tag}: twin status"
        assert max(err.values()) <= 1e-6, f"{tag}: vs twins {err}"
        assert e_stiff <= STIFF_TOL, f"{tag}: stiffness vs twins {e_stiff}"
        _TWIN_RESULTS[tag] = err | {"stiffness": e_stiff}
    return check


#: the deferred phase 8 twin comparisons, by tag
_TWIN_RESULTS = {}
#: the stiffness rate at t_final against the twins' (the CPU tests'
#: tolerance for the profiled sweep's, tests/test_torch_stiffness.py)
STIFF_TOL = 1e-4


def run_twin_jobs():
    """Run the deferred twin reruns in up to TWIN_WORKERS processes on the
    CPU (spawned; each rebuilds its mechanism from the record), the longest
    first, and apply each one's check. Returns the wall seconds."""
    import multiprocessing as mp
    if not _TWIN_JOBS:
        return 0.0
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    # the longest reruns start first: the PSR (phase 9's K7 GM, ~80 s) and
    # the output-grid ones (phase 8, 20-85 s); a sweep's takes 15-30 s
    first = {"psr": 0, "batch": 1}
    jobs = sorted(_TWIN_JOBS, key=lambda jc: first.get(jc[0][0], 2))
    with ctx.Pool(min(TWIN_WORKERS, len(jobs))) as pool:
        results = pool.map(_twin_worker, [j for j, _ in jobs], chunksize=1)
    for (_, check), (res, seconds) in zip(jobs, results):
        check(res, seconds)
    _TWIN_JOBS.clear()
    return time.perf_counter() - t0


def sweep_phase(tm, problem, P0, B, t_end, *, energy="ENRG", label=None,
                mode="T_inflection", kw=None, T0=(1000.0, 1400.0), Y0=None,
                mech="grisyn", host_loop=True, require_ignition=True):
    """Phase 3 (grisyn CONP/ENRG, the main path), 3b (CONV/ENRG) and the
    sweeps of phase 6b: ``ignition_delay_sweep`` of ``(problem, energy)``
    on ``tm`` over B lanes (T0 evenly over the range ``T0``, P0 a scalar or
    [B], composition ``Y0``, default stoichiometric H2/air) through K1 and
    K5, then (``host_loop``) through the host-driven loop over K1-K4, each
    with the launch counters set to 0 just before it and read just after;
    then 8 lanes through the plain twins (deferred to ``run_twin_jobs``,
    on the CPU). Every lane must be OK
    with a finite time (``require_ignition``), the host loop must give the
    same status, times within 1e-6 and totals within 1 %, and the twins
    times within 1e-6. Returns ({run label: launches}, summary, the K5
    run's times and status)."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import reactors
    from pychemkin_tpu_torch.resilience.status import (SolveStatus,
                                                       status_counts)
    code = reactors.variant(problem, energy)
    label = label or code.lower()
    T0 = np.linspace(T0[0], T0[1], B)
    Y0 = _stoich_Y(tm) if Y0 is None else Y0
    P0s = np.array(np.broadcast_to(np.asarray(P0, dtype=np.float64), (B,)))
    args = (tm, problem, energy, T0, P0s, Y0, t_end)
    kw = dict(rtol=1e-6, atol=1e-12, ignition_mode=mode,
              ignition_kwargs=kw, max_steps_per_segment=20_000,
              device="cuda")
    name = {k: kernels.launch_name(k, code, xk=kernels.extended(tm))
            for k in ("rhs", "rhs_jac", "sdirk_round")}
    runs = {}
    paths = [("k5", None)] + ([("host_loop", reactors.kernel_ops(code))]
                              if host_loop else [])
    tag = f"sweep {mech} {problem}/{energy} {mode}"
    for path, ops in paths:
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
        print(f"{tag} P0={P0s.min():.6g}-{P0s.max():.6g} B={B} "
              f"t_end={t_end} via {path}: wall {wall:.3f} s, "
              f"{B / wall:.2f} ignitions/s, attempts {runs[path]['attempts']} "
              f"(max per lane {runs[path]['max_attempts']}), Newton "
              f"iterations {runs[path]['newton']}, status "
              f"{status_counts(runs[path]['status'])}, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    k5 = runs["k5"]
    lk = k5["launches"]
    # the sweep's attempts ran only inside K5, one launch per round
    assert lk[name["rhs"]] > 0 and lk[name["sdirk_round"]] > 0, lk
    assert lk[name["rhs_jac"]] == lk["bordered_factor"] \
        == lk["bordered_solve"] == 0, lk
    st = k5["status"]
    assert (st == int(SolveStatus.OK)).all(), \
        f"{tag}: status codes {status_counts(st)}"
    assert bool(k5["ok"].all()), f"{tag}: some lanes did not succeed"
    if require_ignition:
        assert np.isfinite(k5["times"]).all(), f"{tag}: non-finite times"
    # a lane steps in ceil(attempts / ROUND_ATTEMPTS) of the K5 launches
    bound, by, per_call = _k5_bound(tm, code, lk[name["sdirk_round"]], B,
                                    k5["lane_rounds"], k5["attempts"],
                                    k5["newton"])
    summary = dict(
        mech=mech, problem=problem, energy=energy, mode=mode,
        P0_min=float(P0s.min()), P0_max=float(P0s.max()),
        T0_min=float(T0[0]), T0_max=float(T0[-1]), B=B, t_end=t_end,
        wall_s=k5["wall_s"], ignitions_per_s=k5["ignitions_per_s"],
        status=status_counts(st), attempts=k5["attempts"],
        max_attempts=k5["max_attempts"], newton=k5["newton"],
        k5_rounds=lk[name["sdirk_round"]], k5_bound_ms=bound,
        k5_bound_by=by, k5_per_call_bound_sum_ms=per_call)
    if host_loop:
        host = runs["host_loop"]
        lh = host["launches"]
        assert lh[name["sdirk_round"]] == 0 and all(
            lh[k] > 0 for k in (name["rhs"], name["rhs_jac"],
                                "bordered_factor", "bordered_solve")), lh
        assert (st == host["status"]).all(), f"{tag}: K5 and host-loop status"
        fin = np.isfinite(host["times"])
        assert np.array_equal(fin, np.isfinite(k5["times"])), \
            f"{tag}: K5 and host-loop finite times"
        rel_host = float(np.max(np.abs(k5["times"][fin] - host["times"][fin])
                                / np.abs(host["times"][fin]), initial=0.0))
        for k in ("attempts", "newton"):
            assert abs(k5[k] - host[k]) <= 0.01 * host[k], \
                f"{tag} {k}: K5 {k5[k]} vs host loop {host[k]}"
        assert rel_host <= 1e-6, f"{tag}: K5 vs host-loop times {rel_host}"
        print(f"  K5 vs host loop: times within {rel_host:.3e} relative, "
              f"attempts {k5['attempts']} vs {host['attempts']}, Newton "
              f"{k5['newton']} vs {host['newton']}; K5 rounds "
              f"{lk[name['sdirk_round']]}; the K5 work's bound {bound:.2f} ms "
              f"by {by} (as separate K1-K4 launches: {per_call:.2f} ms)",
              flush=True)
        summary.update(host_loop_wall_s=host["wall_s"],
                       host_loop_ignitions_per_s=host["ignitions_per_s"],
                       host_loop_attempts=host["attempts"],
                       host_loop_newton=host["newton"],
                       max_rel_vs_host_loop=rel_host)
    times_np = k5["times"]
    print(f"  times [s]: min {np.nanmin(times_np):.6e} max "
          f"{np.nanmax(times_np):.6e}", flush=True)

    pick = np.unique(np.linspace(0, B - 1, min(8, B)).round().astype(int))
    kw_t = {k: v for k, v in kw.items() if k != "device"}

    def check(res, seconds):
        ref, st_r = res
        fin = np.isfinite(ref)
        assert np.array_equal(fin, np.isfinite(times_np[pick])), \
            f"{tag}: kernel vs twin finite times"
        rel = np.abs(times_np[pick][fin] - ref[fin]) / np.abs(ref[fin])
        rel_max = float(rel.max(initial=0.0))
        print(f"{tag}: plain-twin rerun of lanes {pick.tolist()}: max "
              f"relative difference {rel_max:.3e} ({seconds:.1f} s)",
              flush=True)
        assert (st_r == int(SolveStatus.OK)).all()
        assert rel_max <= 1e-6, f"{tag}: kernel vs twin times {rel_max}"
        summary.update(max_rel_vs_plain=rel_max)
    _defer_twin(("sweep", _mech_spec(tm), problem, energy, T0[pick],
                 P0s[pick], Y0, t_end, kw_t), check)
    return ({f"{label}_{p}": r["launches"] for p, r in runs.items()},
            summary, (k5["times"], st))


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
    lanes, RERUNS times, each from the guess moved by 1e-15 in another
    random direction (``_perturbed``): a lane whose twin outcome moves in
    any of them is rounding-chaotic (a pseudo-transient trajectory that
    swings between the T clamps), and any two roundings, the kernel's and
    the twin's among them, may end it apart. (The twin on the card sums
    with atomics, so its own outcome on such a lane can move between two
    runs from the same guess; one rerun alone can miss a chaotic lane.)
    Checks: the same status and counts as the twin on SAME_SHARE of the
    other (stable) lanes (``overall``: of all lanes); on the lanes OK in
    both with equal counts, T and Y within ``tol``. Returns
    statistics."""
    import torch
    B = q.T.shape[0]

    def same(a, b):
        return ((a.status == b.status) & (a.n_newton_direct == b.n_newton_direct)
                & (a.n_newton_polish == b.n_newton_polish))
    agree = same(k, q)
    apart = (~agree).nonzero()[:, 0]
    stable = torch.ones_like(agree)
    if apart.numel():
        q_apart = type(q)(*[x[apart] for x in q])
        for sol in rerun(apart):
            stable[apart] &= same(q_apart, sol)
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


#: twin reruns of ``_compare_psr`` per lane where kernel and twin differ
RERUNS = 3


def _rerun(tm, mode, energy, args, y0, ctl, seed):
    """``rerun(lanes)`` of ``_compare_psr``: the twin on those lanes from
    the guess moved by 1e-15, RERUNS times (seeds ``seed``, ``seed`` + 1,
    ...)."""
    from pychemkin_tpu_torch.ops import psr

    def run(lanes):
        sub = type(args)(*[a[lanes].contiguous() for a in args])
        return [psr.solve_psr_plain(tm, mode, energy, sub,
                                    _perturbed(y0[lanes], seed + r), ctl)
                for r in range(RERUNS)]
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
             "ops/equilibrium.py:150 (_solve; :258 equilibrate)", home="map",
             mech="h2o2",
             max_abs_err=float((g.T - gq.T).abs().max()),
             scale_rel_err=eq_err["T"], ms=eq_ms, plain_ms=eq_pms,
             **dict(zip(("bound_ms", "bound_by"), _bound_ms(eq_b, eq_f))),
             library_ms=None, batch=B, option=5),
        _row("psr_solve", "psr_solve.cu",
             "ops/psr.py:273 (solve_psr; :148, :225)", home="map",
             mech="h2o2",
             max_abs_err=float((sol.T - q.T).abs()[(sol.status == 0)
                                                   & (q.status == 0)].max()),
             scale_rel_err=cmp["err_T"], ms=psr_ms, plain_ms=psr_pms,
             **dict(zip(("bound_ms", "bound_by"), _bound_ms(ps_b, ps_f))),
             library_ms=None, batch=B)]
    for row in rows:
        _print_row(row)
    return launches, summary, rows


# -- phase 6: TGIV, PLOG, fractional orders, pivoting, faults, rescue -------

#: the pressure levels [atm] of the h2o2_plog tables
H2O2_PLOG_LEVELS = (0.1, 1.0, 10.0, 100.0)
#: ch4global sweep: T0 range [K] and t_end [s], from the reference's CPU
#: ignition_delay_sweep on 8 lanes (stoichiometric CH4/air, 1 atm): every
#: lane ignites, at 2.7e-6 s (1700 K) to 1.9e-4 s (1100 K)
CH4_T0, CH4_T_END = (1100.0, 1700.0), 1e-3
#: h2o2_plog sweep: t_end [s], ten times its slowest lane's delay
PLOG_T_END = 5e-3
#: Species_peak species of the TGIV sweeps: OH (index 4 of grisyn)
OH = 4
#: the fault groups of the rescue check: (mode, t_min, heal_at), each on
#: a quarter of the faulted lanes
FAULT_GROUPS = (("newton_stall", 0.0, 1), ("nan_rhs", 1e-5, 2),
                ("newton_stall", 0.0, 4), ("nan_rhs", 0.0, -1))
#: what the ladder must do with them: (n_tried, n_fixed) per rung, for 64
#: faulted lanes
RESCUE_RUNGS = ((64, 16), (48, 16), (32, 0), (32, 16))


def h2o2_plog_text():
    """h2o2.inp with its one pressure-dependent falloff row
    (2OH(+M)<=>H2O2(+M), LOW + TROE) replaced by a PLOG row: at each of
    0.1, 1, 10 and 100 atm, one Arrhenius fit (least squares in ln k over
    ln T and 1/T) of that row's own falloff kf, with [M] = P/(R T), on 64
    temperatures geometric over 300-2500 K. The same text as
    tests/torch_port_cases.py's."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch.constants import R_CAL, R_GAS
    from pychemkin_tpu_torch.mechanism import DATA_DIR, TorchMechanism
    from pychemkin_tpu_torch.mechanism import load_embedded
    from pychemkin_tpu_torch.ops import kinetics

    with open(os.path.join(DATA_DIR, "h2o2.inp")) as fh:
        lines = fh.read().splitlines()
    head = next(i for i, s in enumerate(lines) if "(+M)" in s)
    tm = TorchMechanism(load_embedded("h2o2"), "cpu")
    i = next(i for i, e in enumerate(tm.record.reaction_equations)
             if "(+M)" in e)
    j = int((tm.fo_rows == i).nonzero()[0, 0])
    T = torch.tensor(np.geomspace(300.0, 2500.0, 64))
    lnT = torch.log(T)
    k_inf = kinetics._arrhenius(tm.A[i:i + 1], tm.beta[i:i + 1],
                                tm.Ea_R[i:i + 1], T, lnT)
    k0 = kinetics._arrhenius(tm.fo_lowA[j:j + 1], tm.fo_lowb[j:j + 1],
                             tm.fo_lowE[j:j + 1], T, lnT)
    sl = slice(j, j + 1)
    fits = []
    for p_atm in H2O2_PLOG_LEVELS:
        M = (p_atm * P_ATM / (R_GAS * T))[:, None]
        k = kinetics.falloff_blend(T, lnT, M, k_inf, k0, tm.fo_type[sl],
                                   tm.fo_chem[sl], tm.fo_troe[sl],
                                   tm.fo_sri[sl])[:, 0].numpy()
        X = np.stack([np.ones(T.shape[0]), lnT.numpy(), -1.0 / T.numpy()], 1)
        c, *_ = np.linalg.lstsq(X, np.log(k), rcond=None)
        fits.append((p_atm, np.exp(c[0]), c[1], c[2] * R_CAL))
    p1 = fits[1]
    row = [f"2OH<=>H2O2{'':26s}{p1[1]:.10E} {p1[2]:.10f} {p1[3]:.10f}"]
    row += [f"PLOG/{p:g} {a:.10E} {b:.10f} {e:.10f}/" for p, a, b, e in fits]
    end = head + 1    # skip the row's LOW, TROE and efficiency lines
    while "/" in lines[end] and "=" not in lines[end]:
        end += 1
    return "\n".join(lines[:head] + row + lines[end:]) + "\n"


def _ch4_Y(tm):
    """Stoichiometric CH4/air mass fractions."""
    import numpy as np
    names = [s.upper() for s in tm.record.species_names]
    X = np.zeros(len(names))
    X[names.index("CH4")] = 1.0
    X[names.index("O2")] = 2.0
    X[names.index("N2")] = 2.0 * 3.76
    Y = X * np.asarray(tm.record.wt)
    return Y / Y.sum()


def _fault_lanes(B, n_faulted):
    """Original indices of the faulted lanes, evenly over the batch, and
    the FaultSpecs of FAULT_GROUPS on them (group g on every 4th lane from
    the g-th)."""
    import numpy as np
    from pychemkin_tpu_torch.resilience.faultinject import FaultSpec
    idx = np.unique(np.linspace(0, B - 1, n_faulted).round().astype(int))
    assert idx.size == n_faulted
    return idx, tuple(FaultSpec(mode, tuple(int(e) for e in idx[g::4]),
                                t_min=t_min, heal_at=heal)
                      for g, (mode, t_min, heal) in enumerate(FAULT_GROUPS))


def _k5_row(tm, problem, lanes, events, s0, mode, reps, *, mech, home,
            replaces, pivot=False, species=0, share=0.99):
    """A K5 check of phase 6a: one round of K5_ATTEMPTS attempts at
    K5_BATCH lanes against the twin (``_k5_vs_twin``), K5's time per
    launch and its bound; the row of the instantiation."""
    from pychemkin_tpu_torch import kernels
    fault = lanes.fault is not None
    sk, st, pms, stats = _k5_vs_twin(tm, problem, lanes, events, s0, mode,
                                     pivot=pivot, species=species,
                                     share=share)
    ms = _k5_ms(tm, lanes, s0, reps, event_mode=mode, problem=problem,
                species_index=species, pivot=pivot)
    att, newton = stats["totals"]["attempts"][0], stats["totals"]["newton"][0]
    bms, by, per_call = _k5_bound(tm, problem, 1, K5_BATCH, K5_BATCH, att,
                                  newton)
    fin = st.y.isfinite()
    row = _row(kernels.launch_name("sdirk_round", problem, pivot, fault,
                                   kernels.extended(tm)),
               "sdirk_round.cuh", replaces, home=home, mech=mech,
               max_abs_err=float((sk.y - st.y).abs()[fin].max()),
               scale_rel_err=max(stats["rel_err"].values()), ms=ms,
               plain_ms=pms, bound_ms=bms, bound_by=by,
               per_call_bound_sum_ms=per_call, library_ms=None,
               batch=K5_BATCH, attempts=K5_ATTEMPTS, **stats)
    _print_row(row)
    return row


def _ch4_psr_lanes(tm, B, seed):
    """(args, y0) of B ch4global PSR lanes on the card: CH4/air at phi
    0.6-1.5, inlets at 298-900 K, tau geometric-random over 1e-5-1 s, 1 atm,
    10 g/s; the guess is the inlet's HP equilibrium from the twin."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch.ops import equilibrium, psr, thermo
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=tm.device)
    names = [s.upper() for s in tm.record.species_names]
    X = np.zeros((B, len(names)))
    X[:, names.index("CH4")] = rng.uniform(0.6, 1.5, B)
    X[:, names.index("O2")] = 2.0
    X[:, names.index("N2")] = 2.0 * 3.76
    Y = X * np.asarray(tm.record.wt)
    Y_in = torch.tensor(Y / Y.sum(1, keepdims=True), **f64)
    T_in = torch.tensor(rng.uniform(298.15, 900.0, B), **f64)
    Pv = torch.full((B,), PSR_P, **f64)
    args = psr.PSRArgs(
        P=Pv, Y_in=Y_in, h_in=thermo.mixture_enthalpy_mass(tm, T_in, Y_in),
        tau=torch.tensor(10 ** rng.uniform(-5.0, 0.0, B), **f64),
        volume=torch.zeros(B, **f64), mdot=torch.full((B,), PSR_MDOT, **f64),
        qloss=torch.zeros(B, **f64), T_fixed=torch.zeros(B, **f64))
    g = equilibrium.equilibrate_plain(tm, T_in, Pv, Y_in, 5)
    return args, torch.cat([g.Y, g.T[:, None]], 1).contiguous()


def check_phase6a(tms, B, t_end, reps):
    """Phase 6a: the new instantiations against their twins on the card.
    K1/K2 for CONP/TGIV and CONV/TGIV on grisyn (B lanes); K1/K2 on
    ch4global (CONP) and on h2o2_plog (CONP, and CONV, where the PLOG
    rows read P = sum(C) R T); K5, one round of K5_ATTEMPTS attempts at
    K5_BATCH lanes, for CONP/TGIV (1 atm) and CONV/TGIV (10 atm) in
    Species_peak mode on OH, on ch4global (CONP) and h2o2_plog (CONP,
    CONV; T_inflection), pivoted on grisyn CONP (the twin's counts on every
    lane), and with the faults of FAULT_GROUPS on a quarter of the lanes,
    pivot-free and pivoted. Returns the rows."""
    import torch
    from pychemkin_tpu_torch.ops import reactors
    from pychemkin_tpu_torch.resilience import faultinject
    tm_g, tm_c, tm_p = tms["grisyn"], tms["ch4global"], tms["h2o2_plog"]
    rows = _rhs_rows(tm_g, B, reps, ("CONP_TGIV", "CONV_TGIV"), home={
        "CONP_TGIV": ("conp_tgiv_k5", "conp_tgiv_host_loop"),
        "CONV_TGIV": ("conv_tgiv_k5", "conv_tgiv_host_loop")})
    # ch4global's water-gas shift, reversible and near equilibrium at many
    # random states, leaves wdot a difference of qf and qr ~1e3 times
    # smaller than either: the kernel's fused multiply-adds then move f by
    # up to ~1.1e-12 of the fastest rate at B=4096 (a CPU emulation of the
    # kernel compiled with -mfma -ffp-contract=fast gives the same
    # 1.0858e-12 on the same lane; without contraction it stays within
    # 3.2e-13), so f is held at J's 1e-11 here
    rows += _rhs_rows(tm_c, B, reps, ("CONP",), mech="ch4global",
                      home={"CONP": ("ch4global_k5", "ch4global_host_loop")},
                      replaces_note="; ops/kinetics.py:412 (fractional "
                                    "orders), :530", f_tol=1e-11)
    rows += _rhs_rows(tm_p, B, reps, ("CONP", "CONV"), mech="h2o2_plog",
                      home={"CONP": ("h2o2_plog_k5", "h2o2_plog_host_loop"),
                            "CONV": ("h2o2_plog_conv_k5",
                                     "h2o2_plog_conv_host_loop")},
                      replaces_note="; ops/kinetics.py:244 (_plog_rate), "
                                    "ops/jacobian.py:282-290, :539")
    odeint_ref = "ops/odeint.py:451 (_segment_fns; :322, :355, :377, :787)"
    mode_sp = reactors.IGNITION_MODES.index(reactors.IGN_SPECIES_PEAK)
    for code, P0 in (("CONP_TGIV", P_ATM), ("CONV_TGIV", 10 * P_ATM)):
        lanes, events, s0 = _sweep_start(
            tm_g, code, P0, K5_BATCH, t_end, reactors.IGN_SPECIES_PEAK,
            kw={"species_index": OH})
        rows.append(_k5_row(
            tm_g, code, lanes, events, s0, mode_sp, reps, mech="grisyn",
            home=f"{code.lower()}_k5", species=OH,
            replaces=f"{odeint_ref}; TGIV ops/reactors.py:"
                     f"{118 if code == 'CONP_TGIV' else 151}"))
    for tm, mech, problem, home, kw in (
            (tm_c, "ch4global", "CONP", "ch4global_k5",
             dict(T0=CH4_T0, Y0=_ch4_Y(tm_c))),
            (tm_p, "h2o2_plog", "CONP", "h2o2_plog_k5", {}),
            (tm_p, "h2o2_plog", "CONV", "h2o2_plog_conv_k5", {})):
        t_e = CH4_T_END if mech == "ch4global" else PLOG_T_END
        P0 = P_ATM if mech == "ch4global" else 3 * P_ATM
        lanes, events, s0 = _sweep_start(tm, problem, P0, K5_BATCH, t_e,
                                         reactors.IGN_T_INFLECTION, **kw)
        rows.append(_k5_row(
            tm, problem, lanes, events, s0, 0, reps, mech=mech, home=home,
            replaces=odeint_ref + (
                "; ops/kinetics.py:412" if mech == "ch4global"
                else "; ops/kinetics.py:244")))
    lanes, events, s0 = _sweep_start(tm_g, "CONP", P_ATM, K5_BATCH, t_end,
                                     reactors.IGN_T_INFLECTION)
    rows.append(_k5_row(tm_g, "CONP", lanes, events, s0, 0, reps,
                        mech="grisyn", home="pivoted_k5", pivot=True,
                        share=1.0, replaces=odeint_ref + "; pivoted "
                        "ops/linalg.py:95 (forced_pivoted), :249"))
    idx, specs = _fault_lanes(K5_BATCH, K5_BATCH // 4)
    with faultinject.inject(*specs):
        fault = faultinject.lane_faults(
            torch.arange(K5_BATCH, device=tm_g.device), 0)
    for pivot in (False, True):
        lanes, events, s0 = _sweep_start(tm_g, "CONP", P_ATM, K5_BATCH,
                                         t_end, reactors.IGN_T_INFLECTION,
                                         fault=fault)
        rows.append(_k5_row(tm_g, "CONP", lanes, events, s0, 0, reps,
                            mech="grisyn", home="rescue", pivot=pivot,
                            replaces=odeint_ref + "; fault hooks "
                            "ops/odeint.py:657-660, ops/reactors.py:556-557"))
    return rows


def ch4_psr_phase(tm, B, reps):
    """Phase 6b, the PSR on ch4global: ``solve_psr`` over B lanes of
    ``_ch4_psr_lanes`` (the map's controls) through K7's lane body with
    the fractional orders, the launch counters set to 0 just before and
    read just after; then the same lanes through the twin on the card,
    with phase 2c's status rule. Returns ({label: launches}, the K7 row)."""
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import psr
    from pychemkin_tpu_torch.resilience.status import status_counts
    args, y0 = _ch4_psr_lanes(tm, B, 11)
    ctl = psr.PSRControls()
    tag = "K7 ch4global tau/ENRG"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    k = ptt.solve_psr(tm, "tau", "ENRG", P=args.P, Y_in=args.Y_in,
                      h_in=args.h_in, T_guess=y0[:, -1],
                      Y_guess=y0[:, :-1], tau=args.tau, mdot=args.mdot,
                      device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    name = kernels.launch_name("psr_solve", xk=kernels.extended(tm))
    assert launches[name] > 0, launches
    t1 = time.perf_counter()
    q = psr.solve_psr_plain(tm, "tau", "ENRG", args, y0, ctl)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t1) * 1e3
    st = _compare_psr(tag, k, q, _rerun(tm, "tau", "ENRG", args, y0, ctl, 12),
                      PSR_TOL)
    ms = _time_ms(lambda: kernels.psr_solve(tm, "tau", "ENRG", args, y0,
                                            ctl), max(reps // 4, 1))
    bms, by = _bound_ms(*_psr_work(tm, k))
    pt = int((k.n_newton_polish > 0).sum())
    print(f"{tag}, B={B}: solve_psr wall {wall * 1e3:.2f} ms, {B / wall:.1f} "
          f"PSR solves/s, status {status_counts(k.status)}; K7 {ms:.2f} ms "
          f"per launch (twin {pms:.0f} ms, bound {bms:.4f} ms by {by}); {st}; "
          f"pseudo-transient lanes {pt}", flush=True)
    ok = (k.status == 0) & (q.status == 0)
    row = _row(name, "psr_solve.cu",
               "ops/psr.py:273 (solve_psr; :148, :225); ops/kinetics.py:412",
               home="ch4global_psr", mech="ch4global",
               max_abs_err=float((k.T - q.T).abs()[ok].max())
               if bool(ok.any()) else 0.0,
               scale_rel_err=st["err_T"], ms=ms, plain_ms=pms, bound_ms=bms,
               bound_by=by, library_ms=None, batch=B, pt_lanes=pt,
               wall_s=wall, **st)
    _print_row(row)
    return {"ch4global_psr": launches}, row


def pivot_sweep(tm, B, t_end, base):
    """Phase 6b: the grisyn CONP/ENRG sweep of phase 3 under
    ``linalg.forced_pivoted()`` (the rescue ladder's last rung's factor, at
    full width) through K1 and K5's PIVOT instantiation; against phase 3's
    K5 run ``base`` (times, status): the same status, times within 1e-6
    relative. Returns ({label: launches}, summary)."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import linalg, reactors
    from pychemkin_tpu_torch.resilience.status import status_counts
    T0 = np.linspace(1000.0, 1400.0, B)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with linalg.forced_pivoted():
        times, ok, status, prof = reactors.ignition_delay_sweep(
            tm, "CONP", "ENRG", T0, P_ATM, _stoich_Y(tm), t_end,
            device="cuda", profile=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    assert launches["sdirk_round_pivot"] > 0 \
        and launches["sdirk_round"] == 0, launches
    times, status = times.cpu().numpy(), status.cpu().numpy()
    att = int((prof["n_steps"] + prof["n_rejected"]).sum())
    assert (status == base[1]).all(), "pivoted vs phase 3 status"
    rel = float(np.max(np.abs(times - base[0]) / np.abs(base[0])))
    print(f"sweep grisyn CONP/ENRG pivoted B={B}: wall {wall:.3f} s, "
          f"{B / wall:.2f} ignitions/s, attempts {att}, Newton "
          f"{int(prof['n_newton'].sum())}, status {status_counts(status)}; "
          f"times within {rel:.3e} of phase 3's; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    assert rel <= 1e-6, f"pivoted vs phase 3 times {rel}"
    return {"pivoted_k5": launches}, dict(
        mech="grisyn", problem="CONP", energy="ENRG", pivoted=True, B=B,
        t_end=t_end, wall_s=wall, ignitions_per_s=B / wall, attempts=att,
        newton=int(prof["n_newton"].sum()), status=status_counts(status),
        max_rel_vs_phase3=rel)


def rescue_phase(tm, B, t_end, base):
    """Phase 6c: ``resilient_ignition_sweep`` on phase 3's inputs with the
    faults of FAULT_GROUPS on 64 lanes, the launch counters set to 0 just
    before and read just after. Checks: the healthy lanes' times and
    status bit-identical to phase 3's K5 run ``base``; per rung the
    (n_tried, n_fixed) of RESCUE_RUNGS; the never-healing lanes abandoned
    NONFINITE, every other lane OK. Returns ({label: launches}, summary)."""
    import numpy as np
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.resilience import faultinject
    from pychemkin_tpu_torch.resilience.status import SolveStatus
    n_f = RESCUE_RUNGS[0][0]
    idx, specs = _fault_lanes(B, n_f)
    T0 = np.linspace(1000.0, 1400.0, B)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with faultinject.inject(*specs):
        times, ok, status, rep = ptt.resilient_ignition_sweep(
            tm, "CONP", "ENRG", T0, P_ATM, _stoich_Y(tm), t_end,
            device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    times, status = times.cpu().numpy(), status.cpu().numpy()
    healthy = np.ones(B, dtype=bool)
    healthy[idx] = False
    same = (np.array_equal(times[healthy], base[0][healthy], equal_nan=True)
            and np.array_equal(status[healthy], base[1][healthy]))
    rungs = [(a["n_tried"], a["n_fixed"]) for a in rep.attempts]
    never = np.asarray(specs[3].elements)
    print(f"rescue ladder grisyn CONP/ENRG B={B}, {n_f} faulted lanes: wall "
          f"{wall:.3f} s; report {json.dumps(rep.as_dict())}; rungs "
          f"(n_tried, n_fixed) {rungs}; healthy lanes bit-identical to "
          f"phase 3: {same}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    t_h, b_h = times[healthy], base[0][healthy]
    assert same, (
        f"healthy lanes differ from phase 3: times on {int((t_h != b_h).sum())}"
        f" lanes (max relative {np.nanmax(np.abs(t_h - b_h) / np.abs(b_h)):.3e})"
        f", status on {int((status[healthy] != base[1][healthy]).sum())}")
    assert rungs == [tuple(r) for r in RESCUE_RUNGS], rungs
    assert (status[never] == int(SolveStatus.NONFINITE)).all()
    assert np.isnan(times[never]).all()
    rest = np.setdiff1d(np.arange(B), never)
    assert (status[rest] == int(SolveStatus.OK)).all()
    assert rep.n_abandoned == len(never) and rep.n_failed == n_f
    assert launches["sdirk_round_fault"] > 0 \
        and launches["sdirk_round_pivot_fault"] > 0, launches
    return {"rescue": launches}, dict(
        B=B, n_faulted=n_f, wall_s=wall, report=rep.as_dict(),
        rung_walls_s=[a["wall_s"] for a in rep.attempts],
        healthy_bit_identical=same)


# -- phase 7: K8, the serving layer and the scheduler on the card -------------

#: K8's limit against its twin, relative to each lane's rate: a sum of
#: absolute values does not cancel, so the kernel's fused multiply-adds
#: (in J and in the sum) move it by rounding only
K8_TOL = 1e-12
K8_REPLACES = ("ops/odeint.py:92 (gershgorin_rate of the closed-form "
               "Jacobian: schedule/predictor.py:48-55, ops/odeint.py:720-725,"
               " ops/reactors.py:596-601)")
#: phase 7b: the served grisyn traffic
SERVE_BURSTS, SERVE_BURST_N, SERVE_EQ_EVERY = 4, 128, 4
SERVE_SAMPLES = 16
#: phase 7c: lanes of the h2o2 PSR map served
SERVE_PSR_N = 256
#: phase 7d: the faulted lane of the bucket-8 batch
FAULT_LANE = 5


def _port_cases():
    """tests/torch_port_cases.py: the seeded payloads shared with the CPU
    tests."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_port_cases
    return torch_port_cases


def _k8_rel(k, t):
    """Per-lane |k - t| / |t| over the lanes where t is not NaN: returns
    (max relative error, NaN lanes of k and t agree, max |k - t|)."""
    import torch
    nk, nt = torch.isnan(k), torch.isnan(t)
    fin = ~nt
    if not fin.any():
        return 0.0, bool(torch.equal(nk, nt)), 0.0
    d = (k[fin] - t[fin]).abs()
    rel = float((d / t[fin].abs().clamp_min(1e-300)).max())
    return rel, bool(torch.equal(nk, nt)), float(d.max())


def _k8_states(tm, code, B, seed, P0, T0=(1000.0, 1400.0), Y0=None,
               nan_lane=True):
    """Two state sets for K8 on ``tm``: phase 2's random states (one lane
    poisoned with NaN) and the sweep's initial states (T0 evenly over the
    range, composition ``Y0``, default stoichiometric H2/air, at P0), each
    as (label, y [B, N], c [B])."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch.ops import reactors, thermo
    KK = tm.KK
    y, P = _states(tm, B, seed, realistic=False)
    if nan_lane:
        y[B // 2, 0] = float("nan")
    c = P if code.startswith("CONP") else thermo.density(tm, y[:, KK], P,
                                                         y[:, :KK])
    f64 = dict(dtype=torch.float64, device=tm.device)
    lanes, y0 = reactors.sweep_lane_args(
        tm, torch.tensor(np.linspace(T0[0], T0[1], B), **f64),
        torch.full((B,), P0, **f64),
        torch.tensor(np.tile(_stoich_Y(tm) if Y0 is None else Y0, (B, 1)),
                     **f64), torch.full((B,), 1.0, **f64), atol=1e-12,
        problem=code)
    return [("random", y.contiguous(), c.contiguous()),
            ("sweep_start", y0.contiguous(), lanes.constraint.contiguous())]


def check_k8(tms, B, reps):
    """Phase 7a: K8 against its twin (K2's twin, then the plain
    max-row-sum) on the card for its eight instantiations: grisyn for the
    four reactors, h2o2_plog for the four with the XK body, and ch4global
    (XK, CONP); on phase 2's random states with one NaN lane and on the
    sweep's initial states, within K8_TOL of each lane's rate and NaN where
    the twin is NaN. Then ``schedule.stiffness_costs`` (the predictor's
    entry point, K8 at the sweeps' initial states) once per instantiation,
    the launch counters set to 0 just before and read just after. Returns
    (rows, {run label: launches})."""
    import torch
    from pychemkin_tpu_torch import kernels, schedule
    from pychemkin_tpu_torch.ops import odeint, reactors
    rows, runs = [], {}
    cases = [("grisyn", code) for code in _CODES] + [
        ("h2o2_plog", code) for code in _CODES] + [("ch4global", "CONP")]
    for mech, code in cases:
        tm = tms[mech]
        problem, energy = next(k for k, v in reactors.VARIANTS.items()
                               if v == code)
        P0 = (10 if problem == "CONV" else 1) * P_ATM
        kw = dict(T0=CH4_T0, Y0=_ch4_Y(tm)) if mech == "ch4global" else {}
        name = kernels.launch_name("gershgorin_rate", code,
                                   xk=kernels.extended(tm))
        _, jac_t = reactors.RHS_TWINS[code]
        errs, nan_ok, abs_err = {}, True, 0.0
        for label, y, c in _k8_states(tm, code, B, 0, P0, **kw):
            k = _launched(name, lambda: kernels.gershgorin_rate(
                tm, y, c, problem=code))
            t = odeint.gershgorin_rate(jac_t(tm, y, c)[1])
            torch.cuda.synchronize()
            errs[label], same_nan, a = _k8_rel(k, t)
            abs_err = max(abs_err, a)
            nan_ok &= same_nan
            assert same_nan, f"K8 {mech} {code} {label}: NaN lanes differ"
            assert errs[label] <= K8_TOL, \
                f"K8 {mech} {code} {label}: {errs[label]:.3e} > {K8_TOL}"
        # timings and the library yardstick on the sweep's initial states
        ms = _time_ms(lambda: kernels.gershgorin_rate(tm, y, c, problem=code),
                      reps)
        pms = _time_ms(lambda: odeint.gershgorin_rate(jac_t(tm, y, c)[1]),
                       max(reps // 10, 2))
        k2_ms = _time_ms(lambda: kernels.rhs_jac(tm, y, c, problem=code),
                         reps)
        J = kernels.rhs_jac(tm, y, c, problem=code)[1]
        norm_ms = _time_ms(lambda: torch.linalg.matrix_norm(
            J, ord=float("inf")), reps)
        lib = torch.linalg.matrix_norm(J, ord=float("inf"))
        torch.cuda.synchronize()
        lib_rel = _k8_rel(kernels.gershgorin_rate(tm, y, c, problem=code),
                          lib)[0]
        N = tm.N
        bms, by = _bound_ms(B * (N + 2) * 8 + _mech_bytes(tm),
                            B * (_rate_flops(tm, True, code) + 2.0 * N * N))
        # the predictor's entry point at the sweep's initial states
        torch.cuda.synchronize()
        kernels.reset_launches()
        costs = schedule.stiffness_costs(
            tm, problem, energy, y[:, -1], P0, y[0, :-1], 1.0,
            device="cuda")
        torch.cuda.synchronize()
        label = f"costs_{mech}_{code.lower()}"
        runs[label] = dict(kernels.LAUNCHES)
        assert costs.shape == (B,) and (costs > 0).all(), label
        row = _row(name, "gershgorin.cu", K8_REPLACES, mech=mech, batch=B,
                   home="serve_profiled" if (mech, code) == ("grisyn", "CONP")
                   else label,
                   max_abs_err=abs_err, scale_rel_err=max(errs.values()),
                   err_by_states=errs, nan_lanes_match=nan_ok, ms=ms,
                   plain_ms=pms, bound_ms=bms, bound_by=by,
                   library_ms=k2_ms + norm_ms, library_norm_ms=norm_ms,
                   library_k2_ms=k2_ms, library_rel_err=lib_rel)
        _print_row(row)
        rows.append(row)
    return rows, runs


def _await(futs, timeout=900):
    return [f.result(timeout=timeout) for f in futs]


def _submit_timed(server, kind, payloads, lat):
    """Submit ``payloads``; each future's completion time minus its submit
    time is appended to ``lat`` (seconds)."""
    futs = []
    for p in payloads:
        t = time.perf_counter()
        f = server.submit(kind, **p)
        f.add_done_callback(lambda _f, t=t: lat.append(
            time.perf_counter() - t))
        futs.append(f)
    return futs


def _same_values(a, b):
    import numpy as np
    return set(a) == set(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True)
        for k in a)


def serve_phase(tm):
    """Phase 7b: grisyn served by ``ChemServer(max_batch_size=128,
    max_delay_ms=2, schedule="adaptive")`` on the card, warmed over the
    ladder 1/8/32/128 for ignition and equilibrium: 512 ignition requests
    (stoichiometric H2/air, 1 atm, T0 uniform over 1000-1400 K from numpy
    seed 0, t_end 0.05 s) in four bursts of 128 with 128 equilibrium
    requests (option 1) interleaved; then, with PYCHEMKIN_SOLVE_PROFILE=1
    (and the ladder warmed again for it), the first burst's 128 payloads
    again. Checks: every request OK (or rescued to OK), no first dispatch
    after either warmup, 16 sampled ignition results bitwise equal to
    ``solve_direct`` at their bucket, the profiled primal values bitwise
    equal to the unprofiled ones, and their ``stiffness`` within K8_TOL of
    K8's twin at those lanes' final states (from the resumable sweep of the
    same payloads). Returns ({run label: launches}, summary)."""
    import collections
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels, serve, telemetry
    from pychemkin_tpu_torch.ops import odeint, reactors
    cases = _port_cases()
    names, wt = tm.record.species_names, tm.record.wt
    ign = cases.serve_ignition_payloads(names, wt,
                                        SERVE_BURSTS * SERVE_BURST_N, seed=0,
                                        t_end=0.05)
    eq = cases.serve_equilibrium_payloads(
        names, wt, SERVE_BURSTS * SERVE_BURST_N // SERVE_EQ_EVERY, seed=1)
    os.environ.pop("PYCHEMKIN_SOLVE_PROFILE", None)
    rec = telemetry.MetricsRecorder()
    server = serve.ChemServer(tm, max_batch_size=128, max_delay_ms=2.0,
                              schedule="adaptive", recorder=rec,
                              device="cuda")
    t0 = time.perf_counter()
    warm = server.warmup(["ignition", "equilibrium"])
    warm_s = time.perf_counter() - t0
    compiles0 = rec.counters.get("serve.compiles", 0)
    lat_ign, lat_eq, futs_ign, futs_eq = [], [], [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    server.start()
    t_first = time.perf_counter()
    for b in range(SERVE_BURSTS):
        burst = []
        for j in range(SERVE_BURST_N):
            i = b * SERVE_BURST_N + j
            f, = _submit_timed(server, "ignition", [ign[i]], lat_ign)
            futs_ign.append(f)
            burst.append(f)
            if j % SERVE_EQ_EVERY == SERVE_EQ_EVERY - 1:
                f, = _submit_timed(server, "equilibrium",
                                   [eq[i // SERVE_EQ_EVERY]], lat_eq)
                futs_eq.append(f)
                burst.append(f)
        _await(burst)
    window = time.perf_counter() - t_first
    res_ign, res_eq = _await(futs_ign), _await(futs_eq)
    torch.cuda.synchronize()
    launches = {"serve": dict(kernels.LAUNCHES)}
    compiles_a = rec.counters.get("serve.compiles", 0) - compiles0
    snap = rec.snapshot(write=False)
    occ = snap["histograms"]["serve.batch_occupancy"]
    n_req = len(res_ign) + len(res_eq)
    lat = np.array(lat_ign + lat_eq) * 1e3
    bad = [r.status_name for r in res_ign + res_eq if not r.ok]
    hot = {k[len("serve.status."):]: v for k, v in snap["counters"].items()
           if k.startswith("serve.status.")}
    rescued = collections.Counter(r.kind for r in res_ign + res_eq
                                  if r.rescued)
    # padding: per kind, dispatched bucket lanes that carry no request
    # (edge duplicates, each running the whole solve of the lane it copies)
    padding = {}
    for ev in rec.events("serve.batch"):
        k = padding.setdefault(ev["req_kind"], {"batches": 0, "requests": 0,
                                                "bucket_lanes": 0})
        k["batches"] += 1
        k["requests"] += ev["occupancy"]
        k["bucket_lanes"] += ev["bucket"]
    for k in padding.values():
        k["padded_share"] = 1.0 - k["requests"] / k["bucket_lanes"]
    print(f"serve grisyn: warmup {warm} in {warm_s:.1f} s; {n_req} requests "
          f"in {window:.3f} s = {n_req / window:.1f} requests/s; latency p50 "
          f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} "
          f"ms (ignition p50 {np.percentile(lat_ign, 50) * 1e3:.1f}, "
          f"equilibrium p50 {np.percentile(lat_eq, 50) * 1e3:.1f}); batches "
          f"{snap['counters'].get('serve.batches')}, mean occupancy "
          f"{occ['mean']}; hot-path status {hot}; rescued {dict(rescued)}"
          f"; first dispatches after warmup {compiles_a}; launches "
          f"{ {k: v for k, v in launches['serve'].items() if v} }; "
          f"padding {json.dumps(padding)}; "
          f"schedule {json.dumps(server.schedule_state())}", flush=True)
    assert not bad, f"served requests not OK: {bad}"
    assert compiles_a == 0, f"{compiles_a} first dispatches after warmup"
    # sampled bit-match against solve_direct at the same bucket
    pick = np.linspace(0, len(ign) - 1, SERVE_SAMPLES).round().astype(int)
    for i in pick:
        d = server.solve_direct("ignition", bucket=res_ign[i].bucket,
                                **ign[i])
        assert d.status == res_ign[i].status and _same_values(
            d.value, res_ign[i].value), \
            f"served lane {i} != solve_direct at bucket {res_ign[i].bucket}"
    assert rec.counters.get("serve.compiles", 0) == compiles0

    # the profiled half
    os.environ["PYCHEMKIN_SOLVE_PROFILE"] = "1"
    try:
        warm_p = server.warmup(["ignition"])
        compiles1 = rec.counters.get("serve.compiles", 0)
        lat_p = []
        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        res_p = _await(_submit_timed(server, "ignition", ign[:SERVE_BURST_N],
                                     lat_p))
        window_p = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches["serve_profiled"] = dict(kernels.LAUNCHES)
        compiles_b = rec.counters.get("serve.compiles", 0) - compiles1
    finally:
        os.environ.pop("PYCHEMKIN_SOLVE_PROFILE", None)
    server.close()
    assert all(r.ok for r in res_p), [r.status_name for r in res_p]
    assert compiles_b == 0, f"{compiles_b} first dispatches after warmup"
    same_primal = all(p.status == r.status and _same_values(p.value, r.value)
                      for p, r in zip(res_p, res_ign))
    assert same_primal, "profiled primal values differ from unprofiled"
    stiff = torch.tensor([np.nan if r.profile["stiffness"] is None
                          else r.profile["stiffness"] for r in res_p],
                         dtype=torch.float64, device=tm.device)
    # the lanes' final states: the resumable sweep of the same payloads
    kern = reactors.ignition_sweep_kernel(tm, "CONP", "ENRG", profile=True,
                                          device="cuda")
    carry = kern.init(*(np.array([p[f] for p in ign[:SERVE_BURST_N]])
                        for f in ("T0", "P0", "Y0", "t_end")))
    while True:
        carry = kern.advance(carry)
        h = kern.harvest(carry)
        if bool(h["done"].all()):
            break
    with torch.inference_mode():
        twin = odeint.gershgorin_rate(reactors.RHS_TWINS["CONP"][1](
            tm, carry.state.y, carry.lanes.constraint)[1])
    rel, nan_same, _ = _k8_rel(stiff, twin)
    times_same = np.array_equal(
        h["times"].cpu().numpy(),
        np.array([r.value["ignition_time_s"] for r in res_p]), equal_nan=True)
    print(f"  profiled half: warmup {warm_p}; {len(res_p)} requests in "
          f"{window_p:.3f} s; first dispatches after warmup {compiles_b}; "
          f"primal values bitwise equal to the unprofiled run: {same_primal};"
          f" stiffness vs K8's twin at the final states {rel:.3e} (NaN lanes "
          f"match: {nan_same}); resumable sweep's times bitwise equal: "
          f"{times_same}; launches "
          f"{ {k: v for k, v in launches['serve_profiled'].items() if v} }",
          flush=True)
    assert nan_same and rel <= K8_TOL, f"served stiffness vs twin {rel}"
    assert times_same, "resumable sweep times differ from served"
    for label, need in (("serve", ("rhs", "sdirk_round", "equil_solve")),
                        ("serve_profiled", ("sdirk_round",
                                            "gershgorin_rate"))):
        assert all(launches[label][k] > 0 for k in need), launches[label]
    return launches, dict(
        requests=n_req, window_s=window, requests_per_s=n_req / window,
        latency_p50_ms=float(np.percentile(lat, 50)),
        latency_p99_ms=float(np.percentile(lat, 99)),
        ignition_latency_p50_ms=float(np.percentile(lat_ign, 50) * 1e3),
        equilibrium_latency_p50_ms=float(np.percentile(lat_eq, 50) * 1e3),
        batches=snap["counters"].get("serve.batches"),
        mean_occupancy=occ["mean"], padding=padding, hot_path_status=hot,
        rescued_by_kind=dict(rescued), compiles_after_warmup=[compiles_a,
                                                           compiles_b],
        warmup_s=warm_s, profiled_window_s=window_p,
        stiffness_rel_err=rel,
        schedule=server.schedule_state(),
        k5_launches=launches["serve"]["sdirk_round"],
        k6_launches=launches["serve"]["equil_solve"],
        k8_launches=launches["serve_profiled"]["gershgorin_rate"])


def serve_psr_phase(tm):
    """Phase 7c: SERVE_PSR_N lanes of phase 5's h2o2 stability map (evenly
    spaced), with phase 5's guess (K6, option 5, of each inlet), served as
    ``psr`` requests by ``ChemServer(h2o2)`` on the card; the launch
    counters set to 0 just before and read just after. The lanes solved on
    the hot path must equal ``solve_psr`` of the same lanes in batches of
    the top bucket bit for bit. Returns ({label: launches}, summary)."""
    import numpy as np
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels, serve, telemetry
    from pychemkin_tpu_torch.ops import thermo
    from pychemkin_tpu_torch.resilience.status import status_counts
    cases = _port_cases()
    Y_in, T_in, tau = _map_lanes(tm)
    sel = torch.as_tensor(np.linspace(0, T_in.shape[0] - 1, SERVE_PSR_N)
                          .round().astype(np.int64), device=tm.device)
    Y_in, T_in, tau = Y_in[sel], T_in[sel], tau[sel]
    with torch.inference_mode():
        h_in = thermo.mixture_enthalpy_mass(tm, T_in, Y_in)
    g = ptt.equilibrate(tm, T_in, PSR_P, Y_in, option=5, device="cuda")
    host = [x.cpu().numpy() for x in (Y_in, h_in, tau, g.T, g.Y)]
    payloads = cases.serve_psr_payloads(*host, P=PSR_P)
    rec = telemetry.MetricsRecorder()
    server = serve.ChemServer(tm, max_batch_size=128, max_delay_ms=2.0,
                              recorder=rec, device="cuda")
    warm = server.warmup(["psr"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with server:
        res = _await([server.submit("psr", **p) for p in payloads])
    wall = time.perf_counter() - t0
    launches = {"serve_psr": dict(kernels.LAUNCHES)}
    top = server.buckets[-1]
    ref = []
    for lo in range(0, SERVE_PSR_N, top):
        s = slice(lo, lo + top)
        ref.append(ptt.solve_psr(tm, "tau", "ENRG", P=PSR_P, Y_in=Y_in[s],
                                 h_in=h_in[s], T_guess=g.T[s],
                                 Y_guess=g.Y[s], tau=tau[s], device="cuda"))
    rT = torch.cat([r.T for r in ref]).cpu().numpy()
    rY = torch.cat([r.Y for r in ref]).cpu().numpy()
    rst = torch.cat([r.status for r in ref]).cpu().numpy()
    hot = [i for i, r in enumerate(res) if r.rescue_rungs == 0]
    diff = [i for i in hot if not (
        res[i].status == rst[i] and res[i].value["T"] == rT[i]
        and np.array_equal(res[i].value["Y"], rY[i]))]
    st = np.array([r.status for r in res])
    cnt = snap = rec.snapshot(write=False)["counters"]
    print(f"serve psr h2o2: warmup {warm}; {SERVE_PSR_N} requests in "
          f"{wall:.3f} s = {SERVE_PSR_N / wall:.1f} requests/s; status "
          f"{status_counts(st)}; rescue thread: rescued "
          f"{cnt.get('serve.rescued', 0)}, abandoned "
          f"{cnt.get('serve.abandoned', 0)}; hot-path lanes {len(hot)}, "
          f"differing from solve_psr {len(diff)}; launches "
          f"{ {k: v for k, v in launches['serve_psr'].items() if v} }",
          flush=True)
    assert not diff, f"served PSR lanes differ from solve_psr: {diff[:8]}"
    assert launches["serve_psr"]["psr_solve"] > 0
    return launches, dict(
        requests=SERVE_PSR_N, wall_s=wall, requests_per_s=SERVE_PSR_N / wall,
        status=status_counts(st), rescued=snap.get("serve.rescued", 0),
        abandoned=snap.get("serve.abandoned", 0), hot_path_lanes=len(hot))


def fault_phase(tm):
    """Phase 7d: a Newton-stall fault (healing at rung 1) on lane
    FAULT_LANE of one bucket-8 batch of grisyn ignition requests, served
    on the card: the faulted request is healed by the rescue thread (K5
    FAULT in the batch, the clean K5 in the rung) and its 7 companions are
    bitwise equal to the same batch served without the fault. Returns
    ({label: launches}, summary)."""
    import torch
    from pychemkin_tpu_torch import kernels, serve, telemetry
    from pychemkin_tpu_torch.resilience import faultinject
    from pychemkin_tpu_torch.resilience.faultinject import FaultSpec
    cases = _port_cases()
    payloads = cases.serve_ignition_payloads(
        tm.record.species_names, tm.record.wt, 8, seed=3, t_end=0.05)

    def run(rec):
        server = serve.ChemServer(tm, bucket_sizes=(8,), max_delay_ms=50.0,
                                  recorder=rec, device="cuda")
        # admitted before the worker starts: one batch, lanes in order
        futs = [server.submit("ignition", **p) for p in payloads]
        with server:
            return _await(futs)

    clean = run(telemetry.MetricsRecorder())
    rec = telemetry.MetricsRecorder()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with faultinject.inject(FaultSpec("newton_stall", (FAULT_LANE,),
                                      heal_at=1)):
        res = run(rec)
    wall = time.perf_counter() - t0
    launches = {"serve_fault": dict(kernels.LAUNCHES)}
    victim = res[FAULT_LANE]
    same = all(_same_values(r.value, c.value) and r.status == c.status
               for i, (r, c) in enumerate(zip(res, clean))
               if i != FAULT_LANE)
    ev = rec.last_event("serve.rescue")
    print(f"serve fault grisyn: victim {victim.status_name} rescued "
          f"{victim.rescued} at rung {victim.rescue_rungs} (rescue event "
          f"{ev}), delay "
          f"{victim.value['ignition_delay_ms']:.6g} ms (clean "
          f"{clean[FAULT_LANE].value['ignition_delay_ms']:.6g}); companions "
          f"bitwise equal to the clean batch: {same}; {wall:.2f} s; launches "
          f"{ {k: v for k, v in launches['serve_fault'].items() if v} }",
          flush=True)
    assert victim.ok and victim.rescued and victim.rescue_rungs == 1
    assert same, "companions of the faulted lane differ from the clean run"
    assert launches["serve_fault"]["sdirk_round_fault"] > 0
    assert launches["serve_fault"]["sdirk_round"] > 0
    return launches, dict(wall_s=wall, victim_rungs=victim.rescue_rungs,
                          companions_bit_identical=same)


#: phase 7e: the round lengths of the compacted sweeps (None: the default,
#: K5's 512-attempt round; 64 makes the stragglers compact)
COMPACT_ROUNDS = (None, 64)


def compacted_phase(tm, B, t_end, base):
    """Phase 7e: the grisyn CONP/ENRG sweep of phase 3 (B lanes) through
    ``compacted_ignition_sweep`` in the order of
    ``plan_cohorts(stiffness_costs(...))`` (K8 at t = 0), once for each of
    COMPACT_ROUNDS, the launch counters set to 0 just before and read just
    after each; results scattered to caller order must equal phase 3's K5
    run ``base`` bit for bit, and the short rounds must compact at least
    once. Prints the rungs taken, K5 launches per rung, wall and
    ignitions/s, and the Spearman correlation of the costs with the
    measured attempts. Returns ({label: launches}, summary)."""
    import collections
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels, schedule, telemetry
    T0 = np.linspace(1000.0, 1400.0, B)
    Y0 = _stoich_Y(tm)
    launches, summary = {}, {}
    for round_len in COMPACT_ROUNDS:
        label = ("compacted" if round_len is None
                 else f"compacted_r{round_len}")
        rec = telemetry.MetricsRecorder()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        if round_len is None:
            costs = schedule.stiffness_costs(tm, "CONP", "ENRG", T0, P_ATM,
                                             Y0, t_end, device="cuda")
            plan = schedule.plan_cohorts(costs, chunk=B, recorder=rec)
        out = schedule.compacted_ignition_sweep(
            tm, "CONP", "ENRG", T0[plan.order], P_ATM, Y0, t_end,
            elem_ids=plan.order, round_len=round_len, recorder=rec,
            device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = dict(kernels.LAUNCHES)
        times = out["times"][plan.inverse]
        status = out["status"][plan.inverse]
        attempts = (out["n_steps"] + out["n_rejected"])[plan.inverse]
        same = (np.array_equal(times, base[0], equal_nan=True)
                and np.array_equal(status, base[1]))
        ev = rec.last_event("schedule.compaction")
        per_rung = dict(collections.Counter(ev["round_widths"]))
        corr = schedule.bank_predictor_calibration(costs, attempts,
                                                   recorder=rec)
        print(f"{label} sweep grisyn CONP/ENRG B={B}, rounds of "
              f"{ev['round_len']} attempts: wall {wall:.3f} s, "
              f"{B / wall:.2f} ignitions/s; rounds {ev['rounds']} at widths "
              f"{ev['round_widths']} (K5 launches per rung {per_rung}), "
              f"compactions {ev['n_compactions']}; predictor spearman "
              f"{corr}; bitwise equal to phase 3 in caller order: {same}; "
              f"launches "
              f"{ {k: v for k, v in launches[label].items() if v} }",
              flush=True)
        if not same:
            d = np.nonzero(~((times == base[0]) | (np.isnan(times)
                                                   & np.isnan(base[0]))))[0]
            rel = np.nanmax(np.abs(times[d] - base[0][d]) / base[0][d])
            raise AssertionError(
                f"{label} sweep differs from phase 3 on {d.size} lanes, e.g. "
                f"{d[:4].tolist()} (relative {rel:.3e})")
        if round_len is None:
            assert launches[label]["gershgorin_rate"] > 0
        else:
            assert ev["n_compactions"] >= 1, \
                f"{label}: no compaction in rounds of {round_len}"
        summary[label] = dict(
            B=B, round_len=ev["round_len"], wall_s=wall,
            ignitions_per_s=B / wall, rounds=ev["rounds"],
            round_widths=ev["round_widths"], k5_launches_per_rung=per_rung,
            n_compactions=ev["n_compactions"], predictor_spearman=corr,
            bit_identical_to_phase3=same)
    return launches, summary


def phases_2_to_6(tm, tm_h, tms, B, reps, t_end):
    """Phases 2-6 (see the module docstring). Returns (kernel rows,
    {run label: launches}, phase 3 summaries, phase 6 sweep summaries, the
    rescue summary, the PSR map summary, the steady-state checks, phase
    3's K5 run (times, status))."""
    import numpy as np
    import torch
    rows = check_kernels(tm, B, reps)
    with torch.inference_mode():
        steady = dict(equilibrium=check_equilibrium(tm, tm_h, B,
                                                    max(reps // 4, 2)),
                      psr=check_psr(tm, tm_h))
    for problem, P0 in SWEEPS:
        rows.append(check_k5(tm, problem, P0, t_end, max(reps // 4, 2)))
    launches, summaries = {}, []
    base = None
    for problem, P0 in SWEEPS:
        runs, summary, k5_out = sweep_phase(tm, problem, P0, B, t_end)
        launches.update(runs)
        summaries.append(summary)
        base = base or k5_out
    prof = profile_window(tm, B)
    print(json.dumps({"profile": prof if prof is not None else
                      "not measured: no device time in the trace"}),
          flush=True)
    with torch.inference_mode():
        map_launches, map_summary, map_rows = psr_map_phase(
            tm_h, max(reps // 4, 2))
    launches["map"] = map_launches
    rows.extend(map_rows)

    # phase 6
    t6 = time.perf_counter()
    with torch.inference_mode():
        rows.extend(check_phase6a(tms, B, t_end, max(reps // 4, 2)))
    print(f"phase 6a: {time.perf_counter() - t6:.1f} s", flush=True)
    sweeps6 = []
    for spec in (
            dict(tm=tm, problem="CONP", P0=P_ATM, energy="TGIV",
                 mode="Species_peak", kw={"species_index": OH},
                 t_end=t_end),
            dict(tm=tm, problem="CONV", P0=10 * P_ATM, energy="TGIV",
                 mode="Species_peak", kw={"species_index": OH},
                 t_end=t_end),
            dict(tm=tms["ch4global"], problem="CONP", P0=P_ATM,
                 mech="ch4global", label="ch4global", T0=CH4_T0,
                 Y0=_ch4_Y(tms["ch4global"]), t_end=CH4_T_END),
            dict(tm=tms["h2o2_plog"], problem="CONP",
                 P0=np.geomspace(1.0, 10.0, B) * P_ATM, mech="h2o2_plog",
                 label="h2o2_plog", t_end=PLOG_T_END),
            dict(tm=tms["h2o2_plog"], problem="CONV",
                 P0=np.geomspace(1.0, 10.0, B) * P_ATM, mech="h2o2_plog",
                 label="h2o2_plog_conv", t_end=PLOG_T_END)):
        runs, summary, _ = sweep_phase(spec.pop("tm"), spec.pop("problem"),
                                       spec.pop("P0"), B, spec.pop("t_end"),
                                       **spec)
        launches.update(runs)
        sweeps6.append(summary)
    with torch.inference_mode():
        runs, row = ch4_psr_phase(tms["ch4global"], K5_BATCH, reps)
    launches.update(runs)
    rows.append(row)
    runs, summary = pivot_sweep(tm, B, t_end, base)
    launches.update(runs)
    sweeps6.append(summary)
    runs, rescue = rescue_phase(tm, B, t_end, base)
    launches.update(runs)
    print(f"phase 6: {time.perf_counter() - t6:.1f} s", flush=True)
    return (rows, launches, summaries, sweeps6, rescue, map_summary, steady,
            base)


# -- phase 7f: linalg_unstable faults in K6 and K7, served ---------------------

def _served_bucket(tm, kind, payloads, spec=None):
    """One bucket-8 batch of ``payloads`` served by ``ChemServer(tm)`` on
    the card (admitted before the worker starts: one batch, lanes in
    order), under the fault ``spec`` if given. Returns (results, wall s,
    launches)."""
    import torch
    from pychemkin_tpu_torch import kernels, serve, telemetry
    from pychemkin_tpu_torch.resilience import faultinject
    server = serve.ChemServer(tm, bucket_sizes=(8,), max_delay_ms=50.0,
                              recorder=telemetry.MetricsRecorder(),
                              device="cuda")
    futs = [server.submit(kind, **p) for p in payloads]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with faultinject.inject(*([spec] if spec else [])):
        with server:
            res = _await(futs)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def steady_fault_phase(tm, tm_h, reps):
    """Phase 7f: a ``linalg_unstable`` fault healing at rung 1 on one
    request of a bucket-8 batch of grisyn equilibrium requests (K6) and of
    h2o2 PSR requests (K7), served on the card: the faulted lane runs the
    FAULT instantiation, fails on the hot path and is healed at rung 1 by
    the clean kernel; its 7 companions are bitwise equal to the batch
    served without the fault. Then the FAULT instantiations against their
    twins on the card (the same 8 lanes, the victim flagged): equal status
    codes, values within the phase 2c tolerances on the lanes OK in both.
    Returns ({label: launches}, summary, kernel rows)."""
    import numpy as np
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import equilibrium, psr, thermo
    from pychemkin_tpu_torch.resilience.faultinject import FaultSpec
    cases = _port_cases()
    f64 = dict(dtype=torch.float64, device="cuda")
    eq_pay = cases.serve_equilibrium_payloads(
        tm.record.species_names, tm.record.wt, 8, seed=1)
    Y_in, T_in, tau = _map_lanes(tm_h)
    sel = torch.as_tensor(np.linspace(2048, 4095, 8).round().astype(np.int64),
                          device="cuda")
    Y_in, T_in, tau = Y_in[sel], T_in[sel], tau[sel]
    with torch.inference_mode():
        h_in = thermo.mixture_enthalpy_mass(tm_h, T_in, Y_in)
    g = ptt.equilibrate(tm_h, T_in, PSR_P, Y_in, option=5, device="cuda")
    psr_pay = cases.serve_psr_payloads(
        *[x.cpu().numpy() for x in (Y_in, h_in, tau, g.T, g.Y)], P=PSR_P)
    launches, summary, rows = {}, {}, []
    for kind, mech, payloads in (("equilibrium", tm, eq_pay),
                                 ("psr", tm_h, psr_pay)):
        clean, _, _ = _served_bucket(mech, kind, payloads)
        victim = next(i for i, r in enumerate(clean)
                      if r.ok and r.rescue_rungs == 0)
        res, wall, lk = _served_bucket(
            mech, kind, payloads, FaultSpec("linalg_unstable", (victim,),
                                            heal_at=1))
        label = f"serve_fault_{kind}"
        launches[label] = lk
        v = res[victim]
        same = all(_same_values(r.value, c.value) and r.status == c.status
                   for i, (r, c) in enumerate(zip(res, clean)) if i != victim)
        healed = _same_values(v.value, clean[victim].value)
        fname = "equil_solve_fault" if kind == "equilibrium" else \
            kernels.launch_name("psr_solve", fault=True,
                                xk=kernels.extended(mech))
        cname = "equil_solve" if kind == "equilibrium" else \
            kernels.launch_name("psr_solve", xk=kernels.extended(mech))
        print(f"serve {kind} linalg_unstable on lane {victim}: {v.status_name}"
              f" rescued {v.rescued} at rung {v.rescue_rungs}, value equal "
              f"to the clean solve: {healed}; companions bitwise equal to the "
              f"clean batch: {same}; {wall:.2f} s; launches "
              f"{ {k: n for k, n in lk.items() if n} }", flush=True)
        assert v.ok and v.rescued and v.rescue_rungs == 1, (kind, v)
        assert same, f"{kind}: companions of the faulted lane differ"
        assert lk[fname] > 0 and lk[cname] > 0, lk
        summary[kind] = dict(victim=victim, wall_s=wall,
                             rescue_rungs=v.rescue_rungs,
                             companions_bit_identical=same,
                             healed_equals_clean=healed)
        # the FAULT instantiation against its twin on the same lanes
        fault = torch.zeros(8, dtype=torch.bool, device="cuda")
        fault[victim] = True
        with torch.inference_mode():
            if kind == "equilibrium":
                T, P, Y = (torch.tensor(np.array([p[k] for p in payloads]),
                                        **f64) for k in ("T", "P", "Y"))
                call = lambda: kernels.equil_solve(  # noqa: E731
                    mech, T, P, Y, 1, 80, fault=fault)
                k = _launched(fname, call)
                t1 = time.perf_counter()
                q = equilibrium.equilibrate_plain(mech, T, P, Y, 1, 80,
                                                  fault=fault)
                torch.cuda.synchronize()
                pms = (time.perf_counter() - t1) * 1e3
                assert torch.equal(k.status, q.status), \
                    f"K6 FAULT vs twin status {k.status} {q.status}"
                err, _, _ = _compare_eq("K6 FAULT", k, q)
                ms = _time_ms(call, reps)
                bms, by = _bound_ms(8 * _eq_bytes(mech),
                                    8 * _equil_flops(mech, 1))
                rows.append(_row(
                    fname, "equilibrium.cu",
                    "ops/equilibrium.py:150 (_solve; linalg_unstable "
                    ":269-272, ops/linalg.py:479-487)", home=label,
                    mech="grisyn", max_abs_err=float((k.T - q.T).abs().max()),
                    scale_rel_err=err["T"], ms=ms, plain_ms=pms,
                    bound_ms=bms, bound_by=by, library_ms=None, batch=8,
                    status=k.status.tolist()))
            else:
                args = psr.PSRArgs(
                    P=torch.full((8,), PSR_P, **f64), Y_in=Y_in, h_in=h_in,
                    tau=tau, volume=torch.zeros(8, **f64),
                    mdot=torch.full((8,), PSR_MDOT, **f64),
                    qloss=torch.zeros(8, **f64), T_fixed=torch.zeros(8, **f64))
                y0 = torch.cat([g.Y, g.T[:, None]], 1).contiguous()
                ctl = psr.PSRControls()
                call = lambda: kernels.psr_solve(  # noqa: E731
                    mech, "tau", "ENRG", args, y0, ctl, fault=fault)
                k = _launched(fname, call)
                t1 = time.perf_counter()
                q = psr.solve_psr_plain(mech, "tau", "ENRG", args, y0, ctl,
                                        fault=fault)
                torch.cuda.synchronize()
                pms = (time.perf_counter() - t1) * 1e3
                assert int(k.status[victim]) == int(q.status[victim]) == 5, \
                    (k.status, q.status)
                ok = (k.status == 0) & (q.status == 0)
                eT = float(((k.T - q.T).abs() / q.T)[ok].max()) \
                    if bool(ok.any()) else 0.0
                assert eT <= PSR_TOL["T"] * 100, f"K7 FAULT T {eT}"
                ms = _time_ms(call, max(reps // 4, 2))
                bms, by = _bound_ms(*_psr_work(mech, k))
                rows.append(_row(
                    fname, "psr_solve.cuh",
                    "ops/psr.py:273 (solve_psr; linalg_unstable :298-301, "
                    "ops/linalg.py:479-487)", home=label, mech="h2o2",
                    max_abs_err=float((k.T - q.T).abs()[ok].max())
                    if bool(ok.any()) else 0.0,
                    scale_rel_err=eT, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None, batch=8,
                    status=k.status.tolist()))
        _print_row(rows[-1])
    return launches, summary, rows


# -- phase 8: solve_batch with profiles, heat loss and the output grid -------

N_OUT = 101
#: lanes of phase 8's host-driven K1-K4 run
HOST_LANES = 512
#: phase 8's cells on grisyn at B lanes: (label, problem, energy, T0 range,
#: P0 range, t_end, solve_batch's profile arguments, ignition mode and
#: kwargs), T0 and P0 each evenly over its range across the lanes. 8a
#: has a rapid compression machine's volume history: V(t) 1 -> 0.1 cm^3
#: over 20 ms, then held, with wall loss. The loss's time constant
#: m cv / (htc area) is ~10 ms at 1 atm and 1 cm^3 (printed by the
#: phase), so by the end of the compression the charge has forgotten T0
#: and stays below ignition: at T0 450-550 K no lane ignites. The range
#: is moved to 1000-1100 K, where every lane ignites within the first
#: millisecond, before the volume has dropped 5 % (the phase prints the
#: volume at ignition): the cell exercises V(t), V' and the wall loss in
#: the kernels, not a compression-driven ignition. 8c spreads its lanes
#: over P0 1-5 atm under the shared T(t) ramp.
PHASE8 = (
    ("8a_rcm", "CONV", "ENRG", (1000.0, 1100.0), (P_ATM, P_ATM), 0.05,
     dict(constraint_profile=((0.0, 0.02, 0.05), (1.0, 0.1, 0.1)),
          htc=5e5, area=1.0, tamb=300.0), "T_inflection", None),
    ("8b_p_ramp", "CONP", "ENRG", (1000.0, 1400.0), (P_ATM, P_ATM), 0.05,
     dict(constraint_profile=((0.0, 0.05), (P_ATM, 2 * P_ATM)),
          qloss_profile=((0.0, 0.05), (1e6, 1e6))), "T_inflection", None),
    ("8c_t_ramp", "CONP", "TGIV", (900.0, 900.0), (P_ATM, 5 * P_ATM), 0.01,
     dict(t_profile=((0.0, 0.01), (900.0, 1400.0))), "Species_peak",
     {"species_index": OH}),
)


def _profiles_on(kw, device):
    """solve_batch's profile arguments with each (knots, values) pair as a
    Profile of f64 tensors on ``device``."""
    import torch
    from pychemkin_tpu_torch.ops import reactors
    out = {}
    for k, v in kw.items():
        if k.endswith("_profile"):
            v = reactors.Profile(*(torch.tensor(a, dtype=torch.float64,
                                                device=device) for a in v))
        out[k] = v
    return out


def _batch_args(tm, problem, energy, T0, P0, t_end, prof, mode, ikw, B):
    """The positional and keyword arguments of phase 8's solve_batch, with
    the solve profile (its stiffness is K8's, PRF, at t_final)."""
    import numpy as np
    T0s = np.linspace(T0[0], T0[1], B)
    kw = dict(n_out=N_OUT, rtol=1e-6, atol=1e-12, ignition_mode=mode,
              ignition_kwargs=ikw, device="cuda", profile=True,
              **_profiles_on(prof, "cuda"))
    return (tm, problem, energy, T0s, np.linspace(P0[0], P0[1], B),
            _stoich_Y(tm), np.full(B, t_end)), kw


def _solve_timed(ops, args, kw):
    """``reactors._solve_batch`` (K5 with ``ops`` None, else the host loop
    over ``ops``) with the launch counters set to 0 just before it and read
    just after: (solution, wall s, launches)."""
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import reactors
    full = dict(constraint_profile=None, t_profile=None, qloss_profile=None,
                area_profile=None, volume=1.0, htc=0.0, tamb=298.15,
                area=0.0, t_start=0.0, max_steps_per_segment=20_000, h0=0.0,
                jac_mode="analytic", profile=False)
    full.update(kw)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sol = reactors._solve_batch(ops, *args, **full)
    torch.cuda.synchronize()
    return sol, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def _tpv_rel(a, b, pick=None):
    """Max relative difference of T, P and V at every output time."""
    out = {}
    for f in ("T", "P", "volume"):
        x, y = getattr(a, f), getattr(b, f)
        if pick is not None:
            x = x[pick]
        out[f] = float(((x - y).abs() / y.abs().clamp_min(1e-300)).max())
    return out


def _prf_kernel_rows(tm, setup, code, label, B_rows, reps, mech="grisyn"):
    """K1, K2 and K8 PRF against their twins on B_rows random states at
    random times inside the profiles, and K5 PRF over one round of K5_ATTEMPTS
    attempts on K5_BATCH lanes from the start of ``setup``'s lanes against
    the twin: rows with the kernels' times and bounds."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import odeint, reactors
    rows = []
    args = setup.args
    sub = torch.arange(B_rows, device="cuda") % setup.y0.shape[0]
    a = odeint._take(args, sub)
    y, _ = _states(tm, B_rows, 0, realistic=True)
    T = y[:, tm.KK]
    t = torch.tensor(np.random.default_rng(1).uniform(
        0.0, float(setup.ts[0, -1]), B_rows), dtype=torch.float64,
        device="cuda")
    rhs_t, jac_t = reactors.RHS_PRF_TWINS[code]
    xk = kernels.extended(tm)
    mech_b = _mech_bytes(tm)
    N = tm.N
    for kname, twin, src, rep in (
            ("rhs", rhs_t, "rhs.cu", K1_REPLACES[code] + "; profiles "
             ":50, :84"),
            ("rhs_jac", jac_t, "rhs_jac_prf.cu", "ops/jacobian.py:558-700 "
             "(profile terms); " + K2_REPLACES[code])):
        name = kernels.launch_name(kname, code, xk=xk, prf=True)
        fn = getattr(kernels, kname)
        out = _launched(name, lambda: fn(tm, y, a, code, t=t))
        want = twin(tm, t, y, a)
        torch.cuda.synchronize()
        if kname == "rhs":
            err = _rate_rel(out, want, T, tm.KK)
            mae = float((out - want).abs().max())
            nbytes = B_rows * (2 * N + 2) * 8 + mech_b
        else:
            err = max(_rate_rel(out[0], want[0], T, tm.KK),
                      _rate_rel(out[1], want[1], T, tm.KK))
            mae = float((out[1] - want[1]).abs().max())
            nbytes = B_rows * (N + 2 + N + N * N) * 8 + mech_b
        assert err <= (1e-12 if kname == "rhs" else 1e-11), \
            f"{name} vs twin {err:.3e}"
        ms = _time_ms(lambda: fn(tm, y, a, code, t=t), reps)
        pms = _time_ms(lambda: twin(tm, t, y, a), max(reps // 10, 2))
        bms, by = _bound_ms(nbytes, B_rows * _rate_flops(tm, kname ==
                                                         "rhs_jac", code))
        home = f"{label}_k5" if kname == "rhs" else f"{label}_host_loop"
        rows.append(_row(name, src, rep, home=home, mech=mech, batch=B_rows,
                         max_abs_err=mae, scale_rel_err=err, ms=ms,
                         plain_ms=pms, bound_ms=bms, bound_by=by,
                         library_ms=None))
        _print_row(rows[-1])
    # K8 PRF: the stiffness rate of the profile Jacobian, against the twin
    name = kernels.launch_name("gershgorin_rate", code, xk=xk, prf=True)
    out = _launched(name, lambda: kernels.gershgorin_rate(tm, y, a, code,
                                                          t=t))
    want = odeint.gershgorin_rate(jac_t(tm, t, y, a)[1])
    torch.cuda.synchronize()
    err, same_nan, mae = _k8_rel(out, want)
    assert same_nan and err <= K8_TOL, f"{name} vs twin {err:.3e}"
    ms = _time_ms(lambda: kernels.gershgorin_rate(tm, y, a, code, t=t), reps)
    pms = _time_ms(lambda: odeint.gershgorin_rate(jac_t(tm, t, y, a)[1]),
                   max(reps // 10, 2))
    J = kernels.rhs_jac(tm, y, a, code, t=t)[1]
    lms = _time_ms(lambda: torch.linalg.matrix_norm(J, ord=float("inf")),
                   reps)
    bms, by = _bound_ms(B_rows * (N + 3) * 8 + mech_b,
                        B_rows * (_rate_flops(tm, True, code) + 2.0 * N * N))
    rows.append(_row(name, "gershgorin_prf.cu", K8_REPLACES + " with "
                     "ops/jacobian.py:558-700 (profile terms)",
                     home=f"{label}_k5", mech=mech, batch=B_rows,
                     max_abs_err=mae, scale_rel_err=err, ms=ms, plain_ms=pms,
                     bound_ms=bms, bound_by=by, library_ms=lms,
                     library_call="torch.linalg.matrix_norm(J, inf) of K2 "
                     "PRF's J"))
    _print_row(rows[-1])
    # K5 PRF: one round from the lanes' start, against the twin
    pick = torch.arange(K5_BATCH, device="cuda") * (
        setup.y0.shape[0] // K5_BATCH)
    lanes = odeint._take(setup.lanes, pick)
    lanes = lanes._replace(t_end=setup.ts[pick, -1].contiguous())
    with torch.inference_mode():
        s0 = odeint.sweep_start(reactors.kernel_ops(code), tm, lanes,
                                setup.y0[pick].contiguous(), 1e-6,
                                setup.events, t0=setup.ts[pick, 0].contiguous())
    mode = reactors.IGNITION_MODES.index(
        "Species_peak" if code.endswith("TGIV") else "T_inflection")
    species = int(setup.kw["species_index"])
    sk, st, pms, stats = _k5_vs_twin(tm, code, lanes, setup.events, s0, mode,
                                     species=species, prf=True)
    ms = _k5_ms(tm, lanes, s0, max(reps // 4, 2), event_mode=mode,
                problem=code, species_index=species)
    att, newton = stats["totals"]["attempts"][0], stats["totals"]["newton"][0]
    bms, by, per_call = _k5_bound(tm, code, 1, K5_BATCH, K5_BATCH, att,
                                  newton)
    fin = st.y.isfinite()
    rows.append(_row(
        kernels.launch_name("sdirk_round", code, xk=xk, prf=True),
        "sdirk_round.cuh", "ops/odeint.py:451 (_segment_fns) with "
        "ops/reactors.py:50-160 (profiles, heat loss)", home=f"{label}_k5",
        mech=mech, max_abs_err=float((sk.y - st.y).abs()[fin].max()),
        scale_rel_err=max(stats["rel_err"].values()), ms=ms, plain_ms=pms,
        bound_ms=bms, bound_by=by, per_call_bound_sum_ms=per_call,
        library_ms=None, batch=K5_BATCH, attempts=K5_ATTEMPTS, **stats))
    _print_row(rows[-1])
    return rows


def solve_batch_phase(tm, B, base, reference_sweeps, reps, t_end=0.05):
    """Phase 8: ``solve_batch`` on grisyn at B lanes, n_out = N_OUT, rtol
    1e-6, atol 1e-12, for the cells of PHASE8: through K1 and K5 (PRF),
    then the host loop over K1-K4 (K1/K2 PRF) on HOST_LANES lanes, then 8
    lanes through the twins (deferred to ``run_twin_jobs``, on the CPU),
    the card's runs with the launch counters read around them: every
    lane OK, the host loop's status and T, P, V at every output time within
    1e-6 relative, the twins' within 1e-6; the kernel rows of K1, K2 and K5
    PRF against their twins; and the constant-profile solve_batch at
    n_out = 2 bitwise equal to phase 3's sweep (``base``, at ``t_end``).
    Returns ({label: launches}, summaries, rows)."""
    import numpy as np
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import reactors, thermo
    from pychemkin_tpu_torch.resilience.status import (SolveStatus,
                                                       status_counts)
    launches, summaries, rows = {}, [], []
    for label, problem, energy, T0, P0, t_end, prof, mode, ikw in PHASE8:
        code = reactors.variant(problem, energy)
        args, kw = _batch_args(tm, problem, energy, T0, P0, t_end, prof, mode,
                               ikw, B)
        tag = f"{label} {problem}/{energy}"
        sol, wall, lk = _solve_timed(None, args, kw)
        launches[f"{label}_k5"] = lk
        st = sol.status.cpu().numpy()
        att = sol.n_steps + sol.n_rejected
        name5 = kernels.launch_name("sdirk_round", code,
                                    xk=kernels.extended(tm), prf=True)
        name1 = kernels.launch_name("rhs", code, xk=kernels.extended(tm),
                                    prf=True)
        name8 = kernels.launch_name("gershgorin_rate", code,
                                    xk=kernels.extended(tm), prf=True)
        ok_share = float((st == int(SolveStatus.OK)).mean())
        Tmax = float(sol.T.max())
        ref = reference_sweeps.get(code)
        print(f"{tag} B={B} n_out={N_OUT}: wall {wall:.3f} s, "
              f"{B / wall:.2f} solutions/s, attempts {int(att.sum())} (max "
              f"per lane {int(att.max())}), Newton iterations "
              f"{int(sol.n_newton.sum())}, lanes OK {ok_share:.4f}, status "
              f"{status_counts(st)}, T max {Tmax:.1f} K, ignition times "
              f"{float(sol.ignition_time.nan_to_num(0).min()):.4e}-"
              f"{float(sol.ignition_time.nan_to_num(0).max()):.4e} s; the "
              f"constant-profile sweep of this reactor: "
              f"{ {k: ref[k] for k in ('wall_s', 'ignitions_per_s', 'attempts', 'newton')} if ref else None}"
              f"; launches { {k: v for k, v in lk.items() if v} }",
              flush=True)
        assert lk[name5] > 0 and lk[name1] > 0 and lk[name8] == 1, lk
        stiff = sol.profile["stiffness"]
        assert bool((torch.isfinite(stiff) & (stiff > 0)).all()), \
            f"{tag}: stiffness at t_final"
        extra = {}
        if problem == "CONV":
            # where the lanes are when they ignite: V at the ignition time,
            # and the wall loss's time constant m cv(T0) / (htc area)
            setup = reactors.batch_setup(*args, **{
                k: v for k, v in kw.items() if k not in ("rtol", "profile")})
            a0 = setup.args
            cv = thermo.mixture_cv_mass(tm, setup.y0[:, tm.KK],
                                        setup.y0[:, :tm.KK])
            tau_loss = a0.mass * cv / (a0.htc * a0.area.y[:, 0])
            ign = sol.ignition_time
            fin = torch.isfinite(ign)
            v_ign = reactors.profile_value_slope(
                a0.constraint, torch.where(fin, ign, 0.0))[0][fin]
            extra = dict(
                ignited_share=float(fin.double().mean()),
                volume_at_ignition=[float(v_ign.min()), float(v_ign.max())]
                if bool(fin.any()) else None,
                wall_loss_time_constant_s=[float(tau_loss.min()),
                                           float(tau_loss.max())])
            print(f"  {tag}: ignited {extra['ignited_share']:.4f} of the "
                  f"lanes, V at ignition {extra['volume_at_ignition']} cm^3 "
                  f"(1 at t = 0, 0.1 from 20 ms); the wall loss's time "
                  f"constant m cv / (htc area) "
                  f"{extra['wall_loss_time_constant_s']} s", flush=True)
        assert lk[kernels.launch_name("rhs_jac", code,
                                      xk=kernels.extended(tm), prf=True)] \
            == lk["bordered_factor"] == 0, lk
        assert ok_share == 1.0, f"{tag}: status {status_counts(st)}"
        if energy == "ENRG":
            assert Tmax > 2000.0, f"{tag}: the lanes did not ignite"
        assert torch.isfinite(sol.T).all() and torch.isfinite(sol.Y).all()
        # the host loop over K1-K4 with profiles, on HOST_LANES of the
        # lanes (each lane is its own block in K5: its steps do not depend
        # on the batch)
        hp = np.unique(np.linspace(0, B - 1, min(HOST_LANES, B)).round()
                       .astype(int))
        ah = (args[0], args[1], args[2], args[3][hp], args[4][hp], args[5],
              args[6][hp])
        host, wall_h, lh = _solve_timed(reactors.kernel_ops(code), ah, kw)
        launches[f"{label}_host_loop"] = lh
        hpt = torch.as_tensor(hp, device="cuda")
        assert lh[name5] == 0 and lh["bordered_factor"] > 0, lh
        assert torch.equal(host.status, sol.status[hpt]), f"{tag}: host status"
        e_host = _tpv_rel(sol, host, hpt)
        att_h = int((host.n_steps + host.n_rejected).sum())
        att_k = int(att[hpt].sum())
        print(f"  vs the host loop over K1-K4 on {hp.size} lanes "
              f"({wall_h:.3f} s, attempts {att_h}, K5 {att_k}): T, P, V "
              f"within {e_host}", flush=True)
        assert abs(att_h - att_k) <= 0.01 * att_k, f"{tag}: attempts"
        assert max(e_host.values()) <= 1e-6, f"{tag}: vs host loop {e_host}"
        # 8 lanes through the twins (deferred: on the CPU in parallel after
        # the timed phases)
        pick = np.unique(np.linspace(0, B - 1, 8).round().astype(int))
        pt = torch.as_tensor(pick, device="cuda")
        mine = {f: getattr(sol, f)[pt].cpu().numpy()
                for f in ("T", "P", "volume", "status")}
        mine["stiffness"] = stiff[pt].cpu().numpy()
        _defer_twin(("batch", _mech_spec(tm), problem, energy,
                     args[3][pick], args[4][pick], args[5], args[6][pick],
                     {k: v for k, v in kw.items() if k != "device"} | {
                         k: v for k, v in prof.items()}),
                    _batch_twin_check(tag, pick, mine))
        setup = reactors.batch_setup(*args, **{
            k: v for k, v in kw.items() if k not in ("rtol", "profile")})
        rows.extend(_prf_kernel_rows(tm, setup, code, label, B, reps))
        summaries.append(dict(
            label=label, problem=problem, energy=energy, T0=list(T0),
            t_end=t_end, B=B, n_out=N_OUT, wall_s=wall,
            solutions_per_s=B / wall, attempts=int(att.sum()),
            max_attempts=int(att.max()), newton=int(sol.n_newton.sum()),
            ok_share=ok_share, status=status_counts(st), T_max=Tmax,
            P0=list(P0), **extra,
            host_loop_wall_s=wall_h, max_rel_vs_host_loop=e_host,
            constant_profile_sweep={k: ref[k] for k in (
                "wall_s", "ignitions_per_s", "attempts", "newton")}
            if ref else None))
    # the constant-profile special case against phase 3's sweep, bitwise
    base_t, base_st = base
    args, kw = _batch_args(tm, "CONP", "ENRG", (1000.0, 1400.0),
                           (P_ATM, P_ATM), t_end, {}, "T_inflection", None, B)
    kw.update(n_out=2, profile=False)
    sol, wall, lk = _solve_timed(None, args, kw)
    launches["8_constant_n_out_2"] = lk
    same_t = np.array_equal(sol.ignition_time.cpu().numpy(), base_t,
                            equal_nan=True)
    same_s = np.array_equal(sol.status.cpu().numpy(), base_st)
    print(f"solve_batch constant profiles, n_out=2, B={B}: {wall:.3f} s; "
          f"times bitwise equal to phase 3's sweep: {same_t}, status: "
          f"{same_s}", flush=True)
    assert same_t and same_s, "constant-profile solve_batch != phase 3"
    summaries.append(dict(label="8_constant_n_out_2", wall_s=wall,
                          bitwise_equal_to_phase3=same_t and same_s))
    return launches, summaries, rows


# -- phase 9: a mechanism too large for shared memory -----------------------

BIG_COPIES = 8
#: the sweep's lanes: 128 since phase 10 joined the script (256 before;
#: the script's 1200 s hold the build, phases 2-10 and the twin reruns)
BIG_B = 128
BIG_CHECK_B = 64
BIG_PSR_B = 16
#: phase 9's short sweep through the host loop over K1-K4 and through K5:
#: lanes and t_end (before any lane ignites: a few dozen attempts)
BIG_HOST_B = 16
BIG_HOST_T_END = 1e-5
#: the launches each phase 9 row reads: the run of the main path that
#: launches the instantiation (K2 runs only in the host loop)
BIG_HOMES = {"rhs": "big_sweep", "rhs_jac": "big_host_loop",
             "gershgorin_rate": "big_sweep"}


def large_mech_phase(tm, reps):
    """Phase 9: the 8-copy synthetic grisyn (424 species, 2600 reactions;
    tests/torch_port_cases.py): the size chooser's storage for each kernel
    at the card's limit; K1, K2 and K8 against their twins on BIG_CHECK_B
    random states; K5 over one round of K5_ATTEMPTS attempts on
    BIG_CHECK_B lanes against the twin; a BIG_HOST_B sweep to
    BIG_HOST_T_END through the host loop over K1-K4 (K2, K3 and K4 GM,
    also held against their twins) and through K5, which must agree; K7
    on BIG_PSR_B lanes (phase 2c's cold inlets: 298.15 and 700 K, tau
    1e-4-1 s) from K6's HP equilibrium guess against the twin, by phase
    2c's rule (rounding-chaotic lanes found by twin reruns), at least
    half of them OK in both; and a BIG_B CONP/ENRG sweep with every lane
    OK. Every launch of K1, K2, K3, K4, K5, K7 and K8 must be the GM
    instantiation. Each row reads its launches from the run of the path
    that launches it. Returns ({label: launches}, summary, rows)."""
    import ctypes
    import numpy as np
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import odeint, psr, reactors, thermo
    from pychemkin_tpu_torch.resilience.status import (SolveStatus,
                                                       status_counts)
    KK, N = tm.KK, tm.N
    limit = kernels.smem_limit("cuda")
    lib = kernels.build.library()
    view = ctypes.byref(kernels.mech_view(tm))
    storage = {}
    for name in ("rhs", "rhs_jac", "sdirk_round", "gershgorin_rate",
                 "psr_solve", "equil_solve"):
        s = kernels.storage(name, tm, limit)
        c_doubles = (lib.chem_psr_lane_doubles(view) if name == "psr_solve"
                     else lib.chem_equil_lane_doubles(view)
                     if name == "equil_solve" else lib.chem_lane_doubles(
                         view, kernels._LANE_IDS[name], 0))
        assert 8 * c_doubles == s.lane_bytes, (name, c_doubles, s)
        storage[name] = s._asdict()
        print(f"storage {name}: {s} (limit {limit} bytes)", flush=True)
        if name != "equil_solve":
            assert s.kind == "global", (name, s)
    launches, rows = {}, []
    mech_b = _mech_bytes(tm)
    # K1, K2, K8 against their twins
    kernels.reset_launches()
    y, P = _states(tm, BIG_CHECK_B, 0, realistic=True)
    T = y[:, KK]
    for kname, src, rep in (
            ("rhs", "rhs.cu", K1_REPLACES["CONP"]),
            ("rhs_jac", "rhs_jac_gm.cu", K2_REPLACES["CONP"]),
            ("gershgorin_rate", "gershgorin.cu", "ops/odeint.py:92")):
        name = kernels.launch_name(kname, xk=kernels.extended(tm), gm=True)
        fn = getattr(kernels, kname)
        twin = {"rhs": reactors.RHS_TWINS["CONP"][0],
                "rhs_jac": reactors.RHS_TWINS["CONP"][1],
                "gershgorin_rate": lambda tm_, y_, c_: odeint.gershgorin_rate(
                    reactors.RHS_TWINS["CONP"][1](tm_, y_, c_)[1])}[kname]
        out = _launched(name, lambda: fn(tm, y, P))
        want = twin(tm, y, P)
        torch.cuda.synchronize()
        if kname == "rhs":
            err = _rate_rel(out, want, T, KK)
            nb, fl = BIG_CHECK_B * (2 * N + 1) * 8, _rate_flops(tm, False)
        elif kname == "rhs_jac":
            err = max(_rate_rel(out[0], want[0], T, KK),
                      _rate_rel(out[1], want[1], T, KK))
            out, want = out[1], want[1]
            nb, fl = BIG_CHECK_B * (2 * N + 1 + N * N) * 8, \
                _rate_flops(tm, True)
        else:
            err = float(((out - want).abs() / want.abs()).max())
            nb, fl = BIG_CHECK_B * (N + 2) * 8, _rate_flops(tm, True)
        assert err <= (1e-12 if kname == "rhs" else 1e-11), \
            f"{name} vs twin {err:.3e}"
        ms = _time_ms(lambda: fn(tm, y, P), max(reps // 4, 2))
        pms = _time_ms(lambda: twin(tm, y, P), 2)
        bms, by = _bound_ms(nb + mech_b, BIG_CHECK_B * fl)
        rows.append(_row(name, src, rep, home=BIG_HOMES[kname],
                         mech=f"grisyn x{BIG_COPIES}", batch=BIG_CHECK_B,
                         max_abs_err=float((out - want).abs().max()),
                         scale_rel_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None,
                         workspace_bytes=kernels.WORKSPACE_BYTES.get(name)))
        _print_row(rows[-1])
    # K5 GM: one round against the twin
    lanes, events, s0 = _sweep_start(tm, "CONP", P_ATM, BIG_CHECK_B, 0.05,
                                     reactors.IGN_T_INFLECTION)
    sk, st, pms, stats = _k5_vs_twin(tm, "CONP", lanes, events, s0, 0,
                                     gm=True)
    ms = _k5_ms(tm, lanes, s0, 2, event_mode=0, problem="CONP")
    att, newton = stats["totals"]["attempts"][0], stats["totals"]["newton"][0]
    bms, by, per_call = _k5_bound(tm, "CONP", 1, BIG_CHECK_B, BIG_CHECK_B,
                                  att, newton)
    name5 = kernels.launch_name("sdirk_round", xk=kernels.extended(tm),
                                gm=True)
    rows.append(_row(name5, "sdirk_round.cuh", "ops/odeint.py:451 "
                     "(_segment_fns; :322, :355, :377, :787)",
                     home="big_sweep", mech=f"grisyn x{BIG_COPIES}",
                     max_abs_err=float((sk.y - st.y).abs().max()),
                     scale_rel_err=max(stats["rel_err"].values()), ms=ms,
                     plain_ms=pms, bound_ms=bms, bound_by=by,
                     per_call_bound_sum_ms=per_call, library_ms=None,
                     batch=BIG_CHECK_B, attempts=K5_ATTEMPTS,
                     workspace_bytes=kernels.WORKSPACE_BYTES.get(name5),
                     **stats))
    _print_row(rows[-1])
    # K3 and K4 GM against their twins, then a short sweep through the host
    # loop over K1-K4 (K2 GM's home) and through K5
    rows.extend(_k34_rows(tm, BIG_CHECK_B, max(reps // 4, 2),
                          "big_host_loop", mech=f"grisyn x{BIG_COPIES}"))
    for row in rows[-2:]:
        assert row["name"].endswith("_gm"), row["name"]
    T0h = np.linspace(1000.0, 1400.0, BIG_HOST_B)
    Y0h = np.tile(_stoich_Y(tm), (BIG_HOST_B, 1))
    host = {}
    for label, ops in (("big_host_loop", reactors.kernel_ops("CONP")),
                       ("big_host_k5", None)):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = reactors._sweep(
            ops, tm, "CONP", "ENRG", T0h, P_ATM, Y0h, BIG_HOST_T_END,
            rtol=1e-6, atol=1e-12, ignition_mode="T_inflection",
            max_steps_per_segment=20_000, device="cuda", profile=True)
        torch.cuda.synchronize()
        host[label] = (out, time.perf_counter() - t0)
        launches[label] = dict(kernels.LAUNCHES)
    (_, _, st_h, pr_h), wall_h = host["big_host_loop"]
    (_, _, st_k, pr_k), wall_k = host["big_host_k5"]
    lh, lk = launches["big_host_loop"], launches["big_host_k5"]
    att_h = int((pr_h["n_steps"] + pr_h["n_rejected"]).sum())
    att_k = int((pr_k["n_steps"] + pr_k["n_rejected"]).sum())
    e_h = {k: float(((pr_k[k] - pr_h[k]).abs() / pr_h[k].abs()).max())
           for k in ("dt_final", "stiffness")}
    print(f"sweep grisyn x{BIG_COPIES} B={BIG_HOST_B} to {BIG_HOST_T_END} "
          f"s: host loop over K1-K4 {wall_h:.3f} s, {att_h} attempts; K5 "
          f"{wall_k:.3f} s, {att_k} attempts; K5 vs host loop (dt_final, "
          f"stiffness) within {e_h}; launches "
          f"{ {k: v for k, v in lh.items() if v} }", flush=True)
    name2 = kernels.launch_name("rhs_jac", xk=kernels.extended(tm), gm=True)
    assert lh[name2] > 0 and lh[rows[-2]["name"]] > 0 and \
        lh[rows[-1]["name"]] > 0 and lh[name5] == 0, lh
    assert lk[name5] > 0 and lk[name2] == 0, lk
    assert torch.equal(st_h, st_k) and bool(
        (st_k == int(SolveStatus.OK)).all()), (st_h, st_k)
    assert abs(att_h - att_k) <= 0.01 * att_k, (att_h, att_k)
    assert max(e_h.values()) <= STIFF_TOL, e_h
    # K7 GM from K6's guess, against the twin, on phase 2c's cold inlets
    f64 = dict(dtype=torch.float64, device="cuda")
    Y_in = torch.tensor(np.tile(_stoich_Y(tm), (BIG_PSR_B, 1)), **f64)
    T_in = torch.tensor(np.repeat([298.15, 700.0], BIG_PSR_B // 2), **f64)
    tau = torch.tensor(np.tile(np.geomspace(1e-4, 1.0, BIG_PSR_B // 2), 2),
                       **f64)
    with torch.inference_mode():
        h_in = thermo.mixture_enthalpy_mass(tm, T_in, Y_in)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = ptt.equilibrate(tm, T_in, PSR_P, Y_in, option=5, device="cuda")
    sol = ptt.solve_psr(tm, "tau", "ENRG", P=PSR_P, Y_in=Y_in, h_in=h_in,
                        T_guess=g.T, Y_guess=g.Y, tau=tau, mdot=PSR_MDOT,
                        device="cuda")
    torch.cuda.synchronize()
    wall_psr = time.perf_counter() - t0
    launches["big_psr"] = dict(kernels.LAUNCHES)
    name7 = kernels.launch_name("psr_solve", xk=kernels.extended(tm), gm=True)
    assert launches["big_psr"][name7] > 0 and \
        launches["big_psr"]["equil_solve"] > 0, launches["big_psr"]
    args = psr.PSRArgs(P=torch.full_like(T_in, PSR_P), Y_in=Y_in, h_in=h_in,
                       tau=tau, volume=torch.zeros_like(T_in),
                       mdot=torch.full_like(T_in, PSR_MDOT),
                       qloss=torch.zeros_like(T_in),
                       T_fixed=torch.zeros_like(T_in))
    y0 = torch.cat([g.Y, g.T[:, None]], 1).contiguous()
    ctl = psr.PSRControls()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    kernels.psr_solve(tm, "tau", "ENRG", args, y0, ctl)
    ev1.record()
    torch.cuda.synchronize()
    ms7 = ev0.elapsed_time(ev1)
    row7 = _row(name7, "psr_solve.cuh", "ops/psr.py:273 (solve_psr; "
                ":148, :225)", home="big_psr", mech=f"grisyn x{BIG_COPIES}",
                ms=ms7, **dict(zip(("bound_ms", "bound_by"),
                                   _bound_ms(*_psr_work(tm, sol)))),
                library_ms=None, batch=BIG_PSR_B,
                workspace_bytes=kernels.WORKSPACE_BYTES.get(name7))
    rows.append(row7)
    kern = {f: getattr(sol, f).cpu() for f in sol._fields}

    def check7(res, seconds):
        # phase 2c's rule: where kernel and twin differ, the twin reruns
        # from the guess moved by 1e-15 (here on the CPU, as the twin ran)
        from pychemkin_tpu_torch.mechanism import TorchMechanism
        q = psr.PSRSolution(**{f: torch.as_tensor(v) for f, v in res.items()})
        k = psr.PSRSolution(**kern)
        tm_cpu = TorchMechanism(_mech_spec(tm), "cpu")
        args_cpu = type(args)(*[a.cpu() for a in args])
        with torch.inference_mode():
            cmp = _compare_psr(f"K7 GM x{BIG_COPIES}", k, q, _rerun(
                tm_cpu, "tau", "ENRG", args_cpu, y0.cpu(), ctl, 9), MAP_TOL)
        ok = (k.status == 0) & (q.status == 0)
        burning = int(((k.T > T_in.cpu() + 500.0) & ok).sum())
        print(f"K7 GM x{BIG_COPIES} B={BIG_PSR_B}: {wall_psr:.3f} s with the "
              f"K6 guess; status {status_counts(k.status.numpy())}, {burning}"
              f" OK lanes burning (T > T_in + 500 K); against the twin "
              f"({seconds:.1f} s on the CPU) {cmp}", flush=True)
        assert cmp["ok_both"] >= BIG_PSR_B // 2, cmp
        row7.update(max_abs_err=float((k.T - q.T).abs()[ok].max())
                    if bool(ok.any()) else 0.0, scale_rel_err=cmp["err_T"],
                    plain_ms=seconds * 1e3, plain_on="cpu")
        _print_row(row7)
    _defer_twin(("psr", _mech_spec(tm), "tau", "ENRG",
                 tuple(a.cpu().numpy() for a in args), y0.cpu().numpy(),
                 None, None, None), check7)
    # a BIG_B sweep through K1 and K5 GM
    T0 = np.linspace(1000.0, 1400.0, BIG_B)
    Y0 = np.zeros((BIG_B, KK))
    Y0[:] = _stoich_Y(tm)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    times, ok_s, status, prof = reactors.ignition_delay_sweep(
        tm, "CONP", "ENRG", T0, P_ATM, Y0, 0.05, device="cuda", profile=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["big_sweep"] = dict(kernels.LAUNCHES)
    stc = status.cpu().numpy()
    att = prof["n_steps"] + prof["n_rejected"]
    ws = {k: v for k, v in kernels.WORKSPACE_BYTES.items()}
    print(f"sweep grisyn x{BIG_COPIES} CONP/ENRG B={BIG_B}: wall {wall:.3f} "
          f"s, {BIG_B / wall:.2f} ignitions/s, attempts {int(att.sum())} "
          f"(max {int(att.max())}), Newton {int(prof['n_newton'].sum())}, "
          f"status {status_counts(stc)}; workspace bytes {ws}; launches "
          f"{ {k: v for k, v in launches['big_sweep'].items() if v} }",
          flush=True)
    lb = launches["big_sweep"]
    assert lb[name5] > 0 and lb[kernels.launch_name(
        "rhs", xk=kernels.extended(tm), gm=True)] > 0, lb
    assert lb[kernels.launch_name("sdirk_round", xk=kernels.extended(tm))] \
        == 0, lb
    assert (stc == int(SolveStatus.OK)).all(), status_counts(stc)
    assert bool(ok_s.all()) and np.isfinite(times.cpu().numpy()).all()
    return launches, dict(storage=storage, limit=limit, sweep_wall_s=wall,
                          sweep_ignitions_per_s=BIG_B / wall,
                          sweep_attempts=int(att.sum()),
                          workspace_bytes=ws, psr_wall_s=wall_psr,
                          host_loop_wall_s=wall_h, host_k5_wall_s=wall_k,
                          host_attempts=att_h), rows


#: ptxas's mangled kernel names -> kernels.LAUNCHES names
_CODES = ("CONP", "CONV", "CONP_TGIV", "CONV_TGIV")


# -- phase 10: the premixed flame: K9-K12 under the object model ---------------

#: K9's states (T 300-3000 K, random X with zeros and pure species)
K9_BATCH = 4096
#: tolerances of phase 10a, scale-relative (the CPU tests' for K10-K12)
K9_TOL = 1e-12
F_TOL = 1e-12
J_TOL = 1e-10
K12_TOL = 1e-10
#: the card's Newton direction against the twins' (deferred CPU rerun)
DIR_TOL = 1e-9
#: 10b's flame speed and peak temperature against the JAX package's
#: (tests/torch_port_cases.py JAX_FLAME_REFERENCE), and the absolute
#: anchor of the JAX package's acceptance test (tests/test_flame1d.py:182)
SU_REL = 0.005
TMAX_REL = 0.005
SU_ANCHOR = (210.0, 0.15)
#: the flame configurations of 10a's K10/K11 checks
FLAME_CFGS = (("mix", {}), ("lewis", dict(transport="LEWIS", lewis=1.1)),
              ("tdif", dict(soret=True)), ("central", dict(upwind=False)),
              ("tgiv_burner", dict(energy="TGIV", free_flame=False)))
K9_REPLACES = "ops/transport.py:63-229"
K10_REPLACES = "ops/flame1d.py:151"
K11_REPLACES = "ops/flame1d.py:251"
K12_REPLACES = "ops/blocktridiag.py:20"
def _omega_flops(t, which):
    """FP64 operations of one collision integral at t* (Omega(1,1)*: a
    pow and three exps; Omega(2,2)*: a pow and two exps), an exp or pow
    charged ``t``."""
    return 4 * t + 12 if which == 11 else 3 * t + 10


def _species_flops(t):
    """One species' viscosity and conductivity at T: both integrals, the
    square roots of T and of eps/T (eps/T ** 1.5 from the latter), NASA
    cp and the Warnatz split; Zrot(298) is a constant of the mechanism."""
    return _omega_flops(t, 22) + _omega_flops(t, 11) + 2 * t + 40


def _transport_flops(KK, n_light, t=TRANSCENDENTAL):
    """FP64 operations one K9 state needs at least: the KK species terms;
    Wilke's KK square roots of mu_k and KK^2 ratio terms (the weight
    ratios are constants of the mechanism); the binary coefficients once
    per unordered pair (D_jk is symmetric, T ** 1.5 is one per state, and
    D_km reuses them: 2 KK^2 for its sums); Theta only on the n_light rows
    with W <= 5, one Omega(2,2)* per pair (Omega(1,1)* is D_jk's)."""
    pairs = KK * (KK + 1) // 2 * (_omega_flops(t, 11) + 5)
    theta = n_light * KK * (_omega_flops(t, 22) + 15)
    return float(KK * _species_flops(t) + KK * t + 8 * KK * KK + pairs
                 + 2 * KK * KK + theta + 10 * KK)


def _face_flops(KK, n_light=0, t=TRANSCENDENTAL):
    """FP64 operations of one face's fluxes at T_f: the species terms
    and the conductivity average, the binary coefficients once per
    unordered pair and the D_km sums (LEWIS needs fewer), the three X
    conversions and the flux sums; with ``n_light`` (TDIF) Theta on the
    rows with W <= 5. ``t`` = 1 gives the count of primal operations, each
    of which a tangent carries at ~2 flops (a transcendental's tangent
    reuses its value)."""
    pairs = KK * (KK + 1) // 2 * (_omega_flops(t, 11) + 5)
    theta = n_light * KK * (_omega_flops(t, 22) + 15)
    return float(KK * _species_flops(t) + pairs + 2 * KK * KK + theta
                 + 40 * KK)


def _n_light(tm):
    """The species with W <= 5, the rows on which Theta is not zero."""
    return int((tm.wt <= 5.0).sum())


def _flame_k9(tms, reps, names_wt):
    """10a, K9: ``Mixture``'s transport getters (the object model on the
    card), then K9 on K9_BATCH seeded states of h2o2 and of ch4global, the
    launch counters set to 0 before and read after (K9's home run,
    ``10a``); each against its twin on the card within K9_TOL, timed, with
    its bound. Returns (row, {"10a": launches})."""
    import numpy as np
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.mechanism import DATA_DIR
    from pychemkin_tpu_torch.ops import transport
    cases = _port_cases()
    f64 = dict(dtype=torch.float64, device="cuda")
    states = {}
    for mech in ("h2o2", "ch4global"):
        names, wt = names_wt[mech]
        T, P, X = cases.transport_states(names, wt, K9_BATCH, 7)
        states[mech] = [torch.tensor(a, **f64) for a in (T, P, X)]
    chem = ptt.Chemistry(chem=os.path.join(DATA_DIR, "h2o2.inp"),
                         tran=os.path.join(DATA_DIR, "tran_h2o2.dat"))
    chem.preprocess()
    mix = ptt.Mixture(chem)
    mix.temperature, mix.pressure = 1500.0, 2.0 * P_ATM
    mix.X = {"H2": 2.0, "O2": 1.0, "N2": 3.76, "H2O": 0.4, "OH": 0.01}
    torch.cuda.synchronize()
    kernels.reset_launches()
    getters = {g: getattr(mix, g)() for g in (
        "species_Visc", "species_Cond", "species_Diffusion_Coeffs",
        "mixture_viscosity", "mixture_conductivity",
        "mixture_diffusion_coeffs", "mixture_thermal_diffusion_coeffs")}
    outs = {m: kernels.transport_props(tms[m], *states[m]) for m in states}
    torch.cuda.synchronize()
    runs = {"10a": dict(kernels.LAUNCHES)}
    assert runs["10a"]["transport_props"] == len(getters) + 2, runs["10a"]
    assert all(np.all(np.isfinite(np.asarray(v))) for v in getters.values())
    errs, abs_err = {}, 0.0
    for mech, out in outs.items():
        twin = transport.transport_props(tms[mech], *states[mech])
        for f in twin._fields:
            a, b = getattr(out, f), getattr(twin, f)
            d = (a - b).abs().reshape(K9_BATCH, -1).amax(1)
            sc = b.abs().reshape(K9_BATCH, -1).amax(1).clamp_min(1e-300)
            errs[f"{mech}.{f}"] = float((d / sc).max())
            abs_err = max(abs_err, float(d.max()))
    worst = max(errs.values())
    print(f"10a K9: {len(getters)} Mixture getters and {K9_BATCH} states of "
          f"h2o2 and ch4global; worst scale-rel {worst:.3e} "
          f"({max(errs, key=errs.get)})", flush=True)
    assert worst <= K9_TOL, f"K9 vs twin {errs}"
    tm = tms["h2o2"]
    st = states["h2o2"]
    ms = _time_ms(lambda: kernels.transport_props(tm, *st), reps)
    pms = _time_ms(lambda: transport.transport_props(tm, *st),
                   max(reps // 4, 2))
    KK = tm.KK
    bms, by = _bound_ms(K9_BATCH * 8 * ((KK + 2) + (KK * KK + 4 * KK + 2)),
                        K9_BATCH * _transport_flops(KK, _n_light(tm)))
    row = _row("transport_props", "transport.cu", K9_REPLACES, home="10a",
               mech="h2o2", batch=K9_BATCH, max_abs_err=abs_err,
               scale_rel_err=worst, err_by_field=errs, ms=ms, plain_ms=pms,
               bound_ms=bms, bound_by=by, library_ms=None)
    _print_row(row)
    return row, runs


def _flame_data(tm, cfg_kw, u, x, Y_in, T_given, i_fix, mdot):
    import torch
    from pychemkin_tpu_torch.ops import flame1d
    f64 = dict(dtype=torch.float64, device=u.device)
    cfg = flame1d.FlameConfig(**cfg_kw)
    data = flame1d.FlameData(
        x=torch.as_tensor(x, **f64), P=P_ATM,
        T_in=_port_cases().FLAME_T_IN,
        Y_in=torch.as_tensor(Y_in, **f64), mdot_in=mdot, T_fix=400.0,
        i_fix=int(i_fix), T_given=torch.as_tensor(T_given, **f64))
    return cfg, data


def _rel(a, b):
    """Scale-relative error per grid point (leading axis), max over points,
    and the max absolute error."""
    d = (a - b).abs().reshape(a.shape[0], -1).amax(1)
    s = b.abs().reshape(b.shape[0], -1).amax(1).clamp_min(1e-300)
    return float((d / s).max()), float(d.max())


def _f_rel(F, F_t, blk_t, u):
    """The residual's error relative to the size of its terms: per entry
    |F - F_t| over sum_j |dF/du_j| |u_j| (the twin's blocks at the state),
    max over entries, and the max absolute error. Near convergence F is a
    small difference of large terms (convection, diffusion, chemistry), so
    a scale of F itself would measure rounding against the difference."""
    Bb, Ab, Cb = (b.abs() for b in blk_t)
    au = u.abs()[..., None]
    sc = (Ab @ au)[..., 0]
    sc[1:] += (Bb[1:] @ au[:-1])[..., 0]
    sc[:-1] += (Cb[:-1] @ au[1:])[..., 0]
    d = (F - F_t).abs()
    return float((d / sc.clamp_min(1e-300)).max()), float(d.max())


def _w_rel(x, x_t, u, cfg):
    """A Newton direction's error in the Newton's own weighted norm
    (weights atol + rtol |u|): RMS((x - x_t) / w) over RMS(x_t / w)."""
    w = cfg.ss_atol + cfg.ss_rtol * u.abs()
    num = ((x - x_t) / w).pow(2).mean().sqrt()
    den = (x_t / w).pow(2).mean().sqrt().clamp_min(1e-300)
    return float(num / den), float((x - x_t).abs().max())


def _flame_kernel_rows(tm, mech, states, reps, home):
    """10a, K10-K12 on the card against their twins on the card at the
    flame's own states ``states`` ({label: (cfg, u, x, Y_in, T_given,
    i_fix, mdot)}; the initial, a mid-solve and the converged state of
    the path's solve, with the configuration the path solved there) for
    every configuration of FLAME_CFGS: F within F_TOL of the size of its
    terms (:func:`_f_rel`), the blocks within J_TOL per point; K12 on the
    path's Newton system at each state (K11's blocks, -K10, the state's
    own configuration) within K12_TOL of the twin's block Thomas in the
    Newton's weighted norm (:func:`_w_rel`); K12's yardstick is one
    ``torch.linalg.solve`` of the assembled dense [N M, N M] system. Timed at the largest state with its
    configuration. Returns the three rows (K12's only for h2o2)."""
    import dataclasses
    import torch
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.ops import blocktridiag, flame1d
    errs = {"F": {}, "J": {}}
    abs_err = {"F": 0.0, "J": 0.0}
    k12_card, k12_jobs = {}, []
    xk = kernels.extended(tm)
    n_res = kernels.launch_name("flame_residual", xk=xk)
    n_jac = kernels.launch_name("flame_jac", xk=xk)
    big = max(states, key=lambda k: len(states[k][2]))
    for label, (cfg_own, u, x, Y_in, T_given, i_fix, mdot) in states.items():
        for cname, cfg_kw in FLAME_CFGS + (("own", None),):
            cfg, data = _flame_data(
                tm, cfg_kw if cfg_kw is not None else
                dataclasses.asdict(cfg_own), u, x, Y_in, T_given, i_fix,
                mdot)
            res, jac = flame1d.make_residual(tm, cfg)
            F = _launched(n_res, lambda: kernels.flame_residual(
                tm, cfg, u, data))
            blk = _launched(n_jac, lambda: kernels.flame_jac(
                tm, cfg, u, data))
            F_t = res(u, data)
            blk_t = jac(u, data)
            key = f"{label}/{cname}"
            errs["F"][key], a = _f_rel(F, F_t, blk_t, u)
            abs_err["F"] = max(abs_err["F"], a)
            e = [_rel(b, bt) for b, bt in zip(blk, blk_t)]
            errs["J"][key] = max(v[0] for v in e)
            abs_err["J"] = max(abs_err["J"], max(v[1] for v in e))
            if cname == "own":
                d = (-F).contiguous()
                xk12 = _launched("block_thomas", lambda: kernels.block_thomas(
                    *blk, d))
                # the twin on the card (cuSOLVER's LU, another rounding
                # order) for the record; the check is the CPU twin's
                k12_card[label] = _w_rel(
                    xk12, blocktridiag.solve(*blk, d), u, cfg)[0]
                k12_jobs.append((label, blk, d, xk12, u, cfg))
    worst = {k: max(v.values()) for k, v in errs.items()}
    print(f"10a {mech} K10/K11 vs twins at {list(states)} x "
          f"{[c for c, _ in FLAME_CFGS]} and the states' own "
          f"configurations: worst {worst}; K12 at the states' Newton "
          f"systems vs the card's twin (cuSOLVER), weighted: {k12_card}",
          flush=True)
    assert worst["F"] <= F_TOL, f"K10 {mech} {errs['F']}"
    assert worst["J"] <= J_TOL, f"K11 {mech} {errs['J']}"
    # times at the largest state, with its own configuration
    cfg_own, u, x, Y_in, T_given, i_fix, mdot = states[big]
    cfg, data = _flame_data(tm, dataclasses.asdict(cfg_own), u, x, Y_in,
                            T_given, i_fix, mdot)
    res, jac = flame1d.make_residual(tm, cfg)
    N, M = u.shape
    KK = tm.KK
    blk = kernels.flame_jac(tm, cfg, u, data)
    d = (-kernels.flame_residual(tm, cfg, u, data)).contiguous()
    t = {"K10": _time_ms(lambda: kernels.flame_residual(tm, cfg, u, data),
                         reps),
         "K10_twin": _time_ms(lambda: res(u, data), max(reps // 10, 2)),
         "K11": _time_ms(lambda: kernels.flame_jac(tm, cfg, u, data), reps),
         "K11_twin": _time_ms(lambda: jac(u, data), 2)}
    chem = _rate_flops(tm, False)
    chem_j = _rate_flops(tm, True)
    light = _n_light(tm) if cfg.soret else 0
    face = _face_flops(KK, light)
    rows = []
    bms, by = _bound_ms(8 * (2 * N * M + 2 * N + KK),
                        (N - 1) * face + (N - 2) * (chem + 20 * M))
    rows.append(_row(n_res, "flame_residual.cu", K10_REPLACES, home=home,
                     mech=mech, grid_points=N, max_abs_err=abs_err["F"],
                     scale_rel_err=worst["F"], err_by_state=errs["F"],
                     ms=t["K10"], plain_ms=t["K10_twin"], bound_ms=bms,
                     bound_by=by, library_ms=None))
    # K11: each face once, with the 2 M tangents of its two points at ~2
    # flops per primal operation; each interior point's own terms with
    # its 3 M tangents, and the closed-form chemistry J
    tangents = (N - 1) * 2 * M * 2 * _face_flops(KK, light, t=1.0)
    stencil = (N - 2) * (chem_j + 20 * M * (1 + 3 * M * 2))
    bms, by = _bound_ms(8 * (N * M + 2 * N + KK + 3 * N * M * M),
                        (N - 1) * face + tangents + stencil)
    rows.append(_row(n_jac, "flame_jac.cu", K11_REPLACES, home=home,
                     mech=mech, grid_points=N, max_abs_err=abs_err["J"],
                     scale_rel_err=worst["J"], err_by_state=errs["J"],
                     ms=t["K11"], plain_ms=t["K11_twin"], bound_ms=bms,
                     bound_by=by, library_ms=None))
    if mech == "h2o2":
        A = torch.zeros(N * M, N * M, dtype=u.dtype, device=u.device)
        Bb, Ab, Cb = blk
        for i in range(N):
            A[i * M:(i + 1) * M, i * M:(i + 1) * M] = Ab[i]
            if i > 0:
                A[i * M:(i + 1) * M, (i - 1) * M:i * M] = Bb[i]
            if i < N - 1:
                A[i * M:(i + 1) * M, (i + 1) * M:(i + 2) * M] = Cb[i]
        rhs = d.reshape(-1, 1)
        ms12 = _time_ms(lambda: kernels.block_thomas(*blk, d), reps)
        pms12 = _time_ms(lambda: blocktridiag.solve(*blk, d), 2)
        lib_ms = _time_ms(lambda: torch.linalg.solve(A, rhs), reps)
        lib_rel = _w_rel(kernels.block_thomas(*blk, d),
                         torch.linalg.solve(A, rhs).reshape(N, M), u, cfg)[0]
        flops = N * (2.0 * M ** 3 + 2 * M * M + M * M * (2 * M + 1)
                     + M * M * (M + 1)) + 2.0 * N * M * M
        bms, by = _bound_ms(8 * (3 * N * M * M + 2 * N * M), flops)
        row12 = _row("block_thomas", "block_thomas.cu", K12_REPLACES,
                     home=home, mech=mech, grid_points=N,
                     max_abs_err=float("nan"), scale_rel_err=float("nan"),
                     err_by_state={}, err_vs_card_twin=k12_card, ms=ms12,
                     plain_ms=pms12, bound_ms=bms, bound_by=by,
                     library_ms=lib_ms,
                     library="torch.linalg.solve of the dense "
                             f"[{N * M}, {N * M}] system",
                     library_rel_err=lib_rel)
        rows.append(row12)
        for job in k12_jobs:
            _defer_k12_twin(row12, *job)
    for r in rows:
        _print_row(r)
    return rows


class _FlameRecorder:
    """Wraps ``kernels.flame.flame_jac`` during a flame run and keeps the
    (u, data, cfg) of the first call and of the first call on each new
    grid size: the path's initial and mid-solve states."""

    def __init__(self):
        self.calls = []
        self.sizes = set()

    def __enter__(self):
        from pychemkin_tpu_torch.kernels import flame as kf
        self._orig = kf.flame_jac

        def wrapped(tm, cfg, u, data):
            if u.shape[0] not in self.sizes:
                self.sizes.add(u.shape[0])
                self.calls.append((cfg, u.clone(), data))
            return self._orig(tm, cfg, u, data)
        kf.flame_jac = wrapped
        return self

    def __exit__(self, *exc):
        from pychemkin_tpu_torch.kernels import flame as kf
        kf.flame_jac = self._orig


def _state_of(cfg, u, data):
    """(cfg, u, x, Y_in, T_given, i_fix, mdot) of a recorded flame
    call."""
    return (cfg, u, data.x, data.Y_in, data.T_given, data.i_fix,
            data.mdot_in)


def _run_free_flame(mech, label):
    """Chemistry, Stream and FreelyPropagating (FLAME_CASES[mech] on the
    model's default grid controls, MIX) on the card, the launch counters
    set to 0 just before run() and read just after. Returns (the model,
    the recorder, launches, wall seconds)."""
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.mechanism import DATA_DIR
    from pychemkin_tpu_torch.models import FreelyPropagating
    cases = _port_cases()
    tran = {"h2o2": "tran_h2o2.dat", "ch4global": "tran_ch4.dat"}[mech]
    chem = ptt.Chemistry(chem=os.path.join(DATA_DIR, mech + ".inp"),
                         tran=os.path.join(DATA_DIR, tran))
    chem.preprocess()
    inlet = ptt.Stream(chem, label="fuel")
    inlet.pressure = P_ATM
    inlet.temperature = cases.FLAME_T_IN
    inlet.X = cases.FLAME_CASES[mech]["recipe"]
    inlet.mass_flowrate = 0.03
    fl = FreelyPropagating(inlet)
    fl.start_position = 0.0
    fl.end_position = cases.FLAME_CASES[mech]["x_end"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _FlameRecorder() as rec:
        rc = fl.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    assert rc == 0 or mech != "h2o2", f"{label}: run() returned {rc}"
    return fl, rec, launches, wall


def _flame_summary(label, fl, launches, wall):
    # the last solve's report (run() and continuation() both leave it)
    rep = fl._solution.report if fl._solution is not None else {}
    keys = ("equil_solve", "transport_props", "flame_residual",
            "flame_residual_xk", "flame_jac", "flame_jac_xk", "block_thomas")
    out = dict(wall_s=wall, converged=bool(rep.get("converged")),
               n_points=rep.get("n_points"), n_regrids=rep.get("n_regrids"),
               n_newton=rep.get("n_newton"), n_ts_steps=rep.get("n_ts_steps"),
               launches={k: launches.get(k, 0) for k in keys})
    if fl.runstatus == 0:
        sol = fl.process_solution()
        out["T_max"] = float(sol.T.max())
        if hasattr(fl, "get_flame_speed"):
            out["flame_speed"] = float(fl.get_flame_speed())
    print(f"{label}: {out}", flush=True)
    return out


def _defer_flame_twin(tag, tm, cfg, u, x, data, converged_state):
    """A deferred CPU rerun of the flame twins at the card's state: at the
    converged state the twins' step norm from u must be below 1 (the
    Newton criterion); at the initial and mid-solve states the card's
    Newton direction (K11, K10, K12) must match the twins' within DIR_TOL
    in the Newton's weighted norm (:func:`_w_rel`)."""
    import dataclasses
    import numpy as np
    from pychemkin_tpu_torch import kernels
    Bb, Ab, Cb = kernels.flame_jac(tm, cfg, u, data)
    F = kernels.flame_residual(tm, cfg, u, data)
    du = kernels.block_thomas(Bb, Ab, Cb, (-F).contiguous())
    payload = dict(cfg=dataclasses.asdict(cfg), u=u.cpu().numpy(),
                   x=data.x.cpu().numpy(), Y_in=data.Y_in.cpu().numpy(),
                   T_given=data.T_given.cpu().numpy(), P=data.P,
                   T_in=data.T_in, mdot_in=data.mdot_in, T_fix=data.T_fix,
                   i_fix=data.i_fix)
    mine = du.cpu().numpy()

    def check(res, seconds):
        if converged_state:
            print(f"{tag}: twins' step norm at the card's converged state "
                  f"{res['norm']:.3e} ({seconds:.1f} s)", flush=True)
            assert res["norm"] < 1.0, f"{tag}: twin norm {res['norm']}"
            _TWIN_RESULTS[tag] = dict(norm=res["norm"])
        else:
            w = cfg.ss_atol + cfg.ss_rtol * np.abs(payload["u"])
            err = float(np.sqrt(np.mean(((mine - res["du"]) / w) ** 2))
                        / max(np.sqrt(np.mean((res["du"] / w) ** 2)),
                              1e-300))
            print(f"{tag}: card's Newton direction vs the twins' "
                  f"{err:.3e} in the Newton's weighted norm ({seconds:.1f} "
                  "s)", flush=True)
            assert err <= DIR_TOL, f"{tag}: direction {err}"
            _TWIN_RESULTS[tag] = dict(direction=err)
    _defer_twin(("flame", tm.record, None, None, payload, None, None, None,
                 None), check)


def _defer_k12_twin(row, label, blk, d, x, u, cfg):
    """K12's check: the card's solution ``x`` of the Newton system (blk, d)
    at ``label``'s state against the plain block Thomas on the CPU (LAPACK's
    partially pivoted LU per block, the reference's CPU configuration),
    within K12_TOL in the Newton's weighted norm; fills ``row``'s
    errors."""
    import numpy as np
    payload = dict(k12=[b.cpu().numpy() for b in blk] + [d.cpu().numpy()])
    mine = x.cpu().numpy()
    w = cfg.ss_atol + cfg.ss_rtol * np.abs(u.cpu().numpy())

    def check(res, seconds):
        xt = res["x"]
        err = float(np.sqrt(np.mean(((mine - xt) / w) ** 2))
                    / max(np.sqrt(np.mean((xt / w) ** 2)), 1e-300))
        row["err_by_state"][label] = err
        row["scale_rel_err"] = max(v for v in row["err_by_state"].values())
        a = float(np.abs(mine - xt).max())
        row["max_abs_err"] = a if np.isnan(row["max_abs_err"]) else max(
            row["max_abs_err"], a)
        print(f"K12 at {label}: the card's solve vs the CPU twin {err:.3e} "
              f"in the Newton's weighted norm ({seconds:.1f} s)", flush=True)
        assert err <= K12_TOL, f"K12 {label}: {err}"
    _defer_twin(("flame", None, None, None, payload, None, None, None, None),
                check)


def _flame_twin_job(record, payload):
    """The CPU side of :func:`_defer_flame_twin` (the twins' Newton
    direction and step norm at the payload's state) and of
    :func:`_defer_k12_twin` (the plain block Thomas of the payload's
    system)."""
    import torch
    from pychemkin_tpu_torch.mechanism import TorchMechanism
    from pychemkin_tpu_torch.ops import blocktridiag, flame1d
    if "k12" in payload:
        B, A, C, d = (torch.as_tensor(a) for a in payload["k12"])
        return dict(x=blocktridiag.solve(B, A, C, d).numpy())
    tm = TorchMechanism(record, "cpu")
    cfg = flame1d.FlameConfig(**payload["cfg"])
    t = {k: torch.as_tensor(payload[k]) for k in ("u", "x", "Y_in",
                                                 "T_given")}
    data = flame1d.FlameData(x=t["x"], P=payload["P"], T_in=payload["T_in"],
                             Y_in=t["Y_in"], mdot_in=payload["mdot_in"],
                             T_fix=payload["T_fix"], i_fix=payload["i_fix"],
                             T_given=t["T_given"])
    res, jac = flame1d.make_residual(tm, cfg)
    u = t["u"]
    du = blocktridiag.solve(*jac(u, data), -res(u, data))
    w = cfg.ss_atol + cfg.ss_rtol * u.abs()
    return dict(du=du.numpy(), norm=float(((du / w) ** 2).mean().sqrt()))


def flame_phase(tms, reps):
    """Phase 10: 10a K9 (its home run: Mixture's getters and 4096 states);
    10b the h2o2 free flame through Chemistry, Stream and FreelyPropagating
    on the card (converges; Su and T_max within SU_REL/TMAX_REL of the
    JAX package's recorded values, Su within 15 % of 210 cm/s), K10-K12
    held against their twins on the card at the path's initial, mid-solve
    and converged states (10a's flame rows, home ``10b_flame``), the twins
    on the CPU at the card's states in the deferred reruns; 10c the
    ch4global case (see JAX_FLAME_REFERENCE); 10d the burner-stabilized
    TGIV flame of tests/test_flame1d.py:266 and continuation() of 10b's
    flame at 2 atm. Returns (rows, {label: launches}, summary)."""
    import numpy as np
    import torch
    cases = _port_cases()
    ref = cases.JAX_FLAME_REFERENCE
    names_wt = {m: (tms[m].record.species_names, np.asarray(tms[m].record.wt))
                for m in ("h2o2", "ch4global")}
    rows, runs, summary = [], {}, {}
    t10 = time.perf_counter()
    with torch.inference_mode():
        row, r = _flame_k9(tms, reps, names_wt)
    rows.append(row)
    runs.update(r)
    print(f"phase 10a K9: {time.perf_counter() - t10:.1f} s", flush=True)

    # 10b: the main path
    t0 = time.perf_counter()
    fl, rec, launches, wall = _run_free_flame("h2o2", "10b")
    runs["10b_flame"] = launches
    s = summary["10b"] = _flame_summary("10b h2o2 free flame", fl, launches,
                                        wall)
    r_h = ref["h2o2"]
    assert s["converged"], "10b: the h2o2 free flame did not converge"
    su_rel = abs(s["flame_speed"] - r_h["su"]) / r_h["su"]
    tmax_rel = abs(s["T_max"] - r_h["T_max"]) / r_h["T_max"]
    anchor = abs(s["flame_speed"] - SU_ANCHOR[0]) / SU_ANCHOR[0]
    s.update(su_rel_jax=su_rel, T_max_rel_jax=tmax_rel, su_rel_210=anchor,
             jax=r_h)
    print(f"10b: Su {s['flame_speed']:.4f} cm/s (JAX {r_h['su']:.4f}, rel "
          f"{su_rel:.2e}; 210 cm/s anchor rel {anchor:.3f}), T_max "
          f"{s['T_max']:.2f} K (JAX {r_h['T_max']:.2f}, rel {tmax_rel:.2e})",
          flush=True)
    assert su_rel <= SU_REL, f"10b: Su vs JAX {su_rel}"
    assert tmax_rel <= TMAX_REL, f"10b: T_max vs JAX {tmax_rel}"
    assert anchor <= SU_ANCHOR[1], f"10b: Su vs 210 cm/s {anchor}"
    for k in ("equil_solve", "transport_props", "flame_residual",
              "flame_jac", "block_thomas"):
        if k != "transport_props":
            assert launches[k] > 0, f"10b: {k} not launched"
    sol = fl._solution
    tm = fl._effective_tm()
    st = {}
    (cfg0, u0, d0) = rec.calls[0]
    st["initial"] = _state_of(cfg0, u0, d0)
    cfg_m, u_m, d_m = rec.calls[len(rec.calls) // 2]
    st["mid"] = _state_of(cfg_m, u_m, d_m)
    f64 = dict(dtype=torch.float64, device="cuda")
    u_c = torch.as_tensor(sol.u, **f64)
    x_c = torch.as_tensor(sol.x, **f64)
    i_fix = int(np.clip(np.argmin(np.abs(sol.T - 400.0)), 1,
                        len(sol.x) - 2))
    cfg_c, _, d_last = rec.calls[-1]
    d_c = d_last if len(d_last.x) == len(sol.x) else d_last._replace(
        x=x_c, i_fix=i_fix, T_given=torch.zeros_like(x_c))
    st["converged"] = _state_of(cfg_c, u_c, d_c)
    with torch.inference_mode():
        rows.extend(_flame_kernel_rows(tm, "h2o2", st, reps, "10b_flame"))
        for tag, (cfg, u, data), conv in (
                ("10b_initial", rec.calls[0], False),
                ("10b_mid", rec.calls[len(rec.calls) // 2], False),
                ("10b_converged", (cfg_c, u_c, d_c), True)):
            _defer_flame_twin(tag, tm, cfg, u, data.x, data, conv)
    print(f"phase 10b: {time.perf_counter() - t0:.1f} s", flush=True)

    # 10c: ch4global (the XK lane body in a flame)
    t0 = time.perf_counter()
    summary["10c"] = flame_ch4_phase(tms, reps, rows, runs)
    print(f"phase 10c: {time.perf_counter() - t0:.1f} s", flush=True)

    # 10d: the burner TGIV flame, and 10b's flame continued at 2 atm
    t0 = time.perf_counter()
    summary["10d"] = flame_burner_phase(fl, ref)
    print(f"phase 10d: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s", flush=True)
    return rows, runs, summary


def flame_ch4_phase(tms, reps, rows, runs):
    """Phase 10c: ch4global (fractional orders: K10/K11's XK lane body).
    The free flame of FLAME_CASES through FreelyPropagating must give the
    JAX package's outcome (JAX_FLAME_REFERENCE: it does not converge
    there); the burner-stabilized flame at the given temperature
    (BurnedStabilized_GivenTemperature, FLAME_CH4_BURNER), which the JAX
    package converges, must converge with the exit CO2 within 1 % of the
    JAX package's; K10/K11 XK against their twins at that path's
    initial, mid-solve and converged states (home ``10c_flame``)."""
    import numpy as np
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.mechanism import DATA_DIR
    from pychemkin_tpu_torch.models import BurnedStabilized_GivenTemperature
    cases = _port_cases()
    ref = cases.JAX_FLAME_REFERENCE["ch4global"]
    fl, _, launches, wall = _run_free_flame("ch4global", "10c")
    runs["10c_free"] = launches
    out = {"free": _flame_summary("10c ch4global free flame", fl, launches,
                                  wall)}
    assert out["free"]["converged"] == (ref["rc"] == 0), \
        f"10c: free flame converged {out['free']['converged']}, JAX rc {ref}"
    b = cases.FLAME_CH4_BURNER
    chem = ptt.Chemistry(chem=os.path.join(DATA_DIR, "ch4global.inp"),
                         tran=os.path.join(DATA_DIR, "tran_ch4.dat"))
    chem.preprocess()
    inlet = ptt.Stream(chem, label="fuel")
    inlet.pressure = P_ATM
    inlet.temperature = cases.FLAME_T_IN
    inlet.X = cases.FLAME_CASES["ch4global"]["recipe"]
    inlet.mass_flowrate = b["mdot"]
    inlet.flowarea = 1.0
    fb = BurnedStabilized_GivenTemperature(inlet)
    fb.start_position, fb.end_position = 0.0, b["x_end"]
    xs = np.linspace(0.0, b["x_end"], 25)
    fb.set_temperature_profile(xs, cases.flame_tprof(xs, b["T_burnt"]))
    fb.set_max_grid_points(b["ntot"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _FlameRecorder() as rec:
        rc = fb.run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    runs["10c_flame"] = launches
    s = out["burner"] = _flame_summary("10c ch4global burner TGIV", fb,
                                       launches, time.perf_counter() - t0)
    r_b = cases.JAX_FLAME_REFERENCE["ch4global_burner"]
    assert rc == 0 and s["converged"], "10c: the ch4global burner failed"
    sol = fb._solution
    iCO2 = list(chem.species_symbols).index("CO2")
    s.update(n_points_jax=r_b["n_points"], exit_Y_CO2=float(sol.Y[-1, iCO2]),
             exit_Y_CO2_jax=r_b["exit_Y_CO2"])
    # the outcome: both converge, the exit CO2 within 1 % (the port's
    # initial grid drops the reference's node one ulp from another,
    # ops/flame1d.py:_distinct, so the grids differ by that node)
    s["exit_Y_CO2_rel_jax"] = abs(s["exit_Y_CO2"] - r_b["exit_Y_CO2"]) / \
        r_b["exit_Y_CO2"]
    assert s["exit_Y_CO2_rel_jax"] <= 0.01, f"10c: {s}"
    assert launches["flame_jac_xk"] > 0 and launches["flame_residual_xk"] > 0
    tm = fb._effective_tm()
    st = {"initial": _state_of(*rec.calls[0]),
          "mid": _state_of(*rec.calls[len(rec.calls) // 2])}
    cfg_l, _, d_l = rec.calls[-1]
    if len(d_l.x) == len(sol.x):
        st["converged"] = _state_of(cfg_l, torch.as_tensor(
            sol.u, dtype=torch.float64, device="cuda"), d_l)
    with torch.inference_mode():
        rows.extend(_flame_kernel_rows(tm, "ch4global", st, reps,
                                       "10c_flame"))
    return out


def flame_burner_phase(fl_free, ref):
    """Phase 10d: the burner-stabilized TGIV flame of
    tests/test_flame1d.py:266 through BurnedStabilized_GivenTemperature
    (converges; exit H2O above 0.15, exit T above 1400 K, T at 0.6 cm
    within (298, 1500] K), and continuation() of 10b's free flame at
    FLAME_CNTN_P (converges; Su within 1 % of the JAX package's
    continuation)."""
    import numpy as np
    import torch
    import pychemkin_tpu_torch as ptt
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.models import BurnedStabilized_GivenTemperature
    cases = _port_cases()
    chem = fl_free.chemistry
    inlet = ptt.Stream(chem, label="fuel")
    inlet.pressure = P_ATM
    inlet.temperature = 298.0
    inlet.X = cases.FLAME_CASES["h2o2"]["recipe"]
    inlet.mass_flowrate = 0.03
    inlet.flowarea = 1.0
    fb = BurnedStabilized_GivenTemperature(inlet)
    fb.start_position, fb.end_position = 0.0, 1.2
    xs = np.linspace(0.0, 1.2, 25)
    fb.set_temperature_profile(xs, cases.flame_tprof(xs, 1500.0))
    fb.set_max_grid_points(40)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = fb.run()
    torch.cuda.synchronize()
    out = {"burner": _flame_summary("10d h2o2 burner TGIV", fb,
                                    dict(kernels.LAUNCHES),
                                    time.perf_counter() - t0)}
    assert rc == 0, "10d: the burner TGIV flame failed"
    h2o = fb.get_solution_variable_profile("H2O")
    T_exit = fb.get_solution_stream_at_grid(-1).temperature
    T_mid = fb.get_solution_stream(0.6).temperature
    out["burner"].update(exit_Y_H2O=float(h2o[-1]), exit_T=T_exit,
                         T_at_0p6=T_mid)
    assert h2o[-1] > 0.15 and T_exit > 1400.0 and 298.0 < T_mid <= 1500.0, \
        out["burner"]
    fl_free.pressure = cases.FLAME_CNTN_P
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = fl_free.continuation()
    torch.cuda.synchronize()
    c = out["continuation"] = _flame_summary(
        "10d continuation at 2 atm", fl_free, dict(kernels.LAUNCHES),
        time.perf_counter() - t0)
    assert rc == 0 and c["converged"], "10d: continuation failed"
    su_jax = ref["h2o2"]["cntn_su"]
    c.update(su_jax=su_jax,
             su_rel_jax=abs(c["flame_speed"] - su_jax) / su_jax)
    print(f"10d: Su at 2 atm {c['flame_speed']:.4f} cm/s (JAX {su_jax:.4f}"
          f", rel {c['su_rel_jax']:.2e})", flush=True)
    assert c["su_rel_jax"] <= 0.01, f"10d: continuation Su {c}"
    return out


def _launch_name_of(mangled):
    import re
    from pychemkin_tpu_torch.kernels import launch_name
    b = r"ELb([01])"
    m = re.search(r"chem_kernelILb([01])ELi(\d)" + 3 * b + "E", mangled)
    if m:
        return launch_name("rhs_jac" if m.group(1) == "1" else "rhs",
                           _CODES[int(m.group(2))], xk=m.group(3) == "1",
                           prf=m.group(4) == "1", gm=m.group(5) == "1")
    m = re.search(r"sdirk_round_kernelILi(\d)" + 5 * b + "E", mangled)
    if m:
        return launch_name("sdirk_round", _CODES[int(m.group(1))],
                           m.group(2) == "1", m.group(3) == "1",
                           m.group(4) == "1", prf=m.group(5) == "1",
                           gm=m.group(6) == "1")
    m = re.search(r"gershgorin_kernelILi(\d)" + 3 * b + "E", mangled)
    if m:
        return launch_name("gershgorin_rate", _CODES[int(m.group(1))],
                           xk=m.group(2) == "1", prf=m.group(3) == "1",
                           gm=m.group(4) == "1")
    m = re.search(r"psr_kernelILb([01])" + 2 * b + "E", mangled)
    if m:
        return launch_name("psr_solve", xk=m.group(1) == "1",
                           fault=m.group(2) == "1", gm=m.group(3) == "1")
    m = re.search(r"equil_kernelILb([01])" + b + "E", mangled)
    if m:
        return launch_name("equil_solve", fault=m.group(1) == "1",
                           gm=m.group(2) == "1")
    m = re.search(r"(bordered_factor|bordered_solve)_kernelILb([01])E",
                  mangled)
    if m:
        return launch_name(m.group(1), gm=m.group(2) == "1")
    m = re.search(r"flame_kernelILb([01])ELb([01])E", mangled)
    if m:
        return launch_name("flame_jac" if m.group(1) == "1"
                           else "flame_residual", xk=m.group(2) == "1")
    if "transport_kernel" in mangled:
        return "transport_props"
    if "block_thomas_kernel" in mangled:
        return "block_thomas"
    return None


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--t-end", type=float, default=0.05)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--phases", choices=("all", "7", "7f", "8", "9", "10"),
                    default="all",
                    help="'7': the build, phase 3's CONP sweep (7e's "
                    "reference) and phase 7 only, for a quick check; '7f', "
                    "'8', '9', '10': the build and that phase only (8 with "
                    "phase 3's CONP sweep, its bitwise reference)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pychemkin_tpu_torch.kernels import build
    from pychemkin_tpu_torch.mechanism import (TorchMechanism, load_embedded,
                                               load_mechanism_from_strings)

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({build.BUILD_INFO.get('path')})", flush=True)
    ptxas = {_launch_name_of(fn): info for fn, info in _build_report().items()
             if "registers" in info and _launch_name_of(fn)}
    for name, info in sorted(ptxas.items()):
        print(f"  ptxas {name}: {info}", flush=True)
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if "error" in line or "warning" in line:
            print("  " + line.strip(), flush=True)
    build.library()

    torch.backends.cuda.matmul.allow_tf32 = False
    B, reps = args.batch, args.reps
    tm = TorchMechanism(load_embedded("grisyn"), "cuda")
    tm_h = TorchMechanism(load_embedded("h2o2"), "cuda")
    tms = {"grisyn": tm, "h2o2": tm_h,
           "ch4global": TorchMechanism(load_embedded("ch4global"), "cuda"),
           "h2o2_plog": TorchMechanism(
               load_mechanism_from_strings(h2o2_plog_text()), "cuda")}
    phase = args.phases
    if phase == "all":
        rows, launches, summaries, sweeps6, rescue, map_summary, steady, base = \
            phases_2_to_6(tm, tm_h, tms, B, reps, args.t_end)
    else:
        rows, launches, summaries, sweeps6 = [], {}, [], []
        rescue = map_summary = steady = base = None
        if phase in ("7", "8"):
            runs, summary, base = sweep_phase(tm, "CONP", P_ATM, B,
                                              args.t_end, host_loop=False)
            summaries.append(summary)
            launches.update(runs)

    serving = {}
    if phase in ("all", "7"):
        t7 = time.perf_counter()
        with torch.inference_mode():
            k8_rows, runs = check_k8(tms, B, max(reps // 4, 2))
        rows.extend(k8_rows)
        launches.update(runs)
        print(f"phase 7a: {time.perf_counter() - t7:.1f} s", flush=True)
        for key, fn, fargs in (("grisyn", serve_phase, (tm,)),
                               ("h2o2_psr", serve_psr_phase, (tm_h,)),
                               ("fault", fault_phase, (tm,)),
                               ("compacted", compacted_phase,
                                (tm, B, args.t_end, base))):
            runs, serving[key] = fn(*fargs)
            launches.update(runs)
        print(f"phase 7: {time.perf_counter() - t7:.1f} s", flush=True)
    if phase in ("all", "7f"):
        t7 = time.perf_counter()
        runs, serving["steady_faults"], f_rows = steady_fault_phase(
            tm, tm_h, max(reps // 4, 2))
        launches.update(runs)
        rows.extend(f_rows)
        print(f"phase 7f: {time.perf_counter() - t7:.1f} s", flush=True)
    batch = None
    if phase in ("all", "8"):
        t8 = time.perf_counter()
        from pychemkin_tpu_torch.ops.reactors import variant
        reference = {}
        for s in summaries + sweeps6:
            if s.get("mech") == "grisyn" and "energy" in s:
                reference.setdefault(variant(s["problem"], s["energy"]), s)
        runs, batch, b_rows = solve_batch_phase(tm, B, base, reference,
                                                max(reps // 4, 2), args.t_end)
        launches.update(runs)
        rows.extend(b_rows)
        print(f"phase 8: {time.perf_counter() - t8:.1f} s", flush=True)
    big = None
    if phase in ("all", "9"):
        t9 = time.perf_counter()
        cases = _port_cases()
        tm_big = TorchMechanism(load_mechanism_from_strings(
            cases.synthetic_mechanism_text(BIG_COPIES)), "cuda")
        runs, big, g_rows = large_mech_phase(tm_big, reps)
        launches.update(runs)
        rows.extend(g_rows)
        print(f"phase 9: {time.perf_counter() - t9:.1f} s", flush=True)
    flame = None
    if phase in ("all", "10"):
        f_rows, runs, flame = flame_phase(tms, reps)
        launches.update(runs)
        rows.extend(f_rows)

    twin_wall = run_twin_jobs()
    print(f"twin reruns: {twin_wall:.1f} s in parallel processes", flush=True)
    for row in rows:
        row["launches"] = launches[row["home"]][row["name"]]
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in launches.items()
                                   if c.get(row["name"])}
        row["ptxas"] = ptxas.get(row["name"])
        assert row["launches"] > 0, \
            f"{row['name']} ({row['mech']}) not launched on {row['home']}"
    unchecked = sorted(n for c in launches.values() for n, v in c.items()
                       if v and n not in {r["name"] for r in rows})
    assert phase != "all" or not unchecked, \
        f"launched without a check: {unchecked}"
    smi = _nvidia_smi()
    print(json.dumps({"sweeps": summaries, "sweeps_phase6": sweeps6,
                      "rescue": rescue, "psr_map": map_summary,
                      "steady_checks": steady, "serving": serving,
                      "solve_batch": batch, "large_mechanism": big,
                      "flame": flame,
                      "twin_checks": _TWIN_RESULTS, "twin_wall_s": twin_wall,
                      "build_s": build.BUILD_INFO.get("seconds"),
                      "card": smi,
                      "script_s": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
