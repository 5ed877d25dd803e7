#!/usr/bin/env python3
"""Time the port's main path in two source trees on one card, in turns.

``python3 chip_compare.py DIR_A DIR_B`` runs, for DIR_A, DIR_B, DIR_B,
DIR_A in that order, one child process that imports
``pychemkin_tpu_torch`` and ``chip_smoke`` from that tree (building its
kernels there at first use) and measures:

- the grisyn CONP/ENRG ignition-delay sweep of ``chip_smoke.py`` phase 3
  (B=4096, T0 1000-1400 K, 1 atm, stoichiometric H2/air, t_end 0.05 s):
  wall, ignitions/s, attempt and Newton totals;
- K5's mean time per launch of 20 attempts at 256 lanes from the sweep's
  start state (CUDA events, 10 launches after one warm-up);
- the registers and spills ptxas reported for K5's CONP and CONV
  instantiations without pivoting, faults, PLOG rows, profiles or the
  device-memory workspace.

Each child prints one ``RESULT {...}`` line; the parent prints the card's
name and power limit first. Comparing two trees only within one call of
this script keeps the card and its power limit the same for both. Needs
one CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def child(tree):
    import re
    import time

    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs
    from pychemkin_tpu_torch import kernels
    from pychemkin_tpu_torch.kernels import build
    from pychemkin_tpu_torch.mechanism import TorchMechanism, load_embedded
    from pychemkin_tpu_torch.ops import reactors

    build.build()
    ptxas = {}
    for fn, info in cs._build_report().items():
        # the default instantiation: every flag after PROB false (three
        # flags before the PRF and GM ones existed, five since)
        m = re.search(r"sdirk_round_kernelILi([01])E(?:Lb0E)*E", fn)
        if m and "registers" in info:
            ptxas["CONP" if m.group(1) == "0" else "CONV"] = info
    tm = TorchMechanism(load_embedded("grisyn"), "cuda")
    T0 = np.linspace(1000.0, 1400.0, 4096)
    Y0 = cs._stoich_Y(tm)
    reactors.ignition_delay_sweep(tm, "CONP", "ENRG", T0[:8], cs.P_ATM, Y0,
                                  0.05, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = reactors.ignition_delay_sweep(tm, "CONP", "ENRG", T0, cs.P_ATM, Y0,
                                        0.05, device="cuda", profile=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    lanes, _, s0 = cs._sweep_start(tm, "CONP", cs.P_ATM, 256, 0.05,
                                   "T_inflection")
    kw = dict(rtol=1e-6, budget=20_000, max_attempts=20, event_mode=0,
              problem="CONP")
    starts = [cs._clone(s0) for _ in range(11)]
    with torch.inference_mode():
        kernels.sdirk_round(tm, lanes, starts[-1], **kw)
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(10)]
        for (e0, e1), s in zip(ev, starts):
            e0.record()
            kernels.sdirk_round(tm, lanes, s, **kw)
            e1.record()
        torch.cuda.synchronize()
    prof = out[3]
    print("RESULT " + json.dumps(dict(
        tree=tree, wall_s=wall, ignitions_per_s=4096 / wall,
        attempts=int((prof["n_steps"] + prof["n_rejected"]).sum()),
        newton=int(prof["n_newton"].sum()),
        k5_ms=float(np.mean([a.elapsed_time(b) for a, b in ev])),
        k5_ptxas=ptxas)), flush=True)


def main(argv):
    if len(argv) == 3 and argv[1] == "--child":
        child(argv[2])
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    a, b = os.path.abspath(argv[1]), os.path.abspath(argv[2])
    for tree in (a, b, b, a):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child", tree], cwd=tree).returncode
        if rc != 0:
            print(f"chip_compare: the child for {tree} failed (rc {rc})",
                  file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
