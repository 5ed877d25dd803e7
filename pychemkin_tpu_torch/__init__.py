"""PyTorch/CUDA port of pychemkin_tpu.

Batched paths run on an NVIDIA GPU through hand-written CUDA kernels
(:mod:`pychemkin_tpu_torch.kernels`): the ignition-delay sweep of the
four batch reactors (CONP/CONV x ENRG/TGIV), with the rescue ladder
around it (:func:`resilient_ignition_sweep`); the general batch
integrator :func:`solve_batch` (P(t), V(t) and T(t) profiles, wall heat
loss, an output grid); chemical equilibrium (all nine options) and the
PSR steady state; every kernel has a plain PyTorch twin in
:mod:`pychemkin_tpu_torch.ops` that the CPU path uses.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .mechanism import TorchMechanism, load_embedded, load_mechanism
from .ops.equilibrium import equilibrate
from .ops.psr import solve_psr
from .ops.reactors import (BatchArgs, BatchSolution, Profile,
                           ignition_delay_sweep, solve_batch)
from .resilience import (DEFAULT_LADDER, FaultSpec, SolveStatus,
                         resilient_ignition_sweep)

__all__ = ["BatchArgs", "BatchSolution", "DEFAULT_LADDER", "FaultSpec",
           "Profile", "SolveStatus", "TorchMechanism", "equilibrate",
           "ignition_delay_sweep", "load_embedded", "load_mechanism",
           "resilient_ignition_sweep", "solve_batch", "solve_psr"]
