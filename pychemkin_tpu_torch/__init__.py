"""PyTorch/CUDA port of pychemkin_tpu.

Three batched paths run on an NVIDIA GPU through hand-written CUDA
kernels (:mod:`pychemkin_tpu_torch.kernels`): the ignition-delay sweep
(CONP/ENRG and CONV/ENRG), chemical equilibrium (all nine options) and
the PSR steady state; every kernel has a plain PyTorch twin in
:mod:`pychemkin_tpu_torch.ops` that the CPU path uses.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .mechanism import TorchMechanism, load_embedded, load_mechanism
from .ops.equilibrium import equilibrate
from .ops.psr import solve_psr
from .ops.reactors import ignition_delay_sweep
from .resilience.status import SolveStatus

__all__ = ["SolveStatus", "TorchMechanism", "equilibrate",
           "ignition_delay_sweep", "load_embedded", "load_mechanism",
           "solve_psr"]
