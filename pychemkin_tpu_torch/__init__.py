"""PyTorch/CUDA port of pychemkin_tpu.

Batched paths run on an NVIDIA GPU through hand-written CUDA kernels
(:mod:`pychemkin_tpu_torch.kernels`): the ignition-delay sweep of the
four batch reactors (CONP/CONV x ENRG/TGIV), with the rescue ladder
around it (:func:`resilient_ignition_sweep`); the general batch
integrator :func:`solve_batch` (P(t), V(t) and T(t) profiles, wall heat
loss, an output grid); chemical equilibrium (all nine options) and the
PSR steady state; mixture-averaged transport and the premixed laminar
flame (:mod:`.models`: ``FreelyPropagating`` and the burner-stabilized
flames over ``Chemistry``, ``Mixture`` and ``Stream``); every kernel has a
plain PyTorch twin in :mod:`pychemkin_tpu_torch.ops` that the CPU path
uses.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from . import constants, models
from .chemistry import (Chemistry, chemkin_version, done, set_verbose,
                        verbose)
from .constants import (AVOGADRO, BOLTZMANN, ERGS_PER_CALORIE,
                        ERGS_PER_JOULE, JOULES_PER_CALORIE, P_ATM, P_TORRS,
                        R_GAS, R_GAS_CAL, Air, air, water_heat_vaporization)
from .inlet import (Stream, adiabatic_mixing_streams, clone_stream,
                    compare_streams, create_stream_from_mixture)
from .mechanism import TorchMechanism, load_embedded, load_mechanism
from .mixture import (Mixture, adiabatic_mixing, calculate_equilibrium,
                      calculate_mixture_temperature_from_enthalpy,
                      compare_mixtures, detonation, equilibrium,
                      interpolate_mixtures, isothermal_mixing)
from .ops.equilibrium import equilibrate
from .ops.psr import solve_psr
from .ops.reactors import (BatchArgs, BatchSolution, Profile,
                           ignition_delay_sweep, solve_batch)
from .resilience import (DEFAULT_LADDER, FaultSpec, SolveStatus,
                         resilient_ignition_sweep)

__all__ = ["AVOGADRO", "Air", "BOLTZMANN", "BatchArgs", "BatchSolution",
           "Chemistry", "DEFAULT_LADDER", "ERGS_PER_CALORIE",
           "ERGS_PER_JOULE", "FaultSpec", "JOULES_PER_CALORIE", "Mixture",
           "P_ATM", "P_TORRS", "Profile", "R_GAS", "R_GAS_CAL",
           "SolveStatus", "Stream", "TorchMechanism", "adiabatic_mixing",
           "adiabatic_mixing_streams", "air", "calculate_equilibrium",
           "calculate_mixture_temperature_from_enthalpy", "chemkin_version",
           "clone_stream", "compare_mixtures", "compare_streams", "constants",
           "create_stream_from_mixture", "detonation", "done", "equilibrate",
           "equilibrium", "ignition_delay_sweep", "interpolate_mixtures",
           "isothermal_mixing", "load_embedded", "load_mechanism", "models",
           "resilient_ignition_sweep", "set_verbose", "solve_batch",
           "solve_psr", "verbose", "water_heat_vaporization"]
