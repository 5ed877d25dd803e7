"""Steady-state solver controls (mixin).

The port's copy of the JAX package's ``models/steadystatesolver.py``: the
damped-Newton and pseudo-transient control parameters with the
reference's defaults, which parameterize the flame solver
(:func:`pychemkin_tpu_torch.ops.flame1d.solve_flame`) directly. Setter
names and keyword spellings are the reference's.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union


class SteadyStateSolver:
    """Mixin holding steady-state solver control parameters
    (reference: steadystatesolver.py:35)."""

    def __init__(self):
        # steady-state search (reference defaults :40-67)
        self.SSabsolute_tolerance = 1.0e-9
        self.SSrelative_tolerance = 1.0e-4
        self.SSmaxiteration = 100
        self.SSJacobianage = 20
        self.maxpseudotransient = 100
        self.numbinitialpseudosteps = 0
        self.maxTbound = 5000.0
        self.speciesfloor = -1.0e-14
        self.species_positive = 0.0
        self.use_legacy_technique = False
        self.SSdamping = 1
        self.absolute_perturbation = 0.0
        self.relative_perturbation = 0.0
        # pseudo-transient stepping (reference defaults :69-95)
        self.TRabsolute_tolerance = 1.0e-9
        self.TRrelative_tolerance = 1.0e-4
        self.TRmaxiteration = 25
        self.timestepsizeage = 25
        self.TRminstepsize = 1.0e-10
        self.TRmaxstepsize = 1.0e-2
        self.TRupfactor = 2.0
        self.TRdownfactor = 2.2
        self.TRJacobianage = 20
        self.TRstride_fixT = 1.0e-6
        self.TRnumbsteps_fixT = 100
        self.TRstride_ENRG = 1.0e-6
        self.TRnumbsteps_ENRG = 100
        self.print_level = 1
        self.SSsolverkeywords: Dict[str, Union[int, float, str, bool]] = {}

    # --- tolerance properties (reference: :102-194) ------------------------
    @property
    def steady_state_tolerances(self) -> Tuple[float, float]:
        return self.SSabsolute_tolerance, self.SSrelative_tolerance

    @steady_state_tolerances.setter
    def steady_state_tolerances(self, tolerances: Tuple[float, float]):
        atol, rtol = tolerances
        if atol <= 0.0 or rtol <= 0.0:
            raise ValueError("tolerances must be positive")
        self.SSabsolute_tolerance = float(atol)
        self.SSrelative_tolerance = float(rtol)
        self.SSsolverkeywords["ATOL"] = float(atol)
        self.SSsolverkeywords["RTOL"] = float(rtol)

    @property
    def time_stepping_tolerances(self) -> Tuple[float, float]:
        return self.TRabsolute_tolerance, self.TRrelative_tolerance

    @time_stepping_tolerances.setter
    def time_stepping_tolerances(self, tolerances: Tuple[float, float]):
        atol, rtol = tolerances
        if atol <= 0.0 or rtol <= 0.0:
            raise ValueError("tolerances must be positive")
        self.TRabsolute_tolerance = float(atol)
        self.TRrelative_tolerance = float(rtol)
        self.SSsolverkeywords["ATIM"] = float(atol)
        self.SSsolverkeywords["RTIM"] = float(rtol)

    # --- iteration/continuation controls (reference: :195-263) -------------
    def set_max_pseudo_transient_call(self, maxtime: int):
        self.maxpseudotransient = int(maxtime)
        self.SSsolverkeywords["MAXTIME"] = int(maxtime)

    def set_max_timestep_iteration(self, maxiteration: int):
        self.TRmaxiteration = int(maxiteration)
        self.SSsolverkeywords["TRMI"] = int(maxiteration)

    def set_max_search_iteration(self, maxiteration: int):
        self.SSmaxiteration = int(maxiteration)
        self.SSsolverkeywords["SSMI"] = int(maxiteration)

    def set_initial_timesteps(self, initsteps: int):
        self.numbinitialpseudosteps = int(initsteps)
        self.SSsolverkeywords["NINIT"] = int(initsteps)

    # --- bounds (reference: :265-315) --------------------------------------
    def set_species_floor(self, floor_value: float):
        self.speciesfloor = float(floor_value)
        self.SSsolverkeywords["SFLR"] = float(floor_value)

    def set_temperature_ceiling(self, ceilingvalue: float):
        if ceilingvalue <= 0.0:
            raise ValueError("temperature ceiling must be positive")
        self.maxTbound = float(ceilingvalue)
        self.SSsolverkeywords["TMAX"] = float(ceilingvalue)

    def set_species_reset_value(self, resetvalue: float):
        self.species_positive = float(resetvalue)
        self.SSsolverkeywords["SPOS"] = float(resetvalue)

    # --- pseudo-timestep sizing (reference: :317-400) ----------------------
    def set_max_pseudo_timestep_size(self, dtmax: float):
        self.TRmaxstepsize = float(dtmax)
        self.SSsolverkeywords["DTMX"] = float(dtmax)

    def set_min_pseudo_timestep_size(self, dtmin: float):
        self.TRminstepsize = float(dtmin)
        self.SSsolverkeywords["DTMN"] = float(dtmin)

    def set_pseudo_timestep_age(self, age: int):
        self.timestepsizeage = int(age)
        self.SSsolverkeywords["STPAGE"] = int(age)

    def set_Jacobian_age(self, age: int):
        self.SSJacobianage = int(age)
        self.SSsolverkeywords["NJAC"] = int(age)

    def set_pseudo_Jacobian_age(self, age: int):
        self.TRJacobianage = int(age)
        self.SSsolverkeywords["TJAC"] = int(age)

    # --- options (reference: :402-483) -------------------------------------
    def set_damping_option(self, ON: bool):
        self.SSdamping = 1 if ON else 0
        self.SSsolverkeywords["DAMP"] = bool(ON)

    def set_legacy_option(self, ON: bool):
        self.use_legacy_technique = bool(ON)

    def set_print_level(self, level: int):
        self.print_level = int(max(0, min(2, level)))
        self.SSsolverkeywords["PRNT"] = self.print_level

    def set_pseudo_timestepping_parameters(self, energymode: bool,
                                           numbsteps: int, stride: float):
        """Initial stride/steps per pseudo-transient call (reference:
        :458; separate settings for ENRG and fixed-T problems)."""
        if energymode:
            self.TRnumbsteps_ENRG = int(numbsteps)
            self.TRstride_ENRG = float(stride)
        else:
            self.TRnumbsteps_fixT = int(numbsteps)
            self.TRstride_fixT = float(stride)
        self.SSsolverkeywords["TIME" if not energymode else "TIM2"] = (
            int(numbsteps), float(stride))


    def set_SSsolver_keywords(self):
        """Mirror the accumulated steady-state solver parameters into
        the model's keyword table (reference flame.py:245 /
        PSR.py keyword marshalling; here the typed solve consumes the
        attributes directly, so this keeps decks and
        createkeywordinputlines in sync)."""
        for k, v in self.SSsolverkeywords.items():
            self._record_keyword(k, v)
