"""Generic steady-state 1-D flame model base (reference flame.py:37).

The port's copy of the JAX package's ``models/flame.py``: ``Flame``
combines the reactor-model keyword machinery, the steady-state solver
controls and the 1-D grid controls (the reference's
``Flame(ReactorModel, SteadyStateSolver, Grid)`` mixin stack) and holds
the transport-model, differencing and boundary-type selections that the
flame solver (:mod:`pychemkin_tpu_torch.ops.flame1d`) consumes. The
multicomponent (MULT) transport is not ported: selecting it raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..inlet import Stream
from ..logger import logger
from .grid import Grid
from .reactormodel import ReactorModel
from .steadystatesolver import SteadyStateSolver


class Flame(ReactorModel, SteadyStateSolver, Grid):
    """Generic steady-state, one-dimensional flame model
    (reference flame.py:37-117)."""

    def __init__(self, fuelstream: Stream, label: str):
        if not isinstance(fuelstream, Stream):
            raise TypeError("the first argument must be a Stream object.")
        ReactorModel.__init__(self, fuelstream, label)
        if not self.chemistry.verify_transport_data():
            # transport property data is required by the flame models
            # (reference flame.py:64-69)
            raise ValueError(
                "transport properties are required by flame models; "
                "load the mechanism with transport data")
        SteadyStateSolver.__init__(self)
        Grid.__init__(self)
        self.mass_flow_rate = fuelstream.mass_flowrate
        self.temp_profile_set = False
        self.grid_T_profile = False
        self.EnergyTypes = {"ENERGY": 1, "GivenT": 2}
        self._energytype = 1
        # transport mode: 0 not set, 1 mixture-averaged, 2 multicomponent,
        # 3 fixed Lewis number (reference flame.py:92 + :257-304)
        self.transport_mode = 0
        self._lewis = 1.0
        self._thermal_diffusion = False
        self._upwind = True                  # WDIF default (flame.py:134)
        self._species_flux_bc = True         # FLUX default
        self._numbsolutionpoints = 0
        self._temp_profile: Optional[tuple] = None

    # --- temperature profile (reference flame.py:100-130) -----------------

    def set_temperature_profile(self, x, temp) -> int:
        """Specify a temperature profile TPRO (reference flame.py:100).
        Required for the given-temperature flame models; for energy-
        equation models it seeds the initial temperature estimate
        (unless the automatic equilibrium estimate TPROF is on)."""
        x = np.asarray(x, dtype=np.float64)
        temp = np.asarray(temp, dtype=np.float64)
        if x.shape != temp.shape or x.ndim != 1 or x.size < 2:
            logger.error("temperature profile needs matching 1-D arrays")
            return 1
        if not np.all(np.diff(x) > 0):
            logger.error("profile positions must be strictly increasing")
            return 1
        self.setprofile("TPRO", x, temp)
        self._temp_profile = (x, temp)
        self.temp_profile_set = True
        return 0

    def temperature_profile_fn(self):
        """The TPRO data as a callable T(x) (clamped linear interp)."""
        if self._temp_profile is None:
            return None
        x, temp = self._temp_profile
        return lambda xi: float(np.interp(xi, x, temp))

    def use_temp_profile_initial_mesh(self, on: bool = False):
        """Use the TPRO grid points as the initial mesh
        (reference flame.py:122 USE_TPRO_GRID)."""
        self.grid_T_profile = bool(on)

    # --- differencing (reference flame.py:134-152) -------------------------

    # reference flame.py:122 spells the method with a typo; keep the
    # misspelled alias so reference scripts run unchanged
    use_temp_profiel_initial_mesh = None  # assigned after class body

    def set_mesh_keywords(self) -> int:
        """Mirror the Grid mixin's mesh parameters into the keyword
        table (reference flame.py:154); the typed solve reads the
        attributes directly."""
        for key, val in (("NPTS", self.numb_grid_points),
                         ("NTOT", self.max_numb_grid_points),
                         ("NADP", self.max_numb_adapt_points),
                         ("GRAD", self.gradient),
                         ("CURV", self.curvature),
                         ("XSTR", self.starting_x),
                         ("XEND", self.ending_x)):
            if val is not None:
                self._record_keyword(key, val)
        return 0

    def set_convection_differencing_type(self, mode: str):
        """'central' (CDIF) or 'upwind' (WDIF, default)."""
        mode = mode.lower()
        if mode.startswith("c"):
            self._upwind = False
            self.removekeyword("WDIF")
            self.setkeyword("CDIF", True)
        elif mode.startswith("u") or mode.startswith("w"):
            self._upwind = True
            self.removekeyword("CDIF")
            self.setkeyword("WDIF", True)
        else:
            logger.error("differencing mode must be 'central' or 'upwind'")

    # --- transport models (reference flame.py:257-318) ---------------------

    _TRANSPORT_KEYS = ("MIX", "MULT", "LEWIS")

    def _set_transport_keyword(self, key, value=True):
        for k in self._TRANSPORT_KEYS:
            if k != key:
                self.removekeyword(k)
        self.setkeyword(key, value)

    def use_mixture_averaged_transport(self):
        """MIX (reference flame.py:257)."""
        self.transport_mode = 1
        self._set_transport_keyword("MIX")

    def use_multicomponent_transport(self):
        """MULT (reference flame.py:267): the Stefan-Maxwell solve at every
        grid face is not ported; raises NotImplementedError."""
        from ..ops.flame1d import MULT_TODO
        raise NotImplementedError(MULT_TODO)

    def use_fixed_Lewis_number_transport(self, Lewis: float = 1.0):
        """LEWIS (reference flame.py:279)."""
        if Lewis <= 0:
            logger.error("Lewis number must be positive")
            return
        self.transport_mode = 3
        self._lewis = float(Lewis)
        self._set_transport_keyword("LEWIS", float(Lewis))

    def use_thermal_diffusion(self, mode: bool = True):
        """TDIF — include the Soret term (reference flame.py:305)."""
        self._thermal_diffusion = bool(mode)
        self.setkeyword("TDIF", bool(mode))

    # --- species boundary types (reference flame.py:319-344) ---------------

    def set_species_boundary_types(self, mode: str = "comp"):
        """'comp' (fixed inlet composition) or 'flux' (flux balance,
        default in this build — reference flame.py:319)."""
        mode = mode.lower()
        if mode.startswith("c"):
            self._species_flux_bc = False
            self.removekeyword("FLUX")
            self.setkeyword("COMP", True)
        elif mode.startswith("f"):
            self._species_flux_bc = True
            self.removekeyword("COMP")
            self.setkeyword("FLUX", True)
        else:
            logger.error("species boundary mode must be 'comp' or 'flux'")

    # --- solver-core option assembly ---------------------------------------

    def _transport_model_name(self) -> str:
        return {2: "MULT", 3: "LEWIS"}.get(self.transport_mode, "MIX")

    def _flame_solver_options(self) -> dict:
        """Options dict for ops.flame1d.solve_flame shared by every
        concrete flame model (the port's flame1d.solve_flame takes the
        same keywords)."""
        return dict(
            upwind=self._upwind,
            transport_model=self._transport_model_name(),
            lewis=self._lewis,
            soret=self._thermal_diffusion,
            species_flux_bc=self._species_flux_bc,
            ss_atol=float(self.SSabsolute_tolerance),
            ss_rtol=float(self.SSrelative_tolerance),
            ts_dt=float(self.TRstride_ENRG),
            grad=self.gradient, curv=self.curvature,
            nadp=self.max_numb_adapt_points,
            ntot=self.max_numb_grid_points,
            n_initial=max(self.numb_grid_points, 2),
        )


Flame.use_temp_profiel_initial_mesh = Flame.use_temp_profile_initial_mesh
