"""Premixed laminar flame models (reference premixedflames/premixedflame.py).

The port's copy of the JAX package's ``models/premixedflame.py``:
``PremixedFlame`` drives the port's flame solver
(:func:`pychemkin_tpu_torch.ops.flame1d.solve_flame`, kernels K9-K12 and
K6 on the card) on the chemistry's device, where the reference blocks in
``KINPremix_CalculateFlame`` (premixedflame.py:208-229). Concrete
models:

- ``BurnedStabilized_GivenTemperature``  (premixedflame.py:858) — known
  mass flux, temperature profile imposed (TGIV).
- ``BurnedStabilized_EnergyEquation``    (premixedflame.py:877) — known
  mass flux, energy equation solved.
- ``FreelyPropagating``                  (premixedflame.py:920) — mass
  flux is the flame-speed eigenvalue; ``get_flame_speed`` returns
  Su = mdot / rho_unburnt in cm/s (premixedflame.py:605,1004).

(The reference class names spell "BurnedStabilized"; the physical
configuration is the burner-stabilized flame.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..inlet import Stream, create_stream_from_mixture
from ..logger import logger
from ..mixture import Mixture
from ..ops import flame1d
from .flame import Flame
from .reactormodel import STATUS_FAILED, STATUS_NOT_RUN, STATUS_SUCCESS


class PremixedFlame(Flame):
    """Premixed 1-D flame base (reference premixedflame.py:49)."""

    def __init__(self, inlet: Stream, label: Optional[str] = None):
        if not isinstance(inlet, Stream):
            raise TypeError("the first argument must be a Stream object.")
        if label is None:
            label = "premixedflame"
        # unity flow area makes mass flow rate == mass flux
        # (reference premixedflame.py:63-64)
        if inlet.flowarea <= 0.0:
            inlet.flowarea = 1.0
        super().__init__(inlet, label)
        self._inlet = inlet
        self._final_mass_flow_rate = -1.0
        self.flamespeed = -1.0
        self._solution: Optional[flame1d.FlameSolution] = None
        self._free_flame = False
        self._pinned_T = 400.0
        self._skip_fixed_T = False
        self._auto_T_profile = False
        self._raw_ok = False

    def set_inlet(self, extinlet: Stream):
        """Premixed flame models allow only ONE inlet stream
        (reference premixedflame.py:72-89)."""
        raise ValueError(
            "Premixed flame models do NOT allow a second inlet stream.")

    def unburnt_temperature(self, temperature: float):
        """TUNB (reference premixedflame.py:91)."""
        if temperature <= 200.0:
            logger.error("invalid temperature value.")
            return
        self.temperature = temperature
        self.setkeyword("TUNB", temperature)

    @property
    def mass_flux(self) -> float:
        """Inlet mass flux [g/cm^2-s] = mass flow rate / flow area."""
        return self.mass_flow_rate / self._inlet.flowarea

    # ------------------------------------------------------------------

    def _domain(self):
        if self.ending_x <= self.starting_x:
            raise ValueError(
                "set the domain first: flame.start_position / "
                "flame.end_position (XSTR/XEND)")
        return self.starting_x, self.ending_x

    def _solve(self, energy: str, free_flame: bool, u0=None, x0=None):
        x_start, x_end = self._domain()
        opts = self._flame_solver_options()
        T_fn = self.temperature_profile_fn()
        if energy == "TGIV" and T_fn is None:
            raise ValueError("given-temperature flame needs "
                             "set_temperature_profile (TPRO)")
        xcen = (self.reaction_zone_center_x
                if self.reaction_zone_center_x > x_start else None)
        wmix = (self.reaction_zone_width
                if self.reaction_zone_width > 0 else None)
        if free_flame:
            mdot = None
        else:
            # read the LIVE stream flow (it may have been set after
            # construction); burner flames need a positive mass flux
            self.mass_flow_rate = self._inlet.mass_flowrate
            mdot = self.mass_flux
            if not mdot > 0.0:
                raise ValueError(
                    "burner-stabilized flames need a positive inlet "
                    "mass flow rate (set inlet.mass_flowrate)")
        # explicit initial mesh: the Grid mixin's GRID profile wins;
        # otherwise optionally the TPRO grid (USE_TPRO_GRID)
        x_init = None
        if self.numb_grid_profile >= 2:
            x_init = np.asarray(self.grid_profile)
        elif self.grid_T_profile and self._temp_profile is not None:
            x_init = np.asarray(self._temp_profile[0])
        sol = flame1d.solve_flame(
            self._effective_tm(),
            P=self.pressure, T_in=self.temperature,
            Y_in=np.asarray(self.Y),
            x_start=x_start, x_end=x_end, energy=energy,
            free_flame=free_flame, mdot=mdot,
            T_fix=self._pinned_T,
            su_guess=40.0,
            T_given_fn=T_fn if energy == "TGIV" else None,
            T_init_fn=(T_fn if (energy == "ENRG"
                                and not self._auto_T_profile) else None),
            x_init=x_init,
            xcen=xcen, wmix=wmix,
            skip_fixed_T=self._skip_fixed_T,
            u0=u0, x0=x0,
            **opts)
        return sol

    def run(self) -> int:
        """Run the flame simulation (reference premixedflame.py:334).
        Returns 0 on success."""
        self._free_flame = getattr(self, "_is_free", False)
        energy = "TGIV" if self._energytype == 2 else "ENRG"
        sol = self._solve(energy, self._free_flame)
        self._solution = sol
        self._raw_ok = False
        self._record_solve(success=bool(sol.converged),
                           flame_speed=(float(sol.flame_speed)
                                        if sol.converged else None),
                           **(sol.report or {}))
        if sol.converged:
            self.runstatus = STATUS_SUCCESS
            self._numbsolutionpoints = sol.n_points
            self._final_mass_flow_rate = sol.mdot * self._inlet.flowarea
            return 0
        self.runstatus = STATUS_FAILED
        logger.error("flame simulation failed to converge")
        return 1

    def continuation(self) -> int:
        """Continuation run restarting from the previous solution
        (reference premixedflame.py:430, CNTN keyword) — typically after
        changing pressure/composition/grid controls."""
        if self.runstatus == STATUS_NOT_RUN:
            logger.warning("please run the flame simulation first.")
            return 1
        if self.runstatus != STATUS_SUCCESS or self._solution is None:
            logger.error("previous simulation failed; fix and rerun")
            return 1
        prev = self._solution
        energy = "TGIV" if self._energytype == 2 else "ENRG"
        u0 = np.concatenate([np.asarray(prev.T)[:, None],
                             np.full((prev.x.shape[0], 1), prev.mdot),
                             np.asarray(prev.Y)], axis=1)
        sol = self._solve(energy, self._free_flame, u0=u0, x0=prev.x)
        self._solution = sol
        self._raw_ok = False
        if sol.converged:
            self.runstatus = STATUS_SUCCESS
            self._numbsolutionpoints = sol.n_points
            self._final_mass_flow_rate = sol.mdot * self._inlet.flowarea
            return 0
        self.runstatus = STATUS_FAILED
        return 1

    # --- solution access (reference premixedflame.py:476-856) ----------

    def get_solution_size(self) -> int:
        """Number of grid points in the solution
        (reference premixedflame.py:476)."""
        self._require_solution()
        return self._solution.n_points

    def process_solution(self):
        """Post-process the raw solution (reference
        premixedflame.py:526). Marks the raw data valid for
        ``get_solution_variable_profile`` / ``get_flame_speed``."""
        self._require_solution()
        self._raw_ok = True
        sol = self._solution
        if self._free_flame:
            # the solver already computed Su against the exact unburnt
            # state it solved with; re-deriving it from the (mutable)
            # reactor condition would report a wrong speed if the user
            # tweaked T/P/Y between run() and process_solution()
            self.flamespeed = float(sol.flame_speed)
        if self._TextOut or self._XMLOut:
            self._numbsolutionpoints = len(np.asarray(sol.x))
            raw = {"distance": np.asarray(sol.x),
                   "temperature": np.asarray(sol.T)}
            Y = np.asarray(sol.Y)
            for k, name in enumerate(self._specieslist):
                raw[name] = Y[:, k]
            self._solution_rawarray = raw
            self.write_solution_files()
        return sol


    # --- keyword-surface completions (reference premixedflame.py) -------
    def use_TPRO_grids(self, mode: bool = True):
        """Use the TPRO profile's positions as the initial grid
        (reference premixedflame.py:167 USE_TPRO_GRID)."""
        self.setkeyword("USE_TPRO_GRID", bool(mode))
        self.grid_T_profile = bool(mode)

    def lump_diffusion_imbalance(self, mode: bool = True):
        """Reference premixedflame.py:110: lump the diffusive mass-flux
        imbalance into the LAST species instead of the correction
        velocity. This build's flux assembly enforces sum_k j_k = 0 by
        the correction velocity (the reference's own default); the
        lumping alternative is not implemented, so turning it on warns
        and keeps the correction-velocity formulation."""
        self.setkeyword("LUMP", bool(mode))
        if mode:
            logger.warning("lumped-imbalance closure not implemented; "
                           "keeping the correction-velocity default")

    def set_profilekeywords(self) -> int:
        """Render held profiles into keyword lines (reference
        premixedflame.py:127; the typed solve consumes the profile
        objects directly — this keeps deck rendering in sync)."""
        return self.createkeywordinputlines()[0]

    def set_gridkeywords(self) -> int:
        """(reference premixedflame.py:180)."""
        return self.set_mesh_keywords()

    def create_solution_streams(self):
        """Stream objects for every solution grid point
        (reference premixedflame.py:696). Each carries the local state
        and the flame's mass flux per unit area as its flow rate."""
        self._require_solution()
        sol = self._solution
        from ..inlet import Stream

        streams = []
        Y = np.asarray(sol.Y)
        for i in range(len(np.asarray(sol.x))):
            st = Stream(self.chemistry,
                        label=f"{self.label}-pt{i}")
            st.pressure = self.pressure
            st.temperature = float(np.asarray(sol.T)[i])
            st.Y = Y[i]
            st.mass_flowrate = float(sol.mdot)
            streams.append(st)
        self._solution_mixturearray = streams
        return streams

    def getsolution(self):
        """Alias used throughout the reference docs."""
        return self.process_solution()

    def getrawsolutionstatus(self) -> bool:
        return self._raw_ok

    def get_solution_variable_profile(self, varname: str):
        """Profile of one solution variable over the grid
        (reference premixedflame.py:646). Variables: 'x', 'temperature',
        'mdot', or a species name (mass fraction)."""
        self._require_solution()
        sol = self._solution
        v = varname.strip().lower()
        if v in ("x", "distance", "grid"):
            return np.asarray(sol.x)
        if v in ("t", "temp", "temperature"):
            return np.asarray(sol.T)
        if v in ("mdot", "mass_flux", "massflux"):
            return np.full(sol.x.shape, sol.mdot)
        k = self.mech.species_index(varname)
        return np.asarray(sol.Y[:, k])

    def get_solution_stream_at_grid(self, grid_index: int) -> Stream:
        """Stream at one grid point (reference premixedflame.py:808)."""
        self._require_solution()
        sol = self._solution
        i = int(grid_index)
        if not -sol.n_points <= i < sol.n_points:
            raise IndexError(f"grid index {i} out of range")
        mix = Mixture(self.chemistry)
        mix.pressure = self.pressure
        mix.temperature = float(sol.T[i])
        mix.Y = np.asarray(sol.Y[i])
        out = create_stream_from_mixture(mix, label=f"{self.label}@{i}")
        out.mass_flowrate = sol.mdot * self._inlet.flowarea
        out.flowarea = self._inlet.flowarea
        return out

    def get_solution_stream(self, x: float) -> Stream:
        """Stream interpolated at position x (reference
        premixedflame.py:757)."""
        self._require_solution()
        sol = self._solution
        if not sol.x[0] <= x <= sol.x[-1]:
            raise ValueError(f"x={x} outside the solution domain")
        mix = Mixture(self.chemistry)
        mix.pressure = self.pressure
        mix.temperature = float(np.interp(x, sol.x, sol.T))
        Y = np.array([np.interp(x, sol.x, sol.Y[:, k])
                      for k in range(sol.Y.shape[1])])
        mix.Y = np.clip(Y, 0.0, None)
        out = create_stream_from_mixture(mix, label=f"{self.label}@x={x}")
        out.mass_flowrate = sol.mdot * self._inlet.flowarea
        out.flowarea = self._inlet.flowarea
        return out

    def _require_solution(self):
        if self.runstatus == STATUS_NOT_RUN or self._solution is None:
            raise RuntimeError("please run the flame simulation first.")
        if self.runstatus != STATUS_SUCCESS:
            raise RuntimeError("simulation failed; no solution available")


class BurnedStabilized_GivenTemperature(PremixedFlame):
    """Burner-stabilized flame with an imposed temperature profile
    (reference premixedflame.py:858): known inlet mass flux, TGIV."""

    def __init__(self, inlet: Stream, label: Optional[str] = None):
        super().__init__(inlet, label or "Premixed Burner GivenT")
        self._energytype = 2
        self.setkeyword("BURN", True)
        self.setkeyword("TGIV", True)
        self._is_free = False


class BurnedStabilized_EnergyEquation(PremixedFlame):
    """Burner-stabilized flame solving the energy equation
    (reference premixedflame.py:877)."""

    def __init__(self, inlet: Stream, label: Optional[str] = None):
        super().__init__(inlet, label or "Premixed Burner Energy")
        self._energytype = 1
        self.setkeyword("BURN", True)
        self.setkeyword("ENRG", True)
        self._is_free = False

    def skip_fix_T_solution(self, mode: bool = True):
        """NOFT — skip the fixed-temperature intermediate solve
        (reference premixedflame.py:894)."""
        self._skip_fixed_T = bool(mode)
        self.setkeyword("NOFT", mode)

    def automatic_temperature_profile_estimate(self, mode: bool = True):
        """TPROF — build the initial temperature estimate from the
        equilibrium state (reference premixedflame.py:906). This is the
        default behavior of the solver."""
        self._auto_T_profile = bool(mode)
        self.setkeyword("TPROF", mode)


class FreelyPropagating(PremixedFlame):
    """Freely-propagating premixed flame — computes the laminar flame
    speed as the mass-flux eigenvalue (reference premixedflame.py:920)."""

    def __init__(self, inlet: Stream, label: Optional[str] = None):
        super().__init__(inlet, label or "Premixed Propagating")
        self._energytype = 1
        self._flamemode = 0
        self.setkeyword("FREE", True)
        self.setkeyword("ENRG", True)
        self._is_free = True
        self.flamespeed = -1.0

    def skip_fix_T_solution(self, mode: bool = True):
        """NOFT (reference premixedflame.py:937)."""
        self._skip_fixed_T = bool(mode)
        self.setkeyword("NOFT", mode)

    def automatic_temperature_profile_estimate(self, mode: bool = True):
        """TPROF (reference premixedflame.py:949). When ON, the initial
        temperature estimate comes from the equilibrium state (which is
        also this build's default construction) and any user-pinned
        temperature reverts to the default anchor."""
        self._auto_T_profile = bool(mode)
        self.setkeyword("TPROF", mode)
        if not mode:
            return
        if "TFIX" in self._keywords:
            logger.warning("auto temperature profile option is ON, "
                           "the pinned temperature is ignored.")
            self.removekeyword("TFIX")
            self._pinned_T = 400.0

    def pinned_temperature(self, temperature: float = 400.0):
        """TFIX — anchor the flame by pinning this temperature to the
        mesh (reference premixedflame.py:973). Must exceed the unburnt
        gas temperature and sit below the ignition temperature."""
        if temperature <= self.temperature:
            raise ValueError(
                "pinned temperature must exceed the unburnt temperature")
        if self._auto_T_profile:
            raise ValueError("auto temperature profile option is ON; "
                             "the pinned temperature would be ignored "
                             "(reference premixedflame.py:991)")
        self._pinned_T = float(temperature)
        self.setkeyword("TFIX", float(temperature))

    def get_flame_speed(self) -> float:
        """Laminar flame speed [cm/s] (reference premixedflame.py:1004).
        Requires ``process_solution()`` first; returns 0.0 otherwise."""
        if not self.getrawsolutionstatus():
            logger.info("please use 'getsolution' method to post-process "
                        "the raw solution data first.")
            return 0.0
        return self.flamespeed
