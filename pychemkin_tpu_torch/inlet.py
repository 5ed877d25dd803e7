"""Stream: a Mixture with a flow rate, for open reactors and flames.

The port's ``Stream`` and its helpers (the JAX package's ``inlet.py``,
plain Python over :class:`~.mixture.Mixture`). A Stream carries one of
four flow-rate specifications:

- mass flow rate  FLRT  [g/s]
- volumetric flow rate  VDOT  [cm^3/s]   (at the stream's T, P)
- velocity  VEL  [cm/s]                  (requires a flow area)
- standard-condition volumetric flow  SCCM  [std cm^3/min]

plus a flow area [cm^2], a velocity gradient [1/s] (opposed-flow), and a
label. Conversions between the specifications use the stream's own state
(density at T, P).
"""

from __future__ import annotations

from typing import Optional, Tuple

from .constants import P_ATM
from .logger import logger
from .mixture import Mixture, adiabatic_mixing, compare_mixtures

#: standard conditions for SCCM (reference: inlet.py:185-238)
_T_STD = 298.15       # K
_P_STD = P_ATM        # dyne/cm^2

FLOW_NONE = 0
FLOW_MASS = 1        # FLRT
FLOW_VOLUMETRIC = 2  # VDOT
FLOW_VELOCITY = 3    # VEL
FLOW_SCCM = 4        # SCCM


class Stream(Mixture):
    """Mixture + flow specification (reference: inlet.py:42)."""

    def __init__(self, chem, label: Optional[str] = None):
        super().__init__(chem)
        self._flow_mode = FLOW_NONE
        self._flow_value = 0.0
        self._flowarea = 0.0
        self._velocity_gradient = 0.0
        self._label = label if label else ""

    # --- label -------------------------------------------------------------
    @property
    def label(self) -> str:
        """(reference: inlet.py:483)."""
        return self._label

    @label.setter
    def label(self, name: str):
        self._label = str(name)

    # --- geometry ----------------------------------------------------------
    @property
    def flowarea(self) -> float:
        """Flow cross-section area [cm^2] (reference: inlet.py:239)."""
        return self._flowarea

    @flowarea.setter
    def flowarea(self, farea: float):
        if farea <= 0.0:
            raise ValueError("flow area must be positive")
        self._flowarea = float(farea)

    @property
    def velocity_gradient(self) -> float:
        """Inlet velocity gradient [1/s] (reference: inlet.py:447)."""
        return self._velocity_gradient

    @velocity_gradient.setter
    def velocity_gradient(self, velgrad: float):
        self._velocity_gradient = float(velgrad)

    # --- flow-rate modes ----------------------------------------------------
    @property
    def mass_flowrate(self) -> float:
        """Mass flow rate [g/s]; converts from the active specification
        (reference: inlet.py:275)."""
        return self.convert_to_mass_flowrate()

    @mass_flowrate.setter
    def mass_flowrate(self, mflowrate: float):
        if mflowrate < 0.0:
            raise ValueError("mass flow rate must be non-negative")
        self._flow_mode = FLOW_MASS
        self._flow_value = float(mflowrate)

    @property
    def vol_flowrate(self) -> float:
        """Volumetric flow rate [cm^3/s] at stream conditions
        (reference: inlet.py:314)."""
        return self.convert_to_vol_flowrate()

    @vol_flowrate.setter
    def vol_flowrate(self, vflowrate: float):
        if vflowrate < 0.0:
            raise ValueError("volumetric flow rate must be non-negative")
        self._flow_mode = FLOW_VOLUMETRIC
        self._flow_value = float(vflowrate)

    @property
    def sccm(self) -> float:
        """Standard cm^3/min (reference: inlet.py:353)."""
        return self.convert_to_SCCM()

    @sccm.setter
    def sccm(self, vflowrate: float):
        if vflowrate < 0.0:
            raise ValueError("SCCM must be non-negative")
        self._flow_mode = FLOW_SCCM
        self._flow_value = float(vflowrate)

    @property
    def velocity(self) -> float:
        """Flow velocity [cm/s]; requires the flow area
        (reference: inlet.py:392)."""
        if self._flow_mode == FLOW_VELOCITY:
            return self._flow_value
        if self._flowarea <= 0.0:
            raise RuntimeError("flow area must be set to compute velocity")
        return self.convert_to_vol_flowrate() / self._flowarea

    @velocity.setter
    def velocity(self, vel: float):
        if vel < 0.0:
            raise ValueError("velocity must be non-negative")
        self._flow_mode = FLOW_VELOCITY
        self._flow_value = float(vel)

    @property
    def flow_mode(self) -> int:
        return self._flow_mode

    # --- conversions (reference: inlet.py:81-238) ---------------------------
    def _std_density(self) -> float:
        """Density of this composition at standard conditions, g/cm^3."""
        return Mixture.density(self.chemID, _P_STD, _T_STD, self.Y,
                               self.WT, "mass")

    def convert_to_mass_flowrate(self) -> float:
        """[g/s] (reference: inlet.py:81)."""
        if self._flow_mode == FLOW_NONE:
            logger.warning("stream flow rate has not been set")
            return 0.0
        if self._flow_mode == FLOW_MASS:
            return self._flow_value
        if self._flow_mode == FLOW_VOLUMETRIC:
            return self._flow_value * self.RHO
        if self._flow_mode == FLOW_VELOCITY:
            if self._flowarea <= 0.0:
                raise RuntimeError(
                    "flow area required to convert velocity to mass flow")
            return self._flow_value * self._flowarea * self.RHO
        # SCCM: standard cm^3/min at (298.15 K, 1 atm)
        return self._flow_value / 60.0 * self._std_density()

    def convert_to_vol_flowrate(self) -> float:
        """[cm^3/s] at stream conditions (reference: inlet.py:133)."""
        if self._flow_mode == FLOW_VOLUMETRIC:
            return self._flow_value
        return self.convert_to_mass_flowrate() / self.RHO

    def convert_to_SCCM(self) -> float:
        """[std cm^3/min] (reference: inlet.py:185)."""
        if self._flow_mode == FLOW_SCCM:
            return self._flow_value
        return self.convert_to_mass_flowrate() / self._std_density() * 60.0


def clone_stream(source: Stream, target: Stream):
    """Copy state + flow spec from ``source`` into ``target``
    (reference: inlet.py:509)."""
    if source.chemID != target.chemID:
        raise ValueError("streams must share a chemistry set")
    target.temperature = source.temperature
    target.pressure = source.pressure
    target.Y = source.Y
    target._flow_mode = source._flow_mode
    target._flow_value = source._flow_value
    target._flowarea = source._flowarea
    target._velocity_gradient = source._velocity_gradient


def compare_streams(streamA: Stream, streamB: Stream, atol: float = 1.0e-10,
                    rtol: float = 1.0e-3,
                    mode: str = "mass") -> Tuple[bool, float, float]:
    """Compare state + mass flow rate of B against A
    (reference: inlet.py:538). Returns (same, max_abs, max_rel)."""
    same_mix, amax, rmax = compare_mixtures(streamA, streamB, atol, rtol,
                                            mode)
    fa = streamA.convert_to_mass_flowrate()
    fb = streamB.convert_to_mass_flowrate()
    fdiff = abs(fb - fa)
    frel = fdiff / max(abs(fa), 1e-300)
    same = same_mix and ((fdiff <= atol) or (frel <= rtol))
    return same, max(amax, fdiff), max(rmax, frel)


def adiabatic_mixing_streams(streamA: Stream, streamB: Stream) -> Stream:
    """Mix two streams at constant enthalpy, mass-flow weighted; the result
    carries the summed mass flow (reference: inlet.py:596)."""
    wa = streamA.convert_to_mass_flowrate()
    wb = streamB.convert_to_mass_flowrate()
    if wa + wb <= 0.0:
        raise ValueError("both streams have zero flow rate")
    mixed = adiabatic_mixing([(streamA, wa), (streamB, wb)], "mass")
    out = Stream(streamA._chem)
    out.temperature = mixed.temperature
    out.pressure = mixed.pressure
    out.Y = mixed.Y
    out.mass_flowrate = wa + wb
    return out


def create_stream_from_mixture(mixture: Mixture,
                               label: Optional[str] = None) -> Stream:
    """Stream with the mixture's state and zero flow
    (reference: inlet.py:685)."""
    out = Stream(mixture._chem, label=label)
    out.temperature = mixture.temperature
    out.pressure = mixture.pressure
    out.Y = mixture.Y
    return out
