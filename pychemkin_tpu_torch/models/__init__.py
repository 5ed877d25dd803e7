"""Reactor and flame model classes of the port: the Keyword/Profile/
ReactorModel framework and the premixed flame models. The batch, PSR,
PFR, engine and network models of the JAX package are not ported yet
(ROADMAP queue A)."""

from .flame import Flame
from .grid import Grid
from .premixedflame import (
    BurnedStabilized_EnergyEquation,
    BurnedStabilized_GivenTemperature,
    FreelyPropagating,
    PremixedFlame,
)
from .reactormodel import (
    BooleanKeyword,
    IntegerKeyword,
    Keyword,
    Profile,
    ReactorModel,
    RealKeyword,
    StringKeyword,
)
from .steadystatesolver import SteadyStateSolver

__all__ = [
    "BooleanKeyword",
    "BurnedStabilized_EnergyEquation",
    "BurnedStabilized_GivenTemperature",
    "Flame",
    "FreelyPropagating",
    "Grid",
    "IntegerKeyword",
    "Keyword",
    "PremixedFlame",
    "Profile",
    "ReactorModel",
    "RealKeyword",
    "SteadyStateSolver",
    "StringKeyword",
]
