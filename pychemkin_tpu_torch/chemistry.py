"""Chemistry set: a mechanism with the reference's API surface, on one
device.

The port's ``Chemistry`` (the JAX package's ``chemistry.py``): file
plumbing, ``preprocess()`` through the port's CHEMKIN parser, sizes and
symbols, species thermo and transport properties, reaction parameters
and the chemistry-set registry shims. The parsed record is
``self.mech`` (numpy); ``self.tm`` is its
:class:`~.mechanism.TorchMechanism` on the chemistry's device, which
:class:`~.mixture.Mixture`, :class:`~.inlet.Stream` and the models use.

The device is resolved at construction as the other entry points resolve
it: ``cuda`` unless the caller passes ``device`` (``"cpu"`` runs the
plain twins); without a card and without ``device`` the constructor
raises. The real-gas cubic EOS is not ported (ROADMAP queue B, B16).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .constants import P_ATM, R_GAS
from .logger import logger
from .mechanism import MechanismRecord, TorchMechanism, load_mechanism
from .ops import thermo
from .ops.reactors import resolve_device

#: raised by the real-gas switches
REALGAS_TODO = ("the real-gas cubic EOS is not ported to the PyTorch/CUDA "
                "package (ROADMAP queue B, item B16: ops/realgas.py)")

_verbose = False
#: registry of preprocessed chemistry sets, chemID -> Chemistry
_chemset_registry: dict = {}
_chemset_init_flags: dict = {}
_next_chem_id = [0]


def verbose() -> bool:
    """Whether verbose printing is on."""
    return _verbose


def set_verbose(OnOff: bool):
    """Toggle verbose printing."""
    global _verbose
    _verbose = bool(OnOff)


def chemkin_version() -> int:
    """Version tag of the solver core (the JAX package's constant)."""
    return 261


def verify_version(min_version: int) -> bool:
    return chemkin_version() >= min_version


def done():
    """Release all chemistry sets (clears the registry)."""
    _chemset_registry.clear()


def chemistryset_new(chem_index: int):
    _chemset_init_flags[chem_index] = False


def chemistryset_initialized(chem_index: int):
    _chemset_init_flags[chem_index] = True


def check_chemistryset(chem_index: int) -> bool:
    return chem_index in _chemset_registry


def activate_chemistryset(chem_index: int) -> int:
    """Mechanisms are values: activation is a no-op; 0 on success, 1 if
    unknown."""
    return 0 if chem_index in _chemset_registry else 1


def force_activate_chemistryset(chem_index: int):
    if chem_index not in _chemset_registry:
        raise ValueError(f"unknown chemistry set index {chem_index}")


def check_active_chemistryset(chem_index: int) -> bool:
    return chem_index in _chemset_registry


def get_chemistryset(chem_index: int) -> "Chemistry":
    """Look up a registered Chemistry by its chemID."""
    return _chemset_registry[chem_index]


class Chemistry:
    """A preprocessed chemical mechanism (elements, species, reactions,
    thermo and, optionally, transport data) on one device."""

    def __init__(self, chem: str = "", surf: str = "", therm: str = "",
                 tran: str = "", label: str = "", device=None):
        self.device = resolve_device(device)
        self._chem_file = chem
        self._surf_file = surf
        self._therm_file = therm
        self._tran_file = tran
        self.label = label if label else " "
        self._chemset_index = -1
        self.mech: Optional[MechanismRecord] = None
        self._tm: Optional[TorchMechanism] = None
        self.userealgas = False
        self._EOS = 0
        self._want_transport = bool(tran)
        if surf and os.path.isfile(surf):
            logger.warning("surface mechanisms are not supported; "
                           "ignoring %s", surf)

    # --- file names ---------------------------------------------------------
    @property
    def chemfile(self) -> str:
        return self._chem_file

    @chemfile.setter
    def chemfile(self, filename: str):
        self._chem_file = filename

    @property
    def thermfile(self) -> str:
        return self._therm_file

    @thermfile.setter
    def thermfile(self, filename: str):
        self._therm_file = filename

    @property
    def tranfile(self) -> str:
        return self._tran_file

    @tranfile.setter
    def tranfile(self, filename: str):
        self._tran_file = filename

    @property
    def surffile(self) -> str:
        return self._surf_file

    @surffile.setter
    def surffile(self, filename: str):
        self._surf_file = filename

    def set_file_names(self, chem: str = "", surf: str = "", therm: str = "",
                       tran: str = ""):
        if chem:
            self._chem_file = chem
        if surf:
            self._surf_file = surf
        if therm:
            self._therm_file = therm
        if tran:
            self._tran_file = tran

    # --- preprocessing ------------------------------------------------------
    def _register(self):
        self._chemset_index = _next_chem_id[0]
        _next_chem_id[0] += 1
        _chemset_registry[self._chemset_index] = self

    def preprocess(self) -> int:
        """Parse the mechanism files into ``self.mech``; returns 0 (raises
        on parse errors)."""
        if not self._chem_file:
            raise ValueError("no mechanism input file given")
        self.mech = load_mechanism(
            self._chem_file, thermo_path=self._therm_file or None,
            transport_path=self._tran_file or None)
        self._tm = None
        self._register()
        if _verbose:
            print(f"preprocessed mechanism: {self.KK} species, "
                  f"{self.IIGas} gas reactions, {self.MM} elements")
        return 0

    @classmethod
    def from_mechanism(cls, mech: MechanismRecord, label: str = "",
                       device=None) -> "Chemistry":
        """Wrap an already-parsed record."""
        obj = cls(label=label, device=device)
        obj.mech = mech
        obj._register()
        return obj

    def _require_mech(self) -> MechanismRecord:
        if self.mech is None:
            raise RuntimeError("chemistry set has not been preprocessed; "
                               "call preprocess() first")
        return self.mech

    @property
    def tm(self) -> TorchMechanism:
        """The mechanism's tensors on this chemistry's device (built at
        first use)."""
        if self._tm is None or self._tm.record is not self._require_mech():
            self._tm = TorchMechanism(self.mech, self.device)
        return self._tm

    def verify_transport_data(self) -> bool:
        return self.mech is not None and bool(self.mech.has_transport)

    def verify_surface_mechanism(self) -> bool:
        return False

    # --- sizes and symbols --------------------------------------------------
    @property
    def chemID(self) -> int:
        return self._chemset_index

    @property
    def surfchem(self) -> int:
        return 0

    @property
    def KK(self) -> int:
        return self._require_mech().n_species

    @property
    def MM(self) -> int:
        return self._require_mech().n_elements

    @property
    def IIGas(self) -> int:
        return self._require_mech().n_reactions

    @property
    def species_symbols(self) -> list:
        return list(self._require_mech().species_names)

    @property
    def element_symbols(self) -> list:
        return list(self._require_mech().element_names)

    def get_specindex(self, specname: str) -> int:
        """Species index by symbol, -1 if absent (case-insensitive)."""
        try:
            return self._require_mech().species_index(specname)
        except ValueError:
            return -1

    @property
    def AWT(self) -> np.ndarray:
        return np.asarray(self._require_mech().awt)

    @property
    def WT(self) -> np.ndarray:
        return np.asarray(self._require_mech().wt)

    # --- species thermodynamic properties (molar at the API) ---------------
    def _T(self, temp):
        return torch.tensor([float(temp)], dtype=torch.float64,
                            device=self.device)

    def _species(self, fn, temp) -> np.ndarray:
        self._require_mech()
        return (fn(self.tm, self._T(temp))[0] * self.tm.wt).cpu().numpy()

    def SpeciesCp(self, temp: float) -> np.ndarray:
        """Species Cp [KK], erg/(mol K)."""
        return self._species(
            lambda tm, T: thermo.cp_R(tm, T) * R_GAS / tm.wt, temp)

    def SpeciesCv(self, temp: float) -> np.ndarray:
        """Species Cv [KK], erg/(mol K)."""
        return self._species(
            lambda tm, T: thermo.cv_R(tm, T) * R_GAS / tm.wt, temp)

    def SpeciesH(self, temp: float) -> np.ndarray:
        """Species enthalpies [KK], erg/mol."""
        return self._species(thermo.species_enthalpy_mass, temp)

    def SpeciesU(self, temp: float) -> np.ndarray:
        """Species internal energies [KK], erg/mol."""
        return self._species(
            lambda tm, T: thermo.u_RT(tm, T) * (R_GAS * T[:, None])
            / tm.wt, temp)

    # --- species transport properties (kernel K9) ---------------------------
    def _require_transport(self) -> TorchMechanism:
        if not self._require_mech().has_transport:
            raise RuntimeError("mechanism has no transport data; provide a "
                               "tran file")
        return self.tm

    def _transport(self, temp, pres=None):
        """K9 at one state (T, P and a uniform composition: the species
        properties do not depend on it)."""
        from .kernels.flame import transport_props
        tm = self._require_transport()
        f64 = dict(dtype=torch.float64, device=self.device)
        X = torch.full((1, tm.KK), 1.0 / tm.KK, **f64)
        P = torch.tensor([float(pres) if pres else P_ATM], **f64)
        return transport_props(tm, self._T(temp), P, X)

    def SpeciesVisc(self, temp: float = 0.0) -> np.ndarray:
        """Pure-species viscosities [KK], g/(cm s)."""
        return self._transport(temp).mu_k[0].cpu().numpy()

    def SpeciesCond(self, temp: float = 0.0) -> np.ndarray:
        """Pure-species conductivities [KK], erg/(cm K s)."""
        return self._transport(temp).lam_k[0].cpu().numpy()

    def SpeciesDiffusionCoeffs(self, temp: float = 0.0,
                               pres: float = 0.0) -> np.ndarray:
        """Binary diffusion coefficients [KK, KK], cm^2/s."""
        return self._transport(temp, pres).Djk[0].cpu().numpy()

    # --- composition matrix -------------------------------------------------
    def SpeciesComposition(self, elemindex: int = -1, specindex: int = -1):
        """Elemental composition: the [KK, MM] matrix, one species row,
        one element column or one count."""
        ncf = np.asarray(self._require_mech().ncf)
        if elemindex < 0 and specindex < 0:
            return ncf
        if elemindex < 0:
            return ncf[specindex]
        if specindex < 0:
            return ncf[:, elemindex]
        return ncf[specindex, elemindex]

    # --- reaction parameters ------------------------------------------------
    def get_reaction_parameters(self):
        """(A, beta, Ea/R) of all gas reactions (activation temperatures
        in K)."""
        mech = self._require_mech()
        return (np.asarray(mech.A), np.asarray(mech.beta),
                np.asarray(mech.Ea_R))

    def _check_reaction(self, reaction_index: int):
        n = self._require_mech().n_reactions
        if not 1 <= reaction_index <= n:
            raise ValueError(f"reaction index must be in [1, {n}]")

    def set_reaction_AFactor(self, reaction_index: int, AFactor: float):
        """(Re)set one reaction's pre-exponential (1-based index); the
        record is replaced (records are values)."""
        self._check_reaction(reaction_index)
        A = np.asarray(self.mech.A, dtype=np.float64).copy()
        A[reaction_index - 1] = AFactor
        self.mech = dataclasses.replace(self.mech, A=A)

    def get_reaction_AFactor(self, reaction_index: int) -> float:
        self._check_reaction(reaction_index)
        return float(np.asarray(self.mech.A)[reaction_index - 1])

    def get_gas_reaction_string(self, reaction_index: int) -> str:
        self._check_reaction(reaction_index)
        return self.mech.reaction_equations[reaction_index - 1]

    def preprocess_transportdata(self):
        """Include transport data: parsed whenever a ``tran`` file is
        given; warns without one."""
        if not self._tran_file:
            logger.warning("make sure the gas mechanism contains the "
                           "'TRANSPORT ALL' block.")
        self._want_transport = True

    @property
    def summaryfile(self) -> str:
        """Path of a preprocessing summary, written on access (tmp +
        rename)."""
        mech = self._require_mech()
        path = os.path.abspath(f"Summary_{self.chemID}.out")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write("pychemkin_tpu_torch preprocessing summary\n")
            f.write(f"mechanism: {self._chem_file}\n")
            f.write(f"elements ({mech.n_elements}): "
                    + " ".join(mech.element_names) + "\n")
            f.write(f"species ({mech.n_species}): "
                    + " ".join(mech.species_names) + "\n")
            f.write(f"gas reactions: {mech.n_reactions}\n")
            f.write("transport data: "
                    + ("yes" if mech.has_transport else "no") + "\n")
        os.replace(tmp, path)
        return path

    # --- real gas (not ported) ----------------------------------------------
    @property
    def EOS(self) -> int:
        return 0

    def use_realgas_cubicEOS(self):
        """The real-gas cubic EOS: not ported."""
        raise NotImplementedError(REALGAS_TODO)

    def set_realgas_eos_model(self, model):
        raise NotImplementedError(REALGAS_TODO)

    def set_critical_properties(self, species: str, Tc: float, Pc: float,
                                omega: float):
        raise NotImplementedError(REALGAS_TODO)

    def set_realgas_mixing_rule(self, rule: int = 0):
        raise NotImplementedError(REALGAS_TODO)

    def use_idealgas_law(self):
        """The ideal-gas law (the only equation of state of the port)."""
        self.userealgas = False

    def verify_realgas_model(self):
        return 0

    # --- registry shims -----------------------------------------------------
    def save(self):
        """No-op (records are values)."""

    def activate(self):
        """No-op (every chemistry set is active)."""
