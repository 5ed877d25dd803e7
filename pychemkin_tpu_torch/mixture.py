"""Mixture: a thermodynamic state with the reference's API, on the
chemistry's device.

The port's ``Mixture`` (the JAX package's ``mixture.py``): T/P/V and
composition with set-flags and ``validate()``, recipe-or-array setters,
the molar-mass helpers, density and mixture thermo, kinetics (ROP,
reaction rates, heat release), transport and equilibrium at the one
state, the equivalence-ratio setters, and the module-level mixing and
equilibrium functions. CGS units throughout.

The thermo and kinetics getters evaluate the port's plain ``ops`` on the
chemistry's device (their arithmetic is a lane body inside K1/K2/K5 on
the card, with no kernel of its own); the transport getters launch K9
(``kernels.transport_props``) on the card; equilibrium is K6
(``ops.equilibrium.equilibrate``). The real-gas branches raise
(ROADMAP queue B, B16), and so does the Chapman-Jouguet detonation
(ROADMAP queue B, B12).
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from .chemistry import REALGAS_TODO, Chemistry, get_chemistryset
from .constants import P_ATM, R_GAS
from .logger import logger
from .ops import kinetics, thermo

Recipe = List[Tuple[str, float]]

#: raised by the Chapman-Jouguet option
CJ_TODO = ("the Chapman-Jouguet detonation (EQOption 10) is not ported to "
           "the PyTorch/CUDA package (ROADMAP queue B, item B12)")


def _as_fraction_array(mech, value, what: str) -> np.ndarray:
    """A recipe (list or dict of (symbol, fraction)) or a full [KK]
    array, as a [KK] array."""
    KK = mech.n_species
    if isinstance(value, dict):
        value = list(value.items())
    if isinstance(value, (list, tuple)) and len(value) > 0 and isinstance(
            value[0], (list, tuple)) and isinstance(value[0][0], str):
        frac = np.zeros(KK, dtype=np.double)
        for name, f in value:
            frac[mech.species_index(name)] += float(f)
        return frac
    arr = np.asarray(value, dtype=np.double)
    if arr.shape != (KK,):
        raise ValueError(f"{what} must be a recipe or a [{KK}] array")
    return arr


class _State:
    """One state as [1]-batch tensors on the chemistry's device."""

    def __init__(self, chem, T, P=None, Y=None, X=None):
        f64 = dict(dtype=torch.float64, device=chem.device)
        self.tm = chem.tm
        self.T = torch.tensor([float(T)], **f64)
        self.P = None if P is None else torch.tensor([float(P)], **f64)
        self.Y = None if Y is None else torch.as_tensor(
            np.asarray(Y, dtype=np.float64)[None], **f64)
        self.X = None if X is None else torch.as_tensor(
            np.asarray(X, dtype=np.float64)[None], **f64)


def _np(t) -> np.ndarray:
    return t[0].cpu().numpy()


def _scalar(t) -> float:
    return float(t[0])


def _rop(chem, T, P, Y):
    s = _State(chem, T, P, Y)
    rho = thermo.density(s.tm, s.T, s.P, s.Y)
    C = thermo.Y_to_C(s.tm, s.Y, rho)
    return s, kinetics.rop_intermediates(s.tm, s.T, C, P=s.P)


def _wdot(chem, T, P, Y) -> torch.Tensor:
    s, r = _rop(chem, T, P, Y)
    return (r.qf - r.qr) @ s.tm.nu


class Mixture:
    """Gas-mixture state: (T, P, V) and composition with set-flags."""

    def __init__(self, chem: Chemistry):
        if not isinstance(chem, Chemistry):
            raise TypeError("Mixture requires a Chemistry object")
        chem._require_mech()
        self._chem = chem
        self._KK = chem.KK
        self._T = 0.0
        self._P = 0.0
        self._V = 0.0
        self._Tset = 0
        self._Pset = 0
        self._Vset = 0
        self._Xset = 0
        self._Yset = 0
        self._X = np.zeros(self._KK, dtype=np.double)
        self._Y = np.zeros(self._KK, dtype=np.double)

    def __deepcopy__(self, memo):
        """Copy the state arrays, share the Chemistry."""
        cls = self.__class__
        out = cls.__new__(cls)
        memo[id(self)] = out
        for k, v in self.__dict__.items():
            if k == "_chem":
                out._chem = v
            elif isinstance(v, np.ndarray):
                setattr(out, k, v.copy())
            else:
                setattr(out, k, copy.deepcopy(v, memo))
        return out

    # --- identity ------------------------------------------------------------
    @property
    def chemistry(self) -> Chemistry:
        return self._chem

    @property
    def mech(self):
        return self._chem.mech

    @property
    def chemID(self) -> int:
        return self._chem.chemID

    @property
    def KK(self) -> int:
        return self._KK

    @property
    def species_symbols(self) -> list:
        return self._chem.species_symbols

    # --- scalar state --------------------------------------------------------
    @property
    def pressure(self) -> float:
        """Pressure [dyne/cm^2]."""
        if not self._Pset:
            logger.warning("mixture pressure has not been set")
        return self._P

    @pressure.setter
    def pressure(self, p: float):
        if p <= 0.0:
            raise ValueError("pressure must be positive")
        self._P = float(p)
        self._Pset = 1

    @property
    def temperature(self) -> float:
        """Temperature [K]."""
        if not self._Tset:
            logger.warning("mixture temperature has not been set")
        return self._T

    @temperature.setter
    def temperature(self, t: float):
        if t <= 0.0:
            raise ValueError("temperature must be positive")
        self._T = float(t)
        self._Tset = 1

    @property
    def volume(self) -> float:
        """Volume [cm^3] (1.0 when unset)."""
        return self._V if self._Vset else 1.0

    @volume.setter
    def volume(self, vol: float):
        if vol <= 0.0:
            raise ValueError("volume must be positive")
        self._V = float(vol)
        self._Vset = 1

    # --- composition ---------------------------------------------------------
    @property
    def X(self) -> np.ndarray:
        """Mole fractions [KK]."""
        if self._Xset:
            return self._X.copy()
        if self._Yset:
            return Mixture.mass_fraction_to_mole_fraction(self._Y, self.WT)
        logger.warning("mixture composition has not been set")
        return np.zeros(self._KK, dtype=np.double)

    @X.setter
    def X(self, recipe: Union[Recipe, Sequence[float]]):
        frac = _as_fraction_array(self.mech, recipe, "X")
        if np.any(frac < 0.0):
            raise ValueError("negative mole fraction")
        total = frac.sum()
        if total <= 0.0:
            raise ValueError("mole fractions sum to zero")
        self._X = frac / total
        self._Xset = 1
        self._Yset = 0

    @property
    def Y(self) -> np.ndarray:
        """Mass fractions [KK]."""
        if self._Yset:
            return self._Y.copy()
        if self._Xset:
            return Mixture.mole_fraction_to_mass_fraction(self._X, self.WT)
        logger.warning("mixture composition has not been set")
        return np.zeros(self._KK, dtype=np.double)

    @Y.setter
    def Y(self, recipe: Union[Recipe, Sequence[float]]):
        frac = _as_fraction_array(self.mech, recipe, "Y")
        if np.any(frac < 0.0):
            raise ValueError("negative mass fraction")
        total = frac.sum()
        if total <= 0.0:
            raise ValueError("mass fractions sum to zero")
        self._Y = frac / total
        self._Yset = 1
        self._Xset = 0

    @property
    def concentration(self) -> np.ndarray:
        """Molar concentrations [KK], mol/cm^3."""
        self._require_state()
        return self.X * self._P / (R_GAS * self._T)

    @property
    def EOS(self) -> int:
        """Equation of state: 0 = ideal gas."""
        return 0

    @staticmethod
    def normalize(frac: Sequence[float]) -> Tuple[int, np.ndarray]:
        arr = np.asarray(frac, dtype=np.double)
        total = arr.sum()
        if total <= 0.0 or np.any(arr < 0.0):
            return 1, arr
        return 0, arr / total

    # --- molar-mass helpers --------------------------------------------------
    @property
    def WT(self) -> np.ndarray:
        """Species molecular weights [KK], g/mol."""
        return np.asarray(self.mech.wt)

    @property
    def WTM(self) -> float:
        """Mean molar mass, g/mol."""
        if self._Xset:
            return float(np.dot(self._X, self.WT))
        return float(1.0 / max(np.dot(self.Y, 1.0 / self.WT), 1e-30))

    @staticmethod
    def mean_molar_mass(frac, wt, mode: str) -> float:
        frac = np.asarray(frac, dtype=np.double)
        wt = np.asarray(wt, dtype=np.double)
        if mode.lower() == "mole":
            return float(np.dot(frac, wt) / frac.sum())
        return float(1.0 / np.dot(frac / frac.sum(), 1.0 / wt))

    @staticmethod
    def mole_fraction_to_mass_fraction(molefrac, wt) -> np.ndarray:
        x = np.asarray(molefrac, dtype=np.double)
        wx = x * np.asarray(wt)
        return wx / wx.sum()

    @staticmethod
    def mass_fraction_to_mole_fraction(massfrac, wt) -> np.ndarray:
        y = np.asarray(massfrac, dtype=np.double)
        n = y / np.asarray(wt)
        return n / n.sum()

    @staticmethod
    def mass_fraction_to_concentration(p: float, t: float, massfrac,
                                       wt) -> np.ndarray:
        y = np.asarray(massfrac, dtype=np.double)
        wt = np.asarray(wt, dtype=np.double)
        wbar = 1.0 / np.dot(y / y.sum(), 1.0 / wt)
        rho = p * wbar / (R_GAS * t)
        return rho * (y / y.sum()) / wt

    @staticmethod
    def mole_fraction_to_concentration(p: float, t: float,
                                       molefrac) -> np.ndarray:
        x = np.asarray(molefrac, dtype=np.double)
        return (x / x.sum()) * p / (R_GAS * t)

    def list_composition(self, mode: str, option: str = " ",
                         bound: float = 0.0):
        """Print the composition in 'mass' or 'mole' fractions above
        ``bound``."""
        frac = self.Y if mode.lower() == "mass" else self.X
        names = self.species_symbols
        for k in np.argsort(frac)[::-1]:
            if frac[k] > bound:
                print(f"  {names[k]:<16s} {frac[k]:.6e}")

    # --- density and mixture thermo ------------------------------------------
    @staticmethod
    def _frac_to_XY(frac, wt, mode):
        frac = np.asarray(frac, dtype=np.double)
        if mode.lower() == "mole":
            Y = Mixture.mole_fraction_to_mass_fraction(frac, wt)
            X = frac / frac.sum()
        else:
            Y = frac / frac.sum()
            X = Mixture.mass_fraction_to_mole_fraction(Y, wt)
        return X, Y

    @staticmethod
    def density(chemID: int, p: float, t: float, frac, wt,
                mode: str) -> float:
        """Mass density [g/cm^3] (ideal gas)."""
        chem = get_chemistryset(chemID)
        _, Y = Mixture._frac_to_XY(frac, wt, mode)
        s = _State(chem, t, p, Y)
        return _scalar(thermo.density(s.tm, s.T, s.P, s.Y))

    @property
    def RHO(self) -> float:
        """Mass density of this mixture [g/cm^3]."""
        self._require_state()
        s = _State(self._chem, self._T, self._P, self.Y)
        return _scalar(thermo.density(s.tm, s.T, s.P, s.Y))

    @property
    def mass(self) -> float:
        return self.RHO * self.volume

    @staticmethod
    def mixture_specific_heat(chemID: int, p: float, t: float, frac, wt,
                              mode: str) -> float:
        """Mixture Cp [erg/(g K)]."""
        chem = get_chemistryset(chemID)
        _, Y = Mixture._frac_to_XY(frac, wt, mode)
        s = _State(chem, t, Y=Y)
        return _scalar(thermo.mixture_cp_mass(s.tm, s.T, s.Y))

    @staticmethod
    def mixture_enthalpy(chemID: int, p: float, t: float, frac, wt,
                         mode: str) -> float:
        """Mixture specific enthalpy [erg/g]."""
        chem = get_chemistryset(chemID)
        _, Y = Mixture._frac_to_XY(frac, wt, mode)
        s = _State(chem, t, Y=Y)
        return _scalar(thermo.mixture_enthalpy_mass(s.tm, s.T, s.Y))

    # --- kinetics ------------------------------------------------------------
    @staticmethod
    def rate_of_production(chemID: int, p: float, t: float, frac, wt,
                           mode: str) -> np.ndarray:
        """Net molar production rates [KK], mol/(cm^3 s)."""
        chem = get_chemistryset(chemID)
        _, Y = Mixture._frac_to_XY(frac, wt, mode)
        return _np(_wdot(chem, t, p, Y))

    @staticmethod
    def reaction_rates(chemID: int, p: float, t: float, frac, wt,
                       mode: str) -> Tuple[np.ndarray, np.ndarray]:
        """Forward and reverse rates of progress [II each], mol/(cm^3 s)."""
        chem = get_chemistryset(chemID)
        _, Y = Mixture._frac_to_XY(frac, wt, mode)
        _, r = _rop(chem, t, p, Y)
        return _np(r.qf), _np(r.qr)

    def Find_Equilibrium(self) -> "Mixture":
        """Equilibrium mixture at this mixture's (T, P)."""
        return equilibrium(self, opt=1)

    # --- instance accessors --------------------------------------------------
    def HML(self) -> float:
        """Mixture molar enthalpy [erg/mol]."""
        self._require_state(need_P=False)
        s = _State(self._chem, self._T, X=self.X)
        return _scalar((s.X * thermo.h_RT(s.tm, s.T)).sum(-1)
                       * (R_GAS * s.T))

    def CPBL(self) -> float:
        """Mixture molar Cp [erg/(mol K)]."""
        self._require_state(need_P=False)
        s = _State(self._chem, self._T, X=self.X)
        return _scalar((s.X * thermo.cp_R(s.tm, s.T)).sum(-1) * R_GAS)

    def ROP(self) -> np.ndarray:
        """Net production rates at this state, mol/(cm^3 s)."""
        self._require_state()
        return _np(_wdot(self._chem, self._T, self._P, self.Y))

    def RxnRates(self) -> Tuple[np.ndarray, np.ndarray]:
        """(qf, qr) at this state."""
        self._require_state()
        _, r = _rop(self._chem, self._T, self._P, self.Y)
        return _np(r.qf), _np(r.qr)

    def species_Cp(self) -> np.ndarray:
        """[KK] erg/(mol K) at this T."""
        self._require_state(need_P=False, need_comp=False)
        return self._chem.SpeciesCp(self._T)

    def species_H(self) -> np.ndarray:
        """[KK] erg/mol at this T."""
        self._require_state(need_P=False, need_comp=False)
        return self._chem.SpeciesH(self._T)

    # --- transport (kernel K9) -----------------------------------------------
    def _transport(self, need_P=True, need_comp=True):
        """K9 at this state (the pressure is 1 atm where the property does
        not depend on it and it is unset)."""
        from .kernels.flame import transport_props
        self._require_state(need_P=need_P, need_comp=need_comp)
        tm = self._transport_mech()
        P = self._P if self._Pset else P_ATM
        X = self.X if (self._Xset or self._Yset) else np.full(
            self._KK, 1.0 / self._KK)
        s = _State(self._chem, self._T, P, X=X)
        return transport_props(tm, s.T, s.P, s.X)

    def species_Visc(self) -> np.ndarray:
        """[KK] g/(cm s) at this T."""
        return _np(self._transport(need_P=False, need_comp=False).mu_k)

    def species_Cond(self) -> np.ndarray:
        """[KK] erg/(cm K s)."""
        return _np(self._transport(need_P=False, need_comp=False).lam_k)

    def species_Diffusion_Coeffs(self) -> np.ndarray:
        """Binary diffusion coefficients [KK, KK], cm^2/s."""
        return _np(self._transport(need_comp=False).Djk)

    def mixture_viscosity(self) -> float:
        """Wilke mixture-averaged viscosity [g/(cm s)]."""
        return _scalar(self._transport(need_P=False).mu)

    def mixture_conductivity(self) -> float:
        """Mixture-averaged conductivity [erg/(cm K s)]."""
        return _scalar(self._transport(need_P=False).lam)

    def mixture_diffusion_coeffs(self) -> np.ndarray:
        """Mixture-averaged diffusion coefficients [KK], cm^2/s."""
        return _np(self._transport().D_km)

    def mixture_binary_diffusion_coeffs(self) -> np.ndarray:
        """Binary diffusion coefficients at this state."""
        return self.species_Diffusion_Coeffs()

    def mixture_thermal_diffusion_coeffs(self) -> np.ndarray:
        """Thermal diffusion ratios [KK]."""
        return _np(self._transport(need_P=False).theta)

    def volHRR(self) -> float:
        """Volumetric heat release rate [erg/(cm^3 s)], +sum_k H_k ROP_k
        (negative while an exothermic mixture releases heat)."""
        self._require_state()
        s = _State(self._chem, self._T, self._P, self.Y)
        wdot = _wdot(self._chem, self._T, self._P, self.Y)
        h_molar = thermo.h_RT(s.tm, s.T) * (R_GAS * s.T)
        return _scalar((h_molar * wdot).sum(-1))

    def massROP(self) -> np.ndarray:
        """Mass production rates [g/(cm^3 s)]."""
        return self.ROP() * self.WT

    def list_ROP(self, bound: float = 0.0):
        rop = self.ROP()
        names = self.species_symbols
        for k in np.argsort(np.abs(rop))[::-1]:
            if abs(rop[k]) > bound:
                print(f"  {names[k]:<16s} {rop[k]: .6e} mol/cm3-s")

    def list_massROP(self, bound: float = 0.0):
        rop = self.massROP()
        names = self.species_symbols
        for k in np.argsort(np.abs(rop))[::-1]:
            if abs(rop[k]) > bound:
                print(f"  {names[k]:<16s} {rop[k]: .6e} g/cm3-s")

    def list_reaction_rates(self, bound: float = 0.0):
        qf, qr = self.RxnRates()
        for i in range(len(qf)):
            if abs(qf[i] - qr[i]) > bound:
                print(f"  rxn {i + 1:<5d} qf={qf[i]: .4e} qr={qr[i]: .4e}")

    # --- equivalence-ratio composition setters -------------------------------
    def X_by_Equivalence_Ratio(self, chemistryset: Chemistry, fuel_molefrac,
                               oxid_molefrac, add_molefrac, products,
                               equivalenceratio: float,
                               threshold: float = 1.0e-10) -> int:
        """Mole fractions from an equivalence ratio, the fuel, oxidizer and
        additive compositions and the complete-combustion products:
        phi = (F/O) / (F/O)_stoich."""
        from .utilities import calculate_stoichiometrics
        mech = chemistryset.mech
        fuel = np.asarray(fuel_molefrac, dtype=np.double)
        oxid = np.asarray(oxid_molefrac, dtype=np.double)
        add = np.asarray(add_molefrac, dtype=np.double)
        fuel = np.where(fuel > threshold, fuel, 0.0)
        oxid = np.where(oxid > threshold, oxid, 0.0)
        prod_index = np.array([mech.species_index(s) for s in products],
                              dtype=np.int64)
        alpha, _nu = calculate_stoichiometrics(chemistryset,
                                               fuel / fuel.sum(),
                                               oxid / oxid.sum(), prod_index)
        mix = (equivalenceratio * fuel / fuel.sum()
               + alpha * oxid / oxid.sum())
        mix = mix / mix.sum()
        if add.sum() > 0.0:
            mix = (1.0 - add.sum()) * mix + add
        self.X = mix / mix.sum()
        return 0

    def Y_by_Equivalence_Ratio(self, chemistryset: Chemistry, fuel_massfrac,
                               oxid_massfrac, add_massfrac, products,
                               equivalenceratio: float,
                               threshold: float = 1.0e-10) -> int:
        """The mass-fraction variant."""
        wt = chemistryset.WT

        def to_x(y):
            y = np.asarray(y, dtype=np.double)
            if y.sum() <= 0.0:
                return y
            return Mixture.mass_fraction_to_mole_fraction(y, wt)
        return self.X_by_Equivalence_Ratio(
            chemistryset, to_x(fuel_massfrac), to_x(oxid_massfrac),
            to_x(add_massfrac), products, equivalenceratio, threshold)

    def get_EGR_mole_fraction(self, EGRratio: float,
                              threshold: float = 1.0e-8) -> np.ndarray:
        """EGRratio times this mixture's equilibrium composition,
        thresholded."""
        x = self.Find_Equilibrium().X
        return np.where(x > threshold, EGRratio * x, 0.0)

    # --- validation ----------------------------------------------------------
    def validate(self) -> int:
        """0 if fully defined; 1/2/3 for missing T/P/composition."""
        if not self._Tset:
            logger.error("mixture temperature is not provided")
            return 1
        if not self._Pset:
            logger.error("mixture pressure is not provided")
            return 2
        if not (self._Xset or self._Yset):
            logger.error("mixture composition is not provided")
            return 3
        return 0

    def _require_state(self, need_P: bool = True, need_comp: bool = True):
        if not self._Tset:
            raise RuntimeError("mixture temperature is not set")
        if need_P and not self._Pset:
            raise RuntimeError("mixture pressure is not set")
        if need_comp and not (self._Xset or self._Yset):
            raise RuntimeError("mixture composition is not set")

    def _transport_mech(self):
        if not self.mech.has_transport:
            raise RuntimeError("mechanism has no transport data")
        return self._chem.tm

    # --- real gas (not ported) -----------------------------------------------
    def use_realgas_cubicEOS(self):
        raise NotImplementedError(REALGAS_TODO)

    def use_idealgas_law(self):
        self._chem.use_idealgas_law()

    def set_realgas_mixing_rule(self, rule: int = 0):
        raise NotImplementedError(REALGAS_TODO)


# ---------------------------------------------------------------------------
# module-level mixing and equilibrium functions


def _combined_composition(recipe, mode: str):
    """(chemistry, mass weights, mass-weighted Y) of a mixing recipe
    [(Mixture, amount), ...]."""
    if len(recipe) == 0:
        raise ValueError("the mixing recipe is empty")
    chem = recipe[0][0]._chem
    mass_w, Ys = [], []
    for mix, amount in recipe:
        if mix.chemID != chem.chemID:
            raise ValueError("all mixtures must share one chemistry set")
        mass_w.append(amount * mix.WTM if mode.lower() == "mole" else amount)
        Ys.append(mix.Y)
    mass_w = np.asarray(mass_w)
    mass_w = mass_w / mass_w.sum()
    Y = sum(w * y for w, y in zip(mass_w, Ys))
    return chem, mass_w, np.asarray(Y)


def isothermal_mixing(recipe, mode: str, finaltemperature: float) -> Mixture:
    """Mix mixtures to a prescribed final temperature; the pressure is the
    first mixture's."""
    chem, _, Y = _combined_composition(recipe, mode)
    out = Mixture(chem)
    out.pressure = recipe[0][0].pressure
    out.temperature = float(finaltemperature)
    out.Y = Y
    return out


def _h_mass(chem, T, Y) -> float:
    s = _State(chem, T, Y=Y)
    return _scalar(thermo.mixture_enthalpy_mass(s.tm, s.T, s.Y))


def adiabatic_mixing(recipe, mode: str) -> Mixture:
    """Mix at constant total enthalpy: the final T solves
    h_mix(T) = sum_i w_i h_i(T_i)."""
    chem, mass_w, Y = _combined_composition(recipe, mode)
    h_target = sum(w * _h_mass(chem, mix.temperature, mix.Y)
                   for w, (mix, _) in zip(mass_w, recipe))
    out = Mixture(chem)
    out.pressure = recipe[0][0].pressure
    out.Y = Y
    T0 = sum(w * mix.temperature for w, (mix, _) in zip(mass_w, recipe))
    out.temperature = _solve_T_from_h(chem, Y, h_target, T0)
    return out


def _solve_T_from_h(chem, Y, h_target: float, T_guess: float) -> float:
    """Newton on h(T) = h_target with cp as the slope."""
    T = float(np.clip(T_guess, 200.0, 5500.0))
    for _ in range(100):
        s = _State(chem, T, Y=Y)
        h = _scalar(thermo.mixture_enthalpy_mass(s.tm, s.T, s.Y))
        cp = _scalar(thermo.mixture_cp_mass(s.tm, s.T, s.Y))
        dT = (h_target - h) / max(cp, 1e-300)
        T = float(np.clip(T + np.clip(dT, -500.0, 500.0), 150.0, 6000.0))
        if abs(dT) < 1e-10 * max(T, 1.0):
            break
    return T


def calculate_mixture_temperature_from_enthalpy(
        mixture: Mixture, mixtureH: float,
        guesstemperature: float = 0.0) -> int:
    """Set ``mixture.temperature`` so that its molar enthalpy equals
    ``mixtureH`` [erg/mol]; returns 0."""
    if not isinstance(mixture, Mixture):
        raise TypeError("the first argument must be a Mixture object")
    h_mass = mixtureH / mixture.WTM
    T0 = guesstemperature if guesstemperature > 0.0 else (
        mixture._T if mixture._Tset else 1000.0)
    mixture.temperature = _solve_T_from_h(mixture._chem, mixture.Y, h_mass,
                                          T0)
    return 0


def interpolate_mixtures(mixtureleft: Mixture, mixtureright: Mixture,
                         ratio: float) -> Mixture:
    """(1 - ratio) left + ratio right in T, P and mass fractions."""
    if not 0.0 <= ratio <= 1.0:
        raise ValueError("ratio must be in [0, 1]")
    out = Mixture(mixtureleft._chem)
    out.temperature = ((1.0 - ratio) * mixtureleft.temperature
                       + ratio * mixtureright.temperature)
    out.pressure = ((1.0 - ratio) * mixtureleft.pressure
                    + ratio * mixtureright.pressure)
    Y = (1.0 - ratio) * mixtureleft.Y + ratio * mixtureright.Y
    out.Y = Y / Y.sum()
    return out


def compare_mixtures(mixtureA: Mixture, mixtureB: Mixture,
                     atol: float = 1.0e-10, rtol: float = 1.0e-3,
                     mode: str = "mass") -> Tuple[bool, float, float]:
    """Compare P [atm], T [K] and fractions of B against A: (same,
    max_abs_diff, max_rel_diff)."""
    use_mass = mode.lower() == "mass"
    vals_a = np.concatenate([[mixtureA.pressure / P_ATM,
                              mixtureA.temperature],
                             mixtureA.Y if use_mass else mixtureA.X])
    vals_b = np.concatenate([[mixtureB.pressure / P_ATM,
                              mixtureB.temperature],
                             mixtureB.Y if use_mass else mixtureB.X])
    diff = np.abs(vals_b - vals_a)
    denom = np.maximum(np.abs(vals_a), 1e-300)
    issame = bool(np.all((diff <= atol) | (diff / denom <= rtol)))
    return issame, float(diff.max()), float((diff / denom).max())


def calculate_equilibrium(chemID: int, p: float, t: float, frac, wt,
                          mode_in: str, mode_out: str, EQOption: int = 1,
                          useRealGas: int = 0):
    """Equilibrium state from (p, t, composition) through K6:
    ([P_eq, T_eq, 0, 0], composition)."""
    from .ops.equilibrium import equilibrate
    if EQOption == 10:
        raise NotImplementedError(CJ_TODO)
    if useRealGas:
        raise NotImplementedError(REALGAS_TODO)
    chem = get_chemistryset(chemID)
    frac = np.asarray(frac, dtype=np.double)
    if mode_in.lower() == "mole":
        Y = Mixture.mole_fraction_to_mass_fraction(frac, wt)
    else:
        Y = frac / frac.sum()
    res = equilibrate(chem.tm, float(t), float(p), Y, option=EQOption,
                      device=chem.device)
    if not bool(res.converged[0]):
        logger.warning("equilibrium solve did not converge (option %d, "
                       "residual %.2e)", EQOption, float(res.residual[0]))
    state = [float(res.P[0]), float(res.T[0]), 0.0, 0.0]
    comp = res.X if mode_out.lower() == "mole" else res.Y
    return state, _np(comp)


def equilibrium(mixture: Mixture, opt: int = 1) -> Mixture:
    """Equilibrium mixture from an initial mixture (options 1-9)."""
    if not isinstance(mixture, Mixture):
        raise TypeError("the argument must be a Mixture object")
    if mixture.validate() != 0:
        raise RuntimeError("mixture is not fully defined")
    state, comp = calculate_equilibrium(
        mixture.chemID, mixture.pressure, mixture.temperature, mixture.Y,
        mixture.WT, "mass", "mass", EQOption=opt)
    out = Mixture(mixture._chem)
    out.pressure = state[0]
    out.temperature = state[1]
    out.Y = comp
    return out


def detonation(mixture: Mixture):
    """The Chapman-Jouguet detonation: not ported."""
    raise NotImplementedError(CJ_TODO)
