"""Reactor-model framework: Keyword / Profile / ReactorModel base classes.

The port's copy of the JAX package's ``models/reactormodel.py`` (plain
Python): keywords are a typed, introspectable dict that the models read
when they build their solve calls into :mod:`pychemkin_tpu_torch.ops`;
the keyword names, defaults and keyword-line rendering are the
reference's, so decks written for it read the same.

Run-status convention preserved (reference: reactormodel.py:769-773):
-100 = not yet run, 0 = success, other = failed — but a failed batched
solve reports per-element status instead of aborting (SURVEY.md §5).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import telemetry
from ..logger import logger
from ..mixture import Mixture

KeywordValue = Union[bool, int, float, str]

#: run-status codes (reference: reactormodel.py:769-773)
STATUS_NOT_RUN = -100
STATUS_SUCCESS = 0
STATUS_FAILED = 1


class Keyword:
    """One typed solver keyword (reference: reactormodel.py:50-377).

    ``protected`` keywords are managed by property setters / dedicated
    methods and rejected by the generic ``setkeyword`` in API mode
    (reference: reactormodel.py:60-93)."""

    #: keywords only settable through dedicated APIs
    PROTECTED = (
        "TIME", "PRES", "TEMP", "VOL", "QLOS", "HTC", "TAMB", "AREAQ",
        "TAU", "FLRT", "XEND",
    )
    #: profile-carrying keywords (reference: reactormodel.py:94-110)
    PROFILE_KEYS = ("TPRO", "PPRO", "VPRO", "QPRO", "AINT", "AREA", "DPRO",
                    "GRID", "MBPRO")

    #: API-call mode (True) vs full-keyword mode (False): under the
    #: full-keyword mode the entire input deck — protected keywords
    #: included — is supplied as keyword lines (reference:
    #: reactormodel.py:116; required there for multi-zone HCCI,
    #: HCCI.py:95-96). Class-level, like the reference.
    noFullKeyword = True

    @staticmethod
    def setfullkeywords(mode: bool):
        """Turn the full-keyword input mode ON/OFF
        (reference: reactormodel.py:183)."""
        Keyword.noFullKeyword = not mode

    def __init__(self, phrase: str, value: KeywordValue,
                 protected: bool = False):
        self._phrase = str(phrase).upper()
        self._value = value
        self._type = type(value)
        self._protected = protected
        self._prefix = ""           # '!' disables (reference :313-347)

    def resetvalue(self, value: KeywordValue):
        """(reference: reactormodel.py:258)."""
        if not isinstance(value, self._type) and not (
                self._type is float and isinstance(value, int)):
            raise TypeError(
                f"keyword {self._phrase} expects {self._type.__name__}")
        self._value = self._type(value)

    @property
    def parametertype(self) -> type:
        return self._type

    @property
    def value(self) -> KeywordValue:
        return self._value

    @property
    def keyphrase(self) -> str:
        return self._phrase

    @property
    def protected(self) -> bool:
        return self._protected

    def getvalue_as_string(self) -> Tuple[int, str]:
        """Render the keyword input line (reference:
        reactormodel.py:349-377). Booleans render as the bare keyword
        (present = on); other types as 'KEY value'. A '!'-disabled
        keyword (see :meth:`keyprefix`) renders commented out."""
        if self._type is bool:
            line = self._phrase if self._value else ""
            err = 0 if self._value else 1
        else:
            err, line = 0, f"{self._phrase} {self._value}"
        if line and self._prefix:
            line = self._prefix + line
        return err, line

    @property
    def keyprefix(self) -> bool:
        """True when the keyword is active, False when disabled by the
        '!' comment prefix (reference: reactormodel.py:335)."""
        return self._prefix != "!"

    @keyprefix.setter
    def keyprefix(self, on: bool):
        """Enable/disable the keyword by toggling the '!' prefix
        (reference: reactormodel.py:313)."""
        self._prefix = "" if on else "!"

    def show(self):
        print(self.getvalue_as_string()[1])


class BooleanKeyword(Keyword):
    """(reference: reactormodel.py:378)."""

    def __init__(self, phrase: str, value: bool = True):
        super().__init__(phrase, bool(value))


class IntegerKeyword(Keyword):
    """(reference: reactormodel.py:399)."""

    def __init__(self, phrase: str, value: int = 0):
        super().__init__(phrase, int(value))


class RealKeyword(Keyword):
    """(reference: reactormodel.py:421)."""

    def __init__(self, phrase: str, value: float = 0.0):
        super().__init__(phrase, float(value))


class StringKeyword(Keyword):
    """(reference: reactormodel.py:443)."""

    def __init__(self, phrase: str, value: str = ""):
        super().__init__(phrase, str(value))


class Profile:
    """Piecewise-linear (x, y) profile keyword
    (reference: reactormodel.py:467-671)."""

    def __init__(self, key: str, x, y):
        x = np.asarray(x, dtype=np.double)
        y = np.asarray(y, dtype=np.double)
        if x.ndim != 1 or x.shape != y.shape:
            raise ValueError("profile x and y must be equal-length 1-D")
        if len(x) < 2:
            raise ValueError("profile needs at least two points")
        if np.any(np.diff(x) <= 0.0):
            raise ValueError("profile x values must be strictly increasing")
        self._key = str(key).upper()
        self._x = x
        self._y = y

    @property
    def size(self) -> int:
        return len(self._x)

    @property
    def pos(self) -> np.ndarray:
        return self._x

    @property
    def value(self) -> np.ndarray:
        return self._y

    @property
    def profilekey(self) -> str:
        return self._key

    def resetprofile(self, x, y):
        """(reference: reactormodel.py:602)."""
        self.__init__(self._key, x, y)

    def getprofile_as_string_list(self) -> Tuple[int, List[str]]:
        """Render as 'KEY x y' input lines (reference:
        reactormodel.py:632)."""
        return 0, [f"{self._key} {x} {y}" for x, y in zip(self._x, self._y)]

    def show(self):
        for line in self.getprofile_as_string_list()[1]:
            print(line)


class ReactorModel:
    """Base class of every reactor model (reference:
    reactormodel.py:672).

    Holds a deep copy of the reactor-condition mixture/stream (the
    reference deep-copies too, reactormodel.py:690), the keyword and
    profile dicts, the rate multiplier, analysis toggles, and run status.
    """

    def __init__(self, reactor_condition: Mixture, label: str):
        if not isinstance(reactor_condition, Mixture):
            raise TypeError("reactor condition must be a Mixture or Stream "
                            "(reference: reactormodel.py:682)")
        err = reactor_condition.validate()
        if err != 0:
            raise ValueError(
                f"reactor-condition mixture is incomplete (code {err})")
        self._condition = copy.deepcopy(reactor_condition)
        self.label = label
        self._keywords: Dict[str, Keyword] = {}
        self._profiles: Dict[str, Profile] = {}
        self._gasratemultiplier = 1.0
        self._TextOut = False
        self._XMLOut = False
        self.runstatus = STATUS_NOT_RUN
        self._speciesmode = "mass"
        # sensitivity / ROP analysis configuration
        # (reference: reactormodel.py:1522-1621)
        self._sensitivity = False
        self._sensitivity_opts: Dict[str, float] = {}
        self._rop_analysis = False
        self._rop_threshold = 0.0
        # per-solve telemetry filled by concrete run() implementations
        # (see solve_report)
        self._solve_report: Dict = {}
        # raw solution store (reference: reactormodel.py:775-788)
        self._solution_tags = ["time", "distance", "temperature", "pressure",
                               "volume", "velocity", "flowrate"]
        self._numbsolutionpoints = 0
        self._solution_rawarray: Dict[str, np.ndarray] = {}
        self._solution_mixturearray: List[Mixture] = []

    # --- chemistry plumbing -------------------------------------------------
    @property
    def chemID(self) -> int:
        return self._condition.chemID

    @property
    def chemistry(self):
        return self._condition.chemistry

    @property
    def mech(self):
        return self._condition.mech

    @property
    def numbspecies(self) -> int:
        return self._condition.KK

    @property
    def _specieslist(self) -> list:
        return self._condition.species_symbols

    @property
    def reactor_condition(self) -> Mixture:
        return self._condition

    # --- state passthroughs (reference: reactormodel.py:1293-1423) ---------
    @property
    def temperature(self) -> float:
        return self._condition.temperature

    @temperature.setter
    def temperature(self, t: float):
        self._condition.temperature = t

    @property
    def pressure(self) -> float:
        return self._condition.pressure

    @pressure.setter
    def pressure(self, p: float):
        self._condition.pressure = p

    @property
    def X(self) -> np.ndarray:
        return self._condition.X

    @X.setter
    def X(self, recipe):
        self._condition.X = recipe

    @property
    def Y(self) -> np.ndarray:
        return self._condition.Y

    @Y.setter
    def Y(self, recipe):
        self._condition.Y = recipe

    # --- keyword management (reference: reactormodel.py:835-1056) ----------
    def setkeyword(self, key: str, value: KeywordValue):
        """Set or update a keyword (reference: reactormodel.py:861).
        In API mode, protected keywords (TIME, PRES, QLOS, ...) must be
        set through their dedicated property setters; under the
        full-keyword mode (``Keyword.setfullkeywords(True)``) the whole
        deck — protected keywords included — arrives as keyword lines
        (reference: reactormodel.py:116-183)."""
        phrase = str(key).upper()
        if Keyword.noFullKeyword and phrase in Keyword.PROTECTED:
            raise ValueError(
                f"keyword {phrase} is protected; use its dedicated "
                "property/method (reference: reactormodel.py:60-93)")
        self._record_keyword(phrase, value)

    def _record_keyword(self, key: str, value: KeywordValue):
        """Store a keyword without the protected-list check — the path the
        dedicated property setters use."""
        phrase = str(key).upper()
        if phrase in self._keywords:
            self._keywords[phrase].resetvalue(value)
            return
        if isinstance(value, bool):
            kw: Keyword = BooleanKeyword(phrase, value)
        elif isinstance(value, int):
            kw = IntegerKeyword(phrase, value)
        elif isinstance(value, float):
            kw = RealKeyword(phrase, value)
        else:
            kw = StringKeyword(phrase, str(value))
        self._keywords[phrase] = kw

    def getkeyword(self, key: str) -> Optional[KeywordValue]:
        """Value of a set keyword, else None."""
        kw = self._keywords.get(str(key).upper())
        return None if kw is None else kw.value

    def removekeyword(self, key: str):
        """(reference: reactormodel.py:916)."""
        self._keywords.pop(str(key).upper(), None)

    def createkeywordinputlines(self) -> Tuple[int, List[str]]:
        """Render all keywords as deck lines (reference:
        reactormodel.py:966); profiles render after scalars."""
        lines = []
        for kw in self._keywords.values():
            err, line = kw.getvalue_as_string()
            if err == 0 and line:
                lines.append(line)
        for prof in self._profiles.values():
            lines.extend(prof.getprofile_as_string_list()[1])
        return 0, lines

    def showkeywordinputlines(self):
        for line in self.createkeywordinputlines()[1]:
            print(line)

    # --- profiles (reference: reactormodel.py:1057-1187) -------------------
    def setprofile(self, key: str, x, y):
        """Attach or replace a piecewise-linear profile
        (reference: reactormodel.py:1083)."""
        phrase = str(key).upper()
        if phrase in self._profiles:
            self._profiles[phrase].resetprofile(x, y)
        else:
            self._profiles[phrase] = Profile(phrase, x, y)

    def getprofile(self, key: str) -> Optional[Profile]:
        return self._profiles.get(str(key).upper())

    def removeprofile(self, key: str):
        self._profiles.pop(str(key).upper(), None)

    # --- rate multiplier (reference: reactormodel.py:1440) -----------------
    @property
    def gasratemultiplier(self) -> float:
        return self._gasratemultiplier

    @gasratemultiplier.setter
    def gasratemultiplier(self, value: float):
        if value < 0.0:
            raise ValueError("reaction rate multiplier must be >= 0")
        self._gasratemultiplier = float(value)
        self.setkeyword("GFAC", float(value))

    def _effective_tm(self):
        """The mechanism's tensors on the chemistry's device, with the gas
        rate multiplier folded into the forward A-factors."""
        chem = self.chemistry
        if self._gasratemultiplier == 1.0:
            return chem.tm
        import dataclasses

        from ..mechanism import TorchMechanism
        rec = dataclasses.replace(
            chem.mech, A=np.asarray(chem.mech.A) * self._gasratemultiplier)
        return TorchMechanism(rec, chem.device)

    # --- output toggles (reference: reactormodel.py:1471-1521) -------------
    @property
    def STD_Output(self) -> bool:
        return self._TextOut

    @STD_Output.setter
    def STD_Output(self, mode: bool):
        self._TextOut = bool(mode)
        self.setkeyword("NO_SDOUTPUT_WRITE", not mode)

    @property
    def XML_Output(self) -> bool:
        return self._XMLOut

    @XML_Output.setter
    def XML_Output(self, mode: bool):
        self._XMLOut = bool(mode)
        self.setkeyword("NO_XMLOUTPUT_WRITE", not mode)

    # --- analyses (reference: reactormodel.py:1522-1621) -------------------
    def setsensitivityanalysis(self, mode: bool = True,
                               absolute_tolerance: Optional[float] = None,
                               relative_tolerance: Optional[float] = None,
                               temperature_threshold: Optional[float] = None,
                               species_threshold: Optional[float] = None):
        """Enable A-factor sensitivity analysis (reference:
        reactormodel.py:1522, keywords ASEN/ATLS/RTLS/EPST/EPSS). The
        keywords are recorded; the port's models do not compute
        sensitivities yet."""
        self._sensitivity = bool(mode)
        self.setkeyword("ASEN", bool(mode))
        if absolute_tolerance is not None:
            self._sensitivity_opts["atol"] = float(absolute_tolerance)
            self.setkeyword("ATLS", float(absolute_tolerance))
        if relative_tolerance is not None:
            self._sensitivity_opts["rtol"] = float(relative_tolerance)
            self.setkeyword("RTLS", float(relative_tolerance))
        if temperature_threshold is not None:
            self._sensitivity_opts["temp_threshold"] = float(
                temperature_threshold)
            self.setkeyword("EPST", float(temperature_threshold))
        if species_threshold is not None:
            self._sensitivity_opts["spec_threshold"] = float(
                species_threshold)
            self.setkeyword("EPSS", float(species_threshold))

    def setROPanalysis(self, mode: bool = True,
                       threshold: Optional[float] = None):
        """Enable rate-of-production analysis (reference:
        reactormodel.py:1585, keywords AROP/EPSR)."""
        self._rop_analysis = bool(mode)
        self.setkeyword("AROP", bool(mode))
        if threshold is not None:
            self._rop_threshold = float(threshold)
            self.setkeyword("EPSR", float(threshold))

    # --- full-keyword deck input (reference: reactormodel.py:116-183) ------
    def apply_keyword_deck(self, deck):
        """Apply a text input deck: one 'KEY value...' line per keyword,
        CHEMKIN comment ('!') and END conventions. Repeated
        profile-keyword lines (TPRO/VPRO/...) accumulate into profiles;
        REAC lines set the reactor-condition composition in the current
        species mode. Requires the full-keyword mode to already be ON
        (``Keyword.setfullkeywords(True)``) because the deck may carry
        protected keywords — the exact contract of the reference's
        full-keyword path (batchreactor.py:822).
        """
        if Keyword.noFullKeyword:
            raise RuntimeError(
                "apply_keyword_deck requires the full-keyword mode: "
                "call Keyword.setfullkeywords(True) first "
                "(reference: reactormodel.py:116)")
        if isinstance(deck, str):
            lines = deck.splitlines()
        else:
            lines = list(deck)
        prof_acc: Dict[str, List[Tuple[float, float]]] = {}
        reac: Dict[str, float] = {}
        for raw in lines:
            line = raw.split("!", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0].upper()
            if key == "END":
                break
            if key in Keyword.PROFILE_KEYS and len(parts) >= 3:
                prof_acc.setdefault(key, []).append(
                    (float(parts[1]), float(parts[2])))
                continue
            if key == "REAC" and len(parts) >= 3:
                reac[parts[1]] = float(parts[2])
                continue
            if len(parts) == 1:
                self._record_keyword(key, True)
            else:
                val_s = parts[1]
                try:
                    value: KeywordValue = int(val_s)
                except ValueError:
                    try:
                        value = float(val_s)
                    except ValueError:
                        value = " ".join(parts[1:])
                self._record_keyword(key, value)
        for key, pts in prof_acc.items():
            xs, ys = zip(*pts)
            self.setprofile(key, xs, ys)
        if reac:
            if self._speciesmode == "mole":
                self._condition.X = reac
            else:
                self._condition.Y = reac

    def consume_protected_keywords(self):
        """Route protected keywords captured from a full-keyword deck
        into the typed model state. Every concrete ``run()`` calls this
        first, so deck-configured reactors behave like API-configured
        ones (the reference routes them inside
        __process_keywords_withFullInputs, batchreactor.py:822). Units
        follow the reference's keyword conventions: PRES in atm, TEMP
        K, TIME s, VOL cm^3, heat-transfer keywords CGS."""
        if Keyword.noFullKeyword:
            return
        from ..constants import P_ATM

        v = self.getkeyword("TEMP")
        if v is not None:
            self._condition.temperature = float(v)
        v = self.getkeyword("PRES")
        if v is not None:
            self._condition.pressure = float(v) * P_ATM
        # model-level scalars: keyword -> (attribute, scale); applied
        # only where the concrete model has the attribute
        for key, attr, scale in (
                ("TIME", "time", 1.0),
                ("VOL", "volume", 1.0),
                ("TAU", "residence_time", 1.0),
                ("XEND", "length", 1.0),
                ("FLRT", "mass_flowrate", 1.0),
                ("QLOS", "heat_loss_rate", 1.0),
                ("HTC", "heat_transfer_coefficient", 1.0),
                ("TAMB", "ambient_temperature", 1.0),
                ("AREAQ", "area", 1.0)):
            v = self.getkeyword(key)
            if v is not None:
                prop = getattr(type(self), attr, None)
                settable = hasattr(self, attr) and not (
                    isinstance(prop, property) and prop.fset is None)
                if not settable:
                    logger.warning(
                        "deck keyword %s has no effect on %s", key,
                        type(self).__name__)
                    continue
                setattr(self, attr, float(v) * scale)
        atol, rtol = self.getkeyword("ATOL"), self.getkeyword("RTOL")
        if (atol is not None or rtol is not None) and hasattr(
                self, "tolerances"):
            a0, r0 = self.tolerances
            self.tolerances = (float(atol) if atol is not None else a0,
                               float(rtol) if rtol is not None else r0)

    # --- solution writers (reference: reactormodel.py:1471-1521 ------------
    # STD_Output / XML_Output; the reference's native library writes
    # these during the run, here they are written by process_solution)
    def write_solution_files(self, basename: Optional[str] = None):
        """Write the processed solution as a text file (STD_Output) and
        an XML file (XML_Output), whichever toggles are on. Returns the
        list of paths written."""
        if not self.getrawsolutionstatus():
            raise RuntimeError("no solution available; run() and "
                               "process_solution() first")
        base = basename or (self.label.strip().replace(" ", "_") or
                            "solution")
        written = []
        cols = [t for t in self._solution_tags
                if t in self._solution_rawarray]
        cols += [s for s in self._specieslist
                 if s in self._solution_rawarray]
        n = self._numbsolutionpoints
        if self._TextOut:
            path = base + ".out"
            with open(path, "w") as f:
                f.write("! pychemkin_tpu_torch solution: %s\n" % self.label)
                f.write(" ".join(f"{c:>16s}" for c in cols) + "\n")
                for i in range(n):
                    f.write(" ".join(
                        f"{float(self._solution_rawarray[c][i]):16.8e}"
                        for c in cols) + "\n")
            written.append(path)
        if self._XMLOut:
            import xml.etree.ElementTree as ET

            root = ET.Element("chemkin_solution", label=self.label,
                              points=str(n))
            for c in cols:
                var = ET.SubElement(root, "variable", name=c)
                var.text = " ".join(
                    repr(float(v)) for v in self._solution_rawarray[c])
            path = base + ".xml"
            ET.ElementTree(root).write(path)
            written.append(path)
        return written

    @staticmethod
    def read_solution_file(path: str) -> Dict[str, np.ndarray]:
        """Re-parse a solution file written by
        :meth:`write_solution_files` (text or XML) back into
        {variable: array} — the round-trip the output tests use."""
        if path.endswith(".xml"):
            import xml.etree.ElementTree as ET

            root = ET.parse(path).getroot()
            return {v.get("name"): np.asarray(
                [float(t) for t in (v.text or "").split()])
                for v in root.findall("variable")}
        out: Dict[str, list] = {}
        with open(path) as f:
            rows = [ln for ln in f if not ln.startswith("!")]
        header = rows[0].split()
        data = np.asarray([[float(v) for v in ln.split()]
                           for ln in rows[1:]])
        return {h: data[:, i] for i, h in enumerate(header)}

    # --- composition accessors (reference: reactormodel.py:1330-1423) ------
    @property
    def molefraction(self) -> np.ndarray:
        """Reactor-condition mole fractions (reference:
        reactormodel.py:1330)."""
        return self._condition.X

    @molefraction.setter
    def molefraction(self, recipe):
        self._condition.X = recipe

    @property
    def massfraction(self) -> np.ndarray:
        """Reactor-condition mass fractions (reference:
        reactormodel.py:1365)."""
        return self._condition.Y

    @massfraction.setter
    def massfraction(self, recipe):
        self._condition.Y = recipe

    @property
    def concentration(self) -> np.ndarray:
        """Reactor-condition molar concentrations [mol/cm^3]
        (reference: reactormodel.py:1400)."""
        return self._condition.concentration

    def list_composition(self, mode: str = "mole", bound: float = 0.0):
        """(reference: reactormodel.py:1424)."""
        self._condition.list_composition(mode=mode, bound=bound)

    def setsolutionspeciesfracmode(self, mode: str = "mass"):
        """Species-fraction type for post-processed solutions
        (reference: reactormodel.py:1816)."""
        if mode.lower() not in ("mole", "mass"):
            raise ValueError("species fraction mode must be 'mass' or "
                             "'mole'")
        self._speciesmode = mode.lower()

    # --- reactor-level real-gas toggles (reference: 1622-1719) -------------
    def userealgasEOS(self, mode: bool = True):
        """Enable/disable the cubic EOS for this reactor's chemistry
        set (reference: reactormodel.py:1622)."""
        if mode:
            self.chemistry.use_realgas_cubicEOS()
        else:
            self.chemistry.use_idealgas_law()

    def realgas(self) -> bool:
        """(reference: reactormodel.py:1680)."""
        return bool(self.chemistry.userealgas)

    def setrealgasmixingmodel(self, rule: int = 0):
        """(reference: reactormodel.py:1700)."""
        self.chemistry.set_realgas_mixing_rule(rule)

    # --- run status (reference: reactormodel.py:1720-1764) -----------------
    def getrunstatus(self) -> int:
        return self.runstatus

    def setrunstatus(self, status: int):
        """(reference: reactormodel.py:1745)."""
        self.runstatus = int(status)

    def checkrunstatus(self) -> bool:
        return self.runstatus == STATUS_SUCCESS

    def getrawsolutionstatus(self) -> bool:
        return self._numbsolutionpoints > 0

    def getnumbersolutionpoints(self) -> int:
        """(reference: reactormodel.py:1836)."""
        return self._numbsolutionpoints

    def getmixturesolutionstatus(self) -> bool:
        """(reference: reactormodel.py:1848)."""
        return len(self._solution_mixturearray) > 0

    def run(self) -> int:  # pragma: no cover - abstract template
        """Template method; concrete reactors override
        (reference: reactormodel.py:1792)."""
        raise NotImplementedError

    # --- per-solve telemetry ------------------------------------------------
    def solve_report(self) -> Dict:
        """Per-solve counters of the LAST run(): wall_s, solver work
        (n_steps / n_rejected / n_newton as applicable), success, plus
        model-specific fields. Empty dict before any run. The same dict
        is emitted as a ``solve`` telemetry event and logged at INFO when
        the run records it."""
        return dict(self._solve_report)

    @property
    def solve_status(self) -> Optional[int]:
        """Machine-readable :class:`SolveStatus` code of the last
        ``run()`` (None before any run) — the structured reason behind
        a failed ``runstatus``, not just that it failed."""
        return self._solve_report.get("status")

    @property
    def solve_status_name(self) -> Optional[str]:
        """Human/telemetry name of :attr:`solve_status`."""
        return self._solve_report.get("status_name")

    def _record_solve(self, **fields) -> Dict:
        """Store + emit this run's telemetry (concrete ``run()``s call
        this once per solve)."""
        report: Dict = {"model": type(self).__name__, "label": self.label}
        report.update(fields)
        self._solve_report = report
        rec = telemetry.get_recorder()
        rec.event("solve", **report)
        rec.inc("model.solves")
        if not report.get("success", True):
            rec.inc("model.failed_solves")
        sname = report.get("status_name")
        if sname and sname != "OK":
            rec.inc(f"model.status.{sname}")
        logger.info(
            "solve_report %s(%s): %s", type(self).__name__, self.label,
            " ".join(f"{k}={v}" for k, v in report.items()
                     if k not in ("model", "label")))
        return report

    # --- solution plumbing (reference: reactormodel.py:1816-1919) ----------
    def get_solution_variable_profile(self, varname: str) -> np.ndarray:
        """Profile of a state variable ('time', 'temperature', ...) or a
        species symbol (reference: batchreactor.py:1437)."""
        if not self.getrawsolutionstatus():
            raise RuntimeError("no solution available; run() and "
                               "process_solution() first")
        vname = varname.strip()
        if vname.lower() in self._solution_tags:
            return self._solution_rawarray[vname.lower()]
        if vname in self._specieslist:
            return self._solution_rawarray[vname]
        # case-insensitive species fallback
        for s in self._specieslist:
            if s.upper() == vname.upper():
                return self._solution_rawarray[s]
        raise KeyError(f"unknown solution variable {varname!r}")
