"""MechanismRecord (numpy) and TorchMechanism (device tensors).

``MechanismRecord`` is a frozen dataclass of numpy arrays with the same
field names as the JAX package's record, so a record can be carried
across field by field (:func:`from_numpy_fields`). ``TorchMechanism``
holds what the kinetics code and the CUDA kernels read: f64/int32
tensors on one device, including the staged index sets and their CSR
views (:mod:`.staging`).

Array-shape glossary: KK = n species, MM = n elements, II = n reactions.
Units are CGS + mol + K; activation energies are stored as Ea/R in K.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# falloff_type codes (broadening form; orthogonal to is_chem_act)
FALLOFF_NONE = 0
FALLOFF_LINDEMANN = 1
FALLOFF_TROE = 2
FALLOFF_SRI = 3

# third-body codes
TB_NONE = 0      # no third body
TB_MIXTURE = 1   # +M with efficiency row
TB_SPECIES = 2   # specific collider, e.g. (+H2O): eff row is one-hot


@dataclasses.dataclass(frozen=True)
class MechanismRecord:
    """Complete mechanism data: elements, species, NASA-7 thermo,
    reactions, rate parameters and (optionally) transport."""

    # ---- static metadata ---------------------------------------------------
    element_names: tuple
    species_names: tuple
    reaction_equations: tuple
    has_transport: bool

    # ---- element/species data ----------------------------------------------
    awt: Any = None        # [MM] atomic weights, g/mol
    wt: Any = None         # [KK] molecular weights, g/mol
    ncf: Any = None        # [KK, MM] elemental composition counts
    nasa_coeffs: Any = None  # [KK, 2, 7]: [:, 0] low-T range, [:, 1] high-T
    nasa_T: Any = None       # [KK, 3]  (Tlow, Tmid, Thigh)

    # ---- reaction stoichiometry --------------------------------------------
    nu_f: Any = None       # [II, KK] forward (reactant) coefficients
    nu_r: Any = None       # [II, KK] reverse (product) coefficients
    order_f: Any = None    # [II, KK] concentration exponents (FORD)
    order_r: Any = None    # [II, KK] (RORD)
    ford_frac_entries: tuple = ()   # ((i, k), ...) fractional FORD entries
    rord_frac_entries: tuple = ()
    has_order_overrides: bool = False

    # ---- Arrhenius ----------------------------------------------------------
    A: Any = None          # [II] pre-exponential (cgs mole units)
    beta: Any = None       # [II] temperature exponent
    Ea_R: Any = None       # [II] activation temperature, K
    reversible: Any = None     # [II] bool
    has_rev_params: Any = None  # [II] bool: explicit REV parameters
    rev_A: Any = None
    rev_beta: Any = None
    rev_Ea_R: Any = None

    # ---- third body / falloff ----------------------------------------------
    tb_type: Any = None    # [II] int: TB_NONE / TB_MIXTURE / TB_SPECIES
    tb_eff: Any = None     # [II, KK] third-body efficiencies
    falloff_type: Any = None  # [II] int (NONE/LINDEMANN/TROE/SRI)
    is_chem_act: Any = None   # [II] bool: chemically activated (HIGH)
    low_A: Any = None
    low_beta: Any = None
    low_Ea_R: Any = None
    troe: Any = None       # [II, 4] (a, T3*, T1*, T2*); T2* = inf if absent
    sri: Any = None        # [II, 5] (a, b, c, d, e)

    # ---- PLOG (compact over the rows carrying tables) -----------------------
    plog_idx: Any = None       # [IIp] int32
    plog_ln_P: Any = None      # [IIp, L]
    plog_n_levels: Any = None  # [IIp] int32
    plog_A: Any = None         # [IIp, L, Tm]
    plog_beta: Any = None
    plog_Ea_R: Any = None

    # ---- Jacobian sparsity metadata -----------------------------------------
    jac_falloff_rows: tuple = None
    jac_tb_rows: tuple = None
    jac_active_species: tuple = None
    nu_nnz_frac: float = None

    # ---- staged sparse-kernel index sets (mechanism.staging.StagedRop) ------
    rop_stage: Any = None

    # ---- transport ----------------------------------------------------------
    geom: Any = None
    eps_k: Any = None
    sigma: Any = None
    dipole: Any = None
    polar: Any = None
    zrot: Any = None

    @property
    def n_elements(self) -> int:
        return len(self.element_names)

    @property
    def n_species(self) -> int:
        return len(self.species_names)

    @property
    def n_reactions(self) -> int:
        return len(self.reaction_equations)

    def species_index(self, name: str) -> int:
        """Index of species ``name`` (case-insensitive)."""
        names = [s.upper() for s in self.species_names]
        return names.index(name.upper())


#: fields holding numpy arrays (everything :func:`from_numpy_fields`
#: carries across as data)
ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(MechanismRecord)
    if f.name not in ("element_names", "species_names", "reaction_equations",
                      "has_transport", "ford_frac_entries",
                      "rord_frac_entries", "has_order_overrides",
                      "jac_falloff_rows", "jac_tb_rows",
                      "jac_active_species", "nu_nnz_frac", "rop_stage"))


def jac_sparsity_fields(nu_f, nu_r, order_f, order_r, tb_type,
                        falloff_type) -> dict:
    """Static Jacobian-sparsity metadata from concrete stoichiometry
    arrays: the falloff rows, the third-body rows, the active species
    and the nonzero fraction of nu."""
    nu_f = np.asarray(nu_f)
    nu_r = np.asarray(nu_r)
    nu = nu_r - nu_f
    order_f = nu_f if order_f is None else np.asarray(order_f)
    order_r = nu_r if order_r is None else np.asarray(order_r)
    falloff = np.asarray(falloff_type) != FALLOFF_NONE
    third_body = (np.asarray(tb_type) != TB_NONE) | falloff
    active = (nu != 0).any(axis=0) | (order_f != 0).any(axis=0) \
        | (order_r != 0).any(axis=0)
    return dict(
        jac_falloff_rows=tuple(np.where(falloff)[0].tolist()),
        jac_tb_rows=tuple(np.where(third_body)[0].tolist()),
        jac_active_species=tuple(np.where(active)[0].tolist()),
        nu_nnz_frac=round(float(np.count_nonzero(nu)) / max(nu.size, 1), 4),
    )


def from_numpy_fields(fields: dict, *, element_names, species_names,
                      reaction_equations, has_transport,
                      ford_frac_entries=(), rord_frac_entries=(),
                      has_order_overrides=False) -> MechanismRecord:
    """Build the port's record from another record's array leaves turned
    into numpy (``{name: np.ndarray}`` over :data:`ARRAY_FIELDS`) plus
    its static metadata: the system's analogue of carrying weights
    across. The derived sparsity fields and the staged index sets are
    recomputed here from the carried arrays."""
    from .staging import stage_rop

    missing = [n for n in ARRAY_FIELDS if n not in fields]
    if missing:
        raise KeyError(f"missing record fields: {missing}")
    arrays = {n: np.array(fields[n], copy=True) for n in ARRAY_FIELDS}
    rec = MechanismRecord(
        element_names=tuple(element_names),
        species_names=tuple(species_names),
        reaction_equations=tuple(reaction_equations),
        has_transport=bool(has_transport),
        ford_frac_entries=tuple(tuple(int(v) for v in e)
                                for e in ford_frac_entries),
        rord_frac_entries=tuple(tuple(int(v) for v in e)
                                for e in rord_frac_entries),
        has_order_overrides=bool(has_order_overrides),
        **jac_sparsity_fields(arrays["nu_f"], arrays["nu_r"],
                              arrays["order_f"], arrays["order_r"],
                              arrays["tb_type"], arrays["falloff_type"]),
        **arrays)
    return dataclasses.replace(rec, rop_stage=stage_rop(rec))


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that it compares equal to the ``.device`` of tensors made on it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class TorchMechanism:
    """The mechanism as f64/int32 tensors on one device, with the staged
    index sets and CSR views the kinetics code and kernels read.

    Attribute names follow the record (``wt``, ``A``, ...); compact row
    subsets carry a prefix (``fo_*`` falloff rows, ``tb_*`` third-body
    rows, ``rev_*`` reversible rows)."""

    def __init__(self, rec: MechanismRecord, device):
        st = rec.rop_stage
        if st is None:
            raise ValueError("TorchMechanism needs a staged record")
        self.record = rec
        self.device = canonical_device(device)
        self._ix = {}
        self.KK = rec.n_species
        self.II = rec.n_reactions
        self.MM = rec.n_elements
        self.N = self.KK + 1
        f64 = dict(dtype=torch.float64, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)

        def F(a):
            return torch.as_tensor(np.array(a, dtype=np.float64),
                                   **f64)

        def I(a):
            return torch.as_tensor(np.array(a, dtype=np.int32),
                                   **i32)

        nu = np.asarray(rec.nu_r, np.float64) - np.asarray(rec.nu_f,
                                                           np.float64)
        self.wt = F(rec.wt)
        self.ncf = F(np.asarray(rec.ncf).reshape(self.KK, self.MM))  # [KK, MM]
        self.nasa_lo = F(np.asarray(rec.nasa_coeffs)[:, 0, :])
        self.nasa_hi = F(np.asarray(rec.nasa_coeffs)[:, 1, :])
        self.t_mid = F(np.asarray(rec.nasa_T)[:, 1])
        self.nu = F(nu)                                   # [II, KK]
        self.A = F(rec.A)
        self.beta = F(rec.beta)
        self.Ea_R = F(rec.Ea_R)
        tb_type = np.asarray(rec.tb_type)
        ftype = np.asarray(rec.falloff_type)
        plain_tb = (tb_type == TB_MIXTURE) & (ftype == FALLOFF_NONE)
        self.plain_tb = torch.as_tensor(plain_tb, device=self.device)
        self.plain_tb_i = I(plain_tb)

        # falloff rows
        fo = np.asarray(st.falloff_rows, np.int64)
        self.fo_rows = I(fo)
        self.fo_lowA = F(np.asarray(rec.low_A)[fo])
        self.fo_lowb = F(np.asarray(rec.low_beta)[fo])
        self.fo_lowE = F(np.asarray(rec.low_Ea_R)[fo])
        self.fo_type = I(ftype[fo])
        self.fo_chem = I(np.asarray(rec.is_chem_act)[fo])
        self.any_troe = bool((ftype[fo] == FALLOFF_TROE).any())
        self.any_sri = bool((ftype[fo] == FALLOFF_SRI).any())
        self.fo_troe = F(np.asarray(rec.troe)[fo].reshape(-1, 4))
        self.fo_sri = F(np.asarray(rec.sri)[fo].reshape(-1, 5))

        # third-body rows: dense efficiency rows over the compact subset
        tb = np.asarray(st.tb_rows, np.int64)
        self.tb_rows = I(tb)
        self.tb_eff = F(np.asarray(rec.tb_eff)[tb].reshape(-1, self.KK))

        # reversible rows: ln Kc via the staged nu entries (CSR over
        # the compact reversible index), explicit-REV parameters
        rev = np.asarray(st.rev_rows, np.int64)
        self.rev_rows = I(rev)
        self.rev_dnu = F(nu[rev].sum(axis=1))
        self.rev_hasp = I(np.asarray(rec.has_rev_params)[rev])
        self.rev_A = F(np.asarray(rec.rev_A)[rev])
        self.rev_beta = F(np.asarray(rec.rev_beta)[rev])
        self.rev_Ea_R = F(np.asarray(rec.rev_Ea_R)[rev])
        self.kc_seg = I(st.kc_seg)
        self.kc_sp = I(st.kc_sp)
        self.kc_coef = F(nu[st.kc_rxn, st.kc_sp])
        self.kc_ptr = I(st.kc_ptr)

        # concentration-product entry lists (COO sorted by row, + CSR)
        ord_f = np.asarray(rec.order_f, np.float64)
        ord_r = np.asarray(rec.order_r, np.float64)
        self.of_rxn = I(st.of_rxn)
        self.of_sp = I(st.of_sp)
        self.of_coef = F(ord_f[st.of_rxn, st.of_sp])
        self.of_ptr = I(st.of_ptr)
        self.or_rxn = I(st.or_rxn)
        self.or_sp = I(st.or_sp)
        self.or_coef = F(ord_r[st.or_rxn, st.or_sp])
        self.or_ptr = I(st.or_ptr)

        # nu by species (CSR): wdot_k = sum_i nu[i, k] q_i
        self.nus_ptr = I(st.nus_ptr)
        self.nus_rxn = I(st.nus_rxn)
        self.nus_coef = F(nu[st.nus_rxn, np.repeat(
            np.arange(self.KK), np.diff(st.nus_ptr))])

        # Jacobian triple products with segment offsets over jac_seg
        self.jac_rxn = I(st.jac_rxn)
        self.jac_seg = I(st.jac_seg)
        self.jac_cf = F(nu[st.jac_rxn, st.jac_ko]
                        * ord_f[st.jac_rxn, st.jac_ki])
        self.jac_cr = F(nu[st.jac_rxn, st.jac_ko]
                        * ord_r[st.jac_rxn, st.jac_ki])
        self.jac_ptr = I(st.jac_ptr)

        # third-body correction by output species (CSR): entries
        # (compact tb index j, nu[tb_rows[j], ko]) for nu != 0
        self.tbs_ptr = I(st.tbs_ptr)
        self.tbs_row = I(st.tbs_row)
        self.tbs_nu = F(nu[tb[st.tbs_row], np.repeat(
            np.arange(self.KK), np.diff(st.tbs_ptr))] if tb.size else
            np.zeros(0))

        # fractional FORD/RORD orders: per ord entry and per Jacobian
        # triple, whether it reads the FRAC_ORDER_FLOOR-clamped ln C
        self.of_frac = I(st.of_frac)
        self.or_frac = I(st.or_frac)
        self.jac_ff = I(st.jac_ff)
        self.jac_rf = I(st.jac_rf)
        self.any_frac = bool(st.of_frac.any() or st.or_frac.any())

        # PLOG rows (compact, padded by level and by term as the record):
        # ln P levels [n_plog, L], Arrhenius terms [n_plog, L, Tm]
        plog = np.asarray(rec.plog_idx, np.int64).reshape(-1)
        self.n_plog = int(plog.size)
        self.plog_idx = I(plog)
        pos = np.full(self.II, -1, dtype=np.int64)
        pos[plog] = np.arange(plog.size)
        self.plog_pos = I(pos)
        ln_P = np.asarray(rec.plog_ln_P, np.float64)
        self.plog_L = int(ln_P.shape[1]) if plog.size else 1
        self.plog_Tm = int(np.asarray(rec.plog_A).shape[2]) if plog.size \
            else 1
        self.plog_ln_P = F(ln_P.reshape(-1, self.plog_L))
        self.plog_n_levels = I(np.asarray(rec.plog_n_levels).reshape(-1))
        for name in ("plog_A", "plog_beta", "plog_Ea_R"):
            setattr(self, name, F(np.asarray(getattr(rec, name), np.float64)
                                  .reshape(-1, self.plog_L, self.plog_Tm)))

        # transport columns [KK] (ops/transport.py, kernels K9-K11):
        # geometry code, LJ eps/k (K) and sigma (Angstrom), dipole
        # (Debye), polarizability (Angstrom^3), Zrot at 298 K
        self.has_transport = bool(rec.has_transport)
        if self.has_transport:
            self.geom = I(rec.geom)
            for name in ("eps_k", "sigma", "dipole", "polar", "zrot"):
                setattr(self, name, F(getattr(rec, name)))

    def ix(self, name):
        """The int32 index tensor ``name`` as int64, for PyTorch indexing
        (cached)."""
        t = self._ix.get(name)
        if t is None:
            t = self._ix[name] = getattr(self, name).long()
        return t

    def to(self, device) -> "TorchMechanism":
        """The same mechanism on another device."""
        return TorchMechanism(self.record, device)
