"""Search, interpolation and stoichiometry helpers of the port: the JAX
package's ``utilities.py`` (pure NumPy host-side helpers), kept as its own
copy so that the port imports nothing of that package."""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from .logger import logger


def bisect(value: float, array: Sequence[float]) -> int:
    """Index i such that array[i] <= value < array[i+1] for an ascending
    array (reference: utilities.py:81). Returns -1 if out of range below,
    len-1 if beyond the end."""
    arr = np.asarray(array)
    if value < arr[0]:
        return -1
    return int(np.searchsorted(arr, value, side="right") - 1)


def find_interpolate_parameters(value: float,
                                array: Sequence[float]) -> Tuple[int, float]:
    """Bracketing index and linear weight for interpolation at ``value``
    (reference: utilities.py:114). Clamped at the array ends."""
    arr = np.asarray(array, dtype=np.double)
    n = len(arr)
    i = int(np.clip(np.searchsorted(arr, value, side="right") - 1, 0, n - 2))
    dx = arr[i + 1] - arr[i]
    frac = 0.0 if dx == 0 else (value - arr[i]) / dx
    return i, float(np.clip(frac, 0.0, 1.0))


def interpolate_array(xarray: Sequence[float], yarray: Sequence[float],
                      x: float) -> float:
    """Piecewise-linear interpolation of y(x), clamped outside the range
    (reference: utilities.py:169)."""
    i, frac = find_interpolate_parameters(x, xarray)
    y = np.asarray(yarray, dtype=np.double)
    return float((1.0 - frac) * y[i] + frac * y[i + 1])


def create_mixture_recipe_from_fractions(
        chemistryset, frac: Sequence[float],
        threshold: float = 0.0) -> List[Tuple[str, float]]:
    """Convert a full [KK] fraction array into a recipe — a list of
    (species symbol, fraction) tuples for entries above ``threshold``
    (reference: utilities.py:199)."""
    names = chemistryset.species_symbols
    arr = np.asarray(frac, dtype=np.double)
    if len(arr) != len(names):
        raise ValueError(f"fraction array must have size {len(names)}")
    return [(names[i], float(arr[i])) for i in range(len(names))
            if arr[i] > threshold]


def calculate_stoichiometrics(
        chemistryset, fuel_molefrac: Sequence[float],
        oxid_molefrac: Sequence[float],
        prod_index: Sequence[int]) -> Tuple[float, np.ndarray]:
    """Stoichiometric coefficients of the complete-combustion reaction

        (fuel mixture) + alpha (oxidizer mixture) -> sum_p nu_p prod_p

    by solving the element-conservation linear system A x = b
    (reference: utilities.py:295-489, np.linalg.solve at :485).

    The unknowns are alpha (the oxidizer multiplier) and one nu per
    product species; the products must number exactly one less than the
    elements participating in the fuel+oxidizer mixtures.

    Returns (alpha, nu[len(prod_index)]).
    """
    mech = chemistryset.mech
    KK, MM = mech.n_species, mech.n_elements
    fuel = np.asarray(fuel_molefrac, dtype=np.double)
    oxid = np.asarray(oxid_molefrac, dtype=np.double)
    prod = np.asarray(prod_index, dtype=np.int64)
    if len(fuel) != KK or len(oxid) != KK:
        raise ValueError(f"fuel/oxidizer arrays must have size {KK}")
    ncf = np.asarray(mech.ncf)                       # [KK, MM]

    fuel_elems = ncf.T @ fuel                        # [MM]
    oxid_elems = ncf.T @ oxid
    prod_cols = ncf[prod].T                          # [MM, n_prod]
    active = (np.abs(fuel_elems) + np.abs(oxid_elems)
              + np.abs(prod_cols).sum(axis=1)) > 0.0
    n_active = int(active.sum())
    n_prod = len(prod)
    if n_prod != n_active - 1:
        raise ValueError(
            f"number of product species ({n_prod}) must be one less than "
            f"the number of participating elements ({n_active}) "
            "(reference: utilities.py:295)")

    # rows: active elements; columns: [alpha | nu_1..nu_p]
    # fuel_m + alpha * oxid_m - sum_p nu_p a_pm = 0
    A = np.concatenate([oxid_elems[active, None], -prod_cols[active]],
                       axis=1)
    b = -fuel_elems[active]
    x = np.linalg.solve(A, b)
    alpha, nu = float(x[0]), x[1:]
    if alpha <= 0.0 or np.any(nu < -1e-10):
        logger.warning("non-physical stoichiometric coefficients: "
                       "alpha=%g nu=%s — check fuel/oxidizer/products",
                       alpha, nu)
    return alpha, nu


def find_file(filename: str, search_paths: Sequence[str] = ()) -> str:
    """Locate ``filename`` in the given directories or the CWD
    (reference: utilities.py:526). Returns the full path or '' if not
    found."""
    if os.path.isfile(filename):
        return os.path.abspath(filename)
    for d in search_paths:
        cand = os.path.join(d, filename)
        if os.path.isfile(cand):
            return os.path.abspath(cand)
    return ""


def where_element_in_array_1D(arr, target):
    """Occurrence count and indices of ``target`` in a 1-D array
    (reference: utilities.py:40). Vectorized instead of the
    reference's Python loop."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return 0, []
    idx = np.nonzero(arr == type(arr.flat[0])(target))[0].astype(np.int32)
    if idx.size == 0:
        return 0, []
    return int(idx.size), idx


_ck_rng = None


def random(range=None):            # noqa: A002 — reference signature
    """Random float in [0, 1) or [a, b) from a lazily seeded numpy
    generator (reference: utilities.py:491)."""
    global _ck_rng
    if _ck_rng is None:
        import secrets

        _ck_rng = np.random.default_rng(secrets.randbits(128) - 54231)
    if range is None:
        return _ck_rng.random()
    return range[0] + _ck_rng.random() * (range[1] - range[0])
