"""Shared inputs of the PyTorch-port tests (tests/test_torch_*.py): lane
states made with numpy from a seed, the hand-built one-reaction
mechanisms of each reaction type, and the scale-relative error measure.
Both packages get the same numpy arrays."""

import numpy as np

P_ATM = 1.01325e6

THERM_AB = """\
THERMO ALL
   300.000  1000.000  5000.000
A                 test  H   2               G   300.000  5000.000 1000.00      1
 2.50000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
 1.00000000E+03 5.00000000E+00 2.50000000E+00 0.00000000E+00 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00 1.00000000E+03 5.00000000E+00                   4
B                 test  H   2               G   300.000  5000.000 1000.00      1
 2.50000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00    2
 0.00000000E+00 0.00000000E+00 2.50000000E+00 0.00000000E+00 0.00000000E+00    3
 0.00000000E+00 0.00000000E+00 0.00000000E+00 0.00000000E+00                   4
END
"""

#: one mechanism per reaction type, with a (T, C) state at which every
#: term of that type carries signal
REACTION_TYPES = {
    "plain_reversible": ("A<=>B 5.0E10 0.5 3000.0", 1100.0, [2e-6, 5e-7]),
    "irreversible": ("A=>B 5.0E10 0.0 1000.0", 1100.0, [2e-6, 5e-7]),
    "explicit_rev": ("A<=>B 1.0E10 0.0 0.0\nREV/3.0E9 0.7 500.0/", 1100.0,
                     [2e-6, 5e-7]),
    "negative_A_pair": ("A<=>B 5.0E10 0.0 0.0\nDUP\n"
                        "A<=>B -2.0E10 0.3 100.0\nDUP", 1100.0,
                        [2e-6, 5e-7]),
    "plain_third_body": ("A+M<=>B+M 1.0E10 0.0 0.0\nA/2.5/ B/0.5/", 1100.0,
                         [2e-6, 5e-7]),
    "lindemann": ("A(+M)<=>B(+M) 1.0E12 0.0 0.0\nLOW/1.0E14 0.0 0.0/",
                  1100.0, [2e-6, 5e-7]),
    "troe": ("A(+M)<=>B(+M) 1.0E12 0.0 0.0\nLOW/1.0E16 -0.5 200.0/\n"
             "TROE/0.6 100.0 2000.0 5000.0/", 1100.0, [5e-5, 2e-5]),
    "troe_three_parameter": ("A(+M)<=>B(+M) 1.0E12 0.0 0.0\n"
                             "LOW/1.0E16 0.0 0.0/\nTROE/0.7 150.0 1500.0/",
                             1100.0, [5e-5, 2e-5]),
    "sri": ("A(+M)<=>B(+M) 1.0E12 0.0 0.0\nLOW/1.0E16 0.0 0.0/\n"
            "SRI/0.5 300.0 1200.0/", 1100.0, [5e-5, 2e-5]),
    "sri_five_parameter": ("A(+M)<=>B(+M) 1.0E12 0.0 0.0\n"
                           "LOW/1.0E16 0.0 0.0/\n"
                           "SRI/0.5 300.0 1200.0 1.2 0.1/", 1100.0,
                           [5e-5, 2e-5]),
    "chemically_activated_troe": ("A(+M)<=>B(+M) 1.0E6 0.0 0.0\n"
                                  "HIGH/1.0E12 0.0 0.0/\n"
                                  "TROE/0.6 100.0 2000.0/", 1000.0,
                                  [1e-6, 1e-6]),
    "conc_product_clamp_high": ("A+A+A=>B+B+B 1.0E1 0.0 0.0", 1000.0,
                                [1e13, 1e0]),
    "zero_concentration_floor": ("A+B=>B+B 1.0E10 0.0 0.0\n"
                                 "A<=>B 1.0E8 0.0 0.0", 1000.0, [1e-6, 0.0]),
    "arrhenius_exp_clamp": ("A<=>B 1.0E30 10.0 0.0", 2000.0, [1e-6, 1e-6]),
}


def tiny_mechanism_text(reactions):
    return ("ELEMENTS\nH\nEND\nSPECIES\nA B\nEND\nREACTIONS\n" + reactions
            + "\nEND\n")


def stoich_h2_air(names, wt):
    """Stoichiometric H2/air mass fractions."""
    names = [s.upper() for s in names]
    X = np.zeros(len(names))
    X[names.index("H2")] = 2.0
    X[names.index("O2")] = 1.0
    X[names.index("N2")] = 3.76
    Y = X * np.asarray(wt)
    return Y / Y.sum()


def random_states(n_species, B, seed):
    """(T [B], P [B], Y [B, KK]): T 800-2500 K, P 0.5-20 atm, random
    compositions."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(800.0, 2500.0, B)
    P = rng.uniform(0.5, 20.0, B) * P_ATM
    Y = rng.random((B, n_species)) ** 3
    return T, P, Y / Y.sum(1, keepdims=True)


def radical_pool_states(names, wt, B, seed):
    """(T [B], Y [B, KK]) of igniting stoichiometric H2/air: the fuel/air
    mixture plus a radical and product pool of mass fractions 1e-8..1e-3,
    T 1000-2500 K."""
    rng = np.random.default_rng(seed)
    Y = np.tile(stoich_h2_air(names, wt), (B, 1)) + 10 ** rng.uniform(
        -8, -3, (B, len(names)))
    T = rng.uniform(1000.0, 2500.0, B)
    return T, Y / Y.sum(1, keepdims=True)


def scale_rel(a, b):
    """Max |a - b| divided by max |b| per lane (leading axis), then the
    max over lanes."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = np.abs(a - b).reshape(a.shape[0], -1).max(1)
    s = np.abs(b).reshape(b.shape[0], -1).max(1)
    return float((d / np.maximum(s, 1e-300)).max())


def rate_rel(a, b, T, KK):
    """:func:`scale_rel` of an RHS [B, N] or Jacobian [B, N, N] with the
    temperature nondimensionalised by the lane's T [B], so that every
    entry is a rate in 1/s (f_T / T; J's T row / T, T column * T) and the
    scale is the lane's fastest rate. Without it the single T entries,
    differences of large species sums, would be held to their own size."""
    a = np.array(a, dtype=np.float64)
    b = np.array(b, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64)
    for x in (a, b):
        if x.ndim == 2:
            x[:, KK] /= T
        else:
            x[:, KK, :] /= T[:, None]
            x[:, :, KK] *= T[:, None]
    return scale_rel(a, b)


def h2_air(names, wt, phi):
    """H2/air mass fractions [len(phi), KK] at equivalence ratios phi."""
    names = [s.upper() for s in names]
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    X = np.zeros((phi.size, len(names)))
    X[:, names.index("H2")] = 2.0 * phi
    X[:, names.index("O2")] = 1.0
    X[:, names.index("N2")] = 3.76
    Y = X * np.asarray(wt)
    return Y / Y.sum(1, keepdims=True)


def equilibrium_states(names, wt, B, seed):
    """(T [B], P [B], Y [B, KK]) of equilibrium lanes: T evenly over
    300-2500 K, H2/air at phi 0.5-2 and P 1-10 atm drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    T = np.linspace(300.0, 2500.0, B)
    P = rng.uniform(1.0, 10.0, B) * P_ATM
    return T, P, h2_air(names, wt, rng.uniform(0.5, 2.0, B))


#: the 63-lane h2o2 PSR map: phi x inlet T [K] x residence time [s]
PSR_MAP_PHI = (0.5, 1.0, 2.0)
PSR_MAP_T_IN = (298.15, 600.0, 900.0)
PSR_MAP_TAU = tuple(10.0 ** np.arange(-6, 1))


def psr_map_lanes():
    """(phi, T_in, tau), each [63], of the PSR map in row-major order."""
    P_, T_, t_ = np.meshgrid(PSR_MAP_PHI, PSR_MAP_T_IN, PSR_MAP_TAU,
                             indexing="ij")
    return P_.ravel(), T_.ravel(), t_.ravel()
