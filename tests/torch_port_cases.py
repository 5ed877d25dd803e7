"""Shared inputs of the PyTorch-port tests (tests/test_torch_*.py): lane
states made with numpy from a seed, the hand-built one-reaction
mechanisms of each reaction type, the synthetic large mechanism, and the
scale-relative error measure. Both packages get the same numpy arrays."""

import os
import re

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


#: the PLOG texts of the reference's Jacobian tests (tests/test_jacobian.py)
PLOG_3 = ("A<=>B 1.0E10 0.0 0.0\n"
          "PLOG/0.1  1.0E8  0.0 1000.0/\n"
          "PLOG/1.0  1.0E10 0.5 2000.0/\n"
          "PLOG/10.0 1.0E12 0.0 3000.0/")
PLOG_2 = ("A<=>B 1.0E10 0.0 0.0\n"
          "PLOG/0.1  1.0E8  0.0 1000.0/\n"
          "PLOG/10.0 1.0E12 0.0 3000.0/")
#: two Arrhenius terms at one level (summed in k space), and a one-level
#: table, on a row with a shorter table than its neighbour's
PLOG_TERMS = (PLOG_3 + "\n"
              "A=>B 1.0E9 0.0 0.0\n"
              "PLOG/1.0  4.0E9  0.0 1500.0/\n"
              "PLOG/1.0  2.0E11 -0.5 4000.0/\n"
              "A+B=>B+B 1.0E9 0.0 0.0\n"
              "PLOG/3.0  7.0E12 0.0 2500.0/")

#: the pressure levels [atm] of the h2o2_plog tables
H2O2_PLOG_LEVELS = (0.1, 1.0, 10.0, 100.0)


def h2o2_plog_text():
    """h2o2.inp with its one pressure-dependent falloff row
    (2OH(+M)<=>H2O2(+M), LOW + TROE) replaced by a PLOG row: at each of
    0.1, 1, 10 and 100 atm, one Arrhenius fit (least squares in ln k over
    ln T and 1/T) of that row's own falloff kf, with [M] = P/(R T), on 64
    temperatures geometric over 300-2500 K. The same text as
    chip_smoke.py's."""
    import os

    import torch

    from pychemkin_tpu_torch.constants import R_CAL, R_GAS
    from pychemkin_tpu_torch.mechanism import DATA_DIR, TorchMechanism
    from pychemkin_tpu_torch.mechanism import load_embedded
    from pychemkin_tpu_torch.ops import kinetics

    with open(os.path.join(DATA_DIR, "h2o2.inp")) as fh:
        lines = fh.read().splitlines()
    head = next(i for i, s in enumerate(lines) if "(+M)" in s)
    tm = TorchMechanism(load_embedded("h2o2"), "cpu")
    i = next(i for i, e in enumerate(tm.record.reaction_equations)
             if "(+M)" in e)
    j = int((tm.fo_rows == i).nonzero()[0, 0])
    T = torch.tensor(np.geomspace(300.0, 2500.0, 64))
    lnT = torch.log(T)
    k_inf = kinetics._arrhenius(tm.A[i:i + 1], tm.beta[i:i + 1],
                                tm.Ea_R[i:i + 1], T, lnT)
    k0 = kinetics._arrhenius(tm.fo_lowA[j:j + 1], tm.fo_lowb[j:j + 1],
                             tm.fo_lowE[j:j + 1], T, lnT)
    sl = slice(j, j + 1)
    fits = []
    for p_atm in H2O2_PLOG_LEVELS:
        M = (p_atm * P_ATM / (R_GAS * T))[:, None]
        k = kinetics.falloff_blend(T, lnT, M, k_inf, k0, tm.fo_type[sl],
                                   tm.fo_chem[sl], tm.fo_troe[sl],
                                   tm.fo_sri[sl])[:, 0].numpy()
        X = np.stack([np.ones(T.shape[0]), lnT.numpy(), -1.0 / T.numpy()], 1)
        c, *_ = np.linalg.lstsq(X, np.log(k), rcond=None)
        fits.append((p_atm, np.exp(c[0]), c[1], c[2] * R_CAL))
    p1 = fits[1]
    row = [f"2OH<=>H2O2{'':26s}{p1[1]:.10E} {p1[2]:.10f} {p1[3]:.10f}"]
    row += [f"PLOG/{p:g} {a:.10E} {b:.10f} {e:.10f}/" for p, a, b, e in fits]
    end = head + 1    # skip the row's LOW, TROE and efficiency lines
    while "/" in lines[end] and "=" not in lines[end]:
        end += 1
    return "\n".join(lines[:head] + row + lines[end:]) + "\n"


def ch4_air(names, wt, phi=1.0):
    """CH4/air mass fractions at equivalence ratio ``phi``."""
    names = [s.upper() for s in names]
    X = np.zeros(len(names))
    X[names.index("CH4")] = phi
    X[names.index("O2")] = 2.0
    X[names.index("N2")] = 2.0 * 3.76
    Y = X * np.asarray(wt)
    return Y / Y.sum()


# -- serving payloads (tests/test_torch_serve.py, test_torch_schedule.py,
#    test_torch_stiffness.py and chip_smoke.py phase 7) -----------------------

def serve_ignition_payloads(names, wt, n, seed=0, t_end=0.05,
                            T0=(1000.0, 1400.0), P0=P_ATM):
    """``n`` ignition requests: stoichiometric H2/air at ``P0``, T0 drawn
    uniformly over the range ``T0`` from ``seed``, horizon ``t_end``."""
    rng = np.random.default_rng(seed)
    Y = stoich_h2_air(names, wt)
    return [dict(T0=float(T), P0=float(P0), Y0=Y, t_end=float(t_end))
            for T in rng.uniform(T0[0], T0[1], n)]


def serve_equilibrium_payloads(names, wt, n, seed=1, option=1):
    """``n`` equilibrium requests (:func:`equilibrium_states`) of
    ``option``."""
    T, P, Y = equilibrium_states(names, wt, n, seed)
    return [dict(T=float(T[i]), P=float(P[i]), Y=Y[i], option=int(option))
            for i in range(n)]


def serve_psr_payloads(Y_in, h_in, tau, T_guess, Y_guess, P=P_ATM):
    """PSR requests (residence-time mode) from per-lane arrays: inlet
    composition [n, KK] and enthalpy [n] erg/g, tau [n] s, the guess."""
    return [dict(tau=float(tau[i]), P=float(P), Y_in=np.asarray(Y_in[i]),
                 h_in=float(h_in[i]), T_guess=float(T_guess[i]),
                 Y_guess=np.asarray(Y_guess[i])) for i in range(len(tau))]


#: grisyn's source (the port's copy of the fixture)
GRISYN_INP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "pychemkin_tpu_torch", "mechanism", "data",
                          "grisyn.inp")


def synthetic_mechanism_text(copies):
    """A large mechanism made from grisyn (53 species, 325 reactions):
    ``copies`` copies of its species, thermo and reactions, copy k's
    species renamed with the suffix ``_k`` (copy 0 keeps grisyn's names),
    so that the copies share only the elements. 3 copies: 159 species and
    975 reactions; 8 copies: 424 and 2600. The repository ships no
    mechanism this large; this one has grisyn's reaction types and
    sparsity at a size where a lane no longer fits in shared memory."""
    with open(GRISYN_INP) as fh:
        lines = fh.read().splitlines()
    up = [ln.strip().upper() for ln in lines]
    i_sp, i_th, i_rx = (up.index("SPECIES"), up.index("THERMO ALL"),
                        up.index("REACTIONS"))
    ends = [i for i, u in enumerate(up) if u == "END"]
    e_sp = min(i for i in ends if i > i_sp)
    e_th = min(i for i in ends if i > i_th)
    e_rx = min(i for i in ends if i > i_rx)
    species = " ".join(lines[i_sp + 1:e_sp]).split()
    pattern = re.compile(r"(?<![A-Za-z_])(" + "|".join(
        re.escape(n) for n in sorted(species, key=len, reverse=True))
        + r")(?![A-Za-z_])")
    thermo_head = lines[i_th + 1]
    thermo = lines[i_th + 2:e_th]
    reactions = lines[i_rx + 1:e_rx]

    def suffix(k):
        return "" if k == 0 else f"_{k}"

    out = lines[:i_sp] + ["SPECIES"]
    for k in range(copies):
        names = [n + suffix(k) for n in species]
        out += [" ".join(names[j:j + 8]) for j in range(0, len(names), 8)]
    out += ["END", "THERMO ALL", thermo_head]
    for k in range(copies):
        for j, ln in enumerate(thermo):
            if j % 4 == 0:
                name = ln[:18].split()[0] + suffix(k)
                ln = name.ljust(18) + ln[18:]
            out.append(ln)
    out += ["END", "REACTIONS"]
    for k in range(copies):
        for ln in reactions:
            head, sep, tail = ln.partition("!")
            if re.match(r"\s*(LOW|TROE|SRI|REV|DUP)", head.upper()):
                out.append(ln)
            else:
                out.append(pattern.sub(lambda m: m.group(1) + suffix(k),
                                       head) + sep + tail)
    out.append("END")
    return "\n".join(out) + "\n"
