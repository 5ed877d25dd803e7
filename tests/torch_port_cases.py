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


# -- the premixed flame (tests/test_torch_transport.py,
#    test_torch_flame.py, test_torch_flame_model.py and chip_smoke.py
#    phase 10) ------------------------------------------------------------------

def transport_states(names, wt, B, seed):
    """(T [B], P [B], X [B, KK]) for the transport properties: T
    300-3000 K, P 0.5-10 atm, random mole fractions with about a third of
    the entries zero, and pure species in the first min(B, KK) states."""
    rng = np.random.default_rng(seed)
    KK = len(names)
    T = rng.uniform(300.0, 3000.0, B)
    P = rng.uniform(0.5, 10.0, B) * P_ATM
    X = rng.random((B, KK))
    X[rng.random((B, KK)) < 0.3] = 0.0
    for b in range(min(B, KK)):
        X[b] = 0.0
        X[b, b] = 1.0
    X[X.sum(1) == 0.0, 0] = 1.0
    return T, P, X / X.sum(1, keepdims=True)


def flame_state(names, wt, N, seed, x_end=1.0, M=0.08, Y_in=None):
    """A perturbed premixed-flame state (u [N, M], x [N]) as numpy: a T
    ramp 298 -> 1800 K over the middle of [0, x_end], the species ramped
    from ``Y_in`` (stoichiometric H2/air when None) to a partly burnt
    composition, a radical pool of 1e-6..1e-3 on the hot side, exact
    zeros of the inerts absent from the inlet and of every species the
    inlet lacks at the cold end (the clip's tie points), and the mass
    flux M."""
    rng = np.random.default_rng(seed)
    names = [s.upper() for s in names]
    KK = len(names)
    Y_in = stoich_h2_air(names, wt) if Y_in is None else np.asarray(Y_in)
    x = np.linspace(0.0, x_end, N)
    xi = np.clip((x - 0.3 * x_end) / (0.4 * x_end), 0.0, 1.0)
    T = 298.0 + 1502.0 * xi
    Y_b = Y_in * rng.uniform(0.05, 0.3, KK)
    pool = 10 ** rng.uniform(-6, -3, KK) * (Y_in == 0.0)
    Y_b = Y_b + pool
    inert_absent = [k for k, s in enumerate(names) if s in ("AR", "HE")
                    and Y_in[k] == 0.0]
    Y_b[inert_absent] = 0.0
    Y_b = Y_b / Y_b.sum()
    Y = Y_in[None] + (Y_b - Y_in)[None] * xi[:, None]
    Y = Y * (1.0 + 0.01 * rng.standard_normal((N, KK))) * (Y > 0.0)
    u = np.concatenate([T[:, None], np.full((N, 1), M), Y], axis=1)
    return u, x


def flame_numpy(sol=None, *, u=None, x=None):
    """A flame state of either package as numpy: from a FlameSolution
    (``sol``) its fields, or the packed state ``u`` [N, M] and grid ``x``
    [N]. The dict's ``u``/``x`` restart the other package's
    ``solve_flame(u0=, x0=)`` (CNTN continuation)."""
    if sol is not None:
        u_np = np.asarray(sol.u, dtype=np.float64)
        return dict(x=np.asarray(sol.x, dtype=np.float64), u=u_np,
                    T=np.asarray(sol.T, dtype=np.float64),
                    Y=np.asarray(sol.Y, dtype=np.float64),
                    mdot=float(sol.mdot), flame_speed=float(sol.flame_speed),
                    converged=bool(sol.converged),
                    n_points=int(sol.n_points), n_regrids=int(sol.n_regrids),
                    n_newton=int(sol.n_newton))
    u_np = np.array(u.detach().cpu() if hasattr(u, "detach") else u,
                    dtype=np.float64)
    x_np = np.array(x.detach().cpu() if hasattr(x, "detach") else x,
                    dtype=np.float64)
    return dict(x=x_np, u=u_np, T=u_np[:, 0], Y=u_np[:, 2:],
                mdot=float(u_np[0, 1]), n_points=int(x_np.size))


#: the premixed flames of chip_smoke.py phase 10 (FreelyPropagating on the
#: model's default grid controls, MIX): mechanism, inlet mole recipe
FLAME_CASES = {
    "h2o2": dict(recipe={"H2": 2.0, "O2": 1.0, "N2": 3.76}, x_end=2.0),
    "ch4global": dict(recipe={"CH4": 1.0, "O2": 2.0, "N2": 7.52}, x_end=2.0),
}
#: the free flames' inlet: 1 atm, 298 K
FLAME_T_IN = 298.0
#: the continuation of phase 10d: the h2o2 flame restarted at 2 atm
FLAME_CNTN_P = 2.0 * P_ATM


def jax_flame_reference(name):
    """The JAX package's outcome of FLAME_CASES[name] through its model
    classes (Chemistry, Stream, FreelyPropagating.run, get_flame_speed),
    and for h2o2 its continuation() at FLAME_CNTN_P; the values recorded
    in JAX_FLAME_REFERENCE came from
    ``JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
    import torch_port_cases as c; print(c.jax_flame_reference('h2o2'))"``
    (and 'ch4global', 'ch4global_burner': FLAME_CH4_BURNER through
    BurnedStabilized_GivenTemperature) from the repository root."""
    import time

    import pychemkin_tpu as ck
    from pychemkin_tpu.inlet import Stream
    from pychemkin_tpu.mechanism import DATA_DIR
    from pychemkin_tpu.models import (BurnedStabilized_GivenTemperature,
                                      FreelyPropagating)

    if name == "h2o2_small":
        return _small_flame(ck, Stream, FreelyPropagating, DATA_DIR)
    if name == "ch4global_burner":
        b = FLAME_CH4_BURNER
        chem = ck.Chemistry(chem=os.path.join(DATA_DIR, "ch4global.inp"),
                            tran=os.path.join(DATA_DIR, "tran_ch4.dat"))
        chem.preprocess()
        inlet = Stream(chem, label="fuel")
        inlet.pressure = P_ATM
        inlet.temperature = FLAME_T_IN
        inlet.X = FLAME_CASES["ch4global"]["recipe"]
        inlet.mass_flowrate = b["mdot"]
        inlet.flowarea = 1.0
        fb = BurnedStabilized_GivenTemperature(inlet)
        fb.start_position, fb.end_position = 0.0, b["x_end"]
        xs = np.linspace(0.0, b["x_end"], 25)
        fb.set_temperature_profile(xs, flame_tprof(xs, b["T_burnt"]))
        fb.set_max_grid_points(b["ntot"])
        t0 = time.perf_counter()
        rc = fb.run()
        out = dict(rc=rc, wall_s=round(time.perf_counter() - t0, 1))
        if rc == 0:
            sol = fb.process_solution()
            k = list(chem.species_symbols).index("CO2")
            out.update(n_points=int(sol.n_points), n_newton=int(sol.n_newton),
                       exit_Y_CO2=float(sol.Y[-1, k]))
        return out
    tran = {"h2o2": "tran_h2o2.dat", "ch4global": "tran_ch4.dat"}[name]
    chem = ck.Chemistry(chem=os.path.join(DATA_DIR, name + ".inp"),
                        tran=os.path.join(DATA_DIR, tran))
    chem.preprocess()
    inlet = Stream(chem, label="fuel")
    inlet.pressure = P_ATM
    inlet.temperature = FLAME_T_IN
    inlet.X = FLAME_CASES[name]["recipe"]
    inlet.mass_flowrate = 0.03
    fl = FreelyPropagating(inlet)
    fl.start_position = 0.0
    fl.end_position = FLAME_CASES[name]["x_end"]
    t0 = time.perf_counter()
    rc = fl.run()
    out = dict(rc=rc, wall_s=round(time.perf_counter() - t0, 1))
    if rc == 0:
        sol = fl.process_solution()
        out.update(su=float(fl.get_flame_speed()), T_max=float(sol.T.max()),
                   n_points=int(sol.n_points), n_newton=int(sol.n_newton),
                   n_regrids=int(sol.n_regrids))
        if name == "h2o2":
            fl.pressure = FLAME_CNTN_P
            rc2 = fl.continuation()
            out["cntn_rc"] = rc2
            if rc2 == 0:
                sol2 = fl.process_solution()
                out.update(cntn_su=float(fl.get_flame_speed()),
                           cntn_n_points=int(sol2.n_points))
    return out


def flame_data_pair(jf, tf, u, x, cfg_kw, i_fix=5, mdot=0.08, T_given=None):
    """(JAX FlameConfig, port FlameConfig, JAX FlameData, port FlameData)
    of the state (u, x) for the flame modules ``jf`` (the JAX package's
    ops.flame1d) and ``tf`` (the port's): inlet Y and the given T profile
    from u unless ``T_given`` is passed, 1 atm, T_in 298 K, T_fix 400 K."""
    import jax.numpy as jnp
    import torch
    Y_in = np.array(u[0, 2:])
    T_given = np.array(u[:, 0] if T_given is None else T_given)
    jd = jf.FlameData(x=jnp.asarray(x), P=P_ATM, T_in=298.0,
                      Y_in=jnp.asarray(Y_in), mdot_in=mdot, T_fix=400.0,
                      i_fix=jnp.asarray(i_fix, jnp.int32),
                      T_given=jnp.asarray(T_given))
    td = tf.FlameData(x=torch.tensor(x), P=P_ATM, T_in=298.0,
                      Y_in=torch.tensor(Y_in), mdot_in=mdot, T_fix=400.0,
                      i_fix=i_fix, T_given=torch.tensor(T_given))
    return jf.FlameConfig(**cfg_kw), tf.FlameConfig(**cfg_kw), jd, td


def flame_tprof(x, T_burnt=1500.0, T_in=298.0, x_mid=0.4, width=0.12):
    """The given temperature profile of the burner-stabilized TGIV flames
    (tests/test_flame1d.py:160 and :266): a tanh ramp T_in -> T_burnt."""
    return T_in + (T_burnt - T_in) * 0.5 * (
        1.0 + np.tanh((np.asarray(x) - x_mid) / width))


#: the ch4global burner-stabilized flame at a given temperature of
#: chip_smoke.py phase 10c (BurnedStabilized_GivenTemperature, the TPRO
#: flame_tprof(x, T_burnt) on 25 points, NTOT ntot)
FLAME_CH4_BURNER = dict(mdot=0.03, x_end=1.2, T_burnt=1500.0, ntot=40)

#: the JAX package's outcomes of the phase 10 flames on the CPU (x86-64,
#: jax 0.9.0, f64), from jax_flame_reference(name) (see its docstring for
#: the command): h2o2 converged (388.9 s) and its continuation at 2 atm;
#: the ch4global free flame does not converge there (run() returns 1 after
#: its pseudo-transient rounds: the eigenvalue collapses); nor does the
#: burner-stabilized ENRG flame at 0.005, 0.01, 0.02, 0.03 or 0.035
#: g/cm^2-s on 0.5-2 cm; the TGIV burner of FLAME_CH4_BURNER converges
JAX_FLAME_REFERENCE = {
    "h2o2": {"rc": 0, "su": 232.45135520242556, "T_max": 2336.868883532548,
             "n_points": 80, "n_newton": 188, "n_regrids": 9,
             "cntn_rc": 0, "cntn_su": 225.32689213410836,
             "cntn_n_points": 94},
    "ch4global": {"rc": 1},
    "ch4global_burner": {"rc": 0, "n_points": 40, "n_newton": 51,
                         "exit_Y_CO2": 0.14491849023557735},
}


#: the slice end to end at a small size (tests/test_torch_flame_model.py):
#: h2o2 stoichiometric H2/air, 1 atm, 298 K, on 0-2 cm, a 30-point GRID
#: profile, NTOT 30 (no point added), NOFT
SMALL_FLAME = dict(n_grid=30, x_end=2.0)


def small_flame_model(Stream, FreelyPropagating, chem):
    """The SMALL_FLAME model of either package on ``chem``."""
    inlet = Stream(chem, label="fuel")
    inlet.pressure = P_ATM
    inlet.temperature = FLAME_T_IN
    inlet.X = FLAME_CASES["h2o2"]["recipe"]
    inlet.mass_flowrate = 0.03
    fl = FreelyPropagating(inlet)
    fl.set_grid_profile(np.linspace(0.0, SMALL_FLAME["x_end"],
                                    SMALL_FLAME["n_grid"]))
    fl.set_max_grid_points(SMALL_FLAME["n_grid"])
    fl.skip_fix_T_solution(True)
    return fl


def _small_flame(ck, Stream, FreelyPropagating, DATA_DIR):
    chem = ck.Chemistry(chem=os.path.join(DATA_DIR, "h2o2.inp"),
                        tran=os.path.join(DATA_DIR, "tran_h2o2.dat"))
    chem.preprocess()
    fl = small_flame_model(Stream, FreelyPropagating, chem)
    rc = fl.run()
    sol = fl.process_solution()
    return dict(rc=rc, converged=bool(sol.converged),
                n_points=int(sol.n_points), n_newton=int(sol.n_newton),
                su=float(fl.get_flame_speed()), T=[float(v) for v in sol.T],
                Y=[[float(v) for v in row] for row in sol.Y])


#: the JAX package's SMALL_FLAME (small_flame_model through its models on
#: the CPU, x86-64, jax 0.9.0, f64; 45 s there), from
#: ``JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
#: import torch_port_cases as c; print(c.jax_flame_reference('h2o2_small'))"``
SMALL_FLAME_REFERENCE = {'T': [298.0, 298.0678425690745, 299.03605269453413, 312.6820131981701, 400.0,
       693.792612001792, 1771.0065797763095, 2007.4808296516755,
       2110.918275181378, 2168.8188801409497, 2205.7951645022863,
       2231.4065896182615, 2250.137391356402, 2264.3740987965043,
       2275.507258984655, 2284.4042705764145, 2291.635732756256,
       2297.5933052232394, 2302.5553223677134, 2306.7253686583167,
       2310.256009896585, 2313.2639637004627, 2315.840123551772,
       2318.056379682527, 2319.9703906662694, 2321.629009495582,
       2323.0706957233056, 2324.3261502607716, 2325.4097874015883,
       2326.2520162816363, 2326.2520162816363],
 'Y': [[0.028521107592246586, 1.45657543281769e-17, 2.957333678284967e-12,
        0.22635434971877355, 5.608420500847969e-15, 6.838095541311557e-08,
        6.099590266064689e-10, 1.2229932126812687e-09, 0.7451244724721092,
        1.877426398379569e-38],
       [0.02851163799444795, 7.834456308993519e-17, 4.747972143382602e-11,
        0.22635626350172897, 9.154464991022393e-14, 1.5273425837404306e-06,
        1.4801652174960016e-08, 2.985954154052919e-08, 0.7451305264524742,
        2.351948358126768e-37],
       [0.028432532988087424, 5.735901299219204e-15, 7.974448169218436e-10,
        0.22635819165470836, 9.636040870621969e-12, 3.405177230348505e-05,
        3.588395373156608e-07, 7.277212564999505e-07, 0.7451741362170202,
        0.0],
       [0.02779083619185496, 4.82807282286603e-12, 1.4814082757515265e-08,
        0.22604723821354777, 2.7445599876958814e-09, 0.0007411528176387307,
        8.754324759408288e-06, 1.72774867420081e-05, 0.7453947234019863, 0.0],
       [0.025508843879247834, 1.7285452554073782e-08, 4.2736163718553007e-07,
        0.22162585296695791, 5.352952082732352e-07, 0.007286617831204337,
        0.00014255701699573292, 0.00016453800695626598, 0.7452706103563399,
        0.0],
       [0.02131547708001236, 1.0842596930977862e-05, 2.8290465092461534e-05,
        0.1984097480196895, 7.252561387508351e-05, 0.0355480032316729,
        0.000445339107818755, 0.0002114477569427686, 0.7439583261279651, 0.0],
       [0.003652018804797954, 0.0011955298755215802, 0.004420034564410119,
        0.030466205195778136, 0.00841738159148597, 0.20580040777392136,
        2.0685473507430808e-05, 1.0963775018547538e-05, 0.7460167729455588,
        0.0],
       [0.0029249524224604258, 0.0006172870181051306, 0.002589710335201438,
        0.019091924766744702, 0.00888271623411736, 0.21975987047570059,
        7.836421044655944e-06, 3.6711619946586538e-06, 0.7461220311646309,
        0.0],
       [0.0025401752545949974, 0.0003967255935234944, 0.001698898623146046,
        0.014632493455617013, 0.008099329705032271, 0.2264858635727995,
        4.477900695897498e-06, 1.7824581519237646e-06, 0.7461402534364387,
        0.0],
       [0.0022750363427525007, 0.00028869378708617604, 0.0012352429962828953,
        0.012027953126001875, 0.007351222518976355, 0.23066946965608176,
        3.098169760212597e-06, 1.0944459089613351e-06, 0.7461481889571492,
        0.0],
       [0.0020832831002001615, 0.00022629208794063392, 0.0009609817033800845,
        0.01030691650522739, 0.006739552842384225, 0.23352725240845087,
        2.4003326111661908e-06, 7.656749694156823e-07, 0.7461525553448359,
        0.0],
       [0.0019390748508556915, 0.0001863630671592758, 0.0007836097193646008,
        0.009085007522644883, 0.006247930990066795, 0.2356001905433303,
        1.997308441276135e-06, 5.807788583159175e-07, 0.7461552452192788,
        0.0],
       [0.0018272504149839041, 0.00015899266864547755, 0.0006614648726190163,
        0.008174677144712306, 0.005850366439547618, 0.23716800961592432,
        1.7418306008724632e-06, 4.653317500352899e-07, 0.7461570316812164,
        0.0],
       [0.0017384602922112717, 0.00013928462741680651, 0.0005733861817313761,
        0.007472818728660836, 0.005525410698998406, 0.23839039898110992,
        1.5683448861889913e-06, 3.878708917446252e-07, 0.7461582842740934,
        0.0],
       [0.0016666447363102202, 0.000124562995855611, 0.0005076101833730507,
        0.006917749026950122, 0.005256938602806741, 0.23936551806672035,
        1.4441881497306104e-06, 3.3311672984332586e-07, 0.7461591990831042,
        0.0],
       [0.001607701876329205, 0.00011325037838532885, 0.00045712784443821455,
        0.006470138501642957, 0.00503298854511973, 0.24015725973718985,
        1.3516314242201563e-06, 2.92863477402803e-07, 0.746159888621993, 0.0],
       [0.0015587514328547166, 0.00010436073934488704, 0.00041752781411624084,
        0.006103631317614485, 0.004844617293868883, 0.24080914714329482,
        1.280377423016151e-06, 2.623554793975238e-07, 0.7461604215260035,
        0.0],
       [0.0015177076103889801, 9.724811279950394e-05, 0.00038590792139757413,
        0.005799847458888797, 0.004685043326358338, 0.24135194102489751,
        1.22410457583241e-06, 2.3866727349571313e-07, 0.7461608417734199,
        0.0],
       [0.001483020159459876, 9.147277817788801e-05, 0.00036028781827937865,
        0.005545544543549405, 0.0045490445395941735, 0.24180805280434678,
        1.1787471562355726e-06, 2.1991090781075966e-07, 0.7461611786985284,
        0.0],
       [0.0014535111632585538, 8.67256981870987e-05, 0.0003392741367226295,
        0.005330919947131466, 0.00443253935949182, 0.24219423077058014,
        1.14158387810592e-06, 2.0481908877101725e-07, 0.7461614525216613,
        0.0],
       [0.0014282686269305204, 8.278373942807527e-05, 0.0003218606323532085,
        0.005148550034254908, 0.004332293554366418, 0.24252326263049667,
        1.1107290237762726e-06, 1.9251270189506498e-07, 0.7461616775404445,
        0.0],
       [0.0014065750977704117, 7.948203871395265e-05, 0.0003073041741572753,
        0.004992702548761028, 0.004245712476770238, 0.2428050924599413,
        1.084835456986581e-06, 1.823646717923058e-07, 0.746161864003757, 0.0],
       [0.00138785877638881, 7.669636553232553e-05, 0.00029504521760003035,
        0.0048588763637035836, 0.004170691874451876, 0.24304757543082364,
        1.0629145361114715e-06, 1.7391689848575988e-07, 0.7461620191400651,
        0.0],
       [0.0013716599410520777, 7.433157106180333e-05, 0.00028465540190499017,
        0.004743484240125261, 0.004105509805032292, 0.2432570005076338,
        1.0442231674386737e-06, 1.6682780728731527e-07, 0.746162147482215,
        0.0],
       [0.0013576092206948119, 7.231395350014064e-05, 0.00027580240608590304,
        0.004643627586483048, 0.004048749153387011, 0.24343845824142926,
        1.0281908051542902e-06, 1.608383489182237e-07, 0.7461622504092656,
        0.0],
       [0.0013454180677824421, 7.058644808555635e-05, 0.0002682266699379793,
        0.004556931877245653, 0.0039992473662316275, 0.24359609444470137,
        1.0143712392028412e-06, 1.5574981892417092e-07, 0.7461623250049572,
        0.0],
       [0.001334888113864971, 6.910654266938176e-05, 0.0002617284245418081,
        0.0044814315285402195, 0.003956083969085527, 0.243733242806388,
        1.0024122260030654e-06, 1.5141062857130051e-07, 0.7461623647920554,
        0.0],
       [0.0013259594128196548, 6.784863035827711e-05, 0.00025617104881355083,
        0.004415562601262088, 0.003918663098441744, 0.24385227855556746,
        9.920500554199638e-07, 1.477146386721469e-07, 0.746162376888043, 0.0],
       [0.0013188448420007137, 6.681807381223292e-05, 0.00025153541455782345,
        0.00435869916871811, 0.003887144740249438, 0.24395336415885957,
        9.8319435415219e-07, 1.4463296224490763e-07, 0.7461624657744856, 0.0],
       [0.0013143357849138744, 6.610607057002494e-05, 0.00024819312872236953,
        0.0043147909124951435, 0.0038643774735728255, 0.2440280762880978,
        9.7646980270669e-07, 1.4239421816142176e-07, 0.7461630014776071, 0.0],
       [0.0013143357849138744, 6.610607057002494e-05, 0.00024819312872236953,
        0.0043147909124951435, 0.0038643774735728255, 0.2440280762880978,
        9.7646980270669e-07, 1.4239421816142176e-07, 0.7461630014776071,
        0.0]],
 'converged': True,
 'n_newton': 20,
 'n_points': 31,
 'rc': 0,
 'su': 88.52183694578648}
