"""The PyTorch port's 1-D premixed flame stencils (plain twins of kernels
K10-K12) against the JAX package's ``ops/flame1d.py`` and
``ops/blocktridiag.py``; the Newton and the whole solve are in
``test_torch_flame_solve.py``.

- ``blocktridiag.solve`` (K12's twin) on the shapes of the reference's
  ``tests/test_flame1d.py`` and the identity case: x within 1e-12
  scale-relative of the reference's solve and of the dense solve.
- ``make_residual`` (K10's twin) and ``jacobian_blocks`` (K11's twin) on a
  16-point h2o2 state with exact zeros (the clip's tie points), for
  ENRG x free/burner x MIX/LEWIS/TDIF x upwind/central (TGIV in
  ``test_torch_flame_tgiv.py``): F within 1e-12 and the blocks within
  1e-10 of the reference's residual and ``jax.jacfwd`` blocks,
  scale-relative per grid point. The kernel wrappers' CPU route gives
  the twins.
- On the reference's default initial grid of the free flame (two nodes
  one ulp apart), the twins' residual and blocks against the reference's
  at the initial state and a perturbed one; the Newton direction's
  sensitivity to a one-ulp move of the blocks there and on the port's
  grid (the node dropped).
- ``refine_grid`` and ``_pin_index`` give the reference's grid and index.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import blocktridiag as jbt
from pychemkin_tpu.ops import flame1d as jf
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import blocktridiag as tbt
from pychemkin_tpu_torch.ops import flame1d as tf

from torch_port_cases import (P_ATM, flame_data_pair, flame_state, scale_rel,
                              stoich_h2_air)

F_TOL = 1e-12
J_TOL = 1e-10
N_PTS = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mechs():
    return {"h2o2": (jmech.load_embedded("h2o2"), tmech.TorchMechanism(
        tmech.load_embedded("h2o2"), "cpu"))}


# -- K12's twin ---------------------------------------------------------------

def _random_btd(N, M, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, M, M)) + 4.0 * M * np.eye(M)
    B = rng.normal(size=(N, M, M))
    C = rng.normal(size=(N, M, M))
    B[0] = 0.0
    C[-1] = 0.0
    return B, A, C, rng.normal(size=(N, M))


def _dense(B, A, C):
    N, M, _ = A.shape
    J = np.zeros((N * M, N * M))
    for i in range(N):
        J[i * M:(i + 1) * M, i * M:(i + 1) * M] = A[i]
        if i > 0:
            J[i * M:(i + 1) * M, (i - 1) * M:i * M] = B[i]
        if i < N - 1:
            J[i * M:(i + 1) * M, (i + 1) * M:(i + 2) * M] = C[i]
    return J


@pytest.mark.parametrize("N,M,seed", [(5, 3, 0), (12, 4, 1), (30, 7, 2),
                                      (6, 4, None)])
def test_block_thomas_twin(N, M, seed):
    if seed is None:                       # identity blocks: x == d
        A = np.tile(np.eye(M), (N, 1, 1))
        B = C = np.zeros((N, M, M))
        d = np.arange(N * M, dtype=float).reshape(N, M)
    else:
        B, A, C, d = _random_btd(N, M, seed)
    args = [torch.tensor(a) for a in (B, A, C, d)]
    x = kernels.block_thomas(*args).numpy()
    assert np.array_equal(x, tbt.solve(*args).numpy())
    ref = np.asarray(jbt.solve(*(jnp.asarray(a) for a in (B, A, C, d))))
    dense = np.linalg.solve(_dense(B, A, C), d.ravel()).reshape(N, M)
    assert scale_rel(x, ref) <= F_TOL
    assert scale_rel(x, dense) <= F_TOL


# -- K10's and K11's twins ----------------------------------------------------

def configs(energy):
    """free/burner x MIX/LEWIS/TDIF x upwind/central at ``energy`` (the
    TGIV half runs in test_torch_flame_tgiv.py: each half pays the JAX
    package's ~50 s of first-call compiles in its own process)."""
    return [dict(energy=energy, free_flame=f, transport=t, soret=s, upwind=w)
            for f in (True, False)
            for t, s in (("MIX", False), ("LEWIS", False), ("MIX", True))
            for w in (True, False)]


def _check_stencils(jm, tm, u, x, cfg_kw):
    jcfg, tcfg, jd, td = flame_data_pair(jf, tf, u, x, cfg_kw)
    jres, jjac = jf.make_residual(jm, jcfg)
    F_ref = np.asarray(jres(jnp.asarray(u), jd))
    blk_ref = [np.asarray(b) for b in jjac(jnp.asarray(u), jd)]
    ut = torch.tensor(u)
    F = kernels.flame_residual(tm, tcfg, ut, td).numpy()
    blk = [b.numpy() for b in kernels.flame_jac(tm, tcfg, ut, td)]
    assert scale_rel(F, F_ref) <= F_TOL
    for b, r in zip(blk, blk_ref):
        assert scale_rel(b, r) <= J_TOL
    assert not blk[0][0].any() and not blk[2][-1].any()


@pytest.mark.parametrize("cfg_kw", configs("ENRG"),
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_residual_and_blocks_h2o2(mechs, cfg_kw):
    jm, tm = mechs["h2o2"]
    u, x = flame_state(jm.species_names, np.asarray(jm.wt), N_PTS, 3)
    _check_stencils(jm, tm, u, x, cfg_kw)


# -- the reference's default grid ---------------------------------------------

def _default_grid_state(tm, x):
    """The port's initial profile of the stoichiometric H2/air free flame
    on the grid x after solve_flame's step that adds the node where the
    initial ramp crosses T_fix = 400 K, as the reference does it: (u, x,
    the pin index). The model's defaults on 0-2 cm: xcen 0.7, wmix 1."""
    Y_in = stoich_h2_air(tm.record.species_names, np.asarray(tm.record.wt))

    def initial(xg):
        return tf.initial_profile(tm, torch.tensor(xg), P_ATM, 298.0, Y_in,
                                  0.7, 1.0, su_guess=40.0).numpy()
    u = initial(x)
    x = np.sort(np.unique(np.append(x, np.interp(400.0, u[:, 0], x))))
    u = initial(x)
    return u, x, tf._pin_index(x, u[:, 0], 400.0)


def _perturbed(u, seed):
    rng = np.random.default_rng(seed)
    up = u.copy()
    up[1:, 0] += rng.normal(scale=20.0, size=len(u) - 1)
    up[:, 1] *= 1.0 + rng.normal(scale=1e-3, size=len(u))
    up[:, 2:] *= np.exp(rng.normal(scale=0.05, size=up[:, 2:].shape))
    return up


def _direction_shift(tm, u, x, i_fix, seed):
    """The twins' Newton direction at (u, x) against the one from the same
    blocks each moved by one ulp (random sign), in the Newton's weighted
    norm."""
    _, tcfg, _, td = flame_data_pair(jf, tf, u, x, {}, i_fix=i_fix)
    res, jac = tf.make_residual(tm, tcfg)
    ut = torch.tensor(u)
    blk = jac(ut, td)
    d = -res(ut, td)
    rng = np.random.default_rng(seed)
    moved = [b * (1.0 + 2.0 ** -52 * torch.tensor(
        rng.choice([-1.0, 1.0], size=b.shape))) for b in blk]
    du = tbt.solve(*blk, d).numpy()
    du2 = tbt.solve(*moved, d).numpy()
    w = tcfg.ss_atol + tcfg.ss_rtol * np.abs(u)
    return float(np.sqrt(np.mean(((du2 - du) / w) ** 2))
                 / np.sqrt(np.mean((du / w) ** 2)))


def _term_rel(F, F_ref, blk, u):
    """|F - F_ref| over the size of the residual's terms, sum_j |dF/du_j|
    |u_j| from the blocks, max over entries: where the state is uniform
    (the hot side of an initial profile) F is rounding noise of its
    terms, and its own size is no scale."""
    Bb, Ab, Cb = (np.abs(b) for b in blk)
    au = np.abs(u)
    sc = np.einsum("nij,nj->ni", Ab, au)
    sc[1:] += np.einsum("nij,nj->ni", Bb[1:], au[:-1])
    sc[:-1] += np.einsum("nij,nj->ni", Cb[:-1], au[1:])
    return float((np.abs(F - F_ref) / np.maximum(sc, 1e-300)).max())


def test_blocks_on_the_reference_default_grid(mechs):
    """On the reference's default initial grid of the free flame (0-2 cm,
    NPTS 6 and the ramp's 9 points through np.unique: 1.2 and
    1.2000000000000002 both kept, 16 points with the T_fix node), the
    twins' residual and blocks match the JAX package's residual and
    jax.jacfwd blocks within F_TOL (of the size of the residual's terms:
    the initial state's hot side is uniform, and F there is rounding
    noise) and J_TOL at the initial state and at a perturbed one; the
    twin has no fault there. What the port's grid
    (ops/flame1d.py:_distinct) avoids is the conditioning: there, moving
    every block entry by one ulp moves the Newton direction by more than
    1e-6 in the Newton's weighted norm, while on the port's grid (the node
    dropped) it moves it by less than the 1e-9 to which the card's
    direction is held."""
    jm, tm = mechs["h2o2"]
    x_ref = np.sort(np.unique(np.concatenate(
        [np.linspace(0.0, 2.0, 6), np.linspace(0.2, 1.2, 9)])))
    assert np.diff(x_ref).min() < 1e-15
    u, x, i_fix = _default_grid_state(tm, x_ref)
    assert len(x) == N_PTS
    for state in (u, _perturbed(u, 0)):
        jcfg, tcfg, jd, td = flame_data_pair(jf, tf, state, x, {},
                                             i_fix=i_fix)
        jres, jjac = jf.make_residual(jm, jcfg)
        F_ref = np.asarray(jres(jnp.asarray(state), jd))
        blk_ref = [np.asarray(b) for b in jjac(jnp.asarray(state), jd)]
        res, jac = tf.make_residual(tm, tcfg)
        ut = torch.tensor(state)
        assert _term_rel(res(ut, td).numpy(), F_ref, blk_ref,
                         state) <= F_TOL
        for b, r in zip(jac(ut, td), blk_ref):
            assert scale_rel(b.numpy(), r) <= J_TOL
    u_p, x_p, i_p = _default_grid_state(tm, tf._distinct(x_ref, 2e-10))
    assert len(x_p) == N_PTS - 1
    for seed in range(2):
        ref_state = u if seed == 0 else _perturbed(u, seed)
        port_state = u_p if seed == 0 else _perturbed(u_p, seed)
        assert _direction_shift(tm, ref_state, x, i_fix, seed) > 1e-6
        assert _direction_shift(tm, port_state, x_p, i_p, seed) < 1e-9


# -- the host-side grid code --------------------------------------------------

def test_refine_grid_and_pin_index_match(mechs):
    jm, _ = mechs["h2o2"]
    u, x = flame_state(jm.species_names, np.asarray(jm.wt), 24, 6)
    for kw in (dict(), dict(grad=0.3, curv=0.8, nadp=4, ntot=27),
               dict(keep=(0.4321,))):
        ref = jf.refine_grid(x, u, **kw)
        mine = tf.refine_grid(x, u, **kw)
        assert (ref is None) == (mine is None)
        if ref is not None:
            assert np.array_equal(mine, ref)
    for T_fix in (250.0, 400.0, 1000.0, 5000.0):
        assert tf._pin_index(x, u[:, 0], T_fix) == jf._pin_index(
            x, u[:, 0], T_fix)


def test_flame_config_rejects_mult():
    with pytest.raises(NotImplementedError, match="B14"):
        tf.FlameConfig(transport="MULT")
    cfg = tf.FlameConfig()
    assert dataclasses.replace(cfg, energy="TGIV").energy == "TGIV"


def test_initial_grid_drops_the_one_ulp_interval():
    """The reference's default initial grid (linspace and the ramp through
    np.unique) keeps 1.2000000000000002 beside 1.2 on 0-2 cm; the port
    drops the node one ulp from another (ops/flame1d.py:_distinct), and
    keeps every other node."""
    x = np.linspace(0.0, 2.0, 6)
    ramp = np.linspace(0.2, 1.2, 9)
    ref = np.sort(np.unique(np.concatenate([x, ramp])))
    mine = tf._distinct(np.concatenate([x, ramp]), 1e-10 * 2.0)
    assert np.diff(ref).min() < 1e-15
    assert np.diff(mine).min() > 1e-3
    assert mine.size == ref.size - 1
    assert set(np.round(mine, 12)) == set(np.round(ref, 12))
