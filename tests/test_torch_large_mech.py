"""A mechanism too large for the card's shared memory: the synthetic
copies of grisyn (tests/torch_port_cases.py ``synthetic_mechanism_text``)
in both packages, the port's twins on it, and the size chooser that sends
such a mechanism's lanes to the kernels' device-memory (GM) variants.

- The 3-copy mechanism (159 species, 975 reactions) parses to the same
  record in both packages, field by field.
- The twins' fused (f, J) of CONP/ENRG and CONV/ENRG at random states
  against the reference's within 1e-12 of each lane's fastest rate.
- ``kernels.storage`` with the H100's opt-in limit (232,448 bytes): grisyn
  runs every kernel from shared memory; the 8-copy mechanism (424
  species, 2600 reactions) sends K1, K2, K5 (pivoted too), K7 and K8 to
  the workspace and keeps K6 in shared memory with four lanes a block,
  and the lane sizes are those of ROADMAP's formula (K1 ~314 KB, K5
  ~1.8 MB a lane).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import jacobian as jjac
from pychemkin_tpu.ops import reactors as jre
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import reactors

from torch_port_cases import (P_ATM, radical_pool_states, rate_rel,
                              synthetic_mechanism_text)

H100_OPTIN = 232448
B = 3


@pytest.fixture(scope="module")
def copies3():
    text = synthetic_mechanism_text(3)
    return (jmech.load_mechanism_from_strings(text),
            tmech.load_mechanism_from_strings(text))


def test_synthetic_mechanism_parses_to_the_same_record(copies3):
    jrec, trec = copies3
    assert trec.n_species == 159 and len(trec.reaction_equations) == 975
    names = {f.name for f in dataclasses.fields(jrec)} - {"rop_stage"}
    assert names == {f.name for f in dataclasses.fields(trec)} - {
        "rop_stage"}
    for field in sorted(names):
        a, b = getattr(jrec, field), getattr(trec, field)
        if isinstance(a, (tuple, bool, float, int, str)) or a is None:
            assert a == b, field
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field)


@pytest.mark.parametrize("problem", ["CONP", "CONV"])
def test_twins_match_jax_on_the_large_mechanism(copies3, problem):
    jrec, trec = copies3
    tm = tmech.TorchMechanism(trec, "cpu")
    T, Y = radical_pool_states(trec.species_names, np.asarray(trec.wt), B,
                               5)
    y = np.concatenate([Y, T[:, None]], axis=1)
    P = np.full(B, 2.0 * P_ATM)
    fj = jjac.fused_rhs_jacobian(problem, "ENRG")

    def one(yy, p):
        args, _, _ = jre.sweep_lane_args(jrec, problem, yy[-1], p, yy[:-1])
        return fj(0.0, yy, args)

    f_w, J_w = (np.asarray(a) for a in jax.jit(jax.vmap(one))(
        jnp.asarray(y), jnp.asarray(P)))
    import torch
    yt = torch.tensor(y)
    c = torch.tensor(P)
    if problem == "CONV":
        from pychemkin_tpu_torch.ops import thermo
        c = thermo.density(tm, yt[:, -1], c, yt[:, :-1])
    f, J = reactors.RHS_TWINS[problem][1](tm, yt, c)
    assert rate_rel(f.numpy(), f_w, T, tm.KK) <= 1e-12
    assert rate_rel(J.numpy(), J_w, T, tm.KK) <= 1e-12


GM_KERNELS = ("rhs", "rhs_jac", "sdirk_round", "gershgorin_rate",
              "psr_solve")


def test_size_chooser():
    grisyn = tmech.TorchMechanism(tmech.load_embedded("grisyn"), "cpu")
    big = tmech.TorchMechanism(tmech.load_mechanism_from_strings(
        synthetic_mechanism_text(8)), "cpu")
    assert big.KK == 424 and big.II == 2600
    for name in GM_KERNELS:
        for pivot in ((False, True) if name == "sdirk_round" else (False,)):
            small = kernels.storage(name, grisyn, H100_OPTIN, pivot)
            large = kernels.storage(name, big, H100_OPTIN, pivot)
            assert small.kind == "shared" and small.lanes == 1, name
            assert small.lane_bytes <= H100_OPTIN, name
            assert large.kind == "global" and large.lane_bytes > H100_OPTIN, \
                name
    for tm in (grisyn, big):
        eq = kernels.storage("equil_solve", tm, H100_OPTIN)
        assert eq.kind == "shared" and eq.lanes == kernels.EQ_WARPS
    # a limit that fits no K6 lane sends it to the workspace too
    assert kernels.storage("equil_solve", big, 1000).kind == "global"
    # ROADMAP's sizes: K1 ~314 KB, K5 8 (KK^2 + 29 KK + 13 II + n_tb + ~36)
    k1 = kernels.storage("rhs", big, H100_OPTIN).lane_bytes
    k5 = kernels.storage("sdirk_round", big, H100_OPTIN).lane_bytes
    assert 300e3 < k1 < 330e3
    n_tb = big.tb_rows.numel()
    assert abs(k5 - 8 * (424 ** 2 + 29 * 424 + 13 * 2600 + n_tb + 36)) \
        <= 8 * 64
