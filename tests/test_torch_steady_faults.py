"""``linalg_unstable`` fault injection in the port's steady-state solvers
(the twins of kernels K6 and K7) and their served engines, against the
JAX package.

- Equilibrium (h2o2, 4 lanes, options 1 and 5) and PSR (h2o2, 4 lanes,
  residence-time mode with the energy equation) with one lane poisoned:
  the port's status codes equal the reference's on every lane, the
  poisoned lane's is not OK, and the healthy lanes equal the port's clean
  solve bit for bit (the fault touches only the poisoned lane's Newton
  directions).
- Served: under a ``linalg_unstable`` spec that heals at rung 1, the
  equilibrium and PSR engines no longer refuse the request; the poisoned
  request fails on the hot path and the rescue thread heals it at rung 1
  with the clean solve's answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import equilibrium as jeq
from pychemkin_tpu.ops import psr as jpsr
from pychemkin_tpu.ops import thermo as jthermo
from pychemkin_tpu.resilience import faultinject as jfi
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch import serve
from pychemkin_tpu_torch.ops import equilibrium as teq
from pychemkin_tpu_torch.ops import psr as tpsr
from pychemkin_tpu_torch.resilience import faultinject
from pychemkin_tpu_torch.resilience.status import SolveStatus

from torch_port_cases import P_ATM, stoich_h2_air

B = 4
POISONED = 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def h2o2():
    return jmech.load_embedded("h2o2"), tmech.load_embedded("h2o2")


def _eq_lanes(rec):
    T = np.linspace(900.0, 1800.0, B)
    Y = np.tile(stoich_h2_air(rec.species_names, np.asarray(rec.wt)), (B, 1))
    return T, np.full(B, P_ATM), Y


@pytest.mark.parametrize("option", [1, 5])
def test_equilibrium_fault_matches_jax(h2o2, option):
    jm, rec = h2o2
    T, P, Y = _eq_lanes(rec)
    elems = np.arange(B)
    with jfi.inject(jfi.FaultSpec("linalg_unstable", (POISONED,))):
        ref = jax.jit(jax.vmap(lambda t, p, y, e: jeq.equilibrate(
            jm, t, p, y, option=option, fault_elem=e)))(
                *(jnp.asarray(a) for a in (T, P, Y, elems)))
    with faultinject.inject(faultinject.FaultSpec("linalg_unstable",
                                                  (POISONED,))):
        got = teq.equilibrate(rec, T, P, Y, option=option, elem_ids=elems,
                              device="cpu")
    clean = teq.equilibrate(rec, T, P, Y, option=option, device="cpu")
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert got.status[POISONED] != int(SolveStatus.OK)
    healthy = np.arange(B) != POISONED
    for name in ("T", "P", "X", "Y", "residual", "status"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[healthy],
                                      getattr(clean, name).numpy()[healthy],
                                      err_msg=name)


def test_psr_fault_matches_jax(h2o2):
    jm, rec = h2o2
    Y_in = np.tile(stoich_h2_air(rec.species_names, np.asarray(rec.wt)),
                   (B, 1))
    T_in = np.full(B, 800.0)
    h_in = np.array(jax.vmap(lambda t, y: jthermo.mixture_enthalpy_mass(
        jm, t, y))(T_in, Y_in))
    tau = np.geomspace(1e-4, 1e-2, B)
    T_g = np.full(B, 2200.0)
    elems = np.arange(B)

    def one(Y_i, h_i, ta, e):
        return jpsr.solve_psr(jm, "tau", "ENRG", P=P_ATM, Y_in=Y_i,
                              h_in=h_i, T_guess=2200.0, Y_guess=Y_i, tau=ta,
                              mdot=10.0, fault_elem=e)

    with jfi.inject(jfi.FaultSpec("linalg_unstable", (POISONED,))):
        ref = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (
            Y_in, h_in, tau, elems)))
    kw = dict(P=P_ATM, Y_in=Y_in, h_in=h_in, T_guess=T_g, Y_guess=Y_in,
              tau=tau, mdot=10.0, device="cpu")
    with faultinject.inject(faultinject.FaultSpec("linalg_unstable",
                                                  (POISONED,))):
        got = tpsr.solve_psr(rec, "tau", "ENRG", elem_ids=elems, **kw)
    clean = tpsr.solve_psr(rec, "tau", "ENRG", **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert got.status[POISONED] == int(SolveStatus.LINALG_UNSTABLE)
    healthy = np.arange(B) != POISONED
    for name in ("T", "Y", "residual", "status", "n_newton"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[healthy],
                                      getattr(clean, name).numpy()[healthy],
                                      err_msg=name)


@pytest.mark.parametrize("kind", ["equilibrium", "psr"])
def test_served_engines_heal_at_the_rung(h2o2, kind):
    _, rec = h2o2
    Y = stoich_h2_air(rec.species_names, np.asarray(rec.wt))
    payload = (dict(T=1500.0, P=P_ATM, Y=Y, option=1) if kind == "equilibrium"
               else dict(tau=1e-3, P=P_ATM, Y_in=Y, T_in=800.0,
                         T_guess=2200.0))
    server = serve.ChemServer(rec, device="cpu", bucket_sizes=(1,),
                              max_delay_ms=5.0)
    clean = server.solve_direct(kind, **payload)
    assert clean.status_name == "OK"
    with faultinject.inject(faultinject.FaultSpec("linalg_unstable", (0,),
                                                  heal_at=1)):
        with server:
            r = server.submit(kind, **payload).result(timeout=300)
    assert r.ok and r.rescued and r.rescue_rungs == 1
    got = r.value["T"]
    assert abs(got - clean.value["T"]) <= 1e-9 * clean.value["T"]
