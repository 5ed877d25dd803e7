"""The PyTorch port's mixture-averaged transport (plain twin of kernel K9)
and the object model's getters, against the JAX package.

- Every function of the JAX package's ``ops/transport.py`` that the flame
  runs (species viscosities and conductivities, binary diffusion, the
  Wilke viscosity, the combination-averaged conductivity, the
  mixture-averaged diffusion coefficients and the thermal diffusion
  ratios) on h2o2 and ch4global at 24 seeded states (T 300-3000 K, random
  mole fractions with zeros, pure species among them): within 1e-12 of
  the reference per state, scale-relative. The K9 wrapper on CPU tensors
  is the twin and must give the same.
- ``Mixture``'s transport, thermo and rate getters against the JAX
  package's ``Mixture`` on one stoichiometric H2/air state at 1500 K and
  2 atm: the same tolerance; ``Chemistry``'s species getters likewise.
- Without a card and without ``device``, ``Chemistry`` raises; the
  real-gas switch and the Chapman-Jouguet option raise
  NotImplementedError naming their ROADMAP item.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pychemkin_tpu as ck
from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu.ops import transport as jtr
import pychemkin_tpu_torch as ptt
from pychemkin_tpu_torch import kernels
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch.ops import transport as ttr

from torch_port_cases import P_ATM, scale_rel, transport_states

TOL = 1e-12
B = 24


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["h2o2", "ch4global"])
def case(request):
    name = request.param
    jm = jmech.load_embedded(name)
    tm = tmech.TorchMechanism(tmech.load_embedded(name), "cpu")
    T, P, X = transport_states(jm.species_names, np.asarray(jm.wt), B, 7)
    return name, jm, tm, T, P, X


def _ref(fn, *per_state):
    return np.stack([np.asarray(fn(*(a[b] for a in per_state)))
                     for b in range(B)])


@pytest.mark.parametrize("fn", [
    "species_viscosities", "species_conductivities",
    "binary_diffusion_coefficients", "mixture_viscosity",
    "mixture_conductivity", "mixture_diffusion_coefficients",
    "thermal_diffusion_ratios"])
def test_transport_matches_reference(case, fn):
    _, jm, tm, T, P, X = case
    t = {k: torch.tensor(v) for k, v in dict(T=T, P=P, X=X).items()}
    args = {"species_viscosities": ("T",),
            "species_conductivities": ("T",),
            "binary_diffusion_coefficients": ("T", "P"),
            "mixture_viscosity": ("T", "X"),
            "mixture_conductivity": ("T", "X"),
            "mixture_diffusion_coefficients": ("T", "P", "X"),
            "thermal_diffusion_ratios": ("T", "X")}[fn]
    mine = getattr(ttr, fn)(tm, *(t[a] for a in args)).numpy()
    ref = _ref(lambda *a: getattr(jtr, fn)(jm, *a),
               *(dict(T=T, P=P, X=X)[a] for a in args))
    if ref.ndim == 1:
        ref, mine = ref[:, None], mine[:, None]
    assert scale_rel(mine, ref) <= TOL


def test_k9_wrapper_cpu_route_is_the_twin(case):
    _, _, tm, T, P, X = case
    t = [torch.tensor(v) for v in (T, P, X)]
    props = kernels.transport_props(tm, *t)
    twin = ttr.transport_props(tm, *t)
    for f in twin._fields:
        assert torch.equal(getattr(props, f), getattr(twin, f)), f
    assert props.Djk.shape == (B, tm.KK, tm.KK)
    with pytest.raises(ValueError):
        kernels.transport_props(tm, t[0], t[1], t[2][:, :-1].contiguous())


def _mixtures(name="h2o2"):
    data = jmech.DATA_DIR
    files = dict(chem=os.path.join(data, name + ".inp"),
                 tran=os.path.join(data, "tran_h2o2.dat"))
    jc = ck.Chemistry(**files)
    jc.preprocess()
    tc = ptt.Chemistry(**files, device="cpu")
    tc.preprocess()
    mixes = []
    for chem, cls in ((jc, ck.Mixture), (tc, ptt.Mixture)):
        m = cls(chem)
        m.temperature = 1500.0
        m.pressure = 2.0 * P_ATM
        m.X = {"H2": 2.0, "O2": 1.0, "N2": 3.76, "H2O": 0.4, "OH": 0.01,
               "H": 0.005}
        mixes.append(m)
    return jc, tc, mixes


@pytest.mark.parametrize("getter", [
    "species_Visc", "species_Cond", "species_Diffusion_Coeffs",
    "mixture_viscosity", "mixture_conductivity", "mixture_diffusion_coeffs",
    "mixture_binary_diffusion_coeffs", "mixture_thermal_diffusion_coeffs",
    "HML", "CPBL", "ROP", "RxnRates", "volHRR", "massROP", "species_Cp",
    "species_H", "RHO", "WTM", "concentration", "X", "Y"])
def test_mixture_getters_match_reference(getter):
    _, _, (jm, tm) = _mixtures()
    ref, mine = getattr(jm, getter), getattr(tm, getter)
    if callable(ref):
        ref, mine = ref(), mine()
    ref = np.atleast_1d(np.asarray(ref, dtype=np.float64).ravel())
    mine = np.atleast_1d(np.asarray(mine, dtype=np.float64).ravel())
    assert mine.shape == ref.shape
    assert scale_rel(mine[None], ref[None]) <= TOL


def test_chemistry_species_getters_match_reference():
    jc, tc, _ = _mixtures()
    for name, args in (("SpeciesCp", (900.0,)), ("SpeciesH", (900.0,)),
                       ("SpeciesCv", (900.0,)), ("SpeciesU", (900.0,)),
                       ("SpeciesVisc", (900.0,)), ("SpeciesCond", (900.0,)),
                       ("SpeciesDiffusionCoeffs", (900.0, P_ATM))):
        ref = np.asarray(getattr(jc, name)(*args))
        mine = getattr(tc, name)(*args)
        assert scale_rel(mine[None], ref[None]) <= TOL, name
    assert tc.species_symbols == jc.species_symbols
    assert tc.KK == jc.KK and tc.IIGas == jc.IIGas and tc.MM == jc.MM


def test_entry_points_need_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptt.Chemistry(chem=os.path.join(jmech.DATA_DIR, "h2o2.inp"))


def test_realgas_and_cj_raise_not_implemented():
    _, tc, (_, tm) = _mixtures()
    with pytest.raises(NotImplementedError, match="B16"):
        tc.use_realgas_cubicEOS()
    with pytest.raises(NotImplementedError, match="B16"):
        tm.use_realgas_cubicEOS()
    with pytest.raises(NotImplementedError, match="B12"):
        ptt.detonation(tm)
