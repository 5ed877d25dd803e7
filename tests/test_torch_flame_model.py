"""The PyTorch port's object model for flames (Chemistry, Stream and the
premixed flame models) on the CPU, against the JAX package.

- The keyword surface of ``FreelyPropagating`` (the reference's
  ``tests/test_flame1d.py:236``) and "flames need transport" (:221).
- MULT transport and the real-gas EOS raise NotImplementedError naming
  their ROADMAP items (B14's Stefan-Maxwell fluxes, B16).
- The slice end to end at a small size: Chemistry, Stream and
  FreelyPropagating on h2o2 stoichiometric H2/air at 1 atm and 298 K on
  0-2 cm, a 30-point ``set_grid_profile``, ``set_max_grid_points(30)`` (no
  point added) and ``skip_fix_T_solution(True)``: the same converged,
  n_points and n_newton as the JAX package, with Su, T and Y within 1e-8.
  The JAX side takes ~45 s on this CPU, so its result is recorded in
  ``tests/torch_port_cases.py`` (SMALL_FLAME_REFERENCE, with the command
  that gave it); the ``slow`` test re-derives it.
- The host helpers under the flame's inlet: ``X_by_Equivalence_Ratio``,
  isothermal and adiabatic mixing and Stream's flow conversions against
  the JAX package's, within 1e-10.
"""

import os

import numpy as np
import pytest
import torch

import pychemkin_tpu_torch as ptt
from pychemkin_tpu_torch.mechanism import DATA_DIR
from pychemkin_tpu_torch.models import (BurnedStabilized_GivenTemperature,
                                        FreelyPropagating)
from pychemkin_tpu_torch.ops import flame1d

from torch_port_cases import (SMALL_FLAME_REFERENCE, jax_flame_reference,
                              small_flame_model)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chemistry(tran=True):
    chem = ptt.Chemistry(chem=os.path.join(DATA_DIR, "h2o2.inp"),
                         tran=os.path.join(DATA_DIR, "tran_h2o2.dat")
                         if tran else "", device="cpu")
    chem.preprocess()
    return chem


@pytest.fixture()
def h2_air_inlet():
    inlet = ptt.Stream(_chemistry(), label="fuel")
    inlet.pressure = 1.01325e6
    inlet.temperature = 298.0
    inlet.X = {"H2": 2.0, "O2": 1.0, "N2": 3.76}
    inlet.mass_flowrate = 0.03
    inlet.flowarea = 1.0
    return inlet


def test_flame_requires_transport():
    s = ptt.Stream(_chemistry(tran=False), label="x")
    s.pressure = 1.01325e6
    s.temperature = 300.0
    s.X = {"H2": 1.0}
    with pytest.raises(ValueError, match="transport"):
        FreelyPropagating(s)


def test_premixed_flame_keyword_surface(h2_air_inlet):
    fl = FreelyPropagating(h2_air_inlet)
    assert fl.getkeyword("FREE") is True
    assert fl.getkeyword("ENRG") is True
    fl.start_position = 0.0
    fl.end_position = 2.0
    fl.set_solution_quality(gradient=0.2, curvature=0.6)
    assert fl.gradient == 0.2 and fl.curvature == 0.6
    fl.use_fixed_Lewis_number_transport(1.1)
    assert fl._flame_solver_options()["transport_model"] == "LEWIS"
    fl.use_mixture_averaged_transport()
    assert fl._flame_solver_options()["transport_model"] == "MIX"
    fl.set_convection_differencing_type("central")
    assert fl._flame_solver_options()["upwind"] is False
    fl.pinned_temperature(420.0)
    assert fl.getkeyword("TFIX") == 420.0
    with pytest.raises(ValueError):
        fl.pinned_temperature(100.0)     # below the unburnt T
    with pytest.raises(ValueError):
        fl.set_inlet(h2_air_inlet)       # a single-inlet model
    assert fl.get_flame_speed() == 0.0   # before running: zero
    with pytest.raises(RuntimeError):
        fl.get_solution_size()
    assert "FREE" in fl.createkeywordinputlines()[1]
    burner = BurnedStabilized_GivenTemperature(h2_air_inlet)
    assert burner.getkeyword("TGIV") is True


def test_mult_and_real_gas_raise(h2_air_inlet):
    fl = FreelyPropagating(h2_air_inlet)
    with pytest.raises(NotImplementedError, match="B14"):
        fl.use_multicomponent_transport()
    with pytest.raises(NotImplementedError, match="B14"):
        flame1d.solve_flame(fl.chemistry.tm, P=1.01325e6, T_in=298.0,
                            Y_in=h2_air_inlet.Y, x_start=0.0, x_end=2.0,
                            transport_model="MULT")
    with pytest.raises(NotImplementedError, match="B16"):
        fl.userealgasEOS(True)
    with pytest.raises(NotImplementedError, match="B16"):
        h2_air_inlet.use_realgas_cubicEOS()


def _check_small(mine, ref):
    assert mine["converged"] and ref["converged"]
    assert mine["n_points"] == ref["n_points"]
    assert mine["n_newton"] == ref["n_newton"]
    assert abs(mine["su"] - ref["su"]) <= 1e-8 * ref["su"]
    T_ref, Y_ref = np.asarray(ref["T"]), np.asarray(ref["Y"])
    assert np.max(np.abs(mine["T"] - T_ref)) <= 1e-8 * T_ref.max()
    assert np.max(np.abs(mine["Y"] - Y_ref)) <= 1e-8


@pytest.fixture(scope="module")
def small_flame():
    fl = small_flame_model(ptt.Stream, FreelyPropagating, _chemistry())
    with torch.inference_mode():
        rc = fl.run()
        sol = fl.process_solution()
    return dict(rc=rc, converged=bool(sol.converged),
                n_points=int(sol.n_points), n_newton=int(sol.n_newton),
                su=float(fl.get_flame_speed()), T=np.asarray(sol.T),
                Y=np.asarray(sol.Y), model=fl)


def test_small_free_flame_matches_recorded_reference(small_flame):
    assert small_flame["rc"] == 0
    _check_small(small_flame, SMALL_FLAME_REFERENCE)
    fl = small_flame["model"]
    assert fl.get_solution_size() == small_flame["n_points"]
    T = fl.get_solution_variable_profile("temperature")
    assert T[0] == pytest.approx(298.0) and T.max() > 2000.0
    exit_stream = fl.get_solution_stream_at_grid(-1)
    assert exit_stream.temperature == pytest.approx(T[-1])


@pytest.mark.slow
def test_small_free_flame_matches_reference_rederived(small_flame):
    """Re-derives SMALL_FLAME_REFERENCE through the JAX package's models."""
    _check_small(small_flame, jax_flame_reference("h2o2_small"))


def test_mixing_streams_and_equivalence_ratio_match_reference():
    """The object model's host helpers against the JAX package's:
    X_by_Equivalence_Ratio (calculate_stoichiometrics), isothermal and
    adiabatic mixing, Stream's flow conversions and adiabatic stream
    mixing, on h2o2 at the same inputs."""
    import pychemkin_tpu as ck
    from pychemkin_tpu.mechanism import DATA_DIR as JDATA

    files = dict(chem=os.path.join(JDATA, "h2o2.inp"),
                 tran=os.path.join(JDATA, "tran_h2o2.dat"))
    jc = ck.Chemistry(**files)
    jc.preprocess()
    tc = ptt.Chemistry(**files, device="cpu")
    tc.preprocess()
    out = []
    for pkg, chem in ((ck, jc), (ptt, tc)):
        names = chem.species_symbols
        fuel = np.zeros(len(names))
        fuel[names.index("H2")] = 1.0
        oxid = np.zeros(len(names))
        oxid[names.index("O2")] = 0.21
        oxid[names.index("N2")] = 0.79
        a = pkg.Stream(chem, label="a")
        a.pressure, a.temperature = 1.01325e6, 300.0
        a.X_by_Equivalence_Ratio(chem, fuel, oxid, np.zeros(len(names)),
                                 ["H2O", "N2"], 0.8)
        a.mass_flowrate = 2.0
        b = pkg.Stream(chem, label="b")
        b.pressure, b.temperature = 1.01325e6, 900.0
        b.X = {"N2": 0.7, "O2": 0.2, "H2O": 0.1}
        b.vol_flowrate = 5.0e3
        iso = pkg.isothermal_mixing([(a, 1.0), (b, 2.0)], "mass", 500.0)
        adi = pkg.adiabatic_mixing([(a, 1.0), (b, 2.0)], "mole")
        mix = pkg.adiabatic_mixing_streams(a, b)
        out.append(np.concatenate([
            a.X, [b.mass_flowrate, b.sccm], iso.Y, [adi.temperature],
            adi.Y, [mix.temperature, mix.mass_flowrate], mix.Y]))
    ref, mine = out
    np.testing.assert_allclose(mine, ref, rtol=1e-10, atol=1e-13)
