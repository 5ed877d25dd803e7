"""The PyTorch port's ``solve_batch`` on the TGIV reactors (a T(t) ramp
with a P(t) or V(t) profile, Species_peak of OH) against the JAX
package's, and its constant-profile special case against the port's own
ignition sweep; h2o2, B = 8, n_out = 11 (the companion of
test_torch_solve_batch.py, whose checks and tolerances these are).

- ``solve_batch(device="cpu")`` against ``jax.vmap`` of the reference's:
  the same SolveStatus codes, T (the profile's), P and V at every output
  time within 1e-6 relative, Y within 1e-6 max(|Y|, 1e-8), the peak
  times within rtol; the TGIV profile twins of K1/K2 against the
  reference's RHS and fused Jacobian within 1e-12.
- With the default (constant) profiles, ``solve_batch`` and
  ``ignition_delay_sweep`` at the same width give the same times, status
  and attempt counts bit for bit, with n_out = 2 (the profile terms
  vanish exactly) and with n_out = 11 (the sweep's output grid), and
  ``solution_stats`` aggregates the batch's counters. The
  horizon is the first 3 us (cheap): T_inflection with no slope floor
  and the rising OH peak give finite times there.
"""

import numpy as np
import pytest
import torch

from pychemkin_tpu_torch.ops import odeint, reactors

from test_torch_solve_batch import (B, N_OUT, _lanes, _one_thread,  # noqa: F401
                                    check_against_jax, check_profile_twins,
                                    h2o2)

TGIV = ("conp_tgiv", "conv_tgiv")


@pytest.mark.parametrize("case", TGIV)
def test_solve_batch_matches_jax(h2o2, case):  # noqa: F811
    check_against_jax(h2o2, case)


@pytest.mark.parametrize("case", TGIV)
def test_profile_rhs_and_jacobian_match_jax(h2o2, case):  # noqa: F811
    check_profile_twins(h2o2, case)


@pytest.mark.parametrize("problem, energy", [("CONP", "ENRG"),
                                             ("CONV", "TGIV")])
def test_constant_profiles_equal_the_sweep(h2o2, problem, energy):  # noqa: F811
    _, rec = h2o2
    T0, P0, Y0, t_end = _lanes(rec, dict(T0=(1300.0, 1400.0), t_end=3e-6))
    kw = dict(ignition_mode="T_inflection",
              ignition_kwargs={"min_slope": -1e30}, device="cpu")
    if energy == "TGIV":
        oh = list(rec.species_names).index("OH")
        kw.update(ignition_mode="Species_peak",
                  ignition_kwargs={"species_index": oh})
    for n_out in (2, N_OUT):
        sol = reactors.solve_batch(rec, problem, energy, T0, P0, Y0, t_end,
                                   n_out=n_out, profile=True, **kw)
        times, ok, status, prof = reactors.ignition_delay_sweep(
            rec, problem, energy, T0, P0, Y0, t_end, n_out=n_out,
            profile=True, **kw)
        np.testing.assert_array_equal(sol.status.numpy(), status.numpy())
        np.testing.assert_array_equal(sol.success.numpy(), ok.numpy())
        assert np.isfinite(times.numpy()).all()
        np.testing.assert_array_equal(sol.ignition_time.numpy(),
                                      times.numpy())
        for k in ("n_steps", "n_rejected", "n_newton"):
            np.testing.assert_array_equal(sol.profile[k].numpy(),
                                          prof[k].numpy(), err_msg=k)
        assert sol.times.shape == (B, n_out)
        assert sol.Y.shape == (B, n_out, rec.n_species)
        assert torch.equal(sol.times[:, -1], torch.as_tensor(t_end))
        # the reference's counter aggregate over the batch
        stats = odeint.solution_stats(sol, kind="batch", emit=False)
        assert stats["n_elements"] == B
        assert stats["n_steps"] == int(prof["n_steps"].sum())
        assert stats["n_newton"] == int(prof["n_newton"].sum())
        assert stats["n_success"] == int(ok.sum())
        assert stats["status_counts"] == {"OK": B}
