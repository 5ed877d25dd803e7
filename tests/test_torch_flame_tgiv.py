"""The PyTorch port's flame stencils at a given temperature (TGIV): the
twins of K10 and K11 against the JAX package's ``make_residual`` and
``jacobian_blocks`` on the 16-point h2o2 state of ``test_torch_flame.py``,
for TGIV x free/burner x MIX/LEWIS/TDIF x upwind/central: F within 1e-12
and the blocks within 1e-10, scale-relative per grid point (the ENRG half
is in ``test_torch_flame.py``).
"""

import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu_torch import mechanism as tmech
from test_torch_flame import N_PTS, _check_stencils, configs

from torch_port_cases import flame_state


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


@pytest.mark.parametrize("cfg_kw", configs("TGIV"),
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_residual_and_blocks_h2o2_tgiv(mechs, cfg_kw):
    jm, tm = mechs["h2o2"]
    u, x = flame_state(jm.species_names, np.asarray(jm.wt), N_PTS, 3)
    _check_stencils(jm, tm, u, x, cfg_kw)
