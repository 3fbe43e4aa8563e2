"""An irradiated ``run_climate`` of the port against the JAX package.

rfacv 0.5 and the stellar flux of tests/test_climate.py:116-141 (a 5600 K
blackbody star at 0.05 au, binned by the JAX ``opannection``), on a
stride-8, 24-bin slice of the synthetic CK table in float64, at nlevel 25:
the same ``converged`` and ``cvz_locs`` as the JAX solve and max |dT| <=
1e-6 K.  The brown-dwarf run and its bounds are in
tests/test_torch_climate.py, whose helper this calls.
"""

import torch

from test_torch_climate import run_climate_against_jax

torch.set_num_threads(1)


def test_irradiated_run_climate_matches_jax():
    run_climate_against_jax(irradiated=True)
