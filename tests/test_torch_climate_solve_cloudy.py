"""A whole cloudy climate solve of the port against the JAX package's.

The case of tests/climate_modes_record.py at 31 levels on the stride-4,
48-bin slice of the synthetic CK table (its per-gas tables too), through
the port's front door on the CPU in float64
(``torch_climate_modes_cases.check_solve``), against the JAX package's
float64 solve recorded in tests/climate_modes_reference.json.
"""

import torch

from torch_climate_modes_cases import check_solve

torch.set_num_threads(1)


def test_cloudy_solve_matches_jax():
    check_solve('cloudy_31')
