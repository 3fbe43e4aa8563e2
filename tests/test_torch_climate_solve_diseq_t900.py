"""A whole diseq climate solve of the port that balances, against the JAX
package's.

The field T dwarf of tests/climate_modes_record.py (900 K at 1000 m/s^2,
log g 5) at 31 levels on the stride-4, 48-bin slice of the synthetic CK
table with its per-gas tables, through the port's front door on the CPU in
float64 (``torch_climate_modes_cases.check_solve``), against the JAX
package's float64 solve recorded in tests/climate_modes_reference.json:
both converge, balance the flux within 1e-3 of sigma Teff^4 and quench
at every level the record names.
"""

import torch

from torch_climate_modes_cases import check_solve

torch.set_num_threads(1)


def test_diseq_t900_solve_balances_as_jax():
    check_solve('diseq_t900_31')
