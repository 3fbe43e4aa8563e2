"""Brown-dwarf radiative-convective equilibrium (1D climate).

Port of examples/brown_dwarf_climate.py to picaso_tpu_torch: the
synthetic-CK equivalent of the reference's climate quickstart
(justdoit.py:4982 climate workflow), solved in float64 on the card.

    python picaso_tpu_torch/examples/brown_dwarf_climate.py [cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np

from picaso_tpu_torch import justdoit as jdi
from picaso_tpu_torch.opacities.ck import synthetic_ck_table

device = sys.argv[1] if len(sys.argv) > 1 else 'cuda'
opa_ck = jdi.opannection(ck_table=synthetic_ck_table(device=device),
                         method='preweighted', device=device)

case = jdi.inputs(calculation='brown')
case.phase_angle(0)
case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
case.effective_temp(700.0)
case.setup_nostar()
case.setup_climate()

nlevel = 41
pressure = np.logspace(-4, 2.5, nlevel)
guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
case.inputs_climate(temp_guess=guess, pressure=pressure,
                    rcb_guess=nlevel - 10, rfacv=0.0)

out = case.climate(opa_ck, verbose=False)
t = np.asarray(out['temperature'])
print('converged profile: T_top=%.0fK T_bot=%.0fK' % (t[0], t[-1]))
bal = out['flux_balance']
resid = np.abs(np.asarray(bal['flux_net_ir']) + np.asarray(bal['tidal']))[0]
print('TOA |net flux| / sigma Teff^4 =',
      float(resid / abs(np.asarray(bal['tidal'])[0])))
assert np.isfinite(t).all()
