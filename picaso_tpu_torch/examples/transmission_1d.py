"""1D transmission spectrum (transit geometry).

Port of examples/transmission_1d.py to picaso_tpu_torch: the
synthetic-DB equivalent of the reference's transmission quickstart
(justdoit.py spectrum(calculation='transmission')), on the card.

    python picaso_tpu_torch/examples/transmission_1d.py [cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import tempfile

import numpy as np

from picaso_tpu_torch import justdoit as jdi
from picaso_tpu_torch.opacities.factory import build_synthetic_db

device = sys.argv[1] if len(sys.argv) > 1 else 'cuda'
db = os.path.join(tempfile.mkdtemp(), 'synthetic_opacities.db')
build_synthetic_db(db, wno=np.linspace(1e4 / 5.0, 1e4 / 1.0, 1500),
                   molecules=('H2O', 'CH4', 'CO'), device=device)
opa = jdi.opannection(filename_db=db, device=device)

case = jdi.inputs()
case.phase_angle(0)
case.gravity(radius=1.2, radius_unit=jdi.u.Unit('Rjup'),
             mass=0.8, mass_unit=jdi.u.Unit('Mjup'))
case.star(opa, 5300.0, 0.0, 4.5, radius=0.9,
          radius_unit=jdi.u.Unit('Rsun'), semi_major=0.04,
          semi_major_unit=jdi.u.Unit('au'))
case.approx(p_reference=1.0)

nlevel = 41
pressure = np.logspace(-7, 2, nlevel)
case.atmosphere(df={
    'pressure': pressure, 'temperature': np.full(nlevel, 1200.0),
    'H2': np.full(nlevel, 0.85), 'He': np.full(nlevel, 0.14),
    'H2O': np.full(nlevel, 5e-4), 'CH4': np.full(nlevel, 1e-4),
    'CO': np.full(nlevel, 2e-4)})

df = case.spectrum(opa, calculation='transmission')
wno, depth = df['wavenumber'], df['transit_depth']
wno_bin, depth_bin = jdi.mean_regrid(wno, depth, R=100)
print('transit depth range [ppm]:',
      float(depth_bin.min() * 1e6), '-', float(depth_bin.max() * 1e6))
assert np.isfinite(depth).all() and depth.min() > 0
