"""1D reflected + thermal spectrum of a warm Jupiter (quick start).

Port of examples/reflected_thermal_1d.py to picaso_tpu_torch.  Runs from
a synthetic opacity database written on the fly, so it needs no
downloads; swap the database for a real Zenodo sqlite DB path to
reproduce the reference's science results (justdoit.py quickstart flow).

    python picaso_tpu_torch/examples/reflected_thermal_1d.py [cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import tempfile

import numpy as np

from picaso_tpu_torch import justdoit as jdi
from picaso_tpu_torch.opacities.factory import build_synthetic_db

device = sys.argv[1] if len(sys.argv) > 1 else 'cuda'

# --- opacities: synthetic DB written on the fly (reference sqlite schema)
db = os.path.join(tempfile.mkdtemp(), 'synthetic_opacities.db')
build_synthetic_db(db, wno=np.linspace(1e4 / 2.0, 1e4 / 0.4, 2000),
                   molecules=('H2O', 'CH4', 'CO2'), device=device)
opa = jdi.opannection(filename_db=db, device=device)

# --- scene
case = jdi.inputs()
case.phase_angle(0)
case.gravity(gravity=25.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
case.star(opa, 5800.0, 0.0122, 4.437, radius=1.0,
          radius_unit=jdi.u.Unit('Rsun'), semi_major=0.05,
          semi_major_unit=jdi.u.Unit('au'))

nlevel = 41
pressure = np.logspace(-6, 2, nlevel)
temperature = np.clip(1100.0 * (pressure / 10.0) ** 0.1, 250.0, None)
case.atmosphere(df={
    'pressure': pressure, 'temperature': temperature,
    'H2': np.full(nlevel, 0.84), 'He': np.full(nlevel, 0.15),
    'H2O': np.full(nlevel, 1e-3), 'CH4': np.full(nlevel, 3e-4),
    'CO2': np.full(nlevel, 1e-6)})

# box-model cloud deck
case.clouds(g0=[0.85], w0=[0.90], opd=[0.5], p=[0.0], dp=[1.0])

df = case.spectrum(opa, calculation='reflected+thermal', full_output=True)
wno, albedo, thermal = df['wavenumber'], df['albedo'], df['thermal']

wno_bin, alb_bin = jdi.mean_regrid(wno, albedo, R=150)
print('geometric albedo @ 0.55um:',
      float(np.interp(1e4 / 0.55, wno_bin, alb_bin)))
print('thermal flux peak [erg/cm2/s/cm-1]:', float(np.max(thermal)))
assert np.isfinite(albedo).all() and np.isfinite(thermal).all()
