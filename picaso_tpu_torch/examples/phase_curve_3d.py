"""3D spectra and a thermal phase curve from a GCM-style map.

Port of examples/phase_curve_3d.py to picaso_tpu_torch: a synthetic-DB
miniature of the reference's 3D + phase-curve workflow (justdoit.py:3414
atmosphere_3d, :4741 phase_curve): a longitudinal hot-spot temperature
map, each disk facet a spectrum on the card.

    python picaso_tpu_torch/examples/phase_curve_3d.py [cpu]
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
build_synthetic_db(db, wno=np.linspace(1e4 / 5.0, 1e4 / 1.0, 600),
                   molecules=('H2O', 'CH4'), device=device)
opa = jdi.opannection(filename_db=db, device=device)

# GCM-style map: hot dayside spot
nlevel, nlon, nlat = 25, 12, 8
pressure = np.logspace(-4, 2, nlevel)
lon = np.linspace(-180, 180, nlon)
lat = np.linspace(-85, 85, nlat)
base = np.clip(1000.0 * (pressure / 10.0) ** 0.08, 350.0, None)
tmap = np.zeros((nlevel, nlon, nlat))
for i, lo in enumerate(lon):
    for j, la in enumerate(lat):
        day = np.cos(np.radians(lo)) * np.cos(np.radians(la))
        tmap[:, i, j] = base * (1.0 + 0.25 * max(day, 0.0))
gcm = {'pressure': pressure, 'lat': lat, 'lon': lon, 'temperature': tmap,
       'H2O': np.zeros_like(tmap) + 5e-4,
       'CH4': np.zeros_like(tmap) + 2e-4,
       'H2': np.zeros_like(tmap) + 0.85,
       'He': np.zeros_like(tmap) + 0.14}

# --- single-phase 3D thermal spectrum
case = jdi.inputs(calculation='browndwarf')
case.phase_angle(0, num_gangle=6, num_tangle=4)
case.gravity(gravity=22.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
case.atmosphere_3d(gcm)
out = case.spectrum(opa, calculation='thermal', dimension='3d')
print('3d thermal peak [erg/cm2/s/cm-1]:', float(np.max(out['thermal'])))

# --- thermal phase curve
case_pc = jdi.inputs(calculation='browndwarf')
case_pc.phase_curve_geometry('thermal', np.linspace(0, 2 * np.pi, 4,
                                                    endpoint=False),
                             num_gangle=6, num_tangle=4)
case_pc.gravity(gravity=22.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
case_pc.atmosphere_3d(gcm)
curve = case_pc.phase_curve(opa)
means = [float(np.mean(v['thermal'])) for v in curve.values()]
print('phase-curve disk means:', np.round(means, 1).tolist())
assert all(np.isfinite(m) for m in means)
assert np.isfinite(out['thermal']).all()
