"""Cloudy brown-dwarf spectrum with the full virga cloud solver.

Port of examples/virga_clouds.py to picaso_tpu_torch: the reference's
cloud workflow (justdoit.virga -> eddysed microphysics -> cloudy
spectrum, justdoit.py:4269-4399 + the virga-exo package); the AM01
eddy-sedimentation solver is picaso_tpu_torch.virga on the host, the
spectra run on the card.  Without .mieff Mie files the optics fall back
to geometric efficiencies; the vertical structure (qc, particle sizes,
opd profile) is the full solve either way.

    python picaso_tpu_torch/examples/virga_clouds.py [cpu]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np

from picaso_tpu_torch import justdoit as jdi
from picaso_tpu_torch import virga as vj
from picaso_tpu_torch.opacities.factory import build_synthetic_db

device = sys.argv[1] if len(sys.argv) > 1 else 'cuda'

# ---- base atmosphere ----
db = os.path.join(tempfile.mkdtemp(), 'virga_syn.db')
build_synthetic_db(db, wno=np.linspace(1e4 / 5.0, 1e4 / 0.8, 400),
                   molecules=('H2O', 'CH4'), device=device)
opa = jdi.opannection(filename_db=db, device=device)

case = jdi.inputs(calculation='brown')
case.phase_angle(0)
case.gravity(gravity=300.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
case.setup_nostar()
case.atmosphere(filename=jdi.brown_dwarf_pt(), sep=r'\s+')

prof = case.inputs['atmosphere']['profile']
pressure = np.asarray(prof['pressure'])
temperature = np.asarray(prof['temperature'])

# ---- which species condense on this profile? ----
gases = vj.recommend_gas(pressure, temperature, mh=1.0, mmw=2.2)
print('condensing species on this profile:', gases)
assert len(gases) > 0

# ---- full eddysed solve + cloudy spectrum ----
picks = [g for g in ('MgSiO3', 'Fe', 'H2O') if g in gases][:2] or gases[:2]
out = case.virga(picks, fsed=2.0, mh=1.0, kz_min=1e9, full_output=True)
opd = np.asarray(out['opd_per_layer'])
print(f"virga solved {picks}: column opd "
      f"{float(opd.sum(axis=0).max()):.3f} at the thickest wavelength")
assert np.isfinite(opd).all() and (opd >= 0).all()
assert opd.sum() > 0, 'profile should form clouds'

df_cloudy = case.spectrum(opa, calculation='thermal')
thermal_cloudy = np.asarray(df_cloudy['thermal'])

# clear comparison
case.clouds_reset()
df_clear = case.spectrum(opa, calculation='thermal')
thermal_clear = np.asarray(df_clear['thermal'])

assert np.isfinite(thermal_cloudy).all()
ratio = thermal_cloudy.sum() / thermal_clear.sum()
print(f'cloudy/clear bolometric thermal ratio: {ratio:.3f}')
assert ratio < 1.0, 'clouds should suppress emission'

# ---- variable-fsed (AM01 alpha profile) ----
out2 = case.virga(picks, fsed=2.0, param='exp', b=3.0, mh=1.0,
                  kz_min=1e9, full_output=True)
assert np.isfinite(np.asarray(out2['opd_per_layer'])).all()
print('variable-fsed solve OK')
print('virga clouds example OK')
