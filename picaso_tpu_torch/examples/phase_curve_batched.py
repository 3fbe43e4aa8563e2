"""Batched 1D phase curve: every phase a scene of one batch.

Port of examples/phase_curve_batched.py to picaso_tpu_torch: the
reference computes phase curves with a joblib loop over phases
(justdoit.py:4741-4777); here the phases are the scenes of one
``pipeline.forward_batch`` on the card, checked against the phase-by-phase
loop.

    python picaso_tpu_torch/examples/phase_curve_batched.py [cpu]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np

from picaso_tpu_torch import justdoit as jdi
from picaso_tpu_torch.opacities import factory

device = sys.argv[1] if len(sys.argv) > 1 else 'cuda'
db = os.path.join(tempfile.mkdtemp(), 'example_pc_syn.db')
wno = np.linspace(2000.0, 12000.0, 2000)
factory.build_synthetic_db(db, wno, ntemp=8, npress=6, device=device)

opa = jdi.opannection(filename_db=db, device=device)
case = jdi.inputs()
case.gravity(mass=1.0, mass_unit=jdi.u.Unit('M_jup'),
             radius=1.1, radius_unit=jdi.u.Unit('R_jup'))
phases = np.linspace(0, np.pi * 0.9, 8)
case.phase_curve_geometry('reflected', phases, num_gangle=6, num_tangle=6)
case.star(opa, 5700, 0.0, 4.4, radius=1.0,
          radius_unit=jdi.u.Unit('R_sun'), semi_major=0.05,
          semi_major_unit=jdi.u.Unit('au'))
case.atmosphere(filename=jdi.jupiter_pt(), sep=r'\s+')

t0 = time.time()
out = case.phase_curve(opa, verbose=False, batched=True)
t_batched = time.time() - t0
t0 = time.time()
out_serial = case.phase_curve(opa, verbose=False, batched=False)
t_serial = time.time() - t0

curve = [float(np.nanmean(out[p]['fpfs_reflected'])) for p in out]
print('phase(rad) -> <fpfs>:')
for p, c in zip(out, curve):
    print(f'  {p:5.2f} -> {c:.3e}')
assert curve[0] > curve[-1], 'fpfs should fall toward quadrature+'
mx = max(abs(np.asarray(out[p]['albedo'])
             - np.asarray(out_serial[p]['albedo'])).max() for p in out)
print(f'batched {t_batched:.1f}s vs serial {t_serial:.1f}s; '
      f'max |d albedo| = {mx:.2e}')
assert mx < 1e-3
print('OK')
