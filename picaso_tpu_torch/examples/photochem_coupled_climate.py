"""Photochemistry-coupled 1D climate (kinetics inside the RCE loop).

Port of examples/photochem_coupled_climate.py to picaso_tpu_torch, the
counterpart of the reference's self-consistent photochem climate
(climate.py:3107-3109 + photochem.py:132): every profile iteration runs
chemical kinetics to steady state, warm-started from the previous
solution, and the climate opacities are rebuilt from the kinetic
abundances.  The external ``photochem`` package (Fortran) provides the
kinetics in production; without it this example drives the loop with a
mock of the same ``run_for_picaso`` interface on the port's dict profile,
so the coupled loop itself runs either way.

The climate solve runs in float64 on the card (the port's default for
the climate), the spectra's copy of the table in float32; with ``cpu``
everything runs on the CPU in float64.

    python picaso_tpu_torch/examples/photochem_coupled_climate.py [cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np

from picaso_tpu_torch import justdoit as jdi
from picaso_tpu_torch.opacities.ck import synthetic_ck_table
from picaso_tpu_torch.photochem import MockKinetics, photochem_available


def coupled_case(device, ck=None):
    """The 700 K brown dwarf at log g 4 with 31 levels on ``ck``
    (default: the synthetic CK table with per-gas tables) and its
    kinetics: photochem's where it is installed, else the mock.  Returns
    the case, the connection and the kinetics object."""
    if ck is None:
        ck = synthetic_ck_table(with_per_gas=True, device=device)
    opa = jdi.opannection(ck_table=ck, method='preweighted', device=device)
    case = jdi.inputs(calculation='brown', climate=True)
    case.phase_angle(0)
    case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.effective_temp(700.0)
    case.setup_nostar()
    case.setup_climate()
    nlevel = 31
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    case.inputs_climate(temp_guess=guess, pressure=pressure,
                        rcb_guess=nlevel - 3, rfacv=0.0)
    if photochem_available():
        case.atmosphere(df={'pressure': pressure, 'temperature': guess},
                        photochem_init_args=dict(), device=device)
        return case, opa, case.photochem_init()
    pc = MockKinetics()
    case.inputs['climate']['pc'] = pc
    return case, opa, pc


def main(argv):
    device = argv[0] if argv else 'cuda'
    case, opa, pc = coupled_case(device)
    if not photochem_available():
        print('photochem not installed -> driving the coupled loop with a '
              'mock kinetics backend')
    out = case.climate(opa, diseq_chem=True, verbose=False)

    temp = np.asarray(out['temperature'])
    print(f'converged: {bool(out["converged"])}')
    print(f'T range: {temp.min():.0f} - {temp.max():.0f} K')
    print(f'kinetics solves during the climate run: '
          f'{getattr(pc, "calls", "n/a")}')
    prof = case.inputs['atmosphere']['profile']
    assert np.isfinite(temp).all()
    if not photochem_available():
        assert pc.calls >= 2
        assert np.allclose(prof['CH4'], prof['CH4'][-1])
    print('photochem-coupled climate OK')


if __name__ == '__main__':
    main(sys.argv[1:])
