"""The port's climate solve on a CK table read from a file, against the
JAX package's solve on the same file, on the CPU in float64.

The legacy 1460-grid ASCII table of ``legacy.synthetic_legacy_table``
(written by the port's ``write_legacy_ascii``, read by each package's
``load_ck_db``), every 8th of its 196 bins: ``run_climate`` of the
700 K, 100 m/s^2 brown dwarf at 31 levels (the JAX facade's
``inputs.climate`` and the port's ``climate.api.run_climate``) ends within
1e-6 K of the JAX solve, with the same ``converged`` and ``cvz_locs``, and
balances its fluxes.
"""

import numpy as np
import pytest
import torch

from picaso_tpu import justdoit as jdi
from picaso_tpu.opacities import ck as jck

from picaso_tpu_torch.climate import api as tapi
from picaso_tpu_torch.climate import core as tcore
from picaso_tpu_torch.opacities import ck as tck
from picaso_tpu_torch.opacities import legacy as tleg

torch.set_num_threads(1)

NLEVEL, STRIDE, TEFF = 31, 8, 700.0
DT_MAX = 1e-6


@pytest.fixture(scope='module')
def legacy_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp('legacy')
    tleg.write_legacy_ascii(str(root / 'ascii_data'),
                            **tleg.synthetic_legacy_table())
    return str(root)


def jax_slice(t, sl):
    a = t.arrays
    return jck.CKTable(
        a._replace(wno=a.wno[sl], delta_wno=a.delta_wno[sl],
                   ln_kappa=a.ln_kappa[:, :, sl, :],
                   cont_opa=a.cont_opa[:, :, sl]),
        t.molecules, t.full_abunds, t.gauss_pts, t.temps, t.pressures,
        wno=t.wno[sl], delta_wno=t.delta_wno[sl], gauss_wts=t.gauss_wts)


def problem():
    pressure = np.logspace(-4, 2.5, NLEVEL)
    guess = np.clip(TEFF * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    return pressure, guess, NLEVEL - 8


def test_climate_on_legacy_file_matches_jax(legacy_dir):
    sl = slice(None, None, STRIDE)
    pressure, guess, rcb = problem()

    jt = jax_slice(jck.load_ck_db(legacy_dir, dtype=np.float64), sl)
    case = jdi.inputs(calculation='brown', climate=True)
    case.phase_angle(0)
    case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.effective_temp(TEFF)
    case.setup_nostar()
    case.setup_climate()
    case.inputs_climate(temp_guess=guess, pressure=pressure, rcb_guess=rcb,
                        rfacv=0.0)
    ref = case.climate(jdi.opannection(ck_table=jt), verbose=False)

    tt = tck.load_ck_db(legacy_dir, device='cpu').take_bins(sl)
    assert tt.nwno == 25 and len(tt.molecules) == 24
    inputs = tapi.ClimateInputs(t_eff=TEFF, gravity=1e4, pressure=pressure,
                                guess=guess,
                                nstr=(0, rcb, NLEVEL - 2, 0, 0, 0))
    out = tapi.run_climate(inputs, tt, verbose=False, device='cpu')

    assert out['converged'] == ref['converged'] == 1
    assert [int(i) for i in out['cvz_locs']] == [int(i) for i in
                                                 ref['cvz_locs']]
    d_t = np.abs(out['temperature'] - np.asarray(ref['temperature'])).max()
    assert d_t <= DT_MAX, d_t
    nstr = [int(i) for i in out['cvz_locs']]
    balance = (np.abs(out['flux_balance']['flux_net'][:nstr[1]]).max()
               / (tcore.SIGMA_SB * TEFF ** 4))
    assert balance <= 1e-3
