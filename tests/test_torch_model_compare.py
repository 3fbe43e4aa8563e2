"""picaso_tpu_torch.model_compare against picaso_tpu.model_compare, both
in float64 on the CPU, every cell at rtol 1e-8.

The port returns dicts of numpy columns where the JAX module returns
DataFrames, with the same row and column keys, so the cells are compared
one by one.  Toon throughout (K5 / K6's twins on the CPU); one row of
``thermal_sh_test`` with the SH solver at 2 and 4 streams (the plain SH
path of both front doors), its JAX side built by the same front-door
calls as the JAX harness makes for that row.
"""

import numpy as np
import pandas as pd
import pytest

from picaso_tpu import justdoit as jdi
from picaso_tpu import model_compare as jmc

from picaso_tpu_torch import model_compare as tmc

RTOL = 1e-8


def assert_table(got, want, index):
    """A dict of columns against a DataFrame, cell by cell."""
    assert [str(i) for i in got[index]] == [str(i) for i in want.index]
    assert [c for c in got if c != index] == [str(c) for c in want.columns]
    for col in want.columns:
        np.testing.assert_allclose(got[str(col)], np.asarray(want[col],
                                                             float),
                                   rtol=RTOL, atol=0, err_msg=str(col))


def test_dlugach_matches_jax(tmp_path):
    real_j, got_j = jmc.dlugach_test()
    real_t, got_t = tmc.dlugach_test(device='cpu',
                                     output_dir=str(tmp_path / 'd.csv'))
    assert_table(real_t, real_j, 'asy')
    assert_table(got_t, got_j, 'asy')
    written = pd.read_csv(tmp_path / 'd.csv', index_col=0)
    np.testing.assert_allclose(written.values.astype(float),
                               got_j.values.astype(float), rtol=RTOL)


def test_madhu_matches_jax():
    want = jmc.madhu_test(asymmetric=False)
    got = tmc.madhu_test(asymmetric=False, device='cpu')
    assert list(got) == list(want.columns)
    for col in want.columns:
        np.testing.assert_allclose(got[col], want[col].values, rtol=RTOL,
                                   atol=0, err_msg=col)


def test_thermal_toon_matches_jax():
    assert_table(tmc.thermal_sh_test(device='cpu'), jmc.thermal_sh_test(),
                 'asy')


def jax_thermal_row(g0, cols, **approx):
    """The JAX harness's loop body (picaso_tpu/model_compare.py:76-105)
    for one row of the grid."""
    nlevel = 20
    wno = np.sort(1e4 / np.linspace(1.2, 9.5, 10))
    opa = jdi.opannection(wno_grid=wno)
    case = jdi.inputs(calculation='browndwarf')
    case.phase_angle(0)
    case.gravity(gravity=200, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.surface_reflect(0, opa.wno)
    pressure = np.logspace(-4, 2, nlevel)
    case.atmosphere(df=pd.DataFrame({
        'pressure': pressure,
        'temperature': np.clip(1270 * (pressure / 10) ** 0.1, 500, None),
        'H2': np.zeros(nlevel) + 0.85, 'He': np.zeros(nlevel) + 0.15}))
    case.inputs['test_mode'] = 'constant_tau'
    nlayer = nlevel - 1
    out = {}
    for w in cols:
        w0 = 0.999999 if float(w) == 1.0 else float(w)
        case.clouds(df=pd.DataFrame({
            'opd': np.zeros(196 * nlayer) + 0.2,
            'w0': np.zeros(196 * nlayer) + w0,
            'g0': np.zeros(196 * nlayer) + g0}))
        case.approx(single_phase='OTHG', delta_eddington=True,
                    raman='none', **approx)
        out[w] = float(np.mean(case.spectrum(opa,
                                             calculation='thermal')['thermal']))
    return out


@pytest.mark.parametrize('stream', [2, 4])
def test_thermal_sh_row_matches_jax(stream):
    """The port's whole SH grid; its g0 = 0.5 row against the JAX
    harness's calls for that row (at SH2 the w0 = 0.4 cell is NaN in both
    packages, ROADMAP Queue 3; assert_allclose holds NaN to NaN)."""
    got = tmc.thermal_sh_test(method='SH', stream=stream, device='cpu')
    cols = [c for c in got if c != 'asy']
    want = jax_thermal_row(0.5, cols, rt_method='SH', stream=stream,
                           toon_coefficients='quadrature')
    row = list(got['asy']).index(0.5)
    for w in cols:
        np.testing.assert_allclose(got[w][row], want[w], rtol=RTOL, atol=0,
                                   err_msg=w)
