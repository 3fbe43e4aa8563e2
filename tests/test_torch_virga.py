"""The port's cloud microphysics (virga.py) against the JAX package.

The port's ``virga.py`` is a numpy copy of ``picaso_tpu/virga.py`` without
pandas, so the same inputs give the same numbers; held at rtol 1e-12:
- the vapour pressures, ``condensation_t`` and ``recommend_gas``;
- ``compute``: eddysed on silicate + iron and on water, the analytic
  solver, ``do_virtual``, the variable-fsed ('exp') profile with an
  ``alpha_pressure``, and Mie optics read from a .mieff file written to
  ``tmp_path`` (``load_mieff`` round trip, one condensate with the table
  and one on geometric optics);
- ``calc_optics_user_r_dist``; ``picaso_format`` (a dict here);
- the front door: ``inputs.virga`` (the cloud table it attaches, and then
  a thermal spectrum through it on the CPU) and ``virga_3d`` on a 3 x 2
  GCM map.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from picaso_tpu import justdoit as jdi
from picaso_tpu import virga as jv

from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import virga as tv

torch.set_num_threads(1)

GRAV = 1e4
RTOL = 1e-12


def column(nlevel=41, t0=1900.0, slope=0.1):
    p = np.logspace(-4, 2, nlevel)
    return {'pressure': p, 'temperature': t0 * (p / p[-1]) ** slope,
            'kz': np.zeros(nlevel) + 1e9}


def both(condensates, col, kz_min=1e5, alpha_pressure=None, **kw):
    out = []
    for mod, frame in ((jv, pd.DataFrame), (tv, dict)):
        atmo = mod.Atmosphere(condensates, mmw=2.2, **kw)
        atmo.gravity = GRAV
        atmo.ptk(df=frame(col), kz_min=kz_min,
                 alpha_pressure=alpha_pressure)
        out.append(atmo)
    return out


def assert_same(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            assert_same(port[k], ref[k])
    elif isinstance(ref, (np.ndarray, float, int, np.floating)):
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)
    else:
        assert port == ref


def test_vapour_pressures_and_condensation():
    t = np.linspace(30.0, 3500.0, 300)
    for gas in jv.available():
        assert_same(getattr(tv.pvaps, gas)(t, p=0.3, mh=2.0),
                    getattr(jv.pvaps, gas)(t, p=0.3, mh=2.0))
        assert_same(tv.condensation_t(gas, 1.0, 2.2)[1],
                    jv.condensation_t(gas, 1.0, 2.2)[1])
    col = column(t0=1400.0)
    assert (tv.recommend_gas(col['pressure'], col['temperature'])
            == jv.recommend_gas(col['pressure'], col['temperature']))


CASES = {
    'silicate_iron': (['Mg2SiO4', 'Fe'], dict(fsed=2.0), {}),
    'water': (['H2O'], dict(fsed=1.0), dict(t0=400.0)),
    'analytic': (['Mg2SiO4', 'Fe'], dict(fsed=2.0), {}),
    'virtual': (['Mg2SiO4'], dict(fsed=2.0), dict(t0=1600.0)),
    'exp_fsed': (['Mg2SiO4', 'Fe'], dict(fsed=3.0, param='exp', b=2.0,
                                         eps=0.05), {}),
}


@pytest.mark.parametrize('case', list(CASES))
def test_compute(case):
    condensates, kw, col_kw = CASES[case]
    ja, ta = both(condensates, column(**col_kw),
                  alpha_pressure=0.1 if case == 'exp_fsed' else None, **kw)
    opts = dict(solver='analytic') if case == 'analytic' else dict(
        do_virtual=(case == 'virtual'))
    ref = jv.compute(ja, **opts)
    got = tv.compute(ta, **opts)
    assert_same(got, ref)
    assert got['opd_per_layer'].max() > 0
    df = tv.picaso_format(got['opd_per_layer'], got['single_scattering'],
                          got['asymmetry'], pressure=got['pressure'],
                          wavenumber=1e4 / got['wave'])
    jdf = jv.picaso_format(ref['opd_per_layer'], ref['single_scattering'],
                           ref['asymmetry'], pressure=ref['pressure'],
                           wavenumber=1e4 / ref['wave'])
    assert list(df) == list(jdf.columns)
    for k in jdf.columns:
        assert_same(df[k], jdf[k].values)


def write_mieff(path, nw=9, nr=12):
    wave = np.linspace(0.4, 8.0, nw)
    radii = np.logspace(-6, -3, nr)
    rng = np.random.default_rng(18)
    lines = [f'{nw} {nr}']
    for r in radii:
        lines.append(f'{r:.6e}')
        for w in wave:
            qs, qe = rng.uniform(0.5, 1.5), rng.uniform(1.5, 2.5)
            lines.append(f'{w:.4f} {qs:.5f} {qe:.5f} {0.6 * qs:.5f}')
    path.write_text('\n'.join(lines))


def test_mieff_round_trip(tmp_path):
    write_mieff(tmp_path / 'Mg2SiO4.mieff')
    fn = str(tmp_path / 'Mg2SiO4.mieff')
    assert_same(tv.load_mieff(fn), jv.load_mieff(fn))
    ja, ta = both(['Mg2SiO4', 'Fe'], column(), fsed=2.0)
    got = tv.compute(ta, directory=str(tmp_path))
    assert got['opd_per_layer'].shape[1] == 9
    assert_same(got, jv.compute(ja, directory=str(tmp_path)))
    mie = tv.load_mieff(fn)
    dist = np.exp(-(np.log10(mie['radii']) + 4.5) ** 2)
    args = (mie['wave_um'], 3e6, mie['radii'], dist, mie['qext'],
            mie['qscat'], mie['cos_qscat'])
    for g, r in zip(tv.calc_optics_user_r_dist(*args),
                    jv.calc_optics_user_r_dist(*args)):
        assert_same(g, r)


def facade_cases(module, frame, col):
    case = module.inputs(calculation='browndwarf')
    case.gravity(gravity=100.0, gravity_unit=module.u.Unit('m/(s**2)'))
    prof = dict(col, H2=np.zeros(len(col['pressure'])) + 0.84,
                He=np.zeros(len(col['pressure'])) + 0.16,
                H2O=np.zeros(len(col['pressure'])) + 4e-4)
    case.atmosphere(df=frame(prof))
    return case


def test_inputs_virga_and_a_cloudy_spectrum():
    col = column(nlevel=31)
    ref_case = facade_cases(jdi, pd.DataFrame, col)
    case = facade_cases(tdi, dict, col)
    kw = dict(fsed=2.0, mh=1.0, mmw=2.2)
    jdf = ref_case.virga(['Mg2SiO4', 'Fe'], **kw)
    df = case.virga(['Mg2SiO4', 'Fe'], **kw)
    assert list(df) == list(jdf.columns)
    for k in jdf.columns:
        assert_same(df[k], jdf[k].values)
    jc, tc = (c.inputs['clouds'] for c in (ref_case, case))
    assert_same(tc['wavenumber'], np.asarray(jc['wavenumber']))
    for k in ('opd', 'g0', 'w0', 'pressure', 'wavenumber'):
        assert_same(np.asarray(tc['profile'][k]),
                    jc['profile'][k].values)
    out = case.virga(['Mg2SiO4'], fsed=1.0, full_output=True)
    assert 'condensibles' in out
    # a thermal spectrum through the attached cloud, on an analytic grid
    case.virga(['Mg2SiO4', 'Fe'], **kw)
    opa = tdi.opannection(wno_grid=np.linspace(1000.0, 8000.0, 60),
                          device='cpu')
    spec = case.spectrum(opa, calculation='thermal')
    assert np.isfinite(np.asarray(spec['thermal'])).all()


def test_virga_3d():
    nlevel, nlon, nlat = 25, 3, 2
    pressure = np.logspace(-4, 2, nlevel)
    base_t = 1800.0 * (pressure / pressure[-1]) ** 0.1
    temp = np.zeros((nlevel, nlon, nlat))
    for g in range(nlon):
        for t in range(nlat):
            temp[:, g, t] = base_t * (1 + 0.05 * g - 0.02 * t)
    gcm = {'lat': np.array([-30.0, 30.0]), 'lon': np.array([-60.0, 0.0,
                                                           60.0]),
           'pressure': pressure, 'temperature': temp,
           'kz': np.zeros((nlevel, nlon, nlat)) + 1e9,
           'H2': np.zeros((nlevel, nlon, nlat)) + 0.84,
           'He': np.zeros((nlevel, nlon, nlat)) + 0.16}
    out = []
    for module in (jdi, tdi):
        case = module.inputs()
        case.phase_angle(0, num_gangle=2, num_tangle=2)
        case.gravity(gravity=25, gravity_unit=module.u.Unit('m/(s**2)'))
        case.atmosphere_3d(dict(gcm))
        full = case.virga_3d(['Mg2SiO4', 'Fe'], fsed=1.0, full_output=True)
        assert len(full) == nlon * nlat
        out.append(case.inputs['clouds'])
    ref, got = out
    assert got['profile']['opd'].shape == (nlevel - 1, 196, nlon, nlat)
    assert got['profile']['opd'].max() > 0
    assert_same(got['wavenumber'], np.asarray(ref['wavenumber']))
    for k in ('opd', 'w0', 'g0', 'lat', 'lon', 'pressure'):
        assert_same(got['profile'][k], np.asarray(ref['profile'][k]))
    case = tdi.inputs()
    case.atmosphere_3d({k: v for k, v in gcm.items() if k != 'kz'})
    with pytest.raises(ValueError, match="'kz'"):
        case.virga_3d(['Fe'])
