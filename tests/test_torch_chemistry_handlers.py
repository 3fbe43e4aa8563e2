"""The port's equilibrium-chemistry handlers (picaso_tpu_torch.justdoit)
against the JAX package's: chemeq_visscher_1060, channon_grid_low,
premix_atmosphere on a CK connection, atmosphere(chem_method=...),
chemeq_3d and premix_3d on tests/torch_facade_cases.py's GCM map, and
Parameterize.chem_visscher, at the chemistry tolerance of
tests/test_torch_climate_inputs.py (rtol 1e-12); the unported handlers
raise."""

import numpy as np
import pandas as pd
import pytest

from picaso_tpu import justdoit as jdi
from picaso_tpu import parameterizations as jpar
from picaso_tpu.opacities import ck as jck
from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import parameterizations as tpar
from picaso_tpu_torch.opacities import ck as tck

import torch_facade_cases as fc

RTOL = 1e-12


def assert_profile(port, ref):
    """The port's dict of columns against the JAX DataFrame (or dict):
    the same columns in the same order, each within RTOL."""
    names = list(ref.columns) if isinstance(ref, pd.DataFrame) else list(ref)
    assert list(port) == names
    for k in names:
        np.testing.assert_allclose(np.asarray(port[k], float),
                                   np.asarray(ref[k], float), rtol=RTOL,
                                   atol=0, err_msg=k)


def pt_cases(prof=None):
    """(JAX inputs, port inputs) holding the same 1D (P, T) profile."""
    prof = prof or fc.profile(30)
    a = jdi.inputs()
    a.atmosphere(df=pd.DataFrame({k: prof[k]
                                  for k in ('pressure', 'temperature')}))
    b = tdi.inputs()
    b.atmosphere(df={k: prof[k] for k in ('pressure', 'temperature')})
    return a, b


@pytest.mark.parametrize('cto,log_mh', [(1.0, 0.0), (0.5, 1.0)])
def test_chemeq_visscher_1060(cto, log_mh):
    a, b = pt_cases()
    a.chemeq_visscher_1060(cto, log_mh)
    b.chemeq_visscher_1060(cto, log_mh, device='cpu')
    assert_profile(b.inputs['atmosphere']['profile'],
                   a.inputs['atmosphere']['profile'])


def test_channon_grid_low():
    a, b = pt_cases()
    a.channon_grid_low()
    b.channon_grid_low(device='cpu')
    assert_profile(b.inputs['atmosphere']['profile'],
                   a.inputs['atmosphere']['profile'])


@pytest.mark.parametrize('method', ['visscher', '1060'])
def test_atmosphere_chem_method(method):
    prof = fc.profile(25)
    kw = dict(chem_method=method, mh=3.0, cto_relative=1.5)
    a = jdi.inputs()
    a.atmosphere(df=pd.DataFrame(prof), **kw)
    b = tdi.inputs()
    b.atmosphere(df=prof, device='cpu', **kw)
    assert b.inputs['atmosphere']['mh'] == 3.0
    assert_profile(b.inputs['atmosphere']['profile'],
                   a.inputs['atmosphere']['profile'])


def test_chemistry_handler_records_method_without_a_profile():
    b = tdi.inputs()
    b.chemistry_handler('visscher', device='cpu')
    assert b.inputs['approx']['chem_params']['chem_method'] == 'visscher'
    a, b = pt_cases()
    with pytest.raises(ValueError, match='unknown chem_method'):
        b.chemistry_handler('nonsense', device='cpu')


@pytest.fixture(scope='module')
def ck_connections():
    jt = jck.synthetic_ck_table(dtype=np.float64)
    tt = tck.synthetic_ck_table(device='cpu')
    return jdi.opannection(ck_table=jt), tdi.opannection(ck_table=tt,
                                                         device='cpu')


def test_premix_atmosphere(ck_connections):
    jopa, topa = ck_connections
    a, b = pt_cases()
    ref = a.premix_atmosphere(jopa)
    port = b.premix_atmosphere(topa)
    assert_profile(port, ref)
    assert_profile(b.inputs['atmosphere']['profile'], ref)
    with pytest.raises(ValueError, match='CK connection'):
        b.premix_atmosphere(tdi.opannection(wno_grid=np.linspace(
            1000, 2000, 10), device='cpu'))


def test_add_pt():
    prof = fc.profile(20)
    a, b = jdi.inputs(), tdi.inputs()
    a.add_pt(prof['temperature'], prof['pressure'])
    b.add_pt(prof['temperature'], prof['pressure'])
    assert_profile(b.inputs['atmosphere']['profile'],
                   a.inputs['atmosphere']['profile'])
    a.add_pt(prof['temperature'] + 10, prof['pressure'])
    b.add_pt(prof['temperature'] + 10, prof['pressure'])
    assert_profile(b.inputs['atmosphere']['profile'],
                   a.inputs['atmosphere']['profile'])
    assert b.nlevel == 20


def gcm_cases():
    data = fc.gcm(nlevel=15, nlon=6, nlat=4)
    a, b = jdi.inputs(), tdi.inputs()
    a.atmosphere_3d(dict(data))
    b.atmosphere_3d(dict(data))
    return a, b


def test_chemeq_3d():
    a, b = gcm_cases()
    ref = a.chemeq_3d(c_o=1.0, log_mh=0.5)
    port = b.chemeq_3d(c_o=1.0, log_mh=0.5, device='cpu')
    assert_profile(port, ref)
    a, b = gcm_cases()
    assert_profile(b.chemeq_3d(cto_absolute=0.6, device='cpu'),
                   a.chemeq_3d(cto_absolute=0.6))


def test_premix_3d(ck_connections):
    jopa, topa = ck_connections
    a, b = gcm_cases()
    assert_profile(b.premix_3d(topa), a.premix_3d(jopa))
    c = tdi.inputs()
    c.atmosphere(df=fc.profile(10))
    with pytest.raises(ValueError, match='3D GCM'):
        c.premix_3d(topa)


def test_parameterize_chem_visscher():
    out = []
    for module, par_mod, df in ((jdi, jpar, pd.DataFrame),
                                (tdi, tpar, dict)):
        prof = fc.profile(30)
        case = module.inputs()
        case.atmosphere(df=df(prof))
        par = par_mod.Parameterize()
        par.add_class(case)
        kw = {} if module is jdi else dict(device='cpu')
        out.append(par.chem_visscher(1.0, 0.3, **kw))
    assert_profile(out[1], out[0])


def test_unported_handlers_raise(monkeypatch):
    monkeypatch.delenv('picaso_refdata', raising=False)
    monkeypatch.delenv('picaso_tpu_refdata', raising=False)
    a, b = pt_cases()
    with pytest.raises(FileNotFoundError):
        a.chemeq_visscher_2121(0.458, 0.0)
    with pytest.raises(FileNotFoundError):
        b.chemeq_visscher_2121(0.458, 0.0, device='cpu')
    for call in (lambda: b.sonora('.', 1000), lambda: b.sonora_profile(
            '.', 1000)):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            call()
    # photochemistry is ported: without a kinetics object it raises the
    # JAX package's error
    for case in (a, b):
        with pytest.raises(ValueError, match='photochem_init'):
            case.premix_atmosphere_photochem()
    # find_kzz (ported): none, the profile's kz column, a constant, the
    # self-consistent one first, an int placeholder skipped
    assert a.find_kzz() is None and b.find_kzz() is None
    kz = np.logspace(8, 10, 30)
    for case in (a, b):
        case.inputs['atmosphere']['profile']['kz'] = kz
    np.testing.assert_array_equal(b.find_kzz(), a.find_kzz())
    for store in ({'constant_kzz': kz * 2}, {'sc_kzz': kz * 3,
                                             'constant_kzz': kz * 2},
                  {'sc_kzz': 0, 'constant_kzz': kz * 4}):
        for case in (a, b):
            case.inputs['atmosphere']['kzz'] = dict(store)
        np.testing.assert_array_equal(b.find_kzz(), a.find_kzz())
