"""The port's Parameterize (picaso_tpu_torch.parameterizations) against the
JAX package's: every temperature form, free-chemistry form and grey-cloud
form, picaso_format and cloud_averaging, from the same inputs, rtol 1e-12
(the port's tables are dicts of columns in the DataFrames' order),
and the Mie and virga members."""

import numpy as np
import pandas as pd
import pytest

from picaso_tpu import justdoit as jdi
from picaso_tpu import parameterizations as jpar
from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import parameterizations as tpar

RTOL = 1e-12


def assert_table(port, ref):
    """A dict of columns against a DataFrame (or two arrays)."""
    if isinstance(ref, pd.DataFrame):
        assert list(port) == list(ref.columns)
        for k in ref.columns:
            np.testing.assert_allclose(np.asarray(port[k], float),
                                       np.asarray(ref[k], float), rtol=RTOL,
                                       atol=0, err_msg=k)
    else:
        np.testing.assert_allclose(np.asarray(port, float),
                                   np.asarray(ref, float), rtol=RTOL, atol=0)


PT = {
    'isothermal': ('pt_isothermal', (812.5,), {}),
    'guillot': ('pt_guillot', (1200.0, 150.0, -1.2, -1.6, 0.4),
                dict(gravity_cgs=2140.0)),
    'madhu_seager_noinv': ('pt_madhu_seager_09_noinversion',
                           (0.6, 0.5, 1e-3, 1.0, 1600.0), {}),
    'madhu_seager_noinv_beta': ('pt_madhu_seager_09_noinversion',
                                (0.4, 0.3, 1e-2, 3.0, 1400.0),
                                dict(beta=0.4)),
    'madhu_seager_inv': ('pt_madhu_seager_09_inversion',
                         (0.6, 0.5, 1e-3, 1e-2, 1.0, 1600.0), {}),
    'knots_linear': ('pt_knots', ([1e-4, 1e-1, 1e2], [200, 500, 1500]), {}),
    'knots_brewster': ('pt_knots', ([1e-5, 1e-3, 1e-1, 1e1, 1e2],
                                    [300, 450, 800, 1400, 1900]),
                       dict(interpolation='brewster')),
    'knots_cubic': ('pt_knots', ([1e-5, 1e-3, 1e-1, 1e2],
                                 [300, 450, 800, 1900]),
                    dict(interpolation='cubic')),
    'zj24': ('pt_zj24', ([1e-4, 1e-2, 1e0, 1e2], [100, 200, 300], 2000),
             {}),
}


@pytest.mark.parametrize('name', PT)
def test_temperature_forms(name):
    method, args, kw = PT[name]
    ref = getattr(jpar.Parameterize(nlevel=60), method)(*args, **kw)
    port = getattr(tpar.Parameterize(nlevel=60), method)(*args, **kw)
    assert_table(port, ref)


def test_guillot_gravity_from_the_case():
    cases = []
    for module, par_mod in ((jdi, jpar), (tdi, tpar)):
        case = module.inputs()
        case.gravity(gravity=21.4, gravity_unit=module.u.Unit('m/(s**2)'))
        par = par_mod.Parameterize(nlevel=40)
        par.add_class(case)
        cases.append(par.pt_guillot(1200.0, 150.0, -1.2, -1.6, 0.4))
    assert_table(cases[1], cases[0])


CHEM = {
    'constant': ('chem_free', (), dict(H2O=-3, CH4=-4)),
    'linear_vmr_and_ratio': ('chem_free', (),
                             dict(H2O=2e-3, CO=-3.5, background=('H2', 'He'),
                                  background_ratio=5.667)),
    'vmr_knots': ('vmr_knots', ([1e-5, 1e-2, 1e2], [-6.0, -4.0, -3.0]), {}),
    'vmr_gradient': ('vmr_gradient', (-3.0, -6.0), dict(P_deep=10.0,
                                                        P_top=1e-4)),
}


@pytest.mark.parametrize('name', CHEM)
def test_free_chemistry_forms(name):
    method, args, kw = CHEM[name]
    ref = getattr(jpar.Parameterize(nlevel=40), method)(*args, **kw)
    port = getattr(tpar.Parameterize(nlevel=40), method)(*args, **kw)
    assert_table(port, ref)


def test_chem_free_profile_column():
    """A per-level vmr array and a temperature column pass through."""
    p = jpar.Parameterize(nlevel=30).pressure
    kw = dict(H2O=np.linspace(1e-4, 1e-3, 30), temperature=p * 0 + 900.0)
    assert_table(tpar.Parameterize(nlevel=30).chem_free(**kw),
                 jpar.Parameterize(nlevel=30).chem_free(**kw))


CLOUDS = {
    'deck_decay': ('deck_decay', (1.0,), dict(dp=0.3, opd_max=5.0, w0=0.9,
                                             g0=0.3)),
    'slab_decay': ('slab_decay', (0.01, 1.0, 5.0), dict(alpha=2.0,
                                                        reference_wave=1.5)),
    'brewster_grey_deck': ('cloud_brewster_grey', ('deck', 0.0, 0.95, 0.5),
                           dict(dp=0.2, reference_tau=3.0)),
    'brewster_grey_slab': ('cloud_brewster_grey', ('slab', 1.5, 0.9, 0.01),
                           dict(dp=1.0, reference_tau=2.0,
                                reference_wave=2.0, g0=0.4)),
}


@pytest.mark.parametrize('name', CLOUDS)
def test_grey_cloud_forms(name):
    method, args, kw = CLOUDS[name]
    ref = getattr(jpar.Parameterize(nlevel=40), method)(*args, **kw)
    port = getattr(tpar.Parameterize(nlevel=40), method)(*args, **kw)
    assert_table(port, ref)


def test_cloud_hard_grey_through_the_case():
    out = []
    for module, par_mod, df in ((jdi, jpar, pd.DataFrame), (tdi, tpar, dict)):
        par = par_mod.Parameterize(nlevel=35)
        case = module.inputs()
        case.atmosphere(df=df({'pressure': par.pressure,
                               'temperature': par.pressure * 0 + 800.0,
                               'H2': par.pressure * 0 + 0.85,
                               'He': par.pressure * 0 + 0.15}))
        par.add_class(case)
        out.append(par.cloud_hard_grey(0.2, 0.8, 4.0, 0.5, 1.5))
    assert list(out[1]) == ['g0', 'w0', 'opd']
    for k in ('g0', 'w0', 'opd'):
        np.testing.assert_allclose(out[1][k], np.asarray(out[0][k]),
                                   rtol=RTOL, atol=0)


def test_picaso_format_and_cloud_averaging():
    rng = np.random.default_rng(3)
    nl, nw = 12, 20
    play = np.logspace(-4, 2, nl)
    wno = np.linspace(500.0, 9000.0, nw)
    opd, w0, g0 = rng.random(nw), rng.random(nw), rng.random(nw)
    kwargs = [dict(p_decay=np.exp(-np.arange(nl) / 3.0)),
              dict(opd_profile=rng.random(nl)),
              dict(p_top=1e-2, p_bottom=1.0)]
    tables = []
    for kw in kwargs:
        ref = jpar.picaso_format(opd, w0, g0, wno, play, **kw)
        port = tpar.picaso_format(opd, w0, g0, wno, play, **kw)
        assert_table(port, ref)
        tables.append((port, ref))
    two_d = rng.random((nl, nw))
    assert_table(tpar.picaso_format(two_d, two_d * 0.5, two_d * 0.1),
                 jpar.picaso_format(two_d, two_d * 0.5, two_d * 0.1))
    ports, refs = zip(*tables)
    for weights in (None, [0.2, 0.3, 0.5]):
        assert_table(tpar.cloud_averaging(list(ports), weights),
                     jpar.cloud_averaging(list(refs), weights))
    with pytest.raises(ValueError):
        tpar.picaso_format(opd, w0, g0, wno)


def test_add_class_adopts_the_profile_grid():
    p = np.logspace(-5, 2, 27)
    case = tdi.inputs()
    case.atmosphere(df={'pressure': p, 'temperature': p * 0 + 700.0})
    par = tpar.Parameterize()
    par.add_class(case)
    assert par.nlevel == 27 and par.pressure is not None


@pytest.mark.parametrize('member', ['get_particle_dist', 'cloud_flex_fsed',
                                    'cloud_brewster_mie', 'cloud_virga'])
def test_mie_and_virga_members_raise(member, tmp_path):
    """The Mie and virga members (ported with virga.py) against the JAX
    module's, rtol 1e-12: the Mie tables of ``load_cld_optical`` from a
    .mieff file written to ``tmp_path``, both particle distributions, the
    slab and deck forms, and virga through the case (scalar kzz).  A
    missing table still raises."""
    from test_torch_virga import write_mieff
    write_mieff(tmp_path / 'MgSiO3.mieff')
    pars = [mod.Parameterize(nlevel=20, load_cld_optical='MgSiO3',
                             mieff_dir=str(tmp_path))
            for mod in (jpar, tpar)]
    with pytest.raises(FileNotFoundError):
        tpar.Parameterize(load_cld_optical='Fe', mieff_dir=str(tmp_path))
    with pytest.raises(ValueError, match='mieff_dir'):
        tpar.Parameterize(load_cld_optical='Fe')
    logn = dict(sigma=0.3, lograd=-4.5)
    hansen = dict(lograd=-4.2, b=0.2)
    if member == 'get_particle_dist':
        for dist, kw in (('lognorm', dict(lognorm_kwargs=logn)),
                         ('hansen', dict(hansen_kwargs=hansen))):
            got, ref = (par.get_particle_dist('MgSiO3', dist, **kw)
                        for par in pars[::-1])
            assert_table(got, ref)
    elif member == 'cloud_flex_fsed':
        for dist, kw in (('lognorm', dict(lognorm_kwargs=logn)),
                         ('hansen', dict(hansen_kwargs=hansen))):
            got, ref = (par.cloud_flex_fsed('MgSiO3', 0.3, 2e5, 1.5, dist,
                                            **kw) for par in pars[::-1])
            assert_table(got, ref)
    elif member == 'cloud_brewster_mie':
        for decay, kw in (('slab', dict(slab_kwargs=dict(
                ptop=0.01, dp=0.5, reference_tau=2.0))),
                          ('deck', dict(deck_kwargs=dict(ptop=0.1,
                                                         dp=0.3)))):
            got, ref = (par.cloud_brewster_mie('MgSiO3', 'lognorm', decay,
                                               lognorm_kwargs=logn, **kw)
                        for par in pars[::-1])
            assert_table(got, ref)
    else:
        p = np.logspace(-4, 2, 20)
        prof = {'pressure': p, 'temperature': 1900.0 * (p / 100.0) ** 0.1,
                'H2': p * 0 + 0.84, 'He': p * 0 + 0.16}
        out = []
        for mod, jd, par, frame in ((jpar, jdi, pars[0], pd.DataFrame),
                                    (tpar, tdi, pars[1], dict)):
            case = jd.inputs()
            case.gravity(gravity=1e4, gravity_unit=jd.u.Unit('cm/(s**2)'))
            case.atmosphere(df=frame(prof))
            par.add_class(case)
            out.append(par.cloud_virga(condensates=['MgSiO3', 'Fe'],
                                       fsed=2.0, kzz=1e9))
        assert_table(out[1], out[0])
