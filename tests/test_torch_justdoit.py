"""The port's front door (picaso_tpu_torch.justdoit) against the JAX
package's (picaso_tpu.justdoit), 1D spectra, on the CPU in float64.

The same calls -- opannection, inputs, phase_angle, gravity, star,
atmosphere, clouds, approx, spectrum -- go through both packages on the
synthetic database of tests/test_three_d.py (tests/torch_facade_cases.py).
The port runs its kernels' twins (K1 for the molecular opacity, K5 and K6
for the Toon solves) where the JAX facade runs its scan path: outputs
agree to rtol 2e-5, transit depths to 1e-8, the host-side numpy (units,
the star's binning, the profile tables) to 1e-12.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from picaso_tpu import justdoit as jdi
from picaso_tpu import units as junits
from picaso_tpu.opacities import ck as jck

from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import units as tunits
from picaso_tpu_torch.opacities import ck as tck
from picaso_tpu_torch.opacities import cuda_interp
from picaso_tpu_torch.rt import cuda_toon

from torch_facade_cases import (assert_same, connections, egp_clouds,
                                planet, profile, synthetic_db)

torch.set_num_threads(1)

CALC = 'reflected+thermal+transmission'


@pytest.fixture(scope='module')
def opas(tmp_path_factory):
    return connections(synthetic_db(tmp_path_factory))


def _spectrum(module, opa, calculation=CALC, full_output=False, clouds='egp',
              star=True, nostar=False, surface=None, exclude_mol=None,
              do_holes=False, **approx):
    case = module.inputs(calculation='browndwarf' if nostar else 'planet')
    case.approx(**approx)    # before star(): Oklopcic Raman bins the star
    planet(case, module, opa, star=star and not nostar)
    prof = profile()
    case.atmosphere(df=pd.DataFrame(prof), exclude_mol=exclude_mol)
    nlayer = len(prof['pressure']) - 1
    holes = dict(do_holes=True, fhole=0.3, fthin_cld=0.2) if do_holes else {}
    if clouds == 'egp':
        case.clouds(df=pd.DataFrame(egp_clouds(nlayer)), **holes)
    elif clouds == 'box':
        case.clouds(g0=[0.8, 0.7], w0=[0.9, 0.95], opd=[0.5, 0.2],
                    p=[0.0, -2.0], dp=[2.0, 1.0], **holes)
    if surface is not None:
        case.surface_reflect(surface, opa.wno)
    return case.spectrum(opa, calculation=calculation,
                         full_output=full_output)


@pytest.mark.parametrize('calculation', ['reflected', 'thermal',
                                         'transmission', CALC])
def test_spectrum_matches_jax(opas, calculation):
    jopa, topa = opas
    assert_same(_spectrum(tdi, topa, calculation),
                _spectrum(jdi, jopa, calculation))


def test_full_output_matches_jax(opas):
    jopa, topa = opas
    out = _spectrum(tdi, topa, full_output=True)
    ref = _spectrum(jdi, jopa, full_output=True)
    assert set(out['full_output']) >= {'taugas', 'tauray', 'taucld',
                                       'xint_at_top', 'flux_at_top'}
    assert_same(out, ref)


@pytest.mark.parametrize('approx', [
    dict(multi_phase='isotropic'), dict(multi_phase='N=1'),
    dict(single_phase='cahoy', toon_coefficients='eddington'),
    dict(delta_eddington=False, single_phase='OTHG')],
    ids=['isotropic', 'N=1', 'cahoy-eddington', 'OTHG-no-dedd'])
def test_toon_options_match_jax(opas, approx):
    jopa, topa = opas
    assert_same(_spectrum(tdi, topa, **approx),
                _spectrum(jdi, jopa, **approx))


@pytest.mark.parametrize('stream', [2, 4])
def test_sh_matches_jax(opas, stream):
    """SH from RTProps: plain torch in the port, XLA in the JAX package."""
    jopa, topa = opas
    kw = dict(calculation='reflected+thermal', rt_method='SH', stream=stream)
    assert_same(_spectrum(tdi, topa, **kw), _spectrum(jdi, jopa, **kw))


@pytest.mark.parametrize('raman', ['oklopcic', 'pollack', 'none'])
def test_raman_matches_jax(opas, raman):
    jopa, topa = opas
    kw = dict(calculation='reflected', raman=raman)
    assert_same(_spectrum(tdi, topa, **kw), _spectrum(jdi, jopa, **kw))


@pytest.mark.parametrize('option', ['do_holes', 'exclude_mol', 'surface',
                                    'box_clouds', 'clear', 'nostar'])
def test_scene_options_match_jax(opas, option):
    jopa, topa = opas
    kw = {'do_holes': dict(do_holes=True),
          'exclude_mol': dict(exclude_mol='H2O'),
          'surface': dict(surface=0.3),
          'box_clouds': dict(clouds='box', do_holes=True),
          'clear': dict(clouds=None, full_output=True),
          'nostar': dict(nostar=True)}[option]
    assert_same(_spectrum(tdi, topa, **kw), _spectrum(jdi, jopa, **kw))


def test_level_fluxes_match_jax(opas):
    """get_lvl_flux: the level fluxes (plain torch in the port) and the
    spectra with the bin-integrated Planck function the JAX facade uses
    then."""
    jopa, topa = opas
    kw = dict(calculation='reflected+thermal', full_output=True,
              get_lvl_flux=True)
    out = _spectrum(tdi, topa, **kw)
    assert {'lvl_output_reflected', 'lvl_output_thermal'} <= set(
        out['full_output'])
    assert_same(out, _spectrum(jdi, jopa, **kw))


def test_ck_connection_matches_jax():
    """A premixed CK table: 8 gauss points, each its own K5 and K6 launch
    (the twins here), against the JAX facade's gauss loop."""
    jopa = jdi.opannection(ck_table=jck.synthetic_ck_table(dtype=np.float64))
    topa = tdi.opannection(ck_table=tck.synthetic_ck_table(device='cpu'),
                           device='cpu')
    assert topa.ngauss == jopa.ngauss == 8
    kw = dict(calculation='reflected+thermal', clouds=None)
    assert_same(_spectrum(tdi, topa, **kw), _spectrum(jdi, jopa, **kw))


def test_query_nearest_matches_jax(tmp_path_factory):
    jopa, topa = connections(synthetic_db(tmp_path_factory),
                             query_method='nearest')
    kw = dict(calculation='thermal')
    assert_same(_spectrum(tdi, topa, **kw), _spectrum(jdi, jopa, **kw))


def test_host_side_matches_jax(opas, tmp_path):
    """units, the star's binning, the base-case tables and the profile
    and cloud tables read from files with numpy (rtol 1e-12)."""
    for name in ('Mjup', 'Rjup', 'AU', 'm/(s**2)', 'bar', 'Rsun'):
        assert tunits.Unit(name).cgs_factor == junits.Unit(name).cgs_factor
    assert tunits.to_cgs(2.5, 'km') == junits.to_cgs(2.5, 'km')
    jopa, topa = opas
    for module, opa in ((jdi, jopa), (tdi, topa)):
        planet(module.inputs(), module, opa)
    np.testing.assert_allclose(topa.relative_flux, jopa.relative_flux,
                               rtol=1e-12)
    np.testing.assert_allclose(topa.unshifted_stellar_spec,
                               jopa.unshifted_stellar_spec, rtol=1e-12)
    for name in ('jupiter_pt', 'jupiter_cld', 'HJ_pt', 'HJ_cld',
                 'brown_dwarf_pt', 'brown_dwarf_cld'):
        assert getattr(tdi, name)() == getattr(jdi, name)()
    jcase, tcase = jdi.inputs(), tdi.inputs()
    jcase.atmosphere(filename=jdi.jupiter_pt(), sep=r'\s+')
    tcase.atmosphere(filename=tdi.jupiter_pt(), sep=r'\s+')
    jcase.clouds(filename=jdi.jupiter_cld(), sep=r'\s+')
    tcase.clouds(filename=tdi.jupiter_cld(), sep=r'\s+')
    for key in ('atmosphere', 'clouds'):
        want = jcase.inputs[key]['profile']
        got = tcase.inputs[key]['profile']
        assert list(got) == list(want.keys())
        for col in want:
            np.testing.assert_allclose(got[col], want[col].values,
                                       rtol=1e-12)
    np.testing.assert_array_equal(tcase.inputs['clouds']['wavenumber'],
                                  jcase.inputs['clouds']['wavenumber'])
    with pytest.raises(ValueError, match='sep'):
        tcase.atmosphere(filename=tdi.jupiter_pt(), sep=',')


def test_facade_routes_through_the_kernel_wrappers(opas, monkeypatch):
    """The facade's spectrum goes through the kernels' wrappers (one K1
    per _gas_optics call, one K5 and one K6 per gauss point), so on the
    card the kernels run; on CPU tensors the wrappers run their twins and
    count no launch."""
    _, topa = opas
    calls = {}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper
    k5 = cuda_toon.reflected_toon_props
    before = k5.launches
    monkeypatch.setattr(tdi, 'interp_tau',
                        counted('interp_tau', cuda_interp.interp_tau))
    for name in ('reflected_toon_props', 'thermal_toon_props'):
        monkeypatch.setattr(cuda_toon, name,
                            counted(name, getattr(cuda_toon, name)))
    out = _spectrum(tdi, topa, calculation='reflected+thermal')
    assert calls == {'interp_tau': 1, 'reflected_toon_props': 1,
                     'thermal_toon_props': 1}
    assert np.isfinite(out['albedo']).all()
    assert k5.launches == before


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdi.opannection(wno_grid=np.linspace(1000.0, 5000.0, 50))
    opa = tdi.opannection(wno_grid=np.linspace(1000.0, 5000.0, 50),
                          device='cpu')
    assert opa.device.type == 'cpu' and opa.dtype == torch.float64


@pytest.fixture()
def cdbs(tmp_path):
    """A synthetic CDBS tree (tests/test_stellar.py's writer): PHOENIX at
    [Fe/H] 0 and -0.5, Teff 5000/5200, log g 4.0/4.5, a spectral slope."""
    from test_stellar import write_bintable_fits
    wave = np.linspace(3000.0, 30000.0, 200)
    for sub, fac in (('phoenixm00', 1.0), ('phoenixm05', 3.0)):
        base = tmp_path / 'grid' / 'phoenix' / sub
        base.mkdir(parents=True)
        for teff, scale in ((5000, 1.0), (5200, 2.0)):
            write_bintable_fits(
                str(base / f'{sub}_{teff}.fits'),
                {'WAVELENGTH': wave,
                 'g40': fac * scale * (wave / 1e4) ** -2,
                 'g45': fac * scale * 2.0 * (wave / 1e4) ** -1})
    return str(tmp_path)


def test_stellar_grids_match_jax(opas, cdbs, monkeypatch):
    """fits_lite and stellar (numpy copies) give the JAX package's numbers
    exactly, and star(database='phoenix') bins them as the JAX facade does
    (rtol 1e-12)."""
    from picaso_tpu import fits_lite as jfits
    from picaso_tpu import stellar as jstellar
    from picaso_tpu_torch import fits_lite as tfits
    from picaso_tpu_torch import stellar as tstellar
    path = f'{cdbs}/grid/phoenix/phoenixm00/phoenixm00_5000.fits'
    for (jh, jd), (th, td) in zip(jfits.read_fits(path),
                                  tfits.read_fits(path)):
        assert jh == th
        if jd is not None:
            for key in jd:
                np.testing.assert_array_equal(td[key], jd[key])
    for args in ((5100, -0.2, 4.25), (5000, 0.0, 4.0), (5300, -3.0, 9.0)):
        for want, got in zip(
                jstellar.get_stellar_spectrum('phoenix', *args, cdbs=cdbs),
                tstellar.get_stellar_spectrum('phoenix', *args, cdbs=cdbs)):
            np.testing.assert_array_equal(got, want)
    monkeypatch.setenv('PYSYN_CDBS', cdbs)
    jopa, topa = opas
    for module, opa in ((jdi, jopa), (tdi, topa)):
        module.inputs().star(opa, temp=5100, metal=-0.2, logg=4.25,
                             radius=1, radius_unit='R_sun', semi_major=0.05,
                             semi_major_unit='AU', database='phoenix')
    np.testing.assert_allclose(topa.relative_flux, jopa.relative_flux,
                               rtol=1e-12)


@pytest.mark.parametrize('case', ['egp', '661', 'regrid', 'newx', 'R'])
def test_wavelength_matches_jax(case):
    """wavelength.py's numpy copy: the cloud and climate grids, the row
    regrid and the spectral binning (scipy's binned_statistic in the JAX
    package) equal the JAX package's."""
    from picaso_tpu import wavelength as jw
    from picaso_tpu_torch import wavelength as tw
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(500.0, 9000.0, 4000))
    y = rng.normal(size=4000)
    if case == 'egp':
        got, want = tw.get_cld_input_grid(), jw.get_cld_input_grid()
    elif case == '661':
        got, want = (tw.get_cld_input_grid(grid661=True),
                     jw.get_cld_input_grid(grid661=True))
    elif case == 'regrid':
        m = rng.normal(size=(5, 196))
        new = np.linspace(100.0, 30000.0, 333)
        old = jw.get_cld_input_grid()
        got, want = tw.regrid(m, old, new), jw.regrid(m, old, new)
    elif case == 'newx':
        new = np.concatenate([np.linspace(400.0, 3000.0, 90), x[::50]])
        new.sort()
        got, want = (np.concatenate(tw.mean_regrid(x, y, newx=new)),
                     np.concatenate(jw.mean_regrid(x, y, newx=new)))
    else:
        got, want = (np.concatenate(tw.mean_regrid(x, y, R=150)),
                     np.concatenate(jw.mean_regrid(x, y, R=150)))
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize('call', ['resortrebin', 'ck_db', 'chem_method',
                                  'climate'])
def test_unported_parts_raise(call):
    """The front door's parts once left unported, each now ported.
    Photochemistry: ``premix_atmosphere_photochem`` without a kinetics
    object raises the JAX package's ValueError, after the grid chemistry
    ran.  Loading a CK table from ``ck_db`` is ported
    (tests/test_torch_ck_files.py): a missing file raises the loader's
    error, and a per-gas load without ``preload_gases`` a ValueError.  The
    per-gas ('resortrebin') connection and the climate set-up are ported:
    a thermal spectrum through resort-rebin on the per-gas tables (a
    24-bin slice) and ``inputs(climate=True)`` + ``inputs_climate``
    against the JAX facade's."""
    if call == 'resortrebin':
        with pytest.raises(ValueError, match='preload_gases'):
            tdi.opannection(method='resortrebin', device='cpu')
        from test_torch_climate_fluxes import sliced_tables
        from torch_climate_modes_cases import port_table
        js, _ = sliced_tables(8)
        jt = jck.synthetic_ck_table(dtype=np.float64, with_per_gas=True)
        js = jck.CKTable(js.arrays, js.molecules, js.full_abunds,
                         js.gauss_pts, js.temps, js.pressures,
                         per_gas=jt.per_gas[:, :, :, ::8, :],
                         per_gas_molecules=jt.per_gas_molecules,
                         wno=js.wno, delta_wno=js.delta_wno,
                         gauss_wts=js.gauss_wts)
        jopa = jdi.opannection(ck_table=js, method='resortrebin')
        topa = tdi.opannection(ck_table=port_table(js), device='cpu',
                               method='resortrebin')
        with pytest.raises(ValueError, match='per-gas'):
            tdi.opannection(ck_table=tck.synthetic_ck_table(device='cpu'),
                            method='resortrebin', device='cpu')
        kw = dict(calculation='thermal', clouds=None)
        assert_same(_spectrum(tdi, topa, **kw), _spectrum(jdi, jopa, **kw))
        return
    if call == 'climate':
        cases = []
        for module in (jdi, tdi):
            case = module.inputs(calculation='browndwarf', climate=True)
            case.effective_temp(500.0)
            case.gravity(gravity=100.0, gravity_unit=module.u.Unit(
                'm/(s**2)'))
            p = np.logspace(-4, 2, 21)
            case.inputs_climate(temp_guess=np.linspace(300, 900, 21),
                                pressure=p, rcb_guess=15, rfacv=0.0,
                                moistgrad=True)
            case.energy_injection(True, 1e4, 0.3, 1.5)
            cases.append(case)
        ref, got = (c.inputs for c in cases)
        assert got['calculation'] == ref['calculation'] == 'climate'
        assert (got['approx']['rt_params']['common']['raman']
                == ref['approx']['rt_params']['common']['raman'] == 2)
        for key, val in ref['climate'].items():
            np.testing.assert_array_equal(got['climate'][key], val)
        np.testing.assert_array_equal(got['disco'].ubar1,
                                      np.asarray(ref['disco'].ubar1))
        prof = got['atmosphere']['profile']
        np.testing.assert_array_equal(prof['temperature'],
                                      np.linspace(300, 900, 21))
        with pytest.raises(ValueError, match='T_eff'):
            tdi.inputs(climate=True).inputs_climate(
                temp_guess=np.ones(3), pressure=np.ones(3), rcb_guess=1)
        return
    if call == 'ck_db':
        with pytest.raises(OSError):
            tdi.opannection(method='preweighted', ck_db='x', device='cpu')
        return
    # the grid chemistry runs; the kinetics need photochem_init first, in
    # both packages
    case = tdi.inputs()
    case.atmosphere(df=profile(), chem_method='visscher', device='cpu')
    with pytest.raises(ValueError, match='photochem_init'):
        case.premix_atmosphere_photochem()
    jcase = jdi.inputs()
    jcase.atmosphere(df=pd.DataFrame(profile()))
    with pytest.raises(ValueError, match='photochem_init'):
        jcase.premix_atmosphere_photochem()
