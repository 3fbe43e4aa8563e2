"""The port's host Newton solver ``climate.core.t_start`` against the JAX
package's, in float64 on the CPU.

The same profile (31 levels, the synthetic CK table in float64, one
convective zone) goes through ``ck_rtprops`` and ``t_start`` in both
packages:
- the JAX ``test_t_start_keeps_visible_flux_in_residual`` case (strong
  irradiation, rfacv 0.5: the visible fluxes enter the residual);
- a non-irradiated brown dwarf (rfacv 0).

Gates: max |dT| <= 1e-8 K, the same Newton steps (the JAX result's
``len(profiles)`` with ``save_profiles``) and the same ``converged``; the
returned fluxes within rtol 1e-8 of their scale.  ``_ClimateState.
opacities`` gives the port's solve its props in the second case.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from picaso_tpu.climate import core as jcore
from picaso_tpu.climate.adiabat import load_adiabat_grid as j_adiabat
from picaso_tpu.climate.api import ck_rtprops as j_rtprops
from picaso_tpu.opacities.ck import synthetic_ck_table as j_ck
from picaso_tpu.rt import toon as jtoon

from picaso_tpu_torch.climate import api as tapi
from picaso_tpu_torch.climate import core as tcore
from picaso_tpu_torch.climate.adiabat import load_adiabat_grid as t_adiabat
from picaso_tpu_torch.opacities.ck import synthetic_ck_table as t_ck
from picaso_tpu_torch.rt import toon as ttoon

torch.set_num_threads(1)

NLEVEL = 31
DT_MAX = 1e-8


@pytest.fixture(scope='module')
def tables():
    return j_ck(dtype=np.float64), t_ck(device='cpu')


def profile(nlevel):
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    prof = dict(pressure=pressure, temperature=guess)
    for sp, v in (('H2', 0.837), ('He', 0.155), ('H2O', 1e-3),
                  ('CH4', 3e-4)):
        prof[sp] = np.full(nlevel, v)
    return prof


def solve_both(tables, rfacv, F0PI, teff, port_props=None):
    jck, tck = tables
    prof = profile(NLEVEL)
    pressure, guess = prof['pressure'], prof['temperature']
    nstr = [0, NLEVEL - 8, NLEVEL - 2, 0, 0, 0]
    tidal = jcore.tidal_flux(teff, NLEVEL)
    jprops, _ = j_rtprops(pd.DataFrame(prof), jck, gravity=1e4,
                          dtype=np.float64)
    args = (np.asarray(jck.wno), np.asarray(jck.arrays.delta_wno),
            np.asarray(jck.arrays.gauss_wts), 0.0, F0PI)
    ref = jcore.t_start(
        guess, pressure * 1e6, nstr, 1, jprops, jcore.make_climate_geometry(),
        *args, jtoon.ScatteringControls(), j_adiabat(), 1.0, rfacv,
        np.asarray(tidal), 50.0, 10000.0, it_max=10, save_profiles=True)
    if port_props is None:
        port_props, _ = tapi.ck_rtprops(prof, tck, gravity=1e4)
    geom = tcore.make_climate_geometry(torch.device('cpu'), torch.float64)
    out = tcore.t_start(
        guess, pressure * 1e6, nstr, 1, port_props, geom, *args,
        ttoon.ScatteringControls(), t_adiabat('cpu', torch.float64), 1.0,
        rfacv, tcore.tidal_flux(teff, NLEVEL), 50.0, 10000.0, it_max=10,
        save_profiles=True)
    return ref, out, tidal


def check_same(ref, out):
    assert out.converged == ref.converged
    assert out.iterations == len(ref.profiles)
    assert len(out.profiles) == len(ref.profiles)
    assert np.abs(out.temp - np.asarray(ref.temp)).max() <= DT_MAX
    for key in ('flux_net_ir', 'flux_net_v', 'flux_plus_ir_top', 'dtdp'):
        r = np.asarray(getattr(ref, key))
        scale = max(np.abs(r).max(), 1e-300)
        np.testing.assert_allclose(getattr(out, key), r, rtol=1e-8,
                                   atol=1e-8 * scale)


def test_t_start_irradiated_matches_jax(tables):
    """The JAX test_t_start_keeps_visible_flux_in_residual case."""
    nwno = len(tables[0].wno)
    ref, out, tidal = solve_both(tables, 0.5, np.zeros(nwno) + 1e5, 700.0)
    check_same(ref, out)
    # the visible term balances the column, as the JAX test asserts
    balance = (out.flux_net_ir + 0.5 * out.flux_net_v + tidal)
    assert np.max(np.abs(balance[:NLEVEL - 8])) / abs(tidal[0]) < 5e-3
    assert np.max(np.abs(0.5 * out.flux_net_v)) / abs(tidal[0]) > 0.05
    assert out.flux_evaluations > out.iterations


def test_t_start_non_irradiated_matches_jax(tables):
    """No star (rfacv 0), the port's props from ``_ClimateState.
    opacities``."""
    prof = profile(NLEVEL)
    inputs = tapi.ClimateInputs(
        t_eff=700.0, gravity=1e4, pressure=prof['pressure'],
        guess=prof['temperature'], nstr=(0, NLEVEL - 8, NLEVEL - 2, 0, 0, 0))
    st = tapi.climate_state(inputs, tables[1], device='cpu', verbose=False)
    props, atm = st.opacities(prof)
    assert atm.nlayer == NLEVEL - 1
    nwno = len(tables[0].wno)
    ref, out, _ = solve_both(tables, 0.0, np.zeros(nwno), 700.0,
                             port_props=props)
    check_same(ref, out)
    assert not np.any(out.flux_net_v)
