"""The port's disequilibrium-chemistry pieces against the JAX package.

Same inputs (numpy, from a seed) through the JAX functions in float64 and
through picaso_tpu_torch on the CPU in float64:
- the quench adjustments of a profile (``adjust_quench_chemistry`` with the
  kinetic CO2, ``volatile_rainout``, ``cold_trap``), as functions and as
  the front door's methods, against the JAX facade's on a DataFrame, with
  quench levels whose ``.loc`` slice ends inside the profile and one at
  its bottom: rtol 1e-12;
- ``interp_rows`` against ``jnp.interp`` (points outside, on and between
  the nodes, repeated nodes): rtol 1e-12;
- ``mix_2_gases`` on rows with ties (equal mixed k's, where the sort's
  stability decides the weights' order) and without: rtol 1e-10;
- ``resortrebin_kappa`` on the per-gas synthetic tables: rtol 1e-10;
- ``synthetic_ck_table(with_per_gas=True)`` against the JAX table, and
  ``ck_taugas`` on its per-gas tables (resort-rebin at the atmosphere's
  abundances), rtol 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from picaso_tpu import justdoit as jdi
from picaso_tpu.atmosphere import build_atmosphere as j_build_atmosphere
from picaso_tpu.opacities import ck as jck
from picaso_tpu.opacities import resortrebin as jrr

from picaso_tpu_torch import chemistry as tchem
from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch.atmosphere import build_atmosphere
from picaso_tpu_torch.opacities import ck as tck
from picaso_tpu_torch.opacities import resortrebin as trr

from test_torch_climate_fluxes import close

torch.set_num_threads(1)

QUENCH = {'PH3': 9, 'CO-CH4-H2O': 14, 'CO2': 11, 'NH3-N2': 17, 'HCN': 29}


def chem_profile(nlevel=30, seed=12):
    rng = np.random.default_rng(seed)
    p = np.logspace(-4, 2.5, nlevel)
    t = 180.0 + 900.0 * (p / 300.0) ** 0.12 * rng.uniform(0.98, 1.02,
                                                          nlevel)
    prof = {'pressure': p, 'temperature': t}
    for mol, lo, hi in (('H2', 0.8, 0.86), ('He', 0.14, 0.16),
                        ('H2O', 1e-5, 1e-3), ('CH4', 1e-5, 6e-4),
                        ('CO', 1e-6, 3e-4), ('CO2', 1e-9, 1e-7),
                        ('NH3', 1e-6, 1e-4), ('N2', 1e-6, 1e-5),
                        ('PH3', 1e-8, 1e-6), ('HCN', 1e-10, 1e-8)):
        prof[mol] = np.sort(rng.uniform(lo, hi, nlevel))[::-1].copy()
    return prof


def jax_case(prof):
    case = jdi.inputs()
    case.inputs['atmosphere']['profile'] = pd.DataFrame(
        {k: v.copy() for k, v in prof.items()})
    return case


def assert_profile(port, ref):
    assert list(port) == list(ref.columns)
    for col in ref.columns:
        np.testing.assert_allclose(port[col], ref[col].values, rtol=1e-12,
                                   err_msg=col)


@pytest.mark.parametrize('levels', ['inside', 'bottom'])
def test_adjust_quench_chemistry(levels):
    prof = chem_profile()
    qlv = dict(QUENCH) if levels == 'inside' else {
        k: 29 for k in QUENCH}
    for kinetic in (True, False):
        ref = jax_case(prof)
        ref.adjust_quench_chemistry(qlv, kinetic_CO2=kinetic)
        got = tchem.adjust_quench_chemistry(prof, qlv, kinetic_CO2=kinetic)
        assert_profile(got, ref.inputs['atmosphere']['profile'])
    # the .loc slice [0:qlev + 1] includes its end label: CH4 is frozen
    # down to level 15, not 14
    ch4 = tchem.adjust_quench_chemistry(prof, QUENCH)['CH4']
    assert (ch4[:16] == prof['CH4'][14]).all() and ch4[16] != ch4[15]
    # the input is left as it was
    assert prof['CH4'][0] != prof['CH4'][14]


def test_rainout_and_cold_trap():
    prof = chem_profile(seed=13)
    ref = jax_case(prof)
    ref.volatile_rainout(QUENCH)
    assert_profile(tchem.volatile_rainout(prof, QUENCH),
                   ref.inputs['atmosphere']['profile'])
    ref = jax_case(prof)
    ref.cold_trap()
    assert_profile(tchem.cold_trap(prof), ref.inputs['atmosphere']['profile'])
    # the front door's methods, one after another, as the climate runs them
    ref = jax_case(prof)
    case = tdi.inputs()
    case.atmosphere(df=prof)
    for c in (ref, case):
        c.adjust_quench_chemistry(QUENCH)
        c.volatile_rainout(QUENCH)
        c.cold_trap()
    assert_profile(case.inputs['atmosphere']['profile'],
                   ref.inputs['atmosphere']['profile'])


def test_interp_rows():
    rng = np.random.default_rng(14)
    xp = np.sort(rng.uniform(0.0, 1.0, (20, 64)), axis=1)
    xp[3, 10:13] = xp[3, 10]        # repeated nodes
    fp = rng.normal(size=(20, 64))
    x = np.concatenate([[-0.5, 0.0, 1.0, 1.5], rng.uniform(0, 1, 12),
                        xp[5, [0, 7, 63]]])
    got = trr.interp_rows(torch.tensor(x), torch.tensor(xp),
                          torch.tensor(fp))
    for r in range(20):
        close(got[r], jnp.interp(jnp.asarray(x), jnp.asarray(xp[r]),
                                 jnp.asarray(fp[r])), rtol=1e-12)


def test_mix_2_gases_with_ties():
    gpts, gwts = jck.double_gauss_points()
    rng = np.random.default_rng(15)
    k1 = np.sort(10 ** rng.uniform(-25, -18, (6, 8)), axis=1)
    k2 = np.sort(10 ** rng.uniform(-25, -18, (6, 8)), axis=1)
    # rows 0-2 with ties: equal k's of each gas (and the same gas twice)
    k1[0, 2:5] = k1[0, 2]
    k2[1] = k2[1, 0]
    k2[2] = k1[2]
    m1 = rng.uniform(1e-5, 1e-3, 6)
    m2 = rng.uniform(1e-5, 1e-3, 6)
    m1[2] = m2[2]
    got, gt = trr.mix_2_gases(*(torch.tensor(x) for x in (k1, k2, m1, m2,
                                                          gpts, gwts)))
    ref, rt = jrr.mix_2_gases(*(jnp.asarray(x) for x in (k1, k2, m1, m2,
                                                         gpts, gwts)))
    kmix = ((m1[:, None, None] * k1[:, :, None]
             + m2[:, None, None] * k2[:, None, :]) / (m1 + m2)[:, None, None])
    assert all(len(np.unique(kmix[i])) < 64 for i in range(3))
    close(got, ref, rtol=1e-10)
    close(gt, rt, rtol=1e-12)


@pytest.fixture(scope='module')
def per_gas():
    wno = np.linspace(500.0, 9000.0, 24)
    tables, meta = jrr.synthetic_per_gas_tables(wno, dtype=np.float64)
    tt, tmeta = trr.synthetic_per_gas_tables(wno, dtype=np.float64)
    np.testing.assert_array_equal(tt, tables)
    return wno, tables, meta


def test_resortrebin_kappa(per_gas):
    wno, tables, meta = per_gas
    nlayer = 17
    rng = np.random.default_rng(16)
    tlayer = rng.uniform(200.0, 3000.0, nlayer)
    player = 10 ** rng.uniform(-5, 2.5, nlayer)
    mixes = 10 ** rng.uniform(-6, -3, (tables.shape[0], nlayer))
    t_inv = 1.0 / meta['temps']
    p_log = np.log10(meta['pressures'])
    nc_p = np.full(len(meta['temps']), len(meta['pressures']))
    ref = jrr.resortrebin_kappa(
        jnp.asarray(tables), jnp.asarray(t_inv), jnp.asarray(p_log),
        jnp.asarray(nc_p, jnp.int32), jnp.asarray(meta['gauss_pts']),
        jnp.asarray(meta['gauss_wts']), jnp.asarray(mixes),
        jnp.asarray(tlayer), jnp.asarray(player))
    got = trr.resortrebin_kappa(
        torch.tensor(tables), torch.tensor(t_inv), torch.tensor(p_log),
        torch.tensor(nc_p, dtype=torch.int32),
        torch.tensor(meta['gauss_pts']), torch.tensor(meta['gauss_wts']),
        torch.tensor(mixes), torch.tensor(tlayer), torch.tensor(player))
    assert got.shape == (nlayer, len(wno), 8)
    close(got, ref, rtol=1e-10)


def test_per_gas_table_and_taugas():
    jt = jck.synthetic_ck_table(dtype=np.float64, with_per_gas=True)
    tt = tck.synthetic_ck_table(device='cpu', with_per_gas=True)
    assert tt.per_gas_molecules == jt.per_gas_molecules
    np.testing.assert_array_equal(tt.per_gas.numpy(), np.asarray(jt.per_gas))
    assert tck.synthetic_ck_table(device='cpu').per_gas is None
    moved = tt.to('cpu', torch.float32)
    assert moved.per_gas.dtype == torch.float32
    assert moved.per_gas_molecules == tt.per_gas_molecules
    prof = chem_profile(25, seed=17)
    prof['temperature'] = np.linspace(400.0, 2200.0, 25)
    atm_j = j_build_atmosphere(pd.DataFrame(prof), gravity=1e4,
                               wno=jt.wno)
    atm_t = build_atmosphere(prof, gravity=1e4, wno=tt.wno)
    close(tck.ck_taugas(tt, atm_t), jck.ck_taugas(jt, atm_j), rtol=1e-10)
