"""The port's climate inputs against the JAX package: CK tables, the
chemistry grid, the adiabat table.

Same seeds and points go through the JAX functions in float64 and through
picaso_tpu_torch on the CPU in float64:
- ``synthetic_ck_table`` (the 196-bin EGP grid and the 661-bin climate
  grid) equals the JAX table array for array, chemistry columns included;
  so do the converted JAX table, ``chem_grid_from_table`` and
  ``load_adiabat_grid``;
- ``interp_premix``, ``ck_continuum``, ``chem_interp`` and ``did_grad_cp``
  at random (T, P), with points below, above and on the grid edges and on
  grid nodes: rtol 1e-12 (XLA's and torch's ``exp``/``10 **`` differ by an
  ulp at most).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu import chemistry as jchem
from picaso_tpu import wavelength as jwave
from picaso_tpu.climate import adiabat as jadiabat
from picaso_tpu.opacities import ck as jck

from picaso_tpu_torch import chemistry as tchem
from picaso_tpu_torch import convert
from picaso_tpu_torch import wavelength as twave
from picaso_tpu_torch.climate import adiabat as tadiabat
from picaso_tpu_torch.opacities import ck as tck

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope='module', params=[False, True], ids=['196', '661'])
def tables(request):
    grid661 = request.param
    jt = jck.synthetic_ck_table(dtype=np.float64, grid661=grid661)
    tt = tck.synthetic_ck_table(grid661=grid661, device='cpu')
    return jt, tt


def _numpy_arrays(jt):
    a = {k: np.asarray(v) for k, v in jt.arrays._asdict().items()
         if k != 'continuum_molecules'}
    a['continuum_molecules'] = jt.arrays.continuum_molecules
    return a


def _columns(df):
    return {c: df[c].values for c in df.columns}


def test_synthetic_ck_table_equals_jax(tables):
    jt, tt = tables
    for name in tck.CKArrays._fields[:-1]:
        np.testing.assert_array_equal(
            getattr(tt.arrays, name).numpy(),
            np.asarray(getattr(jt.arrays, name)), err_msg=name)
    assert tt.arrays.continuum_molecules == jt.arrays.continuum_molecules
    assert tt.molecules == jt.molecules
    assert list(tt.full_abunds) == list(jt.full_abunds.columns)
    for col, values in _columns(jt.full_abunds).items():
        np.testing.assert_array_equal(tt.full_abunds[col], values)
    for name in ('gauss_pts', 'gauss_wts', 'temps', 'pressures', 'wno',
                 'delta_wno'):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))


def test_converted_tables_equal_the_ports(tables):
    jt, tt = tables
    ct = convert.ck_table_from_numpy(
        _numpy_arrays(jt), jt.molecules, _columns(jt.full_abunds),
        jt.gauss_pts, jt.temps, jt.pressures, device='cpu')
    for name in tck.CKArrays._fields[:-1]:
        assert torch.equal(getattr(ct.arrays, name),
                           getattr(tt.arrays, name)), name
    jg = jchem.chem_grid_from_table(jt.full_abunds)
    tg = tchem.chem_grid_from_table(tt.full_abunds, device='cpu')
    cg = convert.chem_grid_from_numpy(
        {k: np.asarray(v) for k, v in jg._asdict().items()
         if k != 'species'}, jg.species, device='cpu')
    assert tg.species == jg.species == cg.species
    for name in tchem.ChemGrid._fields[:-1]:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
        assert torch.equal(getattr(cg, name), getattr(tg, name))


def test_adiabat_grid_and_661_grid_equal_jax():
    ja = jadiabat.load_adiabat_grid()
    ta = tadiabat.load_adiabat_grid(device='cpu')
    ca = convert.adiabat_from_numpy(
        {k: np.asarray(v) for k, v in ja._asdict().items()}, device='cpu')
    for name in tadiabat.AdiabatGrid._fields:
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)))
        assert torch.equal(getattr(ca, name), getattr(ta, name))
    np.testing.assert_array_equal(twave.get_cld_input_grid(grid661=True),
                                  jwave.get_cld_input_grid(grid661=True))


def test_table_factories_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    for build in (tck.synthetic_ck_table, tadiabat.load_adiabat_grid):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()


def _points(rng, t_edges, p_edges, n=40):
    """(T, P) pairs: random inside, then every edge value against a random
    partner and every edge pair."""
    t_in = rng.uniform(min(t_edges), max(t_edges), n)
    p_in = 10 ** rng.uniform(np.log10(min(p_edges)),
                             np.log10(max(p_edges)), n)
    t_e = np.asarray(t_edges, float)
    p_e = np.asarray(p_edges, float)
    tt, pp = np.meshgrid(t_e, p_e)
    t = np.concatenate([t_in, t_e, rng.choice(t_in, len(p_e)), tt.ravel()])
    p = np.concatenate([p_in, rng.choice(p_in, len(t_e)), p_e, pp.ravel()])
    return t, p


def test_interp_premix_and_continuum_match_jax(tables):
    jt, tt = tables
    rng = np.random.default_rng(5)
    temps, pressures = jt.temps, jt.pressures
    t, p = _points(rng, [50.0, temps[0], temps[3], 0.5 * (temps[3]
                   + temps[4]), temps[-1], 4000.0],
                   [1e-8, pressures[0], pressures[5], pressures[-1], 1e5])
    j = np.asarray(jck.interp_premix(jt.arrays, jnp.asarray(t),
                                     jnp.asarray(p)))
    k = tck.interp_premix(tt.arrays, torch.tensor(t), torch.tensor(p))
    np.testing.assert_allclose(k.numpy(), j, rtol=RTOL, atol=0)

    cia = np.asarray(jt.arrays.cia_temps)
    tc = np.concatenate([t, [cia[0] - 10, cia[0], cia[3], cia[-1],
                             cia[-1] + 500]])
    jc = np.asarray(jck.ck_continuum(jt.arrays, jnp.asarray(tc)))
    kc = tck.ck_continuum(tt.arrays, torch.tensor(tc))
    np.testing.assert_allclose(kc.numpy(), jc, rtol=RTOL, atol=0)


def test_chem_interp_matches_jax(tables):
    jt, tt = tables
    jg = jchem.chem_grid_from_table(jt.full_abunds)
    tg = tchem.chem_grid_from_table(tt.full_abunds, device='cpu')
    rng = np.random.default_rng(6)
    t, p = _points(rng, [40.0, jt.temps[0], jt.temps[5], jt.temps[-1],
                         5000.0],
                   [1e-9, jt.pressures[0], jt.pressures[4],
                    jt.pressures[-1], 1e6])
    j = np.asarray(jchem.chem_interp(jg, jnp.asarray(t), jnp.asarray(p)))
    k = tchem.chem_interp(tg, torch.tensor(t), torch.tensor(p))
    np.testing.assert_allclose(k.numpy(), j, rtol=RTOL, atol=0)


def test_did_grad_cp_matches_jax():
    ja = jadiabat.load_adiabat_grid()
    ta = tadiabat.load_adiabat_grid(device='cpu')
    t_nodes = 10 ** np.asarray(ja.t_table)
    p_nodes = 10 ** np.asarray(ja.p_table)
    rng = np.random.default_rng(7)
    t, p = _points(rng, [1.0, t_nodes[0], t_nodes[17], t_nodes[-1], 1e7],
                   [1e-12, p_nodes[0], p_nodes[9], p_nodes[-1], 1e9])
    jg, jcp = jadiabat.did_grad_cp(jnp.asarray(t), jnp.asarray(p), ja)
    tg, tcp = tadiabat.did_grad_cp(torch.tensor(t), torch.tensor(p), ta)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=0)
    np.testing.assert_allclose(tcp.numpy(), np.asarray(jcp), rtol=RTOL,
                               atol=0)
