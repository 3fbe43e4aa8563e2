"""The port's moist adiabat, Kzz and quench levels against the JAX package.

Same inputs (numpy, from a seed) through the JAX functions in float64 and
through picaso_tpu_torch on the CPU in float64:
- ``cp_gas`` over all 17 Shomate gases and ``heat_of_vaporization`` over
  the 4 condensables, across every temperature branch, rtol 1e-12;
- ``moist_grad`` with [ncond] and [ncond, n] abundances, rtol 1e-12;
- ``reconstruct_profile`` on the moist adiabat for a [nlevel] and a
  [P, nlevel] beta, one and two convective zones, rtol 1e-12;
- ``get_kzz`` with one and two zones, rtol 1e-10;
- ``quench_levels``: the level indices exactly, ``t_mix`` rtol 1e-12, in
  a warm case and the cold one (min T <= 250 K: the grid extended to
  1e6 bar).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu import chemistry as jchem
from picaso_tpu.climate import core as jcore
from picaso_tpu.climate import kzz as jkzz
from picaso_tpu.climate import moist as jmoist
from picaso_tpu.climate.adiabat import load_adiabat_grid as j_adiabat

from picaso_tpu_torch import chemistry as tchem
from picaso_tpu_torch import convert
from picaso_tpu_torch.climate import core as tcore
from picaso_tpu_torch.climate import kzz as tkzz
from picaso_tpu_torch.climate import moist as tmoist

from test_torch_climate_fluxes import close

torch.set_num_threads(1)

COND = ('H2O', 'CH4', 'NH3', 'Fe')
WEIGHTS = (18.015, 16.04, 17.031, 55.845)


@pytest.fixture(scope='module')
def adiabats():
    jad = j_adiabat()
    tad = convert.adiabat_from_numpy(
        {k: np.asarray(v) for k, v in jad._asdict().items()}, device='cpu')
    return jad, tad


def temps(n=400):
    # every branch: below 100 K, 100-1000, 1000-2500, above 2500, around
    # each critical and freezing point
    rng = np.random.default_rng(3)
    return np.sort(np.concatenate([np.linspace(40.0, 4500.0, n),
                                   rng.uniform(60.0, 700.0, 100),
                                   [90.0, 191.0, 195.0, 273.0, 406.0,
                                    647.0, 1150.0, 4000.0]]))


@pytest.mark.parametrize('mol', list(tmoist.SHOMATE))
def test_cp_gas(mol):
    t = temps()
    close(tmoist.cp_gas(mol, torch.tensor(t), 20.0),
          jmoist.cp_gas(mol, jnp.asarray(t), 20.0), rtol=1e-12)


@pytest.mark.parametrize('mol', COND)
def test_heat_of_vaporization(mol):
    t = temps()
    w = WEIGHTS[COND.index(mol)]
    close(tmoist.heat_of_vaporization(mol, torch.tensor(t), w),
          jmoist.heat_of_vaporization(mol, jnp.asarray(t), w), rtol=1e-12)
    with pytest.raises(ValueError):
        tmoist.heat_of_vaporization('CO', torch.tensor(t), 28.0)


@pytest.mark.parametrize('layout', ['per_point', 'shared'])
def test_moist_grad(adiabats, layout):
    jad, tad = adiabats
    rng = np.random.default_rng(5)
    n = 200
    t = rng.uniform(80.0, 3000.0, n)
    p = 10 ** rng.uniform(-5, 3, n)
    q = (10 ** rng.uniform(-7, -2, (len(COND), n)) if layout == 'per_point'
         else 10 ** rng.uniform(-7, -2, len(COND)))
    tg, tcp = tmoist.moist_grad(torch.tensor(t), torch.tensor(p), tad,
                                torch.tensor(q), COND, WEIGHTS)
    jg, jcp = jmoist.moist_grad(jnp.asarray(t), jnp.asarray(p), jad,
                                jnp.asarray(q), COND, WEIGHTS)
    close(tg, jg, rtol=1e-12)
    close(tcp, jcp, rtol=1e-12)


ZONES = {'one': ([0, 12, 28, 0, 0, 0], 1), 'two': ([0, 8, 14, 14, 22, 28],
                                                  2)}


@pytest.mark.parametrize('zone', list(ZONES))
def test_moist_reconstruct_profile(adiabats, zone):
    jad, tad = adiabats
    nstr, nofczns = ZONES[zone]
    nlevel = 30
    plevel = np.logspace(-4, 2.5, nlevel) * 1e6
    rng = np.random.default_rng(6)
    betas = np.linspace(150.0, 900.0, nlevel) * rng.uniform(0.9, 1.1,
                                                            (3, nlevel))
    cond = 10 ** rng.uniform(-6, -2.5, (nlevel - 1, 3))
    names, weights = COND[:3], WEIGHTS[:3]
    zones = tcore.zone_maps(nstr, nofczns, nlevel)
    moist_t = (torch.tensor(cond), names, weights)
    batched = tcore.reconstruct_profile(torch.tensor(betas), zones,
                                        torch.tensor(plevel), tad,
                                        moist_args=moist_t)
    single = tcore.reconstruct_profile(torch.tensor(betas[1]), zones,
                                       torch.tensor(plevel), tad,
                                       moist_args=moist_t)
    jz = jcore.zone_maps(nstr, nofczns, nlevel)
    for i, beta in enumerate(betas):
        ref = jcore.reconstruct_profile(
            jnp.asarray(beta), jz, jnp.asarray(plevel), jad,
            moist_args=(jnp.asarray(cond), names, weights))
        close(batched[i], ref, rtol=1e-12)
        if i == 1:
            close(single, ref, rtol=1e-12)
    # the moist adiabat differs from the dry one where it matters
    dry = tcore.reconstruct_profile(torch.tensor(betas[1]), zones,
                                    torch.tensor(plevel), tad)
    assert (dry - single).abs().max() > 1e-3


@pytest.mark.parametrize('zone', list(ZONES))
def test_get_kzz(adiabats, zone):
    jad, tad = adiabats
    nstr, _ = ZONES[zone]
    nlevel = 30
    rng = np.random.default_rng(8)
    p = np.logspace(-4, 2.5, nlevel)
    t = np.linspace(300.0, 1600.0, nlevel) * rng.uniform(0.97, 1.03, nlevel)
    tidal = jcore.tidal_flux(700.0, nlevel)
    fnil = rng.uniform(-1e8, 1e8, nlevel)
    fpit = rng.uniform(1e4, 1e6, 48)
    mmw = rng.uniform(2.2, 2.4, nlevel - 1)
    dtdp = np.diff(np.log(t)) / np.diff(np.log(p))
    args = (p, t, 100.0, tidal, fnil, fpit)
    tail = (list(nstr), mmw, dtdp)
    close(tkzz.get_kzz(*args, tad, *tail), jkzz.get_kzz(*args, jad, *tail),
          rtol=1e-10)


@pytest.mark.parametrize('case', ['warm', 'cold'])
def test_quench_levels(case):
    nlevel = 40
    rng = np.random.default_rng(9)
    p = np.logspace(-4, 2.5, nlevel)
    t0 = 1100.0 if case == 'warm' else 230.0
    t = t0 * (p / 10.0) ** 0.11 * rng.uniform(0.99, 1.01, nlevel)
    if case == 'cold':
        t = np.maximum(t, 150.0)
        assert t.min() <= 250
    dtdp = np.diff(np.log(t)) / np.diff(np.log(p))
    kz = 10 ** rng.uniform(7, 10, nlevel)
    mmw = rng.uniform(2.25, 2.35, nlevel - 1)
    scale_h = 1.38e-16 * t[:-1] / (mmw * 1.66e-24 * 1e4)
    x_h2o = rng.uniform(1e-4, 1e-3, nlevel)
    x_h2 = rng.uniform(0.8, 0.85, nlevel)
    for strict in (False, True):
        kw = dict(x_h2o=x_h2o, x_h2=x_h2, strict=strict)
        try:
            ref = jchem.quench_levels(p, t, dtdp, kz, mmw, scale_h, 100.0,
                                      **kw)
        except ValueError:
            with pytest.raises(ValueError):
                tchem.quench_levels(p, t, dtdp, kz, mmw, scale_h, 100.0,
                                    **kw)
            continue
        got = tchem.quench_levels(p, t, dtdp, kz, mmw, scale_h, 100.0, **kw)
        assert got[0] == ref[0]
        assert len(got[1]) == (nlevel + 10 if case == 'cold' else nlevel)
        close(got[1], ref[1], rtol=1e-12)
