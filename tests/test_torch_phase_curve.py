"""The port's phase curves (picaso_tpu_torch.justdoit ``phase_curve``)
against the JAX package's, on the CPU in float64.

Both paths of the facade: 1D profiles as one batch of scenes
(``_phase_curve_batched``: ``pipeline.scene_from_case`` per phase, then
``forward_batch``, whose kernels' twins here stand for K1 and K2/K3/K4),
and the per-phase path (3D maps rotated by ``atmosphere_4d`` and
``clouds_4d``, each phase a ``picaso_3d`` run; or ``batched=False``).
Outputs agree with the JAX package's to rtol 2e-5 (transit 1e-8).
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from picaso_tpu import justdoit as jdi
from picaso_tpu import pipeline as jpipeline

from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import pipeline as tpipeline

from torch_facade_cases import (assert_same, connections, egp_clouds, gcm,
                                planet, profile, synthetic_db)

torch.set_num_threads(1)

PHASES = np.array([0.0, np.pi / 4, np.pi / 2])


@pytest.fixture(scope='module')
def opas(tmp_path_factory):
    return connections(synthetic_db(tmp_path_factory))


def _case_1d(module, opa, calculation, clouds=True, **approx):
    case = module.inputs()
    case.approx(**approx)
    planet(case, module, opa)
    case.phase_angle(phase_grid=PHASES, num_gangle=6, num_tangle=4,
                     calculation=calculation)
    prof = profile()
    case.atmosphere(df=pd.DataFrame(prof))
    if clouds:
        case.clouds(df=pd.DataFrame(egp_clouds(len(prof['pressure']) - 1)))
    return case


@pytest.mark.parametrize('calculation,approx', [
    ('reflected', {}), ('thermal', {}), ('reflected+thermal', {}),
    ('reflected', dict(multi_phase='isotropic', raman='none')),
    ('reflected+thermal', dict(rt_method='SH', stream=2))],
    ids=['reflected', 'thermal', 'both', 'isotropic', 'SH2'])
def test_batched_phase_curve_matches_jax(opas, calculation, approx):
    jopa, topa = opas
    got = _case_1d(tdi, topa, calculation, **approx).phase_curve(
        topa, verbose=False)
    want = _case_1d(jdi, jopa, calculation, **approx).phase_curve(
        jopa, verbose=False)
    assert list(got) == list(want) == [float(p) for p in PHASES]
    assert_same(got, want)


def test_per_phase_1d_matches_batched(opas):
    """batched=False runs each phase through spectrum(); its albedo is the
    batched curve's within the Toon kernels' twin tolerance."""
    _, topa = opas
    case = _case_1d(tdi, topa, 'reflected')
    batched = case.phase_curve(topa, verbose=False)
    serial = _case_1d(tdi, topa, 'reflected').phase_curve(
        topa, verbose=False, batched=False)
    for phase in batched:
        np.testing.assert_allclose(serial[phase]['albedo'],
                                   batched[phase]['albedo'], rtol=2e-5)


def test_scene_from_case_matches_jax(opas):
    """The scene and config of one phase, field for field."""
    jopa, topa = opas
    jcase = _case_1d(jdi, jopa, 'reflected')
    tcase = _case_1d(tdi, topa, 'reflected')
    for case in (jcase, tcase):
        case.inputs['disco'] = case.inputs['disco'][float(PHASES[1])]
    jscene, jconfig = jpipeline.scene_from_case(jcase, jopa,
                                                dtype=np.float64)
    tscene, tconfig = tpipeline.scene_from_case(tcase, topa)
    for name in tpipeline.SceneTensors._fields:
        np.testing.assert_allclose(getattr(tscene, name).numpy(),
                                   np.asarray(getattr(jscene, name)),
                                   rtol=1e-12, err_msg=name)
    for field in ('mol_indices', 'cont_indices', 'mix_index', 'raman',
                  'delta_eddington', 'stream', 'rt_method', 'hard_surface',
                  'transmission'):
        assert getattr(tconfig, field) == getattr(jconfig, field), field
    assert dataclasses.asdict(tconfig.controls) == \
        dataclasses.asdict(jconfig.controls)


def _case_4d(module, opa, calculation):
    if 'reflected' in calculation:
        case = module.inputs()
        case.gravity(gravity=25, gravity_unit=module.u.Unit('m/(s**2)'))
        case.star(opa, 5700, 0.0, 4.4)
    else:
        case = module.inputs(calculation='browndwarf')
        case.gravity(gravity=100, gravity_unit=module.u.Unit('m/(s**2)'))
    case.phase_angle(phase_grid=np.array([0.0, np.pi / 2, np.pi]),
                     num_gangle=6, num_tangle=4, calculation=calculation)
    case.atmosphere_4d(gcm(), verbose=False, zero_point='night_transit')
    if 'reflected' in calculation:
        data = gcm()
        rng = np.random.default_rng(1)
        shape = (24, 10, len(data['lon']), len(data['lat']))
        case.clouds_4d({'lat': data['lat'], 'lon': data['lon'],
                        'wavenumber': np.linspace(1e4 / 2, 1e4 / 0.3, 10),
                        'opd': rng.uniform(0, 1, shape),
                        'g0': np.full(shape, 0.8),
                        'w0': np.full(shape, 0.9)}, verbose=False)
    return case


@pytest.mark.parametrize('calculation', ['thermal', 'reflected'])
def test_4d_phase_curve_matches_jax(opas, calculation):
    """atmosphere_4d (and clouds_4d for reflected light) through the
    per-phase path: each phase a 24-facet picaso_3d run."""
    jopa, topa = opas
    got = _case_4d(tdi, topa, calculation).phase_curve(topa, verbose=False)
    want = _case_4d(jdi, jopa, calculation).phase_curve(jopa, verbose=False)
    assert list(got) == list(want)
    assert_same(got, want)
    if calculation == 'thermal':
        means = [out['thermal'].mean() for out in got.values()]
        assert abs(means[0] - means[2]) / means[0] > 1e-3


def test_mesh_raises(opas):
    _, topa = opas
    with pytest.raises(NotImplementedError, match='one'):
        _case_1d(tdi, topa, 'reflected').phase_curve(topa, mesh=object())
