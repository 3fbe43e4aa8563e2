"""The program's spans and counter (``picaso_tpu_torch.profiling.span``,
``counted``) on the CPU, and the benchmark's readers of them on a
hand-built Chrome trace.

* With no profiler a span is one shared no-op; under ``torch.profiler``
  ``forward_batch`` records ``picaso.forward_batch`` once, a
  ``picaso.forward`` per scene, and in each forward the stage spans in
  order; the outputs are bitwise those of an unprofiled call.
* ``scene_from_arrays`` counts its calls and host seconds.
* The six readers (``benchmark/metrics/``) give their exact values on a
  trace of known spans, syncs and device gaps, and ``None`` where the
  program records no span or counter (a program without them) or the run
  is not on the card."""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import trace
from benchmark.harness.spec import Spec
from benchmark.tests.tiny import ROOT
from picaso_tpu_torch import pipeline, profiling

STAGES = ['picaso.gather', 'picaso.sources', 'picaso.rt', 'picaso.disco',
          'picaso.transit']
READERS = ['gather_host_ms_per_spectrum', 'glue_host_ms_per_spectrum',
           'rt_host_ms_per_spectrum', 'host_syncs_per_spectrum',
           'idle_in_forward_pct', 'scene_build_ms']


@pytest.fixture(scope='module')
def problem():
    """A batch of two scenes (the second 5 % warmer) on a small regular
    grid, Toon with transmission."""
    scene, grid, config = pipeline.build_problem(
        48, nlevel=21, production=False, device='cpu')
    warm = scene._replace(tlevel=scene.tlevel * 1.05,
                          tlayer=scene.tlayer * 1.05)
    return pipeline.stack_scenes([scene, warm]), grid, config


def _configs(config):
    return {'toon': config,
            'sh4': dataclasses.replace(config, rt_method=1, stream=4)}


def test_span_without_profiler_is_one_shared_noop():
    a, b = profiling.span('picaso.a'), profiling.span('picaso.b')
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inside = profiling.span('picaso.c')
        with inside:
            pass
    assert inside is not a
    assert profiling.span('picaso.d') is a
    names = {e.name for e in prof.events()}
    assert 'picaso.c' in names and 'picaso.a' not in names


@pytest.mark.parametrize('rt', ['toon', 'sh4'])
def test_forward_batch_spans_and_outputs(problem, rt):
    batch, grid, config = problem
    config = _configs(config)[rt]
    plain = pipeline.forward_batch(batch, grid, config)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = pipeline.forward_batch(batch, grid, config)
    assert set(traced) == set(plain) == {'albedo', 'thermal',
                                         'transit_depth'}
    for key in plain:
        assert torch.equal(traced[key], plain[key]), key
    events = sorted((e for e in prof.events()
                     if e.name.startswith('picaso.')),
                    key=lambda e: e.time_range.start)
    batches = [e for e in events if e.name == 'picaso.forward_batch']
    forwards = [e for e in events if e.name == 'picaso.forward']
    assert len(batches) == 1 and len(forwards) == 2
    for f in forwards:
        inside = [e.name for e in events if e.name in STAGES
                  and f.time_range.start <= e.time_range.start
                  and e.time_range.end <= f.time_range.end]
        assert inside == STAGES
    outputs = [e for e in events if e.name == 'picaso.outputs']
    assert len(outputs) == 1
    assert outputs[0].time_range.start >= forwards[-1].time_range.end


def test_scene_from_arrays_counts_calls_and_seconds():
    nlevel = 11
    pressure = np.logspace(-4, 2, nlevel)
    grid = pipeline.build_problem(16, nlevel=nlevel, production=False,
                                  device='cpu')[1]
    mix = {'H2': np.full(nlevel, 0.84), 'He': np.full(nlevel, 0.155),
           'H2O': np.full(nlevel, 1e-3)}
    profiling.reset_counters()
    pipeline.scene_from_arrays(pressure, np.full(nlevel, 1000.0), mix,
                               grid, gravity=25.0, device='cpu')
    c = profiling.counters()['scene_from_arrays']
    assert c['calls'] == 1 and c['seconds'] > 0
    profiling.reset_counters()
    assert profiling.counters() == {}


# A hand-built trace of one request of 2 spectra (times in us).  The
# forwards' stage spans and the two forwards' self times (70 and 60 us);
# two syncs inside picaso.forward_batch and one after it; device
# kernels [0, 100], [150, 300], [600, 700], [920, 1000], so the idle
# gaps [100, 150], [300, 600], [700, 920] lie 550 us inside
# forward_batch [100, 900].
HOST = [('bench.request', 0, 1000, 'user_annotation'),
        ('picaso.forward_batch', 100, 800, 'user_annotation'),
        ('picaso.forward', 110, 390, 'user_annotation'),
        ('picaso.gather', 120, 50, 'user_annotation'),
        ('cudaStreamSynchronize', 130, 5, 'cuda_runtime'),
        ('picaso.sources', 170, 30, 'user_annotation'),
        ('picaso.rt', 200, 200, 'user_annotation'),
        ('picaso.disco', 400, 20, 'user_annotation'),
        ('picaso.transit', 420, 20, 'user_annotation'),
        ('picaso.forward', 500, 350, 'user_annotation'),
        ('picaso.gather', 510, 40, 'user_annotation'),
        ('cudaStreamSynchronize', 520, 5, 'cuda_runtime'),
        ('cudaMemcpyAsync', 530, 5, 'cuda_runtime'),
        ('picaso.sources', 550, 20, 'user_annotation'),
        ('picaso.rt', 570, 200, 'user_annotation'),
        ('picaso.disco', 770, 20, 'user_annotation'),
        ('picaso.transit', 790, 10, 'user_annotation'),
        ('picaso.outputs', 860, 20, 'user_annotation'),
        ('cudaStreamSynchronize', 950, 5, 'cuda_runtime')]
DEVICE = [(0, 100), (150, 150), (600, 100), (920, 80)]
WANT = {'gather_host_ms_per_spectrum': 0.045,
        # sources 50 + disco 40 + transit 30 + outputs 20 + self 130
        'glue_host_ms_per_spectrum': 0.135,
        'rt_host_ms_per_spectrum': 0.2,
        'host_syncs_per_spectrum': 1.0,
        'idle_in_forward_pct': 55.0}


def _trace(program_spans=True):
    host = [(n, ts, dur, cat) for n, ts, dur, cat in HOST
            if program_spans or not n.startswith('picaso.')]
    events = [{'ph': 'X', 'name': n, 'ts': ts, 'dur': dur, 'cat': cat,
               'pid': 1, 'tid': 1} for n, ts, dur, cat in host]
    events += [{'ph': 'X', 'name': 'toon_kernel', 'ts': ts, 'dur': dur,
                'cat': 'kernel', 'pid': 0, 'tid': 7} for ts, dur in DEVICE]
    return trace.parse({'traceEvents': events})


def _ctx(tr, device='cuda'):
    return types.SimpleNamespace(trace=tr, traced_items=[(0, 0), (1, 0)],
                                 device=torch.device(device))


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_on_a_known_trace(name):
    tr = _trace()
    got = Spec(ROOT).reader(name)(_ctx(tr))
    assert got == pytest.approx(WANT[name], rel=1e-12, abs=0)
    if name == 'idle_in_forward_pct':
        device_idle = Spec(ROOT).reader('device_idle_pct')(_ctx(tr))
        assert device_idle == pytest.approx(57.0, rel=1e-12)


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_without_program_spans_reads_none(name):
    read = Spec(ROOT).reader(name)
    assert read(_ctx(_trace(program_spans=False))) is None
    assert read(_ctx(None)) is None


@pytest.mark.parametrize('name', sorted(set(READERS) - {
    'idle_in_forward_pct'}))
def test_reader_reads_none_off_the_card(name):
    # on the CPU the spans time the twins' arithmetic; the idle reader
    # finds no device intervals there by itself
    assert Spec(ROOT).reader(name)(_ctx(_trace(), 'cpu')) is None


def test_scene_build_reader(monkeypatch):
    read = Spec(ROOT).reader('scene_build_ms')
    profiling.reset_counters()
    assert read(_ctx(None)) is None
    profiling._COUNTERS['scene_from_arrays'] = {'calls': 4, 'seconds': 0.1}
    try:
        assert read(_ctx(None)) == pytest.approx(25.0, rel=1e-12)
        # a program with no counters, as before they were added
        monkeypatch.delattr(profiling, 'counters')
        assert read(_ctx(None)) is None
    finally:
        profiling.reset_counters()


def test_benchmark_lists_the_readers():
    per_layer = Spec(ROOT).bench['per_layer']
    added = [m for m in per_layer if m['name'] in READERS]
    assert [m['name'] for m in added] == [
        m['name'] for m in per_layer][-len(READERS):]
    assert all('workloads' not in m for m in added)
    assert {m['name']: m['moves'] for m in added}['scene_build_ms'] == (
        'setup_s')
