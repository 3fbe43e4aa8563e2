"""The harness on the CPU at a tiny width: the port's plain twins
(device='cpu') against the reference for both configurations and both
mixes, a cell that exists only as data, the faults that ``correct`` must
catch, and the control that must fail."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import check, inputs
from benchmark.harness.cell import run_cell
from benchmark.harness.spec import Spec
from benchmark.reference import spectrum as ref
from benchmark.tests.tiny import ROOT, edit, tiny_root

CELLS = ['picaso_r15k_toon.grid16', 'picaso_r15k_sh4.curve36x8',
         'picaso_r15k_toon.curve36x8', 'picaso_r15k_sh4.grid16']
SEED = 2 ** 31 + 4097


@pytest.fixture(scope='module')
def root64(tmp_path_factory):
    """A tiny root whose table is float64: the twins then compute in
    float64 like the reference."""
    root = tiny_root(tmp_path_factory.mktemp('tiny64'))
    for name in os.listdir(os.path.join(root, 'benchmark', 'configs')):
        edit(root, 'configs', name, table_dtype='float64')
    return root


@pytest.fixture(scope='module')
def root32(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp('tiny32'))


def _run(root, cell, traced=False, seconds=0.3):
    return run_cell(Spec(root), cell, SEED, seconds, traced, 'cpu',
                    time.perf_counter())


@pytest.mark.parametrize('cell', CELLS)
def test_twins_agree_with_reference(root64, cell):
    result = _run(root64, cell)
    assert result['correct'] and result['failed'] == 0
    assert result['attempted'] >= 2
    for name, c in result['checks'].items():
        assert c['value'] < 1e-7, (name, c)
    metrics = result['metrics']
    assert set(metrics) == {'spectra_per_s', 'request_ms_p95', 'setup_s'}
    assert all(m['value'] > 0 for m in metrics.values())


@pytest.mark.parametrize('cell', CELLS[:2])
def test_traced_run_reads_per_layer_metrics(root32, cell):
    result = _run(root32, cell, traced=True)
    assert result['correct']
    # no card here: only the host span's metric has something to read
    assert set(result['metrics']) == {'host_ms_per_spectrum'}
    assert result['device']['window_s'] > 0
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    assert list(result)[-1] == 'checks'


def test_a_cell_config_and_metric_that_exist_only_as_data(tmp_path):
    root = tiny_root(tmp_path)
    bench_dir = os.path.join(root, 'benchmark')
    with open(os.path.join(bench_dir, 'configs',
                           'picaso_r15k_toon.json')) as f:
        cfg = json.load(f)
    cfg.update(name='tiny_toon_n1', rt=dict(cfg['rt'], controls=dict(
        cfg['rt']['controls'], multi_phase=1)))
    with open(os.path.join(bench_dir, 'configs', 'tiny_toon_n1.json'),
              'w') as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, 'traffic', 'grid16.json')) as f:
        mix = json.load(f)
    mix.update(name='grid3', pool=3)
    mix['request']['atmospheres'] = 3
    with open(os.path.join(bench_dir, 'traffic', 'grid3.json'), 'w') as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, 'limits',
                           'tiny_toon_n1.grid3.json'), 'w') as f:
        json.dump({'limits': dict.fromkeys(check.names(
            ('albedo', 'thermal', 'transit_depth')), 1e-2)}, f)
    with open(os.path.join(bench_dir, 'metrics',
                           'requests_per_window.py'), 'w') as f:
        f.write('def read(ctx):\n    return float(len(ctx.window.latencies))\n')
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    bench['configs'].append({'name': 'tiny_toon_n1', 'source': 'x',
                             'file': 'benchmark/configs/tiny_toon_n1.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'tiny_toon_n1.grid3',
                               'config': 'tiny_toon_n1', 'traffic': 'grid3',
                               'chips': 1, 'why': 'a test'})
    bench['per_layer'].append({'name': 'requests_per_window',
                               'unit': 'count', 'better': 'higher',
                               'source': 'host_clock', 'layer': 'entry',
                               'moves': 'spectra_per_s',
                               'workloads': ['tiny_toon_n1.grid3']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    result = _run(root, 'tiny_toon_n1.grid3', traced=True)
    assert result['correct']
    assert result['metrics']['requests_per_window']['value'] == result[
        'attempted']
    assert 'requests_per_window' not in _run(
        root, 'picaso_r15k_toon.grid16', traced=True)['metrics']


def _half_batch(forward_batch):
    """Half of the batch left out: its rows are the mean of the rest."""
    def broken(stacked):
        out = forward_batch(stacked)
        fixed = {}
        for k, v in out.items():
            keep = v[::2]
            v = v.clone()
            v[1::2] = keep.mean(dim=0, keepdim=True)
            fixed[k] = v
        return fixed
    return broken


def _altered(forward_batch):
    """One answer altered where it is produced: the last spectrum of the
    batch 1 % off."""
    def broken(stacked):
        out = forward_batch(stacked)
        for v in out.values():
            v[-1] *= 1.01
        return out
    return broken


def _stale(forward_batch):
    """A step that returns its state unchanged: every request gets the
    previous request's spectra."""
    last = []

    def broken(stacked):
        out = forward_batch(stacked)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return broken


@pytest.mark.parametrize('fault', [_half_batch, _altered, _stale],
                         ids=['half_batch', 'altered', 'stale'])
@pytest.mark.parametrize('cell', ['picaso_r15k_toon.grid16',
                                  'picaso_r15k_sh4.curve36x8',
                                  'picaso_r15k_toon.int16grid16'])
def test_faults_make_correct_false(root32, monkeypatch, cell, fault):
    from benchmark.harness import port
    original = port.Port.forward_batch

    def patched(self, stacked):
        if not hasattr(self, '_broken'):
            self._broken = fault(lambda s: original(self, s))
        return self._broken(stacked)
    monkeypatch.setattr(port.Port, 'forward_batch', patched)
    assert _run(root32, cell)['correct'] is False


@pytest.mark.parametrize('precision', ['bf16', 'f16'])
@pytest.mark.parametrize('cell', CELLS + ['picaso_r15k_toon.int16grid16'])
def test_control_fails_the_limits(root32, cell, precision):
    """Each control, the reference with its table rows (and, for bf16,
    its optical depths) rounded to 16 bits, fails at least one of the
    cell's numbers over the pool's atmospheres."""
    spec = Spec(root32)
    c = spec.cell(cell)
    cfg, traffic = spec.config(c['config']), spec.traffic(c['traffic'])
    limits = spec.limits(cell)
    table = inputs.table(spec.dir, cfg, SEED, 'cpu')
    planet = inputs.planet(cfg)
    req = traffic['request']
    outputs = tuple(req['outputs'])
    opts = check.options(cfg)
    # as a run's sample: the worst over several atmospheres
    pool = inputs.pool(cfg, traffic, SEED)
    kind = spec.requests(traffic)(cfg, traffic, pool)
    last = len(req['phases_deg']) - 1
    sample = [([(a, last)],) for a in range(len(pool))]
    control = check.reference(kind, sample, table, planet, opts, outputs,
                              'cpu', precision)
    want = check.reference(kind, sample, table, planet, opts, outputs,
                           'cpu')
    gaps = check.compare(control, want, outputs)
    assert any(gaps[k] > limit for k, limit in limits.items()), gaps


def test_gaps():
    want = np.array([1.0, 2.0, 4.0, 1e-12])
    assert check.gaps_of(want, want) == (0.0,) * 5
    peak, median, p99, p999, p999_gap = check.gaps_of(want * 1.001, want)
    assert peak == pytest.approx(1e-3) and median == pytest.approx(1e-3)
    assert p99 == pytest.approx(1e-3) and p999 == pytest.approx(1e-3)
    assert p999_gap == pytest.approx(1e-3, rel=2e-3)
    got = want.copy()
    got[0] += 0.04
    peak, median, p99, p999, p999_gap = check.gaps_of(got, want)
    assert (peak, median) == (pytest.approx(0.01), 0.0)
    # one wavenumber of four off: above the 75th percentile only
    assert p99 == pytest.approx(0.04 * 0.97) and p999 > p99
    assert p999_gap == pytest.approx(0.01 * 0.997)
    assert check.gaps_of(np.array([1.0, np.nan, 0, 0]), want) == (
        float('inf'),) * 5


def test_sampler_is_uniform_and_seeded():
    a, b = check.Sampler(3, 7), check.Sampler(3, 7)
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.kept == b.kept and len(a.kept) == 3


def test_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the command would run')
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'benchmark', 'run.py'),
         '--workload', CELLS[0], '--seed', '1', '--seconds', '1'],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ''
    assert 'no CUDA device' in proc.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: none here')


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """One short run of the first cell on the card, correct."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'benchmark', 'run.py'),
         '--workload', CELLS[0], '--seed', str(SEED), '--seconds', '3'],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'
