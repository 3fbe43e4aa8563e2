"""Request kinds and the program's table as data, on the CPU at a tiny
width: the four cells read what they read before the disk logic moved
into ``requests/disk.py``, a kind that exists only as a file runs, and
an int16 traffic reaches the program's int16 gather."""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cellmod, check
from benchmark.harness.cell import program_table_of, run_cell
from benchmark.harness.spec import Spec
from benchmark.tests.tiny import edit, tiny_root

SEED = 2 ** 31 + 4097

# Recorded with the harness before the move (the parent commit of the
# request kinds), on the root below at SEED: the sampled (request,
# spectrum) indices, the SHA-256 of the sampled spectra (each output's
# float64 bytes, in sample order) and of the per-layer readers' inputs
# (json of [traced_items, geom_args]).  The spectra's digest is of torch
# 2.13.0+cpu at the AVX512 capability, where it was recorded; another
# build may round the twins differently.
RECORDED_ON = ('2.13.0+cpu', 'AVX512')
GRID = [[0, 0], [0, 2], [0, 3], [0, 4], [0, 5], [0, 6], [0, 8], [0, 9],
        [1, 0], [1, 1], [1, 2], [1, 4], [1, 6], [1, 7], [1, 8], [1, 9]]
CURVE = [[14, 0], [14, 2], [14, 3], [14, 4], [14, 5], [14, 6], [14, 8],
         [14, 9]]
IDENTITY = {
    'picaso_r15k_toon.grid16': (
        GRID,
        '0cf7d93b481511e59d91515e80eeaa8dce699d046929292a6747806d24d6ec3e',
        '98e552f530b2b75e8a6ed1338ff692498ffd6ca5f87e88af7ae55bf034442a7f'),
    'picaso_r15k_sh4.curve36x8': (
        CURVE,
        '8f25d75f90c2e9d836fbf8a37539182f989ee82d4bd364468d04ed03ff99ee99',
        '08b397f3e2e8c6a111d0012fe5a27a82007a181912714c81802160949202897e'),
    'picaso_r15k_toon.curve36x8': (
        CURVE,
        'f402422778cb4fb40639fcec32717b645b41b9b8ef4c85ad5c9a1ed4d5000919',
        '08b397f3e2e8c6a111d0012fe5a27a82007a181912714c81802160949202897e'),
    'picaso_r15k_sh4.grid16': (
        GRID,
        '8b15b43db202e9bfc17f8a9b496a33cd148325108ba660a5fedc357b7727cc6a',
        '98e552f530b2b75e8a6ed1338ff692498ffd6ca5f87e88af7ae55bf034442a7f'),
}


@pytest.fixture
def context(monkeypatch):
    """The last run's reader context."""
    seen = {}

    class Spy(cellmod.Context):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen['ctx'] = self
    monkeypatch.setattr(cellmod, 'Context', Spy)
    return seen


@pytest.fixture(scope='module')
def identity_root(tmp_path_factory):
    """Grid requests of 10 spectra and curves of 10 phases, so that the
    check picks 8 of 10; three traced requests and a window of none
    beyond MIN_REQUESTS, so that a run makes three requests whatever the
    host's speed and the reservoir sampler replaces."""
    root = tiny_root(tmp_path_factory.mktemp('identity'), pool=20,
                     per_grid=10, phases=tuple(range(0, 150, 15)))
    for mix in ('grid16.json', 'curve36x8.json'):
        edit(root, 'traffic', mix, trace_requests=3)
    return root


@pytest.mark.parametrize('cell', sorted(IDENTITY))
def test_move_changes_nothing(identity_root, context, cell):
    sampled, spectra_sha, readers_sha = IDENTITY[cell]
    spec = Spec(identity_root)
    outputs = spec.traffic(spec.cell(cell)['traffic'])['request']['outputs']
    r = run_cell(spec, cell, SEED, 0.0, True, 'cpu', time.perf_counter(),
                 readings=True)
    assert r['correct'] and r['attempted'] == 3
    assert [[w['request'], w['spectrum']] for w in r['where']] == sampled
    ctx = context['ctx']
    assert all(len(w['scenes']) == 1 for w in r['where'])
    readers = json.dumps([[list(map(int, it)) for it in ctx.traced_items],
                          [list(g) for g in ctx.geom_args]])
    assert hashlib.sha256(readers.encode()).hexdigest() == readers_sha
    digest = hashlib.sha256()
    for w in r['where']:
        for k in outputs:
            digest.update(np.ascontiguousarray(w['got'][k],
                                               np.float64).tobytes())
    build = (torch.__version__, torch.backends.cpu.get_cpu_capability())
    if build == RECORDED_ON:
        assert digest.hexdigest() == spectra_sha
    else:
        print(f'spectra digest not compared: torch {build}, recorded on '
              f'{RECORDED_ON}')


PAIR = '''"""Each spectrum the weighted sum of two pool atmospheres' scenes at
one geometry: a disk of two facets."""

from benchmark.harness.kind import Kind


class Requests(Kind):

    def plan(self):
        per = self.req['atmospheres']
        return [[[(a, 0), (a + 1, 0)] for a in range(i, i + per, 2)]
                for i in range(0, len(self.pool), per)]

    def forward(self, batch):
        out = self.port.forward_batch(batch)
        w0, w1 = self.req['weights']
        return {k: w0 * out[k][0::2] + w1 * out[k][1::2]
                for k in self.port.outputs}

    def reference(self, scenes, *args):
        w0, w1 = self.req['weights']
        r0, r1 = (self.scene_reference(s, *args) for s in scenes)
        return {k: w0 * r0[k] + w1 * r1[k] for k in r0}
'''


def _pair_root(tmp_path):
    root = tiny_root(tmp_path)
    bench_dir = os.path.join(root, 'benchmark')
    with open(os.path.join(bench_dir, 'requests', 'pair.py'), 'w') as f:
        f.write(PAIR)
    with open(os.path.join(bench_dir, 'traffic', 'grid16.json')) as f:
        mix = json.load(f)
    mix.update(name='pair8', pool=8)
    mix['request'].update(kind='pair', atmospheres=4, weights=[0.7, 0.3])
    with open(os.path.join(bench_dir, 'traffic', 'pair8.json'), 'w') as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, 'limits',
                           'picaso_r15k_toon.pair8.json'), 'w') as f:
        json.dump({'limits': dict.fromkeys(check.names(
            tuple(mix['request']['outputs'])), 1e-4)}, f)
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    bench['workloads'].append({'name': 'picaso_r15k_toon.pair8',
                               'config': 'picaso_r15k_toon',
                               'traffic': 'pair8', 'chips': 1,
                               'why': 'a test'})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    return root


def test_a_kind_that_exists_only_as_a_file(tmp_path, context):
    root = _pair_root(tmp_path)
    r = run_cell(Spec(root), 'picaso_r15k_toon.pair8', SEED, 0.3, True,
                 'cpu', time.perf_counter(), readings=True)
    assert r['correct'] and r['failed'] == 0
    ctx = context['ctx']
    # both scenes of every traced spectrum, in the order run
    assert ctx.traced_items and len(ctx.traced_items) % 2 == 0
    for (a0, p0), (a1, p1) in zip(ctx.traced_items[0::2],
                                  ctx.traced_items[1::2]):
        assert (a0 % 2, a1, p0, p1) == (0, a0 + 1, 0, 0)
    # the kind's own reference: 0.7 and 0.3 of its two facets'
    w = r['where'][0]
    assert len(w['scenes']) == 2
    f0, f1 = (_facet(root, sc)['albedo'] for sc in w['scenes'])
    assert np.array_equal(w['want']['albedo'], 0.7 * f0 + 0.3 * f1)
    assert np.abs(f0 - f1).max() > 1e-3 * np.abs(f0).max()


def _facet(root, scene):
    """The reference's spectrum of one scene of the pair8 mix."""
    from benchmark.harness import inputs
    spec = Spec(root)
    cfg = spec.config('picaso_r15k_toon')
    traffic = spec.traffic('pair8')
    kind = spec.requests(traffic)(cfg, traffic,
                                  inputs.pool(cfg, traffic, SEED))
    table = inputs.table(spec.dir, cfg, SEED, 'cpu')
    return kind.scene_reference(tuple(scene), table, inputs.planet(cfg),
                                check.options(cfg), ('albedo',), 'cpu',
                                'f64')


def test_a_kind_file_catches_an_altered_spectrum(tmp_path, monkeypatch):
    from benchmark.harness import port
    original = port.Port.forward_batch

    def altered(self, stacked):
        out = original(self, stacked)
        for v in out.values():
            v[-1] *= 1.01
        return out
    monkeypatch.setattr(port.Port, 'forward_batch', altered)
    root = _pair_root(tmp_path)
    assert run_cell(Spec(root), 'picaso_r15k_toon.pair8', SEED, 0.3,
                    False, 'cpu', time.perf_counter())['correct'] is False


@pytest.mark.parametrize('cell,int16,gather', [
    ('picaso_r15k_toon.int16grid16', False, 'interp_tau_q'),
    ('picaso_r15k_toon.grid16', True, 'interp_tau_q'),
    ('picaso_r15k_toon.grid16', False, 'interp_tau')])
def test_program_table_routes_the_gather(tmp_path, monkeypatch, context,
                                         cell, int16, gather):
    """An int16 traffic (or readings.py's ``--int16``) gathers from the
    program's int16 table through K8's twin, a float one through K1's,
    and both are correct under the cell's limits."""
    from picaso_tpu_torch import pipeline
    calls = {'interp_tau': 0, 'interp_tau_q': 0}
    for name in calls:
        def spy(*a, _f=getattr(pipeline, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(pipeline, name, spy)
    root = tiny_root(tmp_path)
    r = run_cell(Spec(root), cell, SEED, 0.3, False, 'cpu',
                 time.perf_counter(), int16=int16)
    assert r['correct'], r['checks']
    assert calls[gather] > 0
    assert calls[({'interp_tau', 'interp_tau_q'} - {gather}).pop()] == 0
    assert context['ctx'].program_table == (
        'int16' if gather == 'interp_tau_q' else 'float32')


def test_program_table_names_only_int16():
    cfg = {'table_dtype': 'float32'}
    assert program_table_of(cfg, {}) == 'float32'
    assert program_table_of(cfg, {}, int16=True) == 'int16'
    assert program_table_of(cfg, {'program_table': 'int16'}) == 'int16'
    with pytest.raises(ValueError):
        program_table_of(cfg, {'program_table': 'float16'})
