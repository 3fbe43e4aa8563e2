"""picaso_tpu_torch.profiling: the counterparts of tests/test_profiling.py
(Timer, device_timer, cost_analysis, RunLog, trace), on the CPU, with the
RunLog records held against the JAX package's for the same fields."""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from picaso_tpu import profiling as jprof

from picaso_tpu_torch import profiling


def test_timer_accumulates():
    t = profiling.Timer()
    with t('work') as h:
        h.append(torch.ones(128) * 2)
    with t('work') as h:
        h.append({'out': (torch.ones(128) * 3,)})
    s = t.summary()
    assert s['work']['calls'] == 2
    assert s['work']['total_s'] > 0
    assert s['work']['mean_s'] == s['work']['total_s'] / 2


def test_device_timer_perturbed():
    dt = profiling.device_timer(lambda x: (x ** 2).sum(),
                                torch.arange(256.0), iters=3,
                                perturb=lambda i: torch.arange(256.0) + i)
    assert dt > 0


def test_cost_analysis_flops():
    a = torch.ones((64, 64))
    cost = profiling.cost_analysis(lambda x, y: x @ y, a, a)
    assert cost['flops'] >= 2 * 64 ** 3
    assert set(cost) == {'flops'}


def test_runlog_jsonl_matches_jax(tmp_path):
    fields = dict(it=0, mean_dT=12.5, nstr=[0, 20, 39],
                  small=np.array([1.0, 2.0]), scalar=np.float64(3.0))
    big = np.linspace(100, 500, 40)
    path = tmp_path / 'run.jsonl'
    log = profiling.RunLog(str(path))
    log.log('climate_iteration', temperature=torch.tensor(big),
            **{k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
               for k, v in fields.items()})
    log.log('converged', it=3)
    want = jprof.RunLog().log('climate_iteration',
                              temperature=jnp.asarray(big), **fields)
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == 2 and len(list(log)) == 2
    for rec in (lines[0], want):
        rec.pop('t')
    assert lines[0] == json.loads(json.dumps(want))
    assert lines[0]['temperature']['shape'] == [40]
    assert lines[0]['temperature']['min'] == 100.0
    assert lines[1]['it'] == 3


def test_trace_writes(tmp_path):
    with profiling.trace(str(tmp_path / 'tr')) as d:
        torch.ones(64).sum()
    files = [f for _, _, fs in os.walk(d) for f in fs]
    assert files == ['trace.json']
    with open(os.path.join(d, 'trace.json')) as f:
        assert 'traceEvents' in json.load(f)
