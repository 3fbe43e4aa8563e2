"""One run of one cell: set-up, warm-up, the measured window (its first
requests traced with ``--trace 1``), then the check against the
reference and the metrics, each read by its own reader."""

from __future__ import annotations

import gc
import sys
import time
from contextlib import nullcontext
from typing import Any, Dict, List

import numpy as np
import torch

from . import check, inputs, trace
from .port import Port
from ..reference import spectrum as ref


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _span(name, on):
    return torch.profiler.record_function(name) if on else nullcontext()


class Window:
    """What the measured window did."""

    def __init__(self):
        self.latencies: List[float] = []
        self.spectra = 0
        self.failed = 0
        self.seconds = 0.0
        self.host_spans = []      # (forward_batch host s, spectra, traced)


class Context:
    """What a metric's reader reads: the cell's definitions, the window,
    the set-up time, the trace and the raw inputs of the traced
    spectra: ``traced_items``, the scenes the program ran for them
    (``(pool atmosphere, geometry index)``, flattened; the index into
    ``geom_args``); ``program_table``, the table the program gathers
    from."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self._derived = {}

    def derived(self, i):
        """The reference's scene of pool atmosphere ``i``."""
        if i not in self._derived:
            self._derived[i] = ref.derive(self.pool[i], self.table,
                                          self.planet)
        return self._derived[i]

    def kernel_s(self, layer):
        """Device seconds of the traced kernels of ``layer``."""
        return sum((ev.end - ev.start) * 1e-6 for ev in self.trace.kernels
                   if trace.layer_of(ev.name, self.layers) == layer)


def _log(msg):
    print(f'[bench {time.strftime("%H:%M:%S")}] {msg}', file=sys.stderr,
          flush=True)


# a window too short for two requests still measures two
MIN_REQUESTS = 2


def program_table_of(cfg, traffic, int16=False):
    """The table the program gathers from: the traffic's
    ``program_table`` (only ``int16``, the program's quantised table, is
    named), else the configuration's ``table_dtype``; ``int16`` forces
    the quantised one."""
    named = traffic.get('program_table')
    if named not in (None, 'int16'):
        raise ValueError(f'program_table {named!r}: only "int16" is known')
    return 'int16' if int16 or named else cfg['table_dtype']


def run_cell(spec, name, seed, seconds, traced, device, t_start,
             controls=(), int16=False, readings=False,
             every=False) -> Dict[str, Any]:
    """Run cell ``name`` once; the result line's object.  For
    ``readings.py``: ``controls``, precisions of the reference (``'f32'``,
    ``'bf16'``, ``'f16'``, ``'tf32'``) whose gaps on the same sample go under
    ``control_checks``; ``int16``, the program on its int16 table (what
    a traffic's ``program_table`` ``int16`` asks for; on such a cell it
    changes nothing);
    ``readings``, every number's reading under ``readings`` and the
    sample's spectra under ``where``; ``every``, a sample of every
    spectrum of each request's last run in place of the seeded one."""
    cell = spec.cell(name)
    cfg = spec.config(cell['config'])
    traffic = spec.traffic(cell['traffic'])
    limits = spec.limits(name)
    outputs = tuple(traffic['request']['outputs'])
    dev = torch.device(device)
    program_table = program_table_of(cfg, traffic, int16)

    _log(f'{name} seed {seed}: set-up from {time.perf_counter() - t_start:.2f} s')
    table = inputs.table(spec.dir, cfg, seed, dev)
    _sync(dev)
    _log(f'table {tuple(table.log_kappa.shape)} at '
         f'{time.perf_counter() - t_start:.2f} s')
    planet = inputs.planet(cfg)
    pool = inputs.pool(cfg, traffic, seed)
    port = Port(table, planet, cfg, outputs, dev,
                int16=program_table == 'int16')
    kind = spec.requests(traffic)(cfg, traffic, pool)
    kind.setup(port)

    _log(f'{len(pool)} scenes at {time.perf_counter() - t_start:.2f} s')
    rng = np.random.default_rng([seed, 2])

    def order():
        while True:
            yield from rng.permutation(len(kind.spectra)).tolist()
    next_group = order()
    win = Window()
    sampler = check.Sampler(traffic['check']['requests'], seed)
    last = {}

    def one(gi, timed=True, spans=False):
        t0 = time.perf_counter()
        try:
            with _span(trace.REQUEST, spans):
                with _span('bench.stack_scenes', spans):
                    st = kind.batch(gi)
                with _span('bench.forward_batch', spans):
                    tf = time.perf_counter()
                    out = kind.forward(st)
                    tf = time.perf_counter() - tf
                with _span('bench.to_host', spans):
                    host = {k: v.cpu() for k, v in out.items()}
        except Exception:  # a failed request counts, the run goes on
            if not timed:
                raise
            win.failed += 1
            win.latencies.append(time.perf_counter() - t0)
            return
        t1 = time.perf_counter()
        if timed:
            win.latencies.append(t1 - t0)
            win.spectra += len(kind.spectra[gi])
            win.host_spans.append((tf, len(kind.spectra[gi]), spans))
            sampler.offer((gi, host))
            last[gi] = host
        return t1

    # warm-up: every shape the traffic uses (all requests share one)
    for _ in range(2):
        one(next(next_group), timed=False)
    if traced:
        trace.record(lambda: one(next(next_group), timed=False, spans=True))
    _sync(dev)
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == 'cuda' else 0)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    tr, traced_groups, t_end = None, [], t0
    if traced:
        def block():
            for _ in range(traffic['trace']['requests']):
                gi = next(next_group)
                traced_groups.append(gi)
                one(gi, spans=True)
        tr = trace.record(block)
        t_end = time.perf_counter()
    while (t_end - t0 < seconds
           or len(win.latencies) < MIN_REQUESTS):
        t_end = one(next(next_group)) or time.perf_counter()
    win.seconds = t_end - t0
    _sync(dev)
    _log(f'window {win.seconds:.3f} s, {len(win.latencies)} requests, '
         f'set-up {setup_s:.2f} s')
    window_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == 'cuda' else 0)

    # the program's state goes before the reference runs
    kept = sorted(last.items()) if every else sampler.kept
    kind.release()
    del port
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    pick = np.random.default_rng([seed, 4])
    samples = []
    for gi, host in kept:
        n_spec = len(kind.spectra[gi])
        k = n_spec if every else min(n_spec, traffic['check']['spectra'])
        for j in sorted(pick.choice(n_spec, k, replace=False).tolist()):
            samples.append((kind.spectra[gi][j],
                            {k: host[k][j].numpy() for k in outputs},
                            (gi, j)))
    opts = check.options(cfg)
    t_ref = time.perf_counter()
    wants = check.reference(kind, samples, table, planet, opts, outputs,
                            dev)
    gots = [got for _, got, _ in samples]
    gaps = check.compare(gots, wants, outputs)
    _sync(dev)
    _log(f'reference on {len(samples)} spectra: '
         f'{time.perf_counter() - t_ref:.2f} s')
    # the limits file names the numbers compared; the others are readings
    checks = {k: {'value': gaps[k], 'limit': v} for k, v in limits.items()}
    control_checks, lows = {}, {}
    for precision in controls:
        lows[precision] = check.reference(kind, samples, table, planet,
                                          opts, outputs, dev, precision)
        control_checks[precision] = check.compare(lows[precision], wants,
                                                  outputs)
    correct = (win.failed == 0 and bool(samples)
               and all(v['value'] <= v['limit'] for v in checks.values()))

    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, peaks=spec.peaks(),
                  layers=spec.layers(), window=win, setup_s=setup_s,
                  trace=tr, window_peak=window_peak, table=table,
                  planet=planet, pool=pool, opts=opts, outputs=outputs,
                  geom_args=kind.geom_args, program_table=program_table,
                  traced_items=[sc for gi in traced_groups
                                for sc in kind.scenes(gi)], device=dev)
    group = 'per_layer' if traced else 'end_to_end'
    metrics = {}
    for m in spec.metrics(group, name):
        value = spec.reader(m['name'])(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {'correct': correct, 'attempted': len(win.latencies),
              'failed': win.failed, 'metrics': metrics,
              'device': _device(dev, cell, max(setup_peak, window_peak))}
    if tr is not None:
        busy = trace.busy_intervals(tr.device, tr.window)
        result['device']['busy_s'] = sum(e - s for s, e in busy) * 1e-6
        result['device']['window_s'] = (tr.window[1] - tr.window[0]) * 1e-6
        result['breakdown'] = trace.breakdown(tr)
    if readings:
        result['control_checks'] = control_checks
        result['readings'] = gaps
        result['where'] = [dict(request=gj[0], spectrum=gj[1],
                                scenes=scenes, got=got, want=want,
                                **{c: lows[c][i] for c in lows})
                           for i, ((scenes, got, gj), want)
                           in enumerate(zip(samples, wants))]
    result['checks'] = checks
    return result


def _device(dev, cell, peak):
    if dev.type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
                'count': cell['chips'], 'memory_peak_bytes': int(peak)}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': 0}
