"""Tracing, profiling, and structured run logs.

Port of ``picaso_tpu/profiling.py`` to PyTorch:

- :func:`trace` -- context manager around ``torch.profiler`` writing a
  Chrome trace (host ops, and the card's kernels where there is a card)
  into the given directory;
- :class:`Timer` / :func:`device_timer` -- wall timers that synchronise
  the device of the tensors handed to them (``torch.cuda.synchronize``),
  so numbers mean "device work finished", not "launch enqueued"; on the
  CPU the host clock alone;
- :func:`cost_analysis` -- the floating-point operations of ``fn(*args)``
  counted by ``torch.utils.flop_counter.FlopCounterMode``;
- :class:`RunLog` -- append-only JSONL structured logs, taking numpy
  arrays and torch tensors;
- :func:`span` -- a named span of the program (``picaso.forward_batch``,
  ``picaso.gather``, ...) in the trace of an active ``torch.profiler``
  profile, on the clock of the card's kernels; a shared no-op otherwise;
- :func:`counted`, :func:`counters`, :func:`reset_counters` -- calls and
  host seconds of a function, counted always (``scene_from_arrays``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time

import numpy as np
import torch

__all__ = ['trace', 'Timer', 'device_timer', 'cost_analysis', 'RunLog',
           'span', 'counted', 'counters', 'reset_counters']

_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_COUNTERS = {}


def _cuda_devices(obj, found=None):
    """The CUDA devices of the tensors in ``obj`` and in its nested lists,
    tuples (named tuples too) and dicts."""
    found = set() if found is None else found
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


def _synchronize(obj):
    for device in _cuda_devices(obj):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(logdir='picaso_tpu_torch_trace', host=True):
    """Profile the enclosed block with ``torch.profiler`` and write a
    Chrome trace (``trace.json``, open in Perfetto or chrome://tracing)
    into ``logdir``.  Host ops are always recorded and the card's kernels
    where CUDA is available; ``host=False`` drops the Python stacks
    (smaller files)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_stack=host) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


class Timer:
    """Accumulating device-synced timer.

    >>> t = Timer()
    >>> with t('forward') as h:
    ...     h.append(forward(...))   # synchronised on __exit__
    >>> t.times['forward']
    """

    def __init__(self):
        self.times = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.perf_counter()
        holder = []
        try:
            yield holder
        finally:
            _synchronize(holder)
            elapsed = time.perf_counter() - start
            self.times[name] = self.times.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {k: {'total_s': v, 'calls': self.counts[k],
                    'mean_s': v / self.counts[k]}
                for k, v in self.times.items()}


def device_timer(fn, *args, iters=5, warmup=1, perturb=None, **kwargs):
    """Steady-state seconds per call of ``fn``: the host clock over
    ``iters`` calls, ended by a ``torch.cuda.synchronize`` of the devices
    of the outputs (none on the CPU).

    ``perturb``: optional callable ``i -> replacement first arg`` so each
    iteration works on distinct inputs."""
    for _ in range(warmup):
        _synchronize(fn(*args, **kwargs))
    start = time.perf_counter()
    out = None
    for i in range(iters):
        a = (perturb(i),) + args[1:] if perturb is not None else args
        out = fn(*a, **kwargs)
    _synchronize(out)
    return (time.perf_counter() - start) / iters


def cost_analysis(fn, *args, **kwargs):
    """Floating-point operations of ``fn(*args, **kwargs)``, counted per
    aten call by ``torch.utils.flop_counter.FlopCounterMode``:
    ``{'flops': n}`` (a multiply-add is 2).  The counter knows matmuls,
    convolutions and attention; XLA's ``bytes_accessed`` and
    ``transcendentals`` of the JAX function have no counterpart here."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {'flops': counter.get_total_flops()}


class RunLog:
    """Structured JSONL run log (one JSON object per line).

    The queryable analog of the reference's ``verbose`` prints: arrays
    (numpy or torch) of up to 16 values are stored whole, larger ones as
    shape, min, max and mean.
    """

    def __init__(self, path=None):
        self.path = path
        self.records = []

    def log(self, event, **fields):
        rec = {'event': event, 't': time.time()}
        for k, v in fields.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if isinstance(v, np.ndarray):
                rec[k] = (float(v) if v.ndim == 0
                          else v.tolist() if v.size <= 16
                          else {'shape': list(v.shape),
                                'min': float(v.min()),
                                'max': float(v.max()),
                                'mean': float(v.mean())})
            else:
                rec[k] = v
        self.records.append(rec)
        if self.path:
            with open(self.path, 'a') as f:
                f.write(json.dumps(rec) + '\n')
        return rec

    def __iter__(self):
        return iter(self.records)


def span(name):
    """A span of the program named ``name`` (``picaso.<stage>``): while a
    ``torch.profiler`` profile records, ``record_function(name)``, which
    writes into the trace beside the card's kernels and runtime calls and
    takes its parent from the spans open on the calling thread; else one
    shared no-op context, so an unprofiled call pays a flag check (a bare
    ``record_function`` costs microseconds even with no profiler)."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def counted(name):
    """Decorator: each call of the function runs inside
    ``span('picaso.' + name)`` and adds one call and its host seconds to
    ``counters()[name]``.  The count is always on: two
    ``time.perf_counter()`` reads a call, for functions that take
    milliseconds and run where no profile records (set-up)."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            start = time.perf_counter()
            with span('picaso.' + name):
                out = fn(*args, **kwargs)
            c = _COUNTERS.setdefault(name, {'calls': 0, 'seconds': 0.0})
            c['calls'] += 1
            c['seconds'] += time.perf_counter() - start
            return out
        return timed
    return wrap


def counters():
    """``{name: {'calls': n, 'seconds': s}}`` of every :func:`counted`
    function called since the process started or the last
    :func:`reset_counters` (a copy)."""
    return {k: dict(v) for k, v in _COUNTERS.items()}


def reset_counters():
    """Clear every counter of :func:`counters`."""
    _COUNTERS.clear()
