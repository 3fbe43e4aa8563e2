"""The device trace of a stretch of requests: ``torch.profiler`` with the
CPU and CUDA activities, exported as a Chrome trace to the run's temporary
directory, read back and deleted.  From it: the kernels by name and layer,
the device's busy time (the union of kernel, copy and set intervals), the
idle gaps and what the host was doing in each."""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import List, NamedTuple

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
REQUEST = 'bench.request'


class Event(NamedTuple):
    name: str
    start: float      # us
    end: float        # us
    cat: str


class Trace(NamedTuple):
    kernels: List[Event]
    device: List[Event]      # kernels, copies and sets
    host: List[Event]        # the requesting thread's CPU-side events
    window: tuple            # (start, end) us: first request to last end


def record(fn):
    """Run ``fn()`` under the profiler; the :class:`Trace` of it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    return parse(raw)


def parse(raw):
    events = raw['traceEvents'] if isinstance(raw, dict) else raw
    device, host_all, requests = [], [], []
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        ev = Event(e.get('name', ''), float(e['ts']),
                   float(e['ts']) + float(e['dur']), e.get('cat', ''))
        if ev.cat in DEVICE_CATS:
            device.append(ev)
        else:
            host_all.append((e.get('pid'), e.get('tid'), ev))
            if ev.name == REQUEST:
                requests.append((e.get('pid'), e.get('tid'), ev))
    if not requests:
        raise RuntimeError('the trace holds no request span')
    thread = requests[0][:2]
    host = sorted((ev for pid, tid, ev in host_all
                   if (pid, tid) == thread), key=lambda ev: ev.start)
    start = min(ev.start for _, _, ev in requests)
    end = max([ev.end for _, _, ev in requests]
              + [ev.end for ev in device])
    device = sorted((ev for ev in device if ev.end > start),
                    key=lambda ev: ev.start)
    kernels = [ev for ev in device if ev.cat == 'kernel']
    return Trace(kernels, device, host, (start, end))


def busy_intervals(events, window):
    """The union of the events' intervals, clipped to the window."""
    lo, hi = window
    merged = []
    for ev in events:
        s, e = max(ev.start, lo), min(ev.end, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def gaps(merged, window):
    """The idle stretches [(start, end)] between busy intervals."""
    out, t = [], window[0]
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def host_at(host, times):
    """For each time (ascending), the host's stack there, as
    'outer > inner' of the benchmark's spans and the innermost operator."""
    labels, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i].start <= t:
            while stack and stack[-1].end < host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        # events that began before t and ended before it were popped;
        # nested ones still open cover t
        live = [ev for ev in stack if ev.end >= t]
        spans = [ev.name[len('bench.'):] for ev in live
                 if ev.name.startswith('bench.')]
        ops = [ev.name for ev in live if not ev.name.startswith('bench.')]
        label = ' > '.join(spans[-2:] + ops[-1:]) or 'between requests'
        labels.append(label)
    return labels


def short_name(name):
    """A kernel's name without its return type and argument list."""
    name = re.sub(r'^void\s+', '', name.replace('(anonymous namespace)::',
                                                 ''))
    depth, out = 0, []
    for ch in name:
        if ch == '(' and depth == 0:
            break
        depth += ch == '<'
        depth -= ch == '>'
        out.append(ch)
    return ''.join(out).strip()[:120]


def breakdown(tr: Trace, top=10):
    """{'device_ops': [[name, s]], 'idle_gaps': [[host activity, s]]}:
    the kernels, copies and sets that took most device time, and the
    idle time summed by what the host was doing at each gap's middle."""
    by_op = defaultdict(float)
    for ev in tr.device:
        by_op[short_name(ev.name)] += (ev.end - ev.start) * 1e-6
    merged = busy_intervals(tr.device, tr.window)
    idle = gaps(merged, tr.window)
    labels = host_at(tr.host, [(s + e) / 2 for s, e in idle])
    by_host = defaultdict(float)
    for (s, e), label in zip(idle, labels):
        by_host[label] += (e - s) * 1e-6
    rank = (lambda d: [[k, v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:top]])
    return {'device_ops': rank(by_op), 'idle_gaps': rank(by_host)}


def layer_of(name, layers):
    """The layer of a kernel: the first non-fallback layer with a matching
    pattern, else the fallback layer."""
    fallback = None
    for layer, patterns, is_fallback in layers:
        if is_fallback:
            fallback = layer
        elif any(p.search(name) for p in patterns):
            return layer
    return fallback
