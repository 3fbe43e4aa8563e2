"""A copy of the benchmark's definition, cut to a width and a pool the
CPU runs in seconds, in a temporary directory: the data files are the
committed ones with a few numbers changed, the code is not copied."""

from __future__ import annotations

import json
import math
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIRS = ('configs', 'traffic', 'limits', 'layers', 'metrics', 'data',
             'requests')


def tiny_root(tmp, levels=31, resolution=1000.0, band=(1.0, 1.1), pool=4,
              per_grid=2, phases=(0, 60, 120)):
    """A root with BENCHMARK.json and the benchmark's data files, at
    ``resolution`` over ``band`` (um), ``levels`` levels, a pool of
    ``pool`` atmospheres, ``per_grid`` of them to a request of one
    phase."""
    tmp = str(tmp)
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp)
    for d in DATA_DIRS:
        shutil.copytree(os.path.join(ROOT, 'benchmark', d),
                        os.path.join(tmp, 'benchmark', d),
                        ignore=shutil.ignore_patterns('__pycache__'))
    nwno = int(math.floor(resolution * math.log(band[1] / band[0]))) + 1
    for name in os.listdir(os.path.join(tmp, 'benchmark', 'configs')):
        edit(tmp, 'configs', name, wavelength_um=list(band),
             resolution=resolution, nwno=nwno, levels=levels)
    # every mix: a phase curve keeps its atmospheres and takes
    # ``phases``, any other takes ``per_grid`` atmospheres a request
    for name in os.listdir(os.path.join(tmp, 'benchmark', 'traffic')):
        with open(os.path.join(tmp, 'benchmark', 'traffic', name)) as f:
            curve = len(json.load(f)['request']['phases_deg']) > 1
        if curve:
            edit(tmp, 'traffic', name, pool=pool,
                 request_phases_deg=list(phases), trace_requests=1)
        else:
            edit(tmp, 'traffic', name, pool=pool,
                 request_atmospheres=per_grid, trace_requests=1)
    return tmp


def edit(root, folder, name, **changes):
    """Set keys of a data file; ``a_b=v`` sets ``d['a']['b']`` where
    ``d['a']`` is a dict."""
    path = os.path.join(root, 'benchmark', folder, name)
    with open(path) as f:
        d = json.load(f)
    for key, value in changes.items():
        head, _, rest = key.partition('_')
        if rest and isinstance(d.get(head), dict):
            d[head][rest] = value
        else:
            d[key] = value
    with open(path, 'w') as f:
        json.dump(d, f)
