"""``BENCHMARK.json`` and the data files that the harness finds by name
under the benchmark's folder:

* ``configs/<config>.json``: the deployment (file named in BENCHMARK.json);
* ``traffic/<mix>.json``: a traffic mix's parameters; its
  ``request.kind`` names the request kind (``disk`` where absent), its
  ``program_table`` the table the program gathers from (``int16``: the
  program's quantised table; absent: the configuration's
  ``table_dtype``);
* ``requests/<kind>.py``: a request kind, its class ``Requests``
  (``harness/kind.py``): how requests are made of the pool, run and
  worked out again by the reference;
* ``limits/<config>.<mix>.json``: the limits ``correct`` is held to;
* ``layers/<layer>.json``: a layer's kernel-name patterns;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
* ``data/peaks.json``: the card's published peaks.

A later cell, mix or metric is a new file here; no code changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Any, Dict, List


class Spec:
    """The benchmark's definition, rooted at a checkout (or any directory
    that holds ``BENCHMARK.json`` and the benchmark's folder)."""

    def __init__(self, root):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, 'benchmark')
        with open(os.path.join(self.root, 'BENCHMARK.json')) as f:
            self.bench = json.load(f)

    def _json(self, *parts):
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def cell(self, name) -> Dict[str, Any]:
        for cell in self.bench['workloads']:
            if cell['name'] == name:
                return cell
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, name) -> Dict[str, Any]:
        for cfg in self.bench['configs']:
            if cfg['name'] == name:
                with open(os.path.join(self.root, cfg['file'])) as f:
                    return json.load(f)
        raise KeyError(f'no config {name!r} in BENCHMARK.json')

    def traffic(self, name) -> Dict[str, Any]:
        return self._json('traffic', f'{name}.json')

    def limits(self, cell) -> Dict[str, float]:
        return self._json('limits', f'{cell}.json')['limits']

    def peaks(self) -> Dict[str, Any]:
        return self._json('data', 'peaks.json')

    def layers(self):
        """[(layer, [compiled patterns], fallback)] of every layer file,
        in name order; the fallback layer takes what no other matches."""
        out = []
        folder = os.path.join(self.dir, 'layers')
        for fname in sorted(os.listdir(folder)):
            if fname.endswith('.json'):
                d = self._json('layers', fname)
                out.append((d['layer'], [re.compile(p) for p in
                                         d.get('kernels', [])],
                            bool(d.get('fallback', False))))
        return out

    def metrics(self, kind, cell) -> List[Dict[str, Any]]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
        reports."""
        return [m for m in self.bench[kind]
                if cell in m.get('workloads', [cell])]

    def _module(self, folder, name):
        path = os.path.join(self.dir, folder, f'{name}.py')
        spec = importlib.util.spec_from_file_location(
            f'benchmark_{folder}_{name.replace(".", "_")}', path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        return self._module('metrics', metric).read

    def requests(self, traffic):
        """The ``Requests`` class of the traffic's request kind,
        ``requests/<kind>.py``."""
        return self._module('requests',
                            traffic['request'].get('kind', 'disk')).Requests
