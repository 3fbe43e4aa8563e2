"""The command line of ``benchmark/run.py``."""

from __future__ import annotations

import argparse
import json
import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'picaso_tpu')


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``picaso_tpu_torch`` is not ``picaso_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names
                   if m.split('.')[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(prog='benchmark/run.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def check_lines(result):
    """The compared numbers beside their limits, one line each."""
    return [f'check {k}: {v["value"]!r} limit {v["limit"]!r} '
            f'{"ok" if v["value"] <= v["limit"] else "FAIL"}'
            for k, v in result['checks'].items()]


def main(argv, root, t_start):
    args = parse(argv)
    import torch
    if not torch.cuda.is_available():
        print('benchmark: no CUDA device; the benchmark runs only on the '
              'card', file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from .cell import run_cell
    from .spec import Spec
    spec = Spec(root)
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell['chips']:
        print(f'benchmark: {args.workload} needs {cell["chips"]} cards, '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), 'cuda', t_start)
    found = forbidden_modules()
    if found:
        print(f'benchmark: loaded {", ".join(found)}; the port may not '
              f'use JAX or the JAX package', file=sys.stderr)
        return 3
    for line in check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
