"""The readings the limits of ``correct`` are set from: one cell over
many seeds in one process (the set-up of each seed as a run makes it),
each seed a short window at the cell's own load and the check of its
sample.  Every number is read, compared or not.  ``--controls`` reads
the same sample against the reference in lower precisions: ``bf16``,
``f16`` and ``tf32``, the controls, and ``f32``, the reference in float32
as it is (a witness for float32's own rounding).  ``--int16`` runs the
program on its own int16 table (K8), the other control; on a cell whose
traffic names ``program_table`` ``int16`` the program runs on that table
already, and ``--int16`` changes nothing.  ``--every``
checks every spectrum of each request's last run in place of the
window's sample.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--controls bf16,f16,f32] [--int16] [--every] \\
        [--out r.jsonl]

One JSON line per seed on standard output (and appended to --out).  Its
``where`` gives, per output and sampled spectrum, the program's widest
gap over the peak and the wavenumber index where it lies, and the same
of each control."""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def widest(got, want):
    """(gap over the peak, its wavenumber index) of ``got`` from
    ``want``."""
    diff = np.abs(np.asarray(got, np.float64) - want)
    i = int(np.argmax(diff))
    return float(diff[i] / (np.abs(want).max() + 1e-300)), i


def where(samples, controls):
    """{output: [per sampled spectrum: its request, its index there, its
    scenes, the program's and each control's (gap, index)]}."""
    out = {}
    for s in samples:
        for k, want in s['want'].items():
            row = {'request': s['request'], 'spectrum': s['spectrum'],
                   'scenes': s['scenes'],
                   'program': widest(s['got'][k], want)}
            for c in controls:
                row[c] = widest(s[c][k], want)
            out.setdefault(k, []).append(row)
    return out


def main(argv):
    p = argparse.ArgumentParser(prog='benchmark/readings.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--controls', default='')
    p.add_argument('--int16', action='store_true')
    p.add_argument('--every', action='store_true')
    p.add_argument('--out')
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('readings: no CUDA device', file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from benchmark.harness.cell import program_table_of, run_cell
    from benchmark.harness.spec import Spec
    spec = Spec(ROOT)
    controls = tuple(c for c in args.controls.split(',') if c)
    cell = spec.cell(args.workload)
    program = program_table_of(spec.config(cell['config']),
                               spec.traffic(cell['traffic']), args.int16)
    for seed in [int(s) for s in args.seeds.split(',')]:
        t0 = time.perf_counter()
        r = run_cell(spec, args.workload, seed, args.seconds, False, 'cuda',
                     t0, controls=controls, int16=args.int16,
                     readings=True, every=args.every)
        line = json.dumps({
            'workload': args.workload, 'seed': seed,
            'program': program,
            'correct': r['correct'], 'attempted': r['attempted'],
            'readings': r['readings'], 'controls': r['control_checks'],
            'where': where(r['where'], controls),
            'metrics': {k: v['value'] for k, v in r['metrics'].items()},
            'kind': r['device']['kind'],
            'seconds': time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
