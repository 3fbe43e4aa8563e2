"""The JAX package's runs of the mesh and photochemistry examples: the
record the port's copies of them are held to (tests/test_torch_examples.py
on the CPU, chip_smoke.py's phase 49 on the card).

Runs ``examples/mesh_sharded_retrieval_climate.py`` and
``examples/photochem_coupled_climate.py`` as scripts on the CPU, each in a
process of its own, once with ``JAX_ENABLE_X64=1`` (``x64``) and once in
their float32 default (``f32``), and records per example and precision
the exit code, every line printed on standard output and the wall
seconds, with the commit and the date of the run.  The four runs take
about a minute each, two at a time.  Not a test.

    python tests/examples_record.py --save tests/examples_reference.json
"""

import argparse
import concurrent.futures
import datetime
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

EXAMPLES = ('mesh_sharded_retrieval_climate.py',
            'photochem_coupled_climate.py')
PRECISIONS = {'x64': '1', 'f32': '0'}


def run(name, x64):
    """One JAX example as a script: its exit code, printed lines and wall
    seconds."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', JAX_ENABLE_X64=x64)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, 'examples',
                                                        name)],
                          capture_output=True, text=True, cwd=ROOT, env=env)
    return dict(returncode=proc.returncode, lines=proc.stdout.splitlines(),
                seconds=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--save', help='write the JSON here')
    args = ap.parse_args()
    runs = [(name, prec) for name in EXAMPLES for prec in PRECISIONS]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        outs = list(pool.map(lambda r: run(r[0], PRECISIONS[r[1]]), runs))
    record = {name: {} for name in EXAMPLES}
    for (name, prec), out in zip(runs, outs):
        record[name][prec] = out
        print(f'{name} {prec}: exit {out["returncode"]}, '
              f'{out["seconds"]:.1f} s', flush=True)
    commit = subprocess.run(['git', 'rev-parse', 'HEAD'], capture_output=True,
                            text=True, cwd=ROOT).stdout.strip()
    record['commit'] = commit
    record['date'] = datetime.date.today().isoformat()
    text = json.dumps(record, indent=1, sort_keys=True)
    if args.save:
        with open(args.save, 'w') as f:
            f.write(text + '\n')
    else:
        print(text)


if __name__ == '__main__':
    main()
