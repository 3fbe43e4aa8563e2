"""Example-script integration runner.

Port of ``picaso_tpu/integration_testing.py`` pointed at the port's own
examples, ``picaso_tpu_torch/examples/`` (copies of the repository's
``examples/*.py`` that import ``picaso_tpu_torch`` and run on the card;
console script ``picaso-tpu-torch-integration``).  As there: the
reference executes its documentation notebooks end-to-end via jupytext +
nbconvert (integration_testing.py:1-108, console script
``picaso-notebooks``); this module runs each plain example script in an
isolated process and reports pass/fail -- the same smoke-test role, with
no notebook toolchain dependency.

Usage::

    python -m picaso_tpu_torch.integration_testing            # run all
    python -m picaso_tpu_torch.integration_testing climate    # filter
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

__all__ = ['discover', 'run_all', 'main']

_EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'examples')
_ROOT = os.path.dirname(os.path.dirname(_EXAMPLES))


def discover(pattern='', examples_dir=None):
    """Sorted example script paths whose filename contains ``pattern``."""
    d = examples_dir or _EXAMPLES
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith('.py') and pattern in f)


def run_all(pattern='', examples_dir=None, timeout=1800, verbose=True):
    """Run each matching example in a subprocess; returns {path: (ok, s)}.

    A script passes when it exits 0 (each example ends in asserts on its
    own outputs).  Each runs from the repository's root, with the
    interpreter running this function.
    """
    results = {}
    for path in discover(pattern, examples_dir):
        t0 = time.time()
        proc = subprocess.run([sys.executable, path], capture_output=True,
                              text=True, timeout=timeout,
                              cwd=_ROOT)
        dt = time.time() - t0
        ok = proc.returncode == 0
        results[path] = (ok, dt)
        if verbose:
            status = 'PASS' if ok else 'FAIL'
            print(f'{status} {os.path.basename(path)} ({dt:.1f}s)')
            if not ok:
                print(proc.stdout[-2000:])
                print(proc.stderr[-2000:])
    return results


def main(argv=None):
    """Console entry point (``picaso-tpu-torch-integration``, beside the
    JAX package's ``picaso-tpu-integration``)."""
    argv = sys.argv[1:] if argv is None else argv
    pattern = argv[0] if argv else ''
    res = run_all(pattern)
    if not res:
        print('no examples matched')
        return 1
    return 0 if all(ok for ok, _ in res.values()) else 1


if __name__ == '__main__':
    sys.exit(main())
