"""Run one cell of the benchmark once on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the check lines on standard error and the result as the last line
of standard output.  Exits nonzero, with no result, without a CUDA card
(there is no CPU fallback), with fewer cards than the cell asks for, or
when jax, jaxlib, flax or picaso_tpu was loaded."""

import os
import sys
import time


def _process_start():
    """perf_counter() at the moment the process started (its age from
    /proc, 10 ms resolution); now where /proc is absent."""
    now = time.perf_counter()
    try:
        with open('/proc/self/stat') as f:
            start_ticks = float(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf('SC_CLK_TCK')
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the program and its libraries at a fixed place inside
# the checkout; no library may pull in JAX
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_var] = os.path.join(ROOT, 'build', _sub)
os.environ['USE_FLAX'] = '0'
os.environ['USE_JAX'] = '0'
sys.path[0] = ROOT

if __name__ == '__main__':
    from benchmark.harness.cli import main
    sys.exit(main(sys.argv[1:], ROOT, T_START))
