"""Probes of the port's kernels on the card: ports of the JAX package's
``scripts/gather_probe.py`` and ``scripts/sweep_layout_probe.py``.  Each
runs as ``python -m picaso_tpu_torch.probes.<name>`` and prints its
report; ``report`` returns the numbers for ``chip_smoke.py``."""

import torch


def cuda_ms(fn, n):
    """Mean device time of fn() over n calls, by CUDA events (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_rel(a, b):
    """Largest |a - b| / |b| over the elements, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).abs() / b.abs().clamp(min=1e-300)).max().item()
