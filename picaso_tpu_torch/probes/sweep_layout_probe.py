"""Sweep-layout probe: where should a column's per-layer values live
during the RT kernels' sequential back-substitution sweeps?

Port of ``scripts/sweep_layout_probe.py``.  The recursion is its
``_step_rows`` (two reciprocals and six mul/sub per layer, bottom to top
from the carry (1.0, 0.5), writing ``ds_o2`` per layer), as two layouts of
one CUDA kernel (``csrc/sweep_layout_probe.cu``), one thread per column
over ``b, c, d, out [nlayer, N]``:

* **rows** (:func:`sweep_rows`): every step reads and writes global memory,
  the ``[slot, row, nwno]`` scratch of K2-K6 and the SH kernels;
* **staged** (:func:`sweep_staged`): the block's ``[nlayer, tile]`` slices
  are copied into shared memory, swept there, and written back once.

The TPU probe's packed variants ((8, 128)-tiled slices) answered a Mosaic
vreg-occupancy question with no CUDA meaning and are not ported.  Both
layouts see the same data in the same places and run the twin's
arithmetic in its order, so they are compared elementwise with
:func:`sweep_plain`, where the JAX probe could only compare means.

    python -m picaso_tpu_torch.probes.sweep_layout_probe [N_per_block] \\
        [nlayer] [nblocks]

Defaults as the JAX probe: N = 1920 per block, 90 layers, 128 blocks.
Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from . import cuda_ms, max_rel

__all__ = ['sweep_plain', 'sweep_rows', 'sweep_staged', 'sweep_inputs',
           'report', 'main']

TILES = (32, 64, 128)


def sweep_plain(b, c, d):
    """The twin: ``_step_rows`` over the layers, bottom to top, on
    [nlayer, N] tensors; returns out [nlayer, N]."""
    nlayer = b.shape[0]
    out = torch.empty_like(b)
    as_n = torch.ones_like(b[0])
    ds_n = torch.full_like(b[0], 0.5)
    for l in range(nlayer - 1, -1, -1):
        x = 1.0 / (b[l] - c[l] * as_n)
        as_o = d[l] * x
        ds_o = (d[l] - c[l] * ds_n) * x
        y = 1.0 / (b[l] + c[l] * as_o)
        as_n = d[l] * y
        ds_n = (d[l] - b[l] * ds_o) * y
        out[l] = ds_n
    return out


def _launch(name, b, c, d, staged, tile):
    if b.device.type != 'cuda':
        raise ValueError(f'{name}: needs CUDA tensors, got {b.device}')
    for t in (b, c, d):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != b.shape or t.dim() != 2 or t.device != b.device):
            raise ValueError(f'{name}: b, c, d must be contiguous float32 '
                             f'[nlayer, N] on one device')
    nlayer, ncol = b.shape
    from .._build import check, library
    out = torch.empty_like(b)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        code = library().sweep_layout_launch(
            b.data_ptr(), c.data_ptr(), d.data_ptr(), out.data_ptr(),
            nlayer, ncol, int(staged), tile, stream)
    check(code, name)
    return out


def sweep_rows(b, c, d):
    """Layout A, rows: the sweep reading and writing global memory.  CPU
    tensors take the twin."""
    if b.device.type == 'cpu':
        return sweep_plain(b, c, d)
    out = _launch('sweep_rows', b, c, d, False, 0)
    sweep_rows.launches += 1
    return out


def sweep_staged(b, c, d, tile=64):
    """Layout B, staged: each block of ``tile`` columns copies its slices
    into shared memory (16 * nlayer * tile bytes), sweeps, writes back.
    CPU tensors take the twin."""
    if b.device.type == 'cpu':
        return sweep_plain(b, c, d)
    if tile not in TILES:
        raise ValueError(f'sweep_staged: tile {tile} not in {TILES}')
    if 16 * b.shape[0] * tile > 227 * 1024:
        raise ValueError(f'sweep_staged: {b.shape[0]} layers x {tile} '
                         f'columns exceed the shared memory')
    out = _launch('sweep_staged', b, c, d, True, tile)
    sweep_staged.launches += 1
    return out


sweep_rows.launches = 0
sweep_staged.launches = 0


def sweep_inputs(nlayer, ncol, device, seed=0):
    """b, c, d [nlayer, ncol] float32 from a seeded generator on
    ``device``: c, d = 1.5 + 0.1 * uniform as in the JAX probe, b one
    larger, so that no pivot ``b - c * as`` comes near zero (with the JAX
    probe's b the first pivot b - c spans +-0.1 and can round to 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, c, d = (1.5 + 0.1 * torch.rand((nlayer, ncol), generator=gen,
                                      device=device) for _ in range(3))
    return [b + 1.0, c, d]


def report(N=1920, nlayer=90, nblocks=128, n_iter=50, log=print):
    """Times of both layouts (every tile) on the JAX probe's shape and
    their elementwise max rel deviation from the twin; returns a dict."""
    b, c, d = sweep_inputs(nlayer, N * nblocks, 'cuda')
    ref = sweep_plain(b, c, d)
    runs = {'rows': lambda: sweep_rows(b, c, d)}
    runs.update({f'staged tile {t}': (lambda t=t: sweep_staged(b, c, d, t))
                 for t in TILES})
    out = {'ms': {}, 'max_rel': {}}
    for label, fn in runs.items():
        out['max_rel'][label] = max_rel(fn(), ref)
        out['ms'][label] = cuda_ms(fn, n_iter)
        log(f'{label:18s} [{nlayer}, {N * nblocks}] '
            f'{out["ms"][label]:8.4f} ms, max rel vs twin '
            f'{out["max_rel"][label]:.2e}')
    best = min((v, k) for k, v in out['ms'].items() if k != 'rows')
    out['staged_over_rows'] = best[0] / out['ms']['rows']
    log(f'best staged ({best[1]}) / rows: {out["staged_over_rows"]:.3f}')
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N = int(argv[0]) if argv else 1920
    nlayer = int(argv[1]) if len(argv) > 1 else 90
    nblocks = int(argv[2]) if len(argv) > 2 else 128
    if not torch.cuda.is_available():
        raise SystemExit('sweep_layout_probe: needs a CUDA device')
    print(torch.cuda.get_device_name(0))
    report(N, nlayer, nblocks)


if __name__ == '__main__':
    main()
