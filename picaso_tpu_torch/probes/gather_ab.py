"""A/B measurement of the gathers (K1, K8) and the forwards around them.

Measures, on one CUDA device, the port found under ``--tree`` (a
checkout's root; default: this one), so that two commits are compared in
one call on one card, in turns:

    python3 picaso_tpu_torch/probes/gather_ab.py --tree build/parent
    python3 picaso_tpu_torch/probes/gather_ab.py
    python3 picaso_tpu_torch/probes/gather_ab.py
    python3 picaso_tpu_torch/probes/gather_ab.py --tree build/parent

It uses only the wrappers' public contract, so it runs on a checkout from
before the chunked gathers too.  Per run it prints one JSON line (and
appends it to ``--out``, by default ``build/gather_ab.jsonl``): the card's
name and power limit; at each width (``--widths``; default nwno 12 500,
50 000 and 200 000, each ``build_problem(nwno, nlevel=91,
production=True)``, the table freed before the next) K1's and K8's times
by CUDA events, as the mean of ``--calls`` calls queued behind a sleep of
the stream in each of ``--repeats`` repeats (the spread is the repeats'
range), a SHA-256 of each output, equal between two checkouts exactly
when their outputs are bitwise equal, and the max abs difference from the
twins; the same on the production width for a scattered profile
(:func:`scattered_layers`: every layer of a chunk reads 4 rows no other
layer of it reads, the most rows a chunk can need); and the wall time and
peak device memory (``max_memory_allocated``) of the Toon forward and the
int16-table forward at nwno 50 000.

Variants of the gather kernels run in the same process: ``--variants
build/a,build/b`` names checkouts whose ``csrc/interp_tau.cu`` (say, with
another chunk length) is compiled alone with the port's nvcc flags; each
is launched through its C entries on the same arguments as the wrappers
give theirs and reported beside them (``variant_ms``, ``variant_sha256``;
the entries alone, without the wrappers' small argument kernels).
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

WIDTHS = (12_500, 50_000, 200_000)
NWNO = 50_000
NLEVEL = 91
SLEEP_CYCLES = 50_000_000   # ~25 ms at the card's clock


def scattered_layers(pt, nlayer, seed=0):
    """(T [nlayer] in K, P [nlayer] in bar), numpy, of a profile that puts
    layer l inside grid cell ``cells[l % n]`` of a random order of the n
    cells (t_low, p_low) with both indices even: such cells share no
    corner, so any n consecutive layers read 4 rows each that no other of
    them reads (4L distinct rows in a chunk of L <= n layers).  ``pt`` is a
    ``db.PTGrid``; each cell keeps ``_find_indices``' guard p_low <=
    nc_p[t_hi] - 3 and has its four rows in the table."""
    temps = 1.0 / pt.t_inv_grid.detach().cpu().double().numpy()
    p_log = pt.p_log_grid.detach().cpu().double().numpy()
    nc_p = pt.nc_p.detach().cpu().numpy()
    cells = [(a, b) for a in range(0, len(temps) - 1, 2)
             for b in range(0, min(nc_p[a + 1] - 3, nc_p[a] - 2) + 1, 2)]
    rng = np.random.default_rng(seed)
    a, b = np.asarray(cells)[rng.permutation(len(cells))][
        np.arange(nlayer) % len(cells)].T
    f = rng.uniform(0.1, 0.9, (2, nlayer))
    t = temps[a] + f[0] * (temps[a + 1] - temps[a])
    p = 10.0 ** (p_log[b] + f[1] * (p_log[b + 1] - p_log[b]))
    return t, p


def scattered_scene(scene, pt, seed=0):
    """``scene`` (a ``pipeline.SceneTensors``) with the layer temperatures
    and pressures of :func:`scattered_layers` on grid ``pt``, its other
    fields as they are."""
    import torch
    from picaso_tpu_torch.constants import PCONV
    t, p = scattered_layers(pt, scene.tlayer.shape[0], seed)
    like = dict(dtype=scene.tlayer.dtype, device=scene.tlayer.device)
    return scene._replace(tlayer=torch.tensor(t, **like),
                          player=torch.tensor(p, **like) * PCONV)


def _cuda_ms(torch, fn, calls, repeats):
    """Mean device time of fn() over ``calls`` calls, by CUDA events, in
    each of ``repeats`` repeats.  The stream first sleeps ~25 ms, so the
    calls are queued before the card reaches them and the host's time per
    call does not leave it idle between them."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out


def _wall_ms(torch, fn, n):
    """Best of two passes of the mean wall time of fn() over n calls."""
    fn()
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3


def _peak(torch, fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _variant_library(tree):
    """Start nvcc on ``tree``'s csrc/interp_tau.cu alone, with the port's
    flags, into ``tree/build``; returns a function that waits for it and
    loads the library with the gathers' argument types set."""
    from picaso_tpu_torch._build import _SIGNATURES, NVCC_FLAGS, _nvcc
    src = os.path.join(tree, 'picaso_tpu_torch', 'csrc', 'interp_tau.cu')
    out = os.path.join(tree, 'build', 'interp_tau_variant.so')
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-o', out, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def load():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src}:\n{log}')
        lib = ctypes.CDLL(out)
        for name in ('interp_tau_launch', 'interp_tau_q_launch'):
            getattr(lib, name).argtypes = _SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        return lib
    return load


def _digest(t):
    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', '..'))
    ap.add_argument('--out', default='build/gather_ab.jsonl')
    ap.add_argument('--widths', default=','.join(map(str, WIDTHS)))
    ap.add_argument('--repeats', type=int, default=5)
    ap.add_argument('--calls', type=int, default=20)
    ap.add_argument('--variants', default='')
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('gather_ab: no CUDA device')
    import picaso_tpu_torch
    from picaso_tpu_torch import pipeline
    from picaso_tpu_torch.opacities.cuda_interp import (_LN10, interp_tau,
                                                        interp_tau_plain,
                                                        interp_tau_q,
                                                        interp_tau_q_plain)
    from picaso_tpu_torch.opacities.db import LOG_AVO, corner_weights
    if not os.path.abspath(picaso_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f'gather_ab: imported {picaso_tpu_torch.__file__}, '
                         f'not the port under {tree}')

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    dev = torch.device('cuda')
    result = {'tree': args.tree, 'card': smi[0], 'kernel_ms': {},
              'sha256': {}, 'max_abs_err': {}, 'rows': {}, 'variant_ms': {},
              'variant_sha256': {}}
    loaders = {v: _variant_library(os.path.abspath(v))
               for v in args.variants.split(',') if v}
    variants = {v: load() for v, load in loaders.items()}

    def entry_call(lib, name, a):
        """A call of ``lib``'s C entry for K1 or K8 on the wrapper's
        arguments ``a``, and the tensor it writes."""
        table, idx, t_w, p_w, mixcol = a[:5]
        w4 = corner_weights(t_w, p_w).to(torch.float32).contiguous()
        idx32 = idx.to(torch.int32).contiguous()
        mixcol = mixcol.to(torch.float32).contiguous()
        qp = [a[5].to(torch.float32).contiguous()] if name == 'K8' else []
        out = torch.empty((idx.shape[1], table.shape[2]), device=dev)
        entry = lib.interp_tau_q_launch if qp else lib.interp_tau_launch
        ptrs = [t.data_ptr() for t in (table, idx32, w4, mixcol, *qp, out)]

        def call():
            code = entry(*ptrs, *table.shape, idx.shape[1], _LN10, LOG_AVO,
                         torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f'{name}: CUDA error {code}')
        return call, (w4, idx32, mixcol, qp, out)

    def measure(label, scene, grid, g16, config):
        for name, fn, twin, g in (('K1', interp_tau, interp_tau_plain, grid),
                                  ('K8', interp_tau_q, interp_tau_q_plain,
                                   g16)):
            a = pipeline.gather_args(scene, g, config)
            key = f'{name} {label}'
            result['kernel_ms'][key] = _cuda_ms(torch, lambda: fn(*a),
                                                args.calls, args.repeats)
            out = fn(*a)
            result['sha256'][key] = _digest(out)
            result['max_abs_err'][key] = (out - twin(*a)).abs().max().item()
            result['rows'][label] = int(torch.unique(a[1]).numel())
            for v, lib in variants.items():
                call, keep = entry_call(lib, name, a)
                result['variant_ms'][f'{v} {key}'] = _cuda_ms(
                    torch, call, args.calls, args.repeats)
                call()
                result['variant_sha256'][f'{v} {key}'] = _digest(keep[-1])
                del call, keep
            del out, a
        torch.cuda.empty_cache()

    for nwno in (int(w) for w in args.widths.split(',')):
        scene, grid, config = pipeline.build_problem(
            nwno, nlevel=NLEVEL, production=True, device=dev)
        g16 = grid.with_blocked_table(quantize=True)
        measure(str(nwno), scene, grid, g16, config)
        if nwno == NWNO:
            measure(f'{nwno} scattered', scattered_scene(scene, grid.pt),
                    grid, g16, config)
            result['forward_ms'], result['forward_peak_bytes'] = {}, {}
            for label, g in (('toon', grid), ('int16', g16)):
                def fwd(g=g):
                    return pipeline.forward(scene, g, config)
                result['forward_peak_bytes'][label] = _peak(torch, fwd)
                result['forward_ms'][label] = _wall_ms(torch, fwd, 10)
        del scene, grid, g16
        torch.cuda.empty_cache()

    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
