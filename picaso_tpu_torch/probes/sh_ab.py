"""A/B measurement of the spherical-harmonics kernels and forwards of one
checkout.

Measures, on one CUDA device at the production shape
(``pipeline.build_problem(50_000, nlevel=91, production=True)``, SH at 4
and 2 streams), the port found under ``--tree`` (a checkout's root;
default: this one), so that two commits are compared in one call on one
card, in turns:

    python3 picaso_tpu_torch/probes/sh_ab.py --tree build/parent
    python3 picaso_tpu_torch/probes/sh_ab.py
    python3 picaso_tpu_torch/probes/sh_ab.py
    python3 picaso_tpu_torch/probes/sh_ab.py --tree build/parent

It uses only the wrappers' public contract, which the two-stage SH
kernels kept, so it runs on a checkout from before them too (with the
timing and digest helpers of ``probes/toon_ab.py``).  Per run it prints
one JSON line (and appends it to ``chiprun_out/sh_ab.jsonl``): the card's
name and power limit; the time of reflected_sh4/sh2 and thermal_sh4/sh2 by
CUDA events, and of reflected_sh4 and thermal_sh4 at a phase curve's 6 x 6
disk of 36 angles, and of reflected_sh4/sh2 at 1, 8, 9 and (SH2) 36
angles (stage B's chunk edges); a SHA-256 of each kernel's output at
every angle count, equal between two checkouts exactly when their
outputs are bitwise equal; each kernel's max abs difference from its
plain twin (5 angles); the time of each stage of a wrapper that takes
``split_event`` (the two-stage kernels); and the wall time and peak
device memory of the SH4 and SH2 forwards.  A peak is
``max_memory_allocated`` over one forward after ``gc.collect()``,
``torch.cuda.empty_cache()`` and a reset, beside the bytes alive before
the call.
"""

import argparse
import dataclasses
import gc
import inspect
import json
import math
import os
import subprocess
import sys

NWNO = 50_000
NLEVEL = 91


def _peak(torch, fn):
    """(bytes alive before one fn() call, peak bytes during it)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alive = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return alive, torch.cuda.max_memory_allocated()


def _stages_ms(torch, fn, n):
    """Mean device time of each stage (A, B) of fn(split_event=...) over n
    calls, by CUDA events before, between and after its two launches."""
    fn(split_event=None)
    torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
              for _ in range(n)]
    for start, mid, end in events:
        start.record()
        fn(split_event=mid)
        end.record()
    torch.cuda.synchronize()
    return [sum(e[i].elapsed_time(e[i + 1]) for e in events) / n
            for i in (0, 1)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', '..'))
    ap.add_argument('--out', default='chiprun_out/sh_ab.jsonl')
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('sh_ab: no CUDA device')
    import picaso_tpu_torch
    from picaso_tpu_torch import disco, pipeline
    from picaso_tpu_torch.probes.toon_ab import _cuda_ms, _digest, _wall_ms
    from picaso_tpu_torch.rt import cuda_sh
    if not os.path.abspath(picaso_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f'sh_ab: imported {picaso_tpu_torch.__file__}, '
                         f'not the port under {tree}')

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    dev = torch.device('cuda')
    scene, grid, config = pipeline.build_problem(NWNO, nlevel=NLEVEL,
                                                 production=True, device=dev)
    tg, tr, rf = pipeline.rt_sources(scene, grid, config)
    scene_36 = pipeline.with_geometry(scene, disco.make_geometry(
        math.radians(45.0), num_gangle=6, num_tangle=6))
    configs = {s: dataclasses.replace(config, rt_method=1, stream=s)
               for s in (4, 2)}
    calls = {}  # kernel -> (wrapper, args, kwargs)
    for s, cfg in configs.items():
        (r_args, r_kw), (t_args, t_kw) = pipeline.sh_args(scene, grid, cfg,
                                                          tg, tr, rf)
        calls[f'reflected_sh{s}'] = (getattr(cuda_sh, f'reflected_sh{s}'),
                                     r_args, r_kw)
        calls[f'thermal_sh{s}'] = (getattr(cuda_sh, f'thermal_sh{s}'),
                                   t_args, t_kw)
    (r36_args, r36_kw), (t36_args, t36_kw) = pipeline.sh_args(
        scene_36, grid, configs[4], tg, tr, rf)
    calls['reflected_sh4 36 angles'] = (cuda_sh.reflected_sh4, r36_args,
                                        r36_kw)
    calls['thermal_sh4 36 angles'] = (cuda_sh.thermal_sh4, t36_args, t36_kw)
    # the reflected kernels at stage B's chunk edges: one angle (the
    # default disk's third), one full chunk of 8, two chunks of 5 (9),
    # five of 8 (36, SH2)
    scenes = {1: scene._replace(ubar0=scene.ubar0[2:3].contiguous(),
                                ubar1=scene.ubar1[2:3].contiguous())}
    for ng, nt in ((4, 2), (3, 3), (6, 6)):
        scenes[ng * nt] = pipeline.with_geometry(scene, disco.make_geometry(
            math.radians(45.0), num_gangle=ng, num_tangle=nt))
    for s, nang in ((4, 1), (4, 8), (4, 9), (2, 1), (2, 8), (2, 9), (2, 36)):
        (rn_args, rn_kw), _ = pipeline.sh_args(scenes[nang], grid,
                                               configs[s], tg, tr, rf)
        calls[f'reflected_sh{s} {nang} angles'] = (
            getattr(cuda_sh, f'reflected_sh{s}'), rn_args, rn_kw)
    result = {'tree': args.tree, 'card': smi[0], 'kernel_ms': {},
              'stages_ms': {}, 'sha256': {}, 'max_abs_err': {}}
    for name, (fn, a, kw) in calls.items():
        result['kernel_ms'][name] = _cuda_ms(torch, lambda: fn(*a, **kw), 10)
        if 'split_event' in inspect.signature(fn).parameters:
            result['stages_ms'][name] = _stages_ms(
                torch, lambda split_event: fn(*a, split_event=split_event,
                                              **kw), 10)
        out = fn(*a, **kw)
        result['sha256'][name] = _digest(out)
        if 'angles' not in name:
            ref = getattr(cuda_sh, f'{fn.__name__}_plain')(*a, **kw)
            result['max_abs_err'][name] = (out - ref).abs().max().item()
            del ref
        del out
    del calls

    result['forward_ms'], result['forward_peak_bytes'] = {}, {}
    result['forward_alive_bytes'] = {}
    for s, cfg in configs.items():
        def fwd(cfg=cfg):
            return pipeline.forward(scene, grid, cfg)
        alive, peak = _peak(torch, fwd)
        result['forward_alive_bytes'][f'SH{s}'] = alive
        result['forward_peak_bytes'][f'SH{s}'] = peak
        result['forward_ms'][f'SH{s}'] = _wall_ms(torch, fwd, 10)

    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
