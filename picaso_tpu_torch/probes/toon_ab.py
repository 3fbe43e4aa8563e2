"""A/B measurement of the Toon kernels and forwards of one checkout.

Measures, on one CUDA device at the production shape
(``pipeline.build_problem(50_000, nlevel=91, production=True)``), the port
found under ``--tree`` (a checkout's root; default: this one), so that two
commits are compared in one call on one card, in turns:

    python3 picaso_tpu_torch/probes/toon_ab.py --tree build/parent
    python3 picaso_tpu_torch/probes/toon_ab.py
    python3 picaso_tpu_torch/probes/toon_ab.py
    python3 picaso_tpu_torch/probes/toon_ab.py --tree build/parent

It uses only the wrappers' public contract, which the two-stage Toon
kernels kept, so it runs on a checkout from before them too.  Per run it
prints one JSON line (and appends it to ``chiprun_out/toon_ab.jsonl``):
the card's name and power limit; each Toon kernel's time by CUDA events
(K2-K6, and K3 and K4 at a phase curve's 6 x 6 disk of 36 angles), and
each stage's where the tree's wrapper takes ``split_event``; a SHA-256 of
every kernel's outputs (K2, K3 and K5 also at ``multi_phase=1``), equal
between two checkouts exactly when their outputs are bitwise equal; K2-K6's max abs difference from their plain
twins; and the wall time and peak device memory
(``max_memory_allocated``) of the Toon, reflected-only (Pollack Raman),
thermal-only and unfused-optics forwards and of a 4-scene phase curve
through ``forward_batch``.
"""

import argparse
import dataclasses
import hashlib
import inspect
import json
import math
import os
import subprocess
import sys
import time

NWNO = 50_000
NLEVEL = 91
PHASES_DEG = (0.0, 45.0, 90.0, 120.0)


def _cuda_ms(torch, fn, n):
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
    """Peak device memory of one fn() call, in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', '..'))
    ap.add_argument('--out', default='chiprun_out/toon_ab.jsonl')
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('toon_ab: no CUDA device')
    import picaso_tpu_torch
    from picaso_tpu_torch import disco, pipeline
    from picaso_tpu_torch.optics import combine_optics
    from picaso_tpu_torch.probes.sh_ab import _stages_ms
    from picaso_tpu_torch.rt import cuda_toon
    if not os.path.abspath(picaso_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f'toon_ab: imported {picaso_tpu_torch.__file__}, '
                         f'not the port under {tree}')

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    dev = torch.device('cuda')
    scene, grid, config = pipeline.build_problem(NWNO, nlevel=NLEVEL,
                                                 production=True, device=dev)
    scene_p, _, config_p = pipeline.with_raman(scene, grid, config, 1)
    tg, tr, rf = pipeline.rt_sources(scene, grid, config)
    tg_p, tr_p, rf_p = pipeline.rt_sources(scene_p, grid, config_p)
    props = combine_optics(tg, tr, scene.cld_opd, scene.cld_w0,
                           scene.cld_g0, rf)
    geom_36 = disco.make_geometry(math.radians(45.0), num_gangle=6,
                                  num_tangle=6)
    scene_36 = pipeline.with_geometry(scene_p, geom_36)
    calls = {  # kernel -> (wrapper, args, kwargs)
        'spectrum_toon': (cuda_toon.spectrum_toon, *pipeline.spectrum_args(
            scene, grid, config, tg, tr, rf)),
        'reflected_toon': (cuda_toon.reflected_toon, *pipeline.reflected_args(
            scene_p, config_p, tg_p, tr_p, rf_p)),
        'thermal_toon': (cuda_toon.thermal_toon, *pipeline.thermal_args(
            scene, grid, config, tg, tr)),
        'reflected_toon_props': (cuda_toon.reflected_toon_props,
                                 *pipeline.reflected_args(scene, config, tg,
                                                          tr, rf, props)),
        'thermal_toon_props': (cuda_toon.thermal_toon_props,
                               *pipeline.thermal_args(scene, grid, config,
                                                      tg, tr, props)),
        'reflected_toon 36 angles': (
            cuda_toon.reflected_toon, *pipeline.reflected_args(
                scene_36, config_p,
                *pipeline.rt_sources(scene_36, grid, config_p))),
        'thermal_toon 36 angles': (
            cuda_toon.thermal_toon, *pipeline.thermal_args(
                pipeline.with_geometry(scene, geom_36), grid, config, tg,
                tr)),
    }
    # the reflected kernels' column routine at multi_phase=1 (N=1) too
    for name in ('spectrum_toon', 'reflected_toon', 'reflected_toon_props'):
        fn, a, kw = calls[name]
        calls[f'{name} N=1'] = (fn, a, dict(kw, controls=dataclasses.replace(
            kw['controls'], multi_phase=1)))
    result = {'tree': args.tree, 'card': smi[0], 'kernel_ms': {},
              'stages_ms': {}, 'sha256': {}, 'max_abs_err': {}}
    for name, (fn, a, kw) in calls.items():
        result['kernel_ms'][name] = _cuda_ms(torch, lambda: fn(*a, **kw), 10)
        if 'split_event' in inspect.signature(fn).parameters:
            result['stages_ms'][name] = _stages_ms(
                torch, lambda split_event: fn(*a, split_event=split_event,
                                              **kw), 10)
        out = fn(*a, **kw)
        out = out if isinstance(out, tuple) else (out,)
        result['sha256'][name] = _digest(*out)
        if '36' not in name:
            twin = getattr(cuda_toon, f'{fn.__name__}_plain')
            ref = twin(*a, **kw)
            ref = ref if isinstance(ref, tuple) else (ref,)
            result['max_abs_err'][name] = max(
                (o - r).abs().max().item() for o, r in zip(out, ref))
        del out
    del calls, props

    paths = {
        'toon': (scene, config),
        'reflected-only (Pollack)': (scene_p, dataclasses.replace(
            config_p, thermal=False)),
        'thermal-only': (scene, dataclasses.replace(config,
                                                    reflected=False)),
        'unfused optics': (scene, dataclasses.replace(config,
                                                      fuse_optics=False)),
    }
    result['forward_ms'], result['forward_peak_bytes'] = {}, {}
    for label, (sc, cfg) in paths.items():
        def fwd(sc=sc, cfg=cfg):
            return pipeline.forward(sc, grid, cfg)
        result['forward_peak_bytes'][label] = _peak(torch, fwd)
        result['forward_ms'][label] = _wall_ms(torch, fwd, 10)
    batch = pipeline.stack_scenes([
        pipeline.with_geometry(scene_p, disco.make_geometry(
            math.radians(deg), num_gangle=6, num_tangle=6))
        for deg in PHASES_DEG])
    refl_cfg = paths['reflected-only (Pollack)'][1]

    def curve():
        return pipeline.forward_batch(batch, grid, refl_cfg)
    result['forward_peak_bytes']['phase curve'] = _peak(torch, curve)
    result['forward_ms']['phase curve'] = _wall_ms(torch, curve, 5)

    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
