"""A/B of the batched retrieval likelihood against another tree.

The likelihood of ``examples/retrieval_nested.py`` at the production shape
(nwno 50 000, 16 molecules on the ragged grid, 91 levels): a cloud-free
``pipeline.scene_from_arrays`` scene per parameter point, 4 scenes per
``stack_scenes`` + ``forward_batch`` (transit only, K1 per scene).  One
process per tree; run it in turns (parent, change, change, parent) in one
call on the card, the parent unpacked with ``git archive`` (it needs
``picaso_tpu_torch/`` and ``picaso_tpu/refdata``):

    python3 picaso_tpu_torch/probes/scene_ab.py --tree build/parent
    python3 picaso_tpu_torch/probes/scene_ab.py

Each run appends one JSON line to ``--out`` (default
``build/scene_ab.jsonl``): the tree, the card, ms per scene set-up,
the wall ms of 12 batches of 4 scenes, likelihoods/s and the SHA-256 of
the 48 spectra (equal when the two trees compute the same numbers).
"""

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', '..'),
        help="a checkout's root (default: this one)")
    ap.add_argument('--out', default='build/scene_ab.jsonl')
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch
    import picaso_tpu_torch
    from picaso_tpu_torch import _build, pipeline
    if not torch.cuda.is_available():
        raise SystemExit('scene_ab: no CUDA device')
    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        picaso_tpu_torch.__file__)))
    _build.build()
    _build.library()
    _, grid, _ = pipeline.build_problem(50_000, nlevel=91, device='cuda')
    pressure = np.logspace(-6, 2, 91)

    def scene(tiso, log_h2o):
        mix = {'H2': np.full(91, 0.86), 'He': np.full(91, 0.14),
               'H2O': np.full(91, 10.0 ** log_h2o),
               'CH4': np.full(91, 1e-4)}
        return pipeline.scene_from_arrays(
            pressure, np.full(91, tiso), mix, grid, gravity=np.nan,
            radius=1.2 * 7.1492e9, mass=0.8 * 1.898e30,
            rstar=0.9 * 6.957e10)

    _, config = scene(1000.0, -3.0)
    config = dataclasses.replace(config, reflected=False, thermal=False,
                                 transmission=True)
    thetas = np.stack([800.0 + 800.0 * np.linspace(0, 1, 48),
                       -5.0 + 3.0 * np.linspace(1, 0, 48)], -1)

    def batch(th):
        scenes = pipeline.stack_scenes([scene(*t)[0] for t in th])
        return pipeline.forward_batch(
            scenes, grid, config)['transit_depth'].cpu().numpy()

    batch(thetas[:4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in thetas[:12]:
        scene(*t)
    torch.cuda.synchronize()
    scene_ms = (time.perf_counter() - t0) / 12 * 1e3
    outs, walls = [], []
    for i in range(0, len(thetas), 4):
        t0 = time.perf_counter()
        outs.append(batch(thetas[i:i + 4]))
        walls.append((time.perf_counter() - t0) * 1e3)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    line = json.dumps({
        'tree': tree, 'card': card, 'scene_ms': scene_ms,
        'batch4_ms': walls,
        'likelihoods_per_s': len(thetas) / sum(walls) * 1e3,
        'sha256': hashlib.sha256(np.concatenate(outs).tobytes()).hexdigest()})
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
