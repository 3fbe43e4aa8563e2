"""A/B of the unsharded forward, its wavenumber reductions and the sharded
forward, for one checkout.

Measures, on one CUDA device, the port found under ``--tree`` (a
checkout's root; default: this one), so that commits are compared in one
call on one card, in turns:

    python3 picaso_tpu_torch/probes/forward_ab.py --tree build/parent
    python3 picaso_tpu_torch/probes/forward_ab.py
    python3 picaso_tpu_torch/probes/forward_ab.py
    python3 picaso_tpu_torch/probes/forward_ab.py --tree build/parent

At the production shape (``pipeline.build_problem(50_000, nlevel=91,
production=True)``), as ``chip_smoke.py``'s phase 8 times it: the wall
time (best of two passes of 10 calls) and peak device memory
(``max_memory_allocated``) of the Toon forward on the float32 table (K1 +
K2) and on the int16 table (K8 + K2); the kernels' device time by CUDA
events, and the glue (forward minus kernels); the device time of each
reduction over the forward's angle, species or layer axes that the
forward runs besides the kernels (``disco.compress_disco``,
``compress_thermal``, ``assemble.rayleigh_tau``, ``rt.transit.
transit_depth``) on the forward's own inputs; a SHA-256 of each forward's
outputs (equal between two checkouts exactly when they compute the same
bits).  Where the checkout has ``parallel.py``: the wall time of
``sharded_forward`` over 4 wave shards on this card and whether each
output is bitwise the unsharded one.  At the width of ``chip_smoke.py``'s
phase 52 (nwno 256, 25 levels, reflected-only): the wall time of one
forward and of one sharded forward (4 wave shards), mostly host time; per
point of 24, a sharded forward each against one ``sharded_forward_batch``
of them (and whether the two agree bit for bit); the forward's heaviest
host functions under ``cProfile``.

Each run prints one JSON line and appends it to ``--out`` (default
``chiprun_out/forward_ab.jsonl``), with the card's name and power limit.
"""

import argparse
import cProfile
import dataclasses
import hashlib
import json
import os
import pstats
import subprocess
import sys
import time

NWNO = 50_000
NLEVEL = 91


def _cuda_ms(torch, fn, n):
    """Mean device time of fn() over n calls, by CUDA events; the stream
    first sleeps so the calls are queued before the card reaches them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _digest(out):
    h = hashlib.sha256()
    for key in sorted(out):
        h.update(out[key].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _production(torch, pipeline, disco, assemble, transit, grid, scene,
                config, kernel):
    """Phase 8's numbers for one table, and its reductions' device ms."""
    def fwd():
        return pipeline.forward(scene, grid, config)
    out = fwd()
    res = {'peak_bytes': _peak(torch, fwd), 'forward_ms': _wall_ms(
        torch, fwd, 10), 'sha256': _digest(out)}
    tg, tr, rf = pipeline.rt_sources(scene, grid, config)
    s_args, s_kw = pipeline.spectrum_args(scene, grid, config, tg, tr, rf)
    g_args = pipeline.gather_args(scene, grid, config)
    res['kernel_ms'] = {
        kernel.__name__: _cuda_ms(torch, lambda: kernel(*g_args), 20),
        'spectrum_toon': _cuda_ms(torch, lambda: pipeline.spectrum_toon(
            *s_args, **s_kw), 10)}
    res['glue_ms'] = res['forward_ms'] - sum(res['kernel_ms'].values())
    xint, flux_top = pipeline.spectrum_toon(*s_args, **s_kw)
    dtau = tg + tr + scene.cld_opd
    calls = {
        'compress_disco': lambda: disco.compress_disco(
            xint, scene.gweight, scene.tweight, scene.cos_theta,
            scene.F0PI),
        'compress_thermal': lambda: disco.compress_thermal(
            flux_top, scene.gweight, scene.tweight),
        'rayleigh_tau': lambda: assemble.rayleigh_tau(
            scene.sigma_ray, scene.mix_ray, scene.colden, scene.mmw_layer),
        'transit_depth': lambda: transit.transit_depth(
            scene.z, scene.dz, scene.rstar, scene.mmw_layer, scene.plevel,
            scene.tlevel, scene.colden, dtau)}
    res['reduction_ms'] = {k: _cuda_ms(torch, f, 20)
                           for k, f in calls.items()}
    res['reduction_shapes'] = {
        'xint': list(xint.shape), 'flux_top': list(flux_top.shape),
        'sigma_ray': list(scene.sigma_ray.shape),
        'dtau': list(dtau.shape)}
    return res, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', '..'))
    ap.add_argument('--out', default='chiprun_out/forward_ab.jsonl')
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('forward_ab: no CUDA device')
    import picaso_tpu_torch
    from picaso_tpu_torch import disco, pipeline
    from picaso_tpu_torch.opacities import assemble, factory
    from picaso_tpu_torch.opacities.cuda_interp import (interp_tau,
                                                        interp_tau_q)
    from picaso_tpu_torch.rt import transit
    if not os.path.abspath(picaso_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f'forward_ab: imported {picaso_tpu_torch.__file__}'
                         f', not the port under {tree}')
    try:
        from picaso_tpu_torch import parallel
    except ImportError:
        parallel = None

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    dev = torch.device('cuda')
    scene, grid, config = pipeline.build_problem(NWNO, nlevel=NLEVEL,
                                                 production=True, device=dev)
    g16 = grid.with_blocked_table(quantize=True)
    result = {'tree': args.tree, 'card': smi[0]}
    mods = (torch, pipeline, disco, assemble, transit)
    for label, g, kernel in (('toon', grid, interp_tau),
                             ('int16', g16, interp_tau_q)):
        res, out = _production(*mods, g, scene, config, kernel)
        if parallel is not None:
            m = parallel.make_mesh(n_wave=4, devices=[dev] * 4)
            scene_s = parallel.shard_scene(scene, m)
            grid_s = parallel.shard_grid(g, m)
            got = parallel.sharded_forward(scene_s, grid_s, config, m)
            res['sharded_bitwise'] = {k: bool(torch.equal(got[k], out[k]))
                                      for k in out}
            res['sharded_ms'] = _wall_ms(torch, lambda: parallel.
                                         sharded_forward(scene_s, grid_s,
                                                         config, m), 5)
            del scene_s, grid_s, got
        result[label] = res
        del out

    # phase 52's likelihood forward: host-bound at this width
    wno = np.linspace(2000.0, 18000.0, 256)
    pressure = np.logspace(-6, 2, 25)
    r_grid = factory.synthetic_opacity_grid(wno, ntemp=6, npress=5,
                                            dtype=torch.float32, device=dev)
    r_scene, r_config = pipeline.scene_from_arrays(
        pressure, 1000.0 * (pressure / 10.0) ** 0.1 + 300.0,
        {'H2': np.zeros(25) + 0.85, 'He': np.zeros(25) + 0.14,
         'H2O': np.zeros(25) + 5e-4, 'CH4': np.zeros(25) + 3e-4}, r_grid,
        gravity=2500.0, radius=7.1e9, mass=1.9e30, rstar=6.96e10)
    r_config = dataclasses.replace(r_config, thermal=False,
                                   transmission=False)
    small = {'forward_ms': _wall_ms(torch, lambda: pipeline.forward(
        r_scene, r_grid, r_config), 200)}
    if parallel is not None:
        m = parallel.make_mesh(n_wave=4, devices=[dev] * 4)
        scene_s = parallel.shard_scene(r_scene, m)
        grid_s = parallel.shard_grid(r_grid, m)
        small['sharded_ms'] = _wall_ms(torch, lambda: parallel.
                                       sharded_forward(scene_s, grid_s,
                                                       r_config, m), 200)

        # 24 likelihood points of one batch row: a sharded forward each
        # (phase 52's likelihood), or one sharded_forward_batch of them
        scales = [0.95 + 0.1 * i / 23 for i in range(24)]

        def scaled(sc, s):
            return sc._replace(tlevel=sc.tlevel * s, tlayer=sc.tlayer * s)

        def per_point():
            return [parallel.sharded_forward(
                scene_s.map(lambda sc: scaled(sc, s)), grid_s, r_config,
                m)['albedo'] for s in scales]

        def batched():
            batch = scene_s._replace(batched=True, shards=tuple(
                tuple(pipeline.stack_scenes([scaled(sc, s) for s in scales])
                      for sc in row) for row in scene_s.shards))
            return parallel.sharded_forward_batch(batch, grid_s, r_config,
                                                  m)['albedo']
        small['point_ms_per_point'] = _wall_ms(torch, per_point, 5) / 24
        small['batch_ms_per_point'] = _wall_ms(torch, batched, 5) / 24
        small['batch_bitwise'] = bool(torch.equal(torch.stack(per_point()),
                                                  batched()))
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(200):
        pipeline.forward(r_scene, r_grid, r_config)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    small['host_top_ms_per_forward'] = [
        [f'{os.path.basename(f)}:{line}({fn})', round(tt / 200 * 1e3, 4),
         round(ct / 200 * 1e3, 4)] for (f, line, fn), (_, _, tt, ct, _)
        in top]
    result['sampler_width'] = small

    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
