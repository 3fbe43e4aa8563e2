"""Smoke run of the PyTorch/CUDA port (picaso_tpu_torch) on one NVIDIA GPU.

Drives the port's main paths -- ``pipeline.build_problem`` and
``pipeline.forward`` at the production shape: ragged 1060-point (T, P)
grid, 16 molecules, nwno = 50 000, 90 layers, 5 disk angles, cloudy, 2 CIA
continua, Rayleigh, reflected + thermal + transit -- with the Toon solver
(reflected and thermal together, each alone, unfused optics; Raman off or
Pollack) and with the spherical-harmonics solver at 4 and 2 streams, and a
4-point reflected phase curve through ``forward_batch``, through the ten
hand-written CUDA kernels, and checks each kernel against its plain
PyTorch twin and each forward against a float64 oracle.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero):
 1. the card's name and power limit (nvidia-smi); no CUDA device -> error
 2. build the kernels from picaso_tpu_torch/csrc with nvcc (sm_90a)
 3. build the production problem on the card
 4. gather kernel vs its twin at the production shape (max rel <= 1e-5)
 5. spectrum kernel vs its twin at the production shape
    (max rel <= 1e-3, median rel <= 1e-5)
 6. forward on 4 temperature-perturbed scenes: finite outputs, each
    kernel launched exactly once per forward
 7. nwno = 5000 oracle: the plain path in float64 against the kernel path
    in float32 (max rel <= 5e-3, median rel <= 2e-4, TPU_PARITY.json's
    forward tolerances)
 8. timings: forward with kernels vs the plain path, each kernel vs twin
 9. each SH kernel (reflected/thermal at 4 and 2 streams) vs its twin at
    the production shape (max rel <= 1e-3, median rel <= 1e-5)
10. SH4 and SH2 forwards on the 4 perturbed scenes: finite outputs, each
    SH kernel of the stream and the gather launched once per forward, no
    other kernel
11. nwno = 5000 SH oracle at 4 and 2 streams: the f32 kernel path against
    the f64 plain path (albedo and thermal max rel <= 8e-3, median rel <=
    1e-3, TPU_PARITY.json's SH tolerances; transit as phase 7)
12. timings: SH forwards with kernels vs the plain path, each SH kernel vs
    its twin
13. the split Toon kernels vs their twins at the production shape: K3
    (reflected) with Pollack Raman, K4 (thermal) without and with a hard
    surface, K5/K6 (from RTProps) on the unfused props and on the
    test_mode='rayleigh' props (max rel <= 1e-3, median rel <= 1e-5);
    each timed against its twin
14. the split Toon paths, counted over 4 forwards each: reflected-only
    (K1 + K3), thermal-only (K1 + K4), unfused optics (K1 + K5 + K6), and
    forward_batch of 4 phase-curve scenes at 0, 45, 90, 120 degrees
    (reflected-only, 6 x 6 disk: K1 + K3 once per scene); no other kernel
15. nwno = 5000 oracle of the split paths, f32 kernels vs f64 plain path
    (max rel <= 5e-3, median rel <= 2e-4): reflected-only with Oklopcic and
    with Pollack Raman, thermal-only, test_mode='constant_tau'
    (reflected-only, as the literature-validation runs use it)
16. timings: the split-path forwards and the phase-curve batch with
    kernels vs the plain path
17. the card, one JSON line with every kernel's summary, then the result
    line.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

NWNO = 50_000
NLEVEL = 91
ORACLE_NWNO = 5_000
N_SCENES = 4
TOL = {'gather_max_rel': 1e-5, 'spectrum_max_rel': 1e-3,
       'spectrum_median_rel': 1e-5, 'forward_max_rel': 5e-3,
       'forward_median_rel': 2e-4, 'sh_max_rel': 8e-3,
       'sh_median_rel': 1e-3}
SH_REPLACES = {'reflected_sh4': 'picaso_tpu/rt/pallas_sh.py:530',
               'thermal_sh4': 'picaso_tpu/rt/pallas_sh.py:717',
               'reflected_sh2': 'picaso_tpu/rt/pallas_sh.py:925',
               'thermal_sh2': 'picaso_tpu/rt/pallas_sh.py:1084'}
SPLIT_REPLACES = {'reflected_toon': 'picaso_tpu/rt/pallas_toon.py:700',
                  'thermal_toon': 'picaso_tpu/rt/pallas_toon.py:850',
                  'reflected_toon_props': 'picaso_tpu/rt/pallas_toon.py:462',
                  'thermal_toon_props': 'picaso_tpu/rt/pallas_toon.py:658'}
PHASES_DEG = (0.0, 45.0, 90.0, 120.0)


def log(msg):
    print(msg, flush=True)


def rel_stats(a, b):
    """(max, median) relative deviation of a from b, with the scale floored
    at 1e-9 of b's largest magnitude (scripts/tpu_parity.py)."""
    a, b = a.double().flatten(), b.double().flatten()
    scale = torch.clamp(b.abs(), min=b.abs().max().item() * 1e-9 + 1e-300)
    rel = (a - b).abs() / scale
    return rel.max().item(), rel.median().item()


def check(name, value, limit):
    ok = value <= limit
    log(f'  {name}: {value:.3e} (limit {limit:.0e}) {"OK" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{name} = {value:.3e} exceeds {limit:.0e}')


def cuda_ms(fn, n):
    """Mean device time of fn() over n calls, by CUDA events."""
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


def wall_ms(fn, n, passes=2):
    """Best-of-passes mean wall time of fn() + synchronize over n calls."""
    fn()
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3


def check_counts(got, expected):
    """Each kernel named in ``expected`` launched once per forward, every
    other kernel not at all."""
    for name, count in got.items():
        want = N_SCENES if name in expected else 0
        if count != want:
            raise AssertionError(f'{name} launched {count} times in '
                                 f'{N_SCENES} forwards, expected {want}')


def check_outputs(outs, keys=('albedo', 'thermal', 'transit_depth'),
                  shape=(NWNO,)):
    for i, out in enumerate(outs):
        assert set(out) == set(keys), out.keys()
        for key, val in out.items():
            if val.shape != shape or not torch.isfinite(val).all():
                raise AssertionError(f'scene {i} {key}: shape '
                                     f'{tuple(val.shape)} or non-finite')


def check_twin(label, out, ref):
    """Kernel output against its twin's: finite, max rel <= 1e-3, median
    rel <= 1e-5.  Returns the max abs difference."""
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise AssertionError(f'{label}: non-finite values')
    mx, med = rel_stats(out, ref)
    err = (out - ref).abs().max().item()
    log(f'[13] {label} kernel vs twin {tuple(out.shape)}: max abs '
        f'{err:.3e}')
    check(f'{label} max rel', mx, TOL['spectrum_max_rel'])
    check(f'{label} median rel', med, TOL['spectrum_median_rel'])
    return err


def perturbed(scene, n):
    """bench.py:179-182: temperatures scaled by (1 + 0.001 i)."""
    return [scene._replace(tlevel=scene.tlevel * (1 + 0.001 * i),
                           tlayer=scene.tlayer * (1 + 0.001 * i))
            for i in range(n)]


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; this script runs '
                         'only on a GPU machine')
    # phase 1: the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)} '
        f'count {torch.cuda.device_count()}')

    from picaso_tpu_torch import _build, disco, pipeline
    from picaso_tpu_torch.opacities.cuda_interp import (interp_tau,
                                                        interp_tau_plain)
    from picaso_tpu_torch.optics import combine_optics
    from picaso_tpu_torch.rt import cuda_sh, cuda_toon
    from picaso_tpu_torch.rt.cuda_toon import (spectrum_toon,
                                               spectrum_toon_plain)
    dev = torch.device('cuda')
    wrappers = {'interp_tau': interp_tau, 'spectrum_toon': spectrum_toon}
    wrappers.update({name: getattr(cuda_sh, name) for name in SH_REPLACES})
    wrappers.update({name: getattr(cuda_toon, name)
                     for name in SPLIT_REPLACES})

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f'[2] built {lib_path} in {time.perf_counter() - t0:.1f} s')

    # phase 3: the production problem
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    scene, grid, config = pipeline.build_problem(NWNO, nlevel=NLEVEL,
                                                 production=True, device=dev)
    torch.cuda.synchronize()
    table_bytes = grid.log_kappa.numel() * grid.log_kappa.element_size()
    log(f'[3] production problem in {time.perf_counter() - t0:.1f} s: '
        f'log_kappa {tuple(grid.log_kappa.shape)} {table_bytes} bytes, '
        f'{scene.ubar0.numel()} angles, peak '
        f'{torch.cuda.max_memory_allocated()} bytes')

    # phase 4: gather kernel vs twin
    g_args = pipeline.gather_args(scene, grid, config)
    k1 = interp_tau(*g_args)
    k1_ref = interp_tau_plain(*g_args)
    torch.cuda.synchronize()
    k1_max, k1_med = rel_stats(k1, k1_ref)
    k1_abs = (k1 - k1_ref).abs().max().item()
    log(f'[4] gather kernel vs twin {tuple(k1.shape)}: median rel '
        f'{k1_med:.3e}, max abs {k1_abs:.3e}')
    check('gather max rel', k1_max, TOL['gather_max_rel'])

    # phase 5: spectrum kernel vs twin
    tg, tr, rf = pipeline.rt_sources(scene, grid, config)
    s_args, s_kw = pipeline.spectrum_args(scene, grid, config, tg, tr, rf)
    xint, therm = spectrum_toon(*s_args, **s_kw)
    xint_ref, therm_ref = spectrum_toon_plain(*s_args, **s_kw)
    torch.cuda.synchronize()
    k2_abs = 0.0
    for name, out, ref in (('xint', xint, xint_ref),
                           ('thermal', therm, therm_ref)):
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            raise AssertionError(f'spectrum {name}: non-finite values')
        mx, med = rel_stats(out, ref)
        k2_abs = max(k2_abs, (out - ref).abs().max().item())
        log(f'[5] spectrum kernel vs twin, {name} {tuple(out.shape)}: '
            f'max abs {(out - ref).abs().max().item():.3e}')
        check(f'spectrum {name} max rel', mx, TOL['spectrum_max_rel'])
        check(f'spectrum {name} median rel', med,
              TOL['spectrum_median_rel'])
    del xint, therm, xint_ref, therm_ref

    # phase 6: the main path, counted
    scenes = perturbed(scene, N_SCENES)
    reset_counts()
    outs = [pipeline.forward(s, grid, config) for s in scenes]
    torch.cuda.synchronize()
    launches = counts()
    log(f'[6] {N_SCENES} forwards, launches {launches}')
    check_counts(launches, ('interp_tau', 'spectrum_toon'))
    check_outputs(outs)
    a = outs[0]
    log(f'    albedo mean {a["albedo"].mean().item():.6g}, thermal mean '
        f'{a["thermal"].mean().item():.6g}, transit mean '
        f'{a["transit_depth"].mean().item():.6g}')
    del outs

    # phase 7: float64 oracle
    o_scene, o_grid, o_config = pipeline.build_problem(
        ORACLE_NWNO, nlevel=NLEVEL, production=False, device=dev,
        dtype=torch.float64)
    oracle = pipeline.forward(o_scene, o_grid, dataclasses.replace(
        o_config, use_kernels=False))
    f_scene, f_grid, f_config = pipeline.build_problem(
        ORACLE_NWNO, nlevel=NLEVEL, production=False, device=dev)
    f_out = pipeline.forward(f_scene, f_grid, f_config)
    torch.cuda.synchronize()
    for key in ('albedo', 'thermal', 'transit_depth'):
        mx, med = rel_stats(f_out[key], oracle[key])
        log(f'[7] f32 kernels vs f64 oracle, {key}')
        check(f'{key} max rel', mx, TOL['forward_max_rel'])
        check(f'{key} median rel', med, TOL['forward_median_rel'])

    # phase 8: timings (nothing asserted)
    s0 = scenes[0]
    plain_cfg = dataclasses.replace(config, use_kernels=False)
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = wall_ms(lambda: pipeline.forward(s0, grid, config), 10)
    fwd_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain_ms = wall_ms(lambda: pipeline.forward(s0, grid, plain_cfg), 5)
    plain_peak = torch.cuda.max_memory_allocated()
    fwd_ms2 = wall_ms(lambda: pipeline.forward(s0, grid, config), 10)
    log(f'[8] forward, kernels: {fwd_ms:.3f} / {fwd_ms2:.3f} ms '
        f'({1e3 / min(fwd_ms, fwd_ms2):.2f} forwards/s), peak {fwd_peak} '
        f'bytes; plain path: {plain_ms:.3f} ms '
        f'({1e3 / plain_ms:.2f} forwards/s), peak {plain_peak} bytes')
    k1_ms = cuda_ms(lambda: interp_tau(*g_args), 20)
    k1_plain_ms = cuda_ms(lambda: interp_tau_plain(*g_args), 5)
    k2_ms = cuda_ms(lambda: spectrum_toon(*s_args, **s_kw), 10)
    k2_plain_ms = cuda_ms(lambda: spectrum_toon_plain(*s_args, **s_kw), 3)
    log(f'    interp_tau {k1_ms:.3f} ms vs twin {k1_plain_ms:.3f} ms; '
        f'spectrum_toon {k2_ms:.3f} ms vs twin {k2_plain_ms:.3f} ms')

    # phase 9: SH kernels vs twins at the production shape
    sh = {}
    for stream in (4, 2):
        cfg = dataclasses.replace(config, rt_method=1, stream=stream)
        (r_args, r_kw), (t_args, t_kw) = pipeline.sh_args(scene, grid, cfg,
                                                          tg, tr, rf)
        for kind, args, kw in (('reflected', r_args, r_kw),
                               ('thermal', t_args, t_kw)):
            name = f'{kind}_sh{stream}'
            kern = getattr(cuda_sh, name)
            twin = getattr(cuda_sh, f'{name}_plain')
            out = kern(*args, **kw)
            ref = twin(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
                raise AssertionError(f'{name}: non-finite values')
            mx, med = rel_stats(out, ref)
            err = (out - ref).abs().max().item()
            log(f'[9] {name} kernel vs twin {tuple(out.shape)}: max abs '
                f'{err:.3e}')
            check(f'{name} max rel', mx, TOL['spectrum_max_rel'])
            check(f'{name} median rel', med, TOL['spectrum_median_rel'])
            del out, ref
            sh[name] = {'max_abs_err': err,
                        'ms': cuda_ms(lambda: kern(*args, **kw), 10),
                        'plain_ms': cuda_ms(lambda: twin(*args, **kw), 2)}
            log(f'    {name} {sh[name]["ms"]:.3f} ms vs twin '
                f'{sh[name]["plain_ms"]:.3f} ms')

    # phase 10: the SH main paths, counted
    for stream in (4, 2):
        cfg = dataclasses.replace(config, rt_method=1, stream=stream)
        reset_counts()
        outs = [pipeline.forward(s, grid, cfg) for s in scenes]
        torch.cuda.synchronize()
        got = counts()
        log(f'[10] SH{stream}: {N_SCENES} forwards, launches {got}')
        check_counts(got, ('interp_tau', f'reflected_sh{stream}',
                           f'thermal_sh{stream}'))
        check_outputs(outs)
        for kind in ('reflected', 'thermal'):
            launches[f'{kind}_sh{stream}'] = got[f'{kind}_sh{stream}']
        a = outs[0]
        log(f'     albedo mean {a["albedo"].mean().item():.6g}, thermal '
            f'mean {a["thermal"].mean().item():.6g}')
        del outs

    # phase 11: float64 SH oracle
    for stream in (4, 2):
        oracle = pipeline.forward(o_scene, o_grid, dataclasses.replace(
            o_config, rt_method=1, stream=stream, use_kernels=False))
        f_out = pipeline.forward(f_scene, f_grid, dataclasses.replace(
            f_config, rt_method=1, stream=stream))
        torch.cuda.synchronize()
        for key in ('albedo', 'thermal', 'transit_depth'):
            mx, med = rel_stats(f_out[key], oracle[key])
            log(f'[11] SH{stream} f32 kernels vs f64 oracle, {key}')
            kind = 'forward' if key == 'transit_depth' else 'sh'
            check(f'SH{stream} {key} max rel', mx, TOL[f'{kind}_max_rel'])
            check(f'SH{stream} {key} median rel', med,
                  TOL[f'{kind}_median_rel'])

    # phase 12: SH forward timings (nothing asserted)
    for stream in (4, 2):
        cfg = dataclasses.replace(config, rt_method=1, stream=stream)
        plain_cfg = dataclasses.replace(cfg, use_kernels=False)
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = wall_ms(lambda: pipeline.forward(s0, grid, cfg), 10)
        fwd_peak = torch.cuda.max_memory_allocated()
        plain_ms = wall_ms(lambda: pipeline.forward(s0, grid, plain_cfg), 2)
        fwd_ms2 = wall_ms(lambda: pipeline.forward(s0, grid, cfg), 10)
        log(f'[12] SH{stream} forward, kernels: {fwd_ms:.3f} / '
            f'{fwd_ms2:.3f} ms ({1e3 / min(fwd_ms, fwd_ms2):.2f} '
            f'forwards/s), peak {fwd_peak} bytes; plain path: '
            f'{plain_ms:.3f} ms ({1e3 / plain_ms:.2f} forwards/s)')

    # phase 13: the split Toon kernels vs their twins (production shape)
    scene_p, _, config_p = pipeline.with_raman(scene, grid, config, 1)
    tg_p, tr_p, rf_p = pipeline.rt_sources(scene_p, grid, config_p)
    props = {mode: combine_optics(tg, tr, scene.cld_opd, scene.cld_w0,
                                  scene.cld_g0, rf, test_mode=mode)
             for mode in (None, 'rayleigh')}
    t_args, t_kw = pipeline.thermal_args(scene, grid, config, tg, tr)
    runs = {  # kernel -> [(label, args, kwargs)], the first one timed
        'reflected_toon': [('reflected_toon pollack', *pipeline.
                            reflected_args(scene_p, config_p, tg_p, tr_p,
                                           rf_p))],
        'thermal_toon': [
            (f'thermal_toon hard_surface={hs}', t_args,
             dict(t_kw, hard_surface=hs)) for hs in (False, True)],
        'reflected_toon_props': [
            (f'reflected_toon_props {mode or "unfused"}', *pipeline.
             reflected_args(scene, config, tg, tr, rf, props[mode]))
            for mode in props],
        'thermal_toon_props': [
            (f'thermal_toon_props {mode or "unfused"}', *pipeline.
             thermal_args(scene, grid, config, tg, tr, props[mode]))
            for mode in props],
    }
    split = {}
    for name, cases in runs.items():
        kern = getattr(cuda_toon, name)
        twin = getattr(cuda_toon, f'{name}_plain')
        err = 0.0
        for label, args, kw in cases:
            out = kern(*args, **kw)
            ref = twin(*args, **kw)
            torch.cuda.synchronize()
            err = max(err, check_twin(label, out, ref))
            del out, ref
        _, args, kw = cases[0]
        split[name] = {'max_abs_err': err,
                       'ms': cuda_ms(lambda: kern(*args, **kw), 10),
                       'plain_ms': cuda_ms(lambda: twin(*args, **kw), 3)}
        log(f'     {name} {split[name]["ms"]:.3f} ms vs twin '
            f'{split[name]["plain_ms"]:.3f} ms')
    del runs, props

    # phase 14: the split Toon paths, counted
    paths = {
        'reflected-only (Pollack)': (
            dataclasses.replace(config_p, thermal=False),
            perturbed(scene_p, N_SCENES), ('interp_tau', 'reflected_toon'),
            ('albedo', 'transit_depth')),
        'thermal-only': (
            dataclasses.replace(config, reflected=False), scenes,
            ('interp_tau', 'thermal_toon'), ('thermal', 'transit_depth')),
        'unfused optics': (
            dataclasses.replace(config, fuse_optics=False), scenes,
            ('interp_tau', 'reflected_toon_props', 'thermal_toon_props'),
            ('albedo', 'thermal', 'transit_depth')),
    }
    for label, (cfg, path_scenes, expected, keys) in paths.items():
        reset_counts()
        outs = [pipeline.forward(s, grid, cfg) for s in path_scenes]
        torch.cuda.synchronize()
        got = counts()
        log(f'[14] {label}: {N_SCENES} forwards, launches {got}')
        check_counts(got, expected)
        check_outputs(outs, keys)
        for name in expected:
            if name in SPLIT_REPLACES:
                launches[name] = got[name]
        log('     ' + ', '.join(f'{k} mean {outs[0][k].mean().item():.6g}'
                                for k in keys))
        del outs
    refl_cfg = paths['reflected-only (Pollack)'][0]
    phase_batch = pipeline.stack_scenes([
        pipeline.with_geometry(s, disco.make_geometry(
            math.radians(deg), num_gangle=6, num_tangle=6))
        for s, deg in zip(perturbed(scene_p, N_SCENES), PHASES_DEG)])
    reset_counts()
    batch_out = pipeline.forward_batch(phase_batch, grid, refl_cfg)
    torch.cuda.synchronize()
    got = counts()
    log(f'[14] phase curve at {PHASES_DEG} deg through forward_batch '
        f'({phase_batch.ubar0.shape[1]} x {phase_batch.ubar0.shape[2]} '
        f'disk), launches {got}')
    check_counts(got, ('interp_tau', 'reflected_toon'))
    check_outputs([batch_out], ('albedo', 'transit_depth'),
                  (N_SCENES, NWNO))
    log('     albedo mean per phase '
        + ', '.join(f'{a:.6g}' for a in batch_out['albedo'].mean(1).tolist()))
    del batch_out

    # phase 15: float64 oracle of the split paths
    oracle_cases = {
        'reflected-only, Oklopcic Raman': (0, dict(thermal=False)),
        'reflected-only, Pollack Raman': (1, dict(thermal=False)),
        'thermal-only': (2, dict(reflected=False)),
        "test_mode='constant_tau'": (2, dict(test_mode='constant_tau',
                                             thermal=False)),
    }
    for label, (raman, change) in oracle_cases.items():
        o_s, _, o_c = pipeline.with_raman(o_scene, o_grid, o_config, raman)
        f_s, _, f_c = pipeline.with_raman(f_scene, f_grid, f_config, raman)
        oracle = pipeline.forward(o_s, o_grid, dataclasses.replace(
            o_c, use_kernels=False, **change))
        f_out = pipeline.forward(f_s, f_grid, dataclasses.replace(
            f_c, **change))
        torch.cuda.synchronize()
        for key in f_out:
            mx, med = rel_stats(f_out[key], oracle[key])
            log(f'[15] {label}: f32 kernels vs f64 oracle, {key}')
            check(f'{key} max rel', mx, TOL['forward_max_rel'])
            check(f'{key} median rel', med, TOL['forward_median_rel'])

    # phase 16: timings of the split paths (nothing asserted)
    for label, (cfg, path_scenes, _, _) in paths.items():
        s0 = path_scenes[0]
        plain_cfg = dataclasses.replace(cfg, use_kernels=False)
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = wall_ms(lambda: pipeline.forward(s0, grid, cfg), 10)
        fwd_peak = torch.cuda.max_memory_allocated()
        plain_ms = wall_ms(lambda: pipeline.forward(s0, grid, plain_cfg), 3)
        fwd_ms2 = wall_ms(lambda: pipeline.forward(s0, grid, cfg), 10)
        log(f'[16] {label} forward, kernels: {fwd_ms:.3f} / {fwd_ms2:.3f} '
            f'ms ({1e3 / min(fwd_ms, fwd_ms2):.2f} forwards/s), peak '
            f'{fwd_peak} bytes; plain path: {plain_ms:.3f} ms '
            f'({1e3 / plain_ms:.2f} forwards/s)')
    plain_refl = dataclasses.replace(refl_cfg, use_kernels=False)
    b_ms = wall_ms(lambda: pipeline.forward_batch(phase_batch, grid,
                                                  refl_cfg), 5)
    b_plain_ms = wall_ms(lambda: pipeline.forward_batch(phase_batch, grid,
                                                        plain_refl), 2)
    log(f'[16] phase curve, {N_SCENES} scenes: kernels {b_ms:.3f} ms '
        f'({N_SCENES * 1e3 / b_ms:.2f} spectra/s); plain path '
        f'{b_plain_ms:.3f} ms')

    # phase 17: summary
    log(smi[0])
    kernels = [
        {'name': 'interp_tau', 'route': 'cuda',
         'source': 'picaso_tpu_torch/csrc/interp_tau.cu',
         'replaces': 'picaso_tpu/opacities/pallas_interp.py:263',
         'launches': launches['interp_tau'], 'max_abs_err': k1_abs,
         'ms': k1_ms, 'plain_ms': k1_plain_ms},
        {'name': 'spectrum_toon', 'route': 'cuda',
         'source': 'picaso_tpu_torch/csrc/toon_spectrum.cu',
         'replaces': 'picaso_tpu/rt/pallas_toon.py:788',
         'launches': launches['spectrum_toon'], 'max_abs_err': k2_abs,
         'ms': k2_ms, 'plain_ms': k2_plain_ms},
    ] + [
        {'name': name, 'route': 'cuda',
         'source': 'picaso_tpu_torch/csrc/sh_spectrum.cu',
         'replaces': SH_REPLACES[name], 'launches': launches[name],
         **sh[name]} for name in SH_REPLACES] + [
        {'name': name, 'route': 'cuda',
         'source': 'picaso_tpu_torch/csrc/toon_spectrum.cu',
         'replaces': SPLIT_REPLACES[name], 'launches': launches[name],
         **split[name]} for name in SPLIT_REPLACES]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
