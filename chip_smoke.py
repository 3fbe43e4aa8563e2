"""Smoke run of the PyTorch/CUDA port (picaso_tpu_torch) on one NVIDIA GPU.

Drives the port's main paths -- ``pipeline.build_problem`` and
``pipeline.forward`` at the production shape: ragged 1060-point (T, P)
grid, 16 molecules, nwno = 50 000, 90 layers, 5 disk angles, cloudy, 2 CIA
continua, Rayleigh, reflected + thermal + transit -- with the Toon solver
(reflected and thermal together, each alone, unfused optics; Raman off or
Pollack) and with the spherical-harmonics solver at 4 and 2 streams, a
4-point reflected phase curve through ``forward_batch``, the int16 opacity
table, and a sqlite database written, loaded and run on the card; then
the gather and sweep-layout probes.  It goes through the 14 hand-written
CUDA kernels, and checks each kernel against its plain PyTorch twin and
each forward against a float64 oracle.

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
17. the int16 table: quantize the production table on the card (bytes,
    seconds)
18. K8, the int16 gather, vs its twin at the production shape (max rel <=
    1e-5), timed against its twin
19. forward on the 4 perturbed scenes with the int16 grid: finite outputs,
    K8 and K2 once per forward, K1 never
20. nwno = 5000 oracle: the int16 f32 kernel path against the f64 plain
    path on the float table (max rel <= 5e-3, median rel <= 4e-3, the
    JAX package's int16 gate, scripts/tpu_parity.py:173-192)
21. sqlite round trip: write a '1060'-layout database (2 molecules,
    nwno 2000) with build_synthetic_db, load it onto the card with
    load_opacity_db, quantize it, one forward through K8 against the same
    grid's f32 plain path (phase 20's gate)
22. the probes' kernels vs their twins at the probes' shapes (layer-inner
    gather max rel <= 1e-5 against its twin, <= 1e-4 against K1 on
    stabilised slots; both sweep layouts <= 1e-5), then each probe's
    report with its kernels counted
23. the card, one JSON line with every kernel's summary (launches on its
    path, times, max abs error, and the bound: the larger of the bytes
    its inputs and outputs need over 3.35 TB/s and the float32
    operations its twin performs on these inputs, counted per aten call,
    over 67 TFLOP/s), then the result line.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
# every kernel: (its source, the TPU kernel it replaces)
KERNELS = {
    'interp_tau': ('interp_tau.cu',
                   'picaso_tpu/opacities/pallas_interp.py:263'),
    'spectrum_toon': ('toon_spectrum.cu', 'picaso_tpu/rt/pallas_toon.py:788'),
    **{name: ('sh_spectrum.cu', line) for name, line in SH_REPLACES.items()},
    **{name: ('toon_spectrum.cu', line)
       for name, line in SPLIT_REPLACES.items()},
    'interp_tau_q': ('interp_tau.cu',
                     'picaso_tpu/opacities/pallas_interp.py:243'),
    'interp_tau_layer_inner': ('gather_probe.cu',
                               'scripts/gather_probe.py:52'),
    'sweep_rows': ('sweep_layout_probe.cu', 'scripts/sweep_layout_probe.py:52'),
    'sweep_staged': ('sweep_layout_probe.cu',
                     'scripts/sweep_layout_probe.py:52'),
}
PHASES_DEG = (0.0, 45.0, 90.0, 120.0)
INT16_TOL = {'max_rel': 5e-3, 'median_rel': 20 * 2e-4}
DB_NWNO = 2_000
# one H100 SXM at its 700 W limit (NVIDIA data sheet): memory rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# elementwise float arithmetic counted one operation per output element;
# reductions and scans one per input element
_ELEMENTWISE = {'add', 'sub', 'rsub', 'mul', 'div', 'neg', 'reciprocal',
                'exp', 'expm1', 'exp2', 'log', 'log10', 'log1p', 'log2',
                'pow', 'sqrt', 'rsqrt', 'maximum', 'minimum', 'clamp',
                'clamp_min', 'clamp_max', 'abs', 'sign', 'sin', 'cos',
                'tanh', 'sigmoid', 'lerp', 'addcmul', 'addcdiv'}
_REDUCING = {'sum', 'cumsum', 'cumprod', 'prod', 'mean', 'amax', 'amin'}


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


def check_counts(got, expected, forwards=N_SCENES):
    """Each kernel named in ``expected`` launched once per forward, every
    other kernel not at all."""
    for name, count in got.items():
        want = forwards if name in expected else 0
        if count != want:
            raise AssertionError(f'{name} launched {count} times in '
                                 f'{forwards} forwards, expected {want}')


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


class OpCounter(TorchDispatchMode):
    """Counts the floating-point operations of the aten calls made inside
    it: the operation count of a kernel's twin, which repeats the kernel's
    arithmetic, on the same inputs."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip('_')
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            if name in _ELEMENTWISE:
                self.ops += out.numel()
            elif name in _REDUCING and isinstance(args[0], torch.Tensor):
                self.ops += args[0].numel()
            elif name in ('mm', 'bmm', 'matmul'):
                self.ops += 2 * out.numel() * args[0].shape[-1]
        return out


def counted(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its floating-point operation count)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.ops


def tensor_bytes(*objs):
    """Bytes of every tensor among ``objs`` (lists, tuples and dict values
    searched too)."""
    total = 0
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            total += obj.numel() * obj.element_size()
        elif isinstance(obj, (list, tuple)):
            total += tensor_bytes(*obj)
        elif isinstance(obj, dict):
            total += tensor_bytes(*obj.values())
    return total


def gather_bytes(table, idx, out, *small):
    """What a gather must move: the distinct table rows its row ids touch
    (every molecule, every wavenumber), the small per-layer inputs, and
    its output."""
    nmol, _, nwno = table.shape
    rows = torch.unique(idx).numel()
    return (rows * nmol * nwno * table.element_size()
            + tensor_bytes(idx, out, *small))


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


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
    from picaso_tpu_torch.opacities import factory
    from picaso_tpu_torch.opacities.cuda_interp import (interp_tau,
                                                        interp_tau_plain,
                                                        interp_tau_q,
                                                        interp_tau_q_plain)
    from picaso_tpu_torch.opacities.db import load_opacity_db
    from picaso_tpu_torch.optics import combine_optics
    from picaso_tpu_torch.probes import gather_probe, sweep_layout_probe
    from picaso_tpu_torch.rt import cuda_sh, cuda_toon
    from picaso_tpu_torch.rt.cuda_toon import (spectrum_toon,
                                               spectrum_toon_plain)
    dev = torch.device('cuda')
    wrappers = {'interp_tau': interp_tau, 'spectrum_toon': spectrum_toon}
    wrappers.update({name: getattr(cuda_sh, name) for name in SH_REPLACES})
    wrappers.update({name: getattr(cuda_toon, name)
                     for name in SPLIT_REPLACES})
    wrappers.update({
        'interp_tau_q': interp_tau_q,
        'interp_tau_layer_inner': gather_probe.interp_tau_layer_inner,
        'sweep_rows': sweep_layout_probe.sweep_rows,
        'sweep_staged': sweep_layout_probe.sweep_staged})

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
    k1_ref, k1_ops = counted(interp_tau_plain, *g_args)
    torch.cuda.synchronize()
    k1_bytes = gather_bytes(g_args[0], g_args[1], k1, *g_args[2:])
    k1_max, k1_med = rel_stats(k1, k1_ref)
    k1_abs = (k1 - k1_ref).abs().max().item()
    log(f'[4] gather kernel vs twin {tuple(k1.shape)}: median rel '
        f'{k1_med:.3e}, max abs {k1_abs:.3e}')
    check('gather max rel', k1_max, TOL['gather_max_rel'])

    # phase 5: spectrum kernel vs twin
    tg, tr, rf = pipeline.rt_sources(scene, grid, config)
    s_args, s_kw = pipeline.spectrum_args(scene, grid, config, tg, tr, rf)
    xint, therm = spectrum_toon(*s_args, **s_kw)
    (xint_ref, therm_ref), k2_ops = counted(spectrum_toon_plain, *s_args,
                                            **s_kw)
    torch.cuda.synchronize()
    k2_bytes = tensor_bytes(s_args, xint, therm)
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
            ref, ops = counted(twin, *args, **kw)
            torch.cuda.synchronize()
            nbytes = tensor_bytes(args, out)
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
                        'plain_ms': cuda_ms(lambda: twin(*args, **kw), 2),
                        'bytes': nbytes, 'ops': ops}
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
        sizes = []
        for label, args, kw in cases:
            out = kern(*args, **kw)
            ref, ops = counted(twin, *args, **kw)
            torch.cuda.synchronize()
            sizes.append((tensor_bytes(args, out), ops))
            err = max(err, check_twin(label, out, ref))
            del out, ref
        _, args, kw = cases[0]
        split[name] = {'max_abs_err': err,
                       'ms': cuda_ms(lambda: kern(*args, **kw), 10),
                       'plain_ms': cuda_ms(lambda: twin(*args, **kw), 3),
                       'bytes': sizes[0][0], 'ops': sizes[0][1]}
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

    # phase 17: the int16 table of the production grid, on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g16 = grid.with_blocked_table(quantize=True)
    torch.cuda.synchronize()
    q_seconds = time.perf_counter() - t0
    q_table = g16.log_kappa_blocked
    log(f'[17] int16 table {tuple(q_table.shape)} '
        f'{q_table.numel() * q_table.element_size()} bytes (float table '
        f'{table_bytes}) quantized in {q_seconds:.3f} s; qparams '
        f'{g16.blocked_qparams.tolist()}')

    # phase 18: K8 vs its twin at the production shape
    q_args = pipeline.gather_args(scene, g16, config)
    k8 = interp_tau_q(*q_args)
    k8_ref, k8_ops = counted(interp_tau_q_plain, *q_args)
    torch.cuda.synchronize()
    k8_bytes = gather_bytes(q_args[0], q_args[1], k8, *q_args[2:])
    k8_max, k8_med = rel_stats(k8, k8_ref)
    k8_abs = (k8 - k8_ref).abs().max().item()
    log(f'[18] int16 gather kernel vs twin {tuple(k8.shape)}: median rel '
        f'{k8_med:.3e}, max abs {k8_abs:.3e}; vs the float gather max rel '
        f'{rel_stats(k8, k1)[0]:.3e}')
    check('int16 gather max rel', k8_max, TOL['gather_max_rel'])
    k8_ms = cuda_ms(lambda: interp_tau_q(*q_args), 20)
    k8_plain_ms = cuda_ms(lambda: interp_tau_q_plain(*q_args), 5)
    log(f'     interp_tau_q {k8_ms:.3f} ms vs twin {k8_plain_ms:.3f} ms')
    del k8, k8_ref

    # phase 19: the int16 path, counted
    reset_counts()
    outs = [pipeline.forward(s, g16, config) for s in scenes]
    torch.cuda.synchronize()
    got = counts()
    log(f'[19] int16 table: {N_SCENES} forwards, launches {got}')
    check_counts(got, ('interp_tau_q', 'spectrum_toon'))
    check_outputs(outs)
    launches['interp_tau_q'] = got['interp_tau_q']
    log('     ' + ', '.join(f'{k} mean {v.mean().item():.6g}'
                            for k, v in outs[0].items()))
    del outs
    s0 = scenes[0]
    q_fwd = [wall_ms(lambda: pipeline.forward(s0, g16, config), 10)
             for _ in range(2)]
    log(f'     int16 forward, kernels: {q_fwd[0]:.3f} / {q_fwd[1]:.3f} ms '
        f'({1e3 / min(q_fwd):.2f} forwards/s)')

    # phase 20: float64 oracle of the int16 path
    oracle = pipeline.forward(o_scene, o_grid, dataclasses.replace(
        o_config, use_kernels=False))
    f_out = pipeline.forward(f_scene, f_grid.with_blocked_table(
        quantize=True), f_config)
    torch.cuda.synchronize()
    for key in ('albedo', 'thermal', 'transit_depth'):
        mx, med = rel_stats(f_out[key], oracle[key])
        log(f'[20] int16 f32 kernels vs f64 oracle, {key}')
        check(f'{key} max rel', mx, INT16_TOL['max_rel'])
        check(f'{key} median rel', med, INT16_TOL['median_rel'])

    # phase 21: sqlite round trip through the loader and K8
    db_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'build', 'chip_smoke')
    os.makedirs(db_dir, exist_ok=True)
    db_path = os.path.join(db_dir, 'opacity_1060.db')
    if os.path.exists(db_path):
        os.remove(db_path)
    t0 = time.perf_counter()
    factory.build_synthetic_db(db_path, np.linspace(300.0, 33000.0, DB_NWNO),
                               molecules=('H2O', 'CO'), pt_layout='1060',
                               device=dev)
    t1 = time.perf_counter()
    db_grid = load_opacity_db(db_path, device=dev)
    db_q = db_grid.with_blocked_table(quantize=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f'[21] wrote {db_path} ({os.path.getsize(db_path)} bytes) in '
        f'{t1 - t0:.2f} s, loaded and quantized in {t2 - t1:.2f} s: '
        f'log_kappa {tuple(db_grid.log_kappa.shape)}, molecules '
        f'{db_grid.molecules}, continua {db_grid.continuum_molecules}')
    db_scene, db_config = profile_scene(pipeline, db_grid)
    reset_counts()
    db_out = pipeline.forward(db_scene, db_q, db_config)
    torch.cuda.synchronize()
    got = counts()
    log(f'[21] one forward, launches {got}')
    check_counts(got, ('interp_tau_q', 'spectrum_toon'), forwards=1)
    db_ref = pipeline.forward(db_scene, db_grid, dataclasses.replace(
        db_config, use_kernels=False))
    check_outputs([db_out], shape=(DB_NWNO,))
    for key in ('albedo', 'thermal', 'transit_depth'):
        mx, med = rel_stats(db_out[key], db_ref[key])
        log(f'[21] database forward through K8 vs its f32 plain path, {key}')
        check(f'{key} max rel', mx, INT16_TOL['max_rel'])
        check(f'{key} median rel', med, INT16_TOL['median_rel'])
    os.remove(db_path)
    del db_grid, db_q

    # phase 22: the probes' kernels vs their twins, then their reports
    log_kappa, mixcol, slots = gather_probe.slot_inputs(scene, grid, config)
    li_kernel = gather_probe.interp_tau_layer_inner
    li_twin = gather_probe.interp_tau_layer_inner_plain
    li_abs = 0.0
    for name in ('raw', 'stabilized', 'parity'):
        ix, w = slots[name]
        out = li_kernel(log_kappa, ix, w, mixcol)
        ref, ops = counted(li_twin, log_kappa, ix, w, mixcol)
        torch.cuda.synchronize()
        li_abs = max(li_abs, (out - ref).abs().max().item())
        log(f'[22] layer-inner gather ({name} slots) vs twin')
        check(f'layer-inner {name} max rel', rel_stats(out, ref)[0],
              TOL['gather_max_rel'])
        check(f'layer-inner {name} vs K1 max rel', rel_stats(out, k1)[0],
              1e-4)
        if name == 'stabilized':
            li_ops, li_bytes = ops, gather_bytes(log_kappa, ix, out, w,
                                                 mixcol)
            li_plain_ms = cuda_ms(lambda: li_twin(log_kappa, ix, w, mixcol),
                                  3)
        del out, ref
    sw_args = sweep_layout_probe.sweep_inputs(90, 1920 * 128, dev)
    sw_ref, sw_ops = counted(sweep_layout_probe.sweep_plain, *sw_args)
    sw_plain_ms = cuda_ms(lambda: sweep_layout_probe.sweep_plain(*sw_args),
                          3)
    sw_abs = {}
    for name, fn in (('sweep_rows', sweep_layout_probe.sweep_rows),
                     ('sweep_staged', sweep_layout_probe.sweep_staged)):
        for kw in ([{}] if name == 'sweep_rows' else
                   [dict(tile=t) for t in sweep_layout_probe.TILES]):
            out = fn(*sw_args, **kw)
            torch.cuda.synchronize()
            sw_abs[name] = max(sw_abs.get(name, 0.0),
                               (out - sw_ref).abs().max().item())
            log(f'[22] {name} {kw} vs twin')
            check(f'{name} max rel', rel_stats(out, sw_ref)[0],
                  TOL['gather_max_rel'])
    sw_bytes = tensor_bytes(sw_args, sw_ref)
    del sw_args, sw_ref, out
    reset_counts()
    g_rep = gather_probe.report(scene, g16, config, n_iter=20, log=log)
    s_rep = sweep_layout_probe.report(n_iter=20, log=log)
    torch.cuda.synchronize()
    got = counts()
    log(f'[22] probes, launches {got}')
    for name in ('interp_tau_layer_inner', 'sweep_rows', 'sweep_staged'):
        if got[name] == 0:
            raise AssertionError(f'{name} was not launched by its probe')
        launches[name] = got[name]
    staged_ms, staged_label = min((v, k) for k, v in s_rep['ms'].items()
                                  if k != 'rows')

    # phase 23: summary
    log(smi[0])
    stats = {
        'interp_tau': dict(max_abs_err=k1_abs, ms=k1_ms,
                           plain_ms=k1_plain_ms, bytes=k1_bytes, ops=k1_ops),
        'spectrum_toon': dict(max_abs_err=k2_abs, ms=k2_ms,
                              plain_ms=k2_plain_ms, bytes=k2_bytes,
                              ops=k2_ops),
        **sh, **split,
        'interp_tau_q': dict(max_abs_err=k8_abs, ms=k8_ms,
                             plain_ms=k8_plain_ms, bytes=k8_bytes,
                             ops=k8_ops),
        'interp_tau_layer_inner': dict(
            max_abs_err=li_abs, ms=g_rep['ms']['layer-inner (stabilized)'],
            plain_ms=li_plain_ms, bytes=li_bytes, ops=li_ops),
        'sweep_rows': dict(max_abs_err=sw_abs['sweep_rows'],
                           ms=s_rep['ms']['rows'], plain_ms=sw_plain_ms,
                           bytes=sw_bytes, ops=sw_ops),
        'sweep_staged': dict(max_abs_err=sw_abs['sweep_staged'],
                             ms=staged_ms, plain_ms=sw_plain_ms,
                             bytes=sw_bytes, ops=sw_ops,
                             layout=staged_label),
    }
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        st = stats[name]
        bound_ms, bound_by = bound(st['bytes'], st['ops'])
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'picaso_tpu_torch/csrc/{source}',
            'replaces': replaces, 'launches': launches[name],
            **st, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'bound_share': bound_ms / st['ms'], 'library_ms': None})
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def profile_scene(pipeline, grid, nlevel=NLEVEL):
    """``build_problem``'s profile (bench.py:121-137: cloudy, 2 CIA
    continua, Rayleigh, transit) over ``grid``'s molecules, with
    ``pipeline.MIX_16``'s mixing ratios: (scene, config)."""
    nwno = grid.wno.shape[0]
    nlayer = nlevel - 1
    pressure = np.logspace(-6, 2.5, nlevel)
    temperature = np.clip(1200.0 * (pressure / 50.0) ** 0.08, 150.0, None)
    mix = {'H2': np.zeros(nlevel) + 0.84, 'He': np.zeros(nlevel) + 0.155}
    for m in grid.molecules:
        mix[m] = np.zeros(nlevel) + pipeline.MIX_16[m]
    cld = {'opd': np.repeat(np.linspace(0.0, 1.0, nlayer) ** 2, nwno),
           'g0': np.zeros(nlayer * nwno) + 0.85,
           'w0': np.zeros(nlayer * nwno) + 0.95}
    return pipeline.scene_from_arrays(
        pressure, temperature, mix, grid, gravity=2500.0, radius=7.1492e9,
        mass=1.898e30, cld=cld, rstar=6.96e10)


if __name__ == '__main__':
    sys.exit(main())
