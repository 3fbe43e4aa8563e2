"""The spectrum pipeline: opacities -> optics -> RT -> disk integration.

Port of ``picaso_tpu/pipeline.py`` for the Toon two-stream solver
(``rt_method=0``) and the spherical-harmonics solver (``rt_method=1``,
stream 2 or 4): reflected and/or thermal, with transmission when the star
radius is finite, Raman modes 0 (Oklopcic), 1 (Pollack) and 2 (none),
fused or unfused optics and the ``test_mode`` optics.  With
``use_kernels`` (the default) the hot stages go through the hand-written
kernels:

* ``opacities.cuda_interp.interp_tau`` -- the molecular opacity gather,
  or ``interp_tau_q`` when the grid carries the int16 table
  (``OpacityGrid.with_blocked_table(quantize=True)``,
  ``build_problem(blocked='int16')``);
* ``rt.cuda_toon.spectrum_toon`` -- Toon optics + reflected + thermal, when
  both are asked for (fused optics, no test mode);
* ``rt.cuda_toon.reflected_toon`` / ``thermal_toon`` -- one of the two
  alone;
* ``rt.cuda_toon.reflected_toon_props`` / ``thermal_toon_props`` -- the
  Toon solves from ``combine_optics``' RTProps, when ``fuse_optics`` is
  off or a ``test_mode`` is set;
* ``rt.cuda_sh.reflected_sh{4,2}`` / ``thermal_sh{4,2}`` -- SH optics and
  solves (fused optics, no test mode; otherwise the plain SH path, as in
  the JAX package).

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
twin for CPU tensors.  ``use_kernels=False`` runs the plain reference
path instead (``interp_molecular`` + ``molecular_tau``, ``combine_optics``
+ ``reflected_1d``/``thermal_1d`` or ``sh.reflected_sh``/``thermal_sh``),
the counterpart of the JAX scan path.  Everything between the kernels
(continuum, Rayleigh, Raman, Planck, disk compression, transit) is plain
PyTorch.  :func:`forward_batch` runs a stacked batch of scenes
(:func:`stack_scenes`) one scene after another.

Every Toon route takes ``multi_phase`` 0 (N=2), 1 (N=1) and 2 (isotropic:
unit Legendre terms, as the JAX scan path; the JAX Pallas kernel takes N=1
there instead).  :func:`scene_from_case` builds a scene from the front
door's ``justdoit.inputs`` bundle.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import checked_device, default_dtype
from . import disco as disco_mod
from . import profiling
from . import raman as raman_mod
from .constants import PCONV
from .opacities import assemble
from .opacities.cuda_interp import interp_tau, interp_tau_q
from .opacities.db import (OpacityGrid, _find_indices, interp_molecular,
                           nearest_continuum)
from .optics import combine_optics
from .rt import cuda_sh, cuda_toon, sh, toon
from .rt.cuda_toon import REFLECTED_FIELDS, spectrum_toon
from .rt.transit import transit_depth

__all__ = ['SceneTensors', 'SpectrumConfig', 'forward', 'forward_parts',
           'scene_transit_depth', 'forward_batch', 'stack_scenes',
           'unstack_scene', 'with_geometry', 'with_raman',
           'stellar_shifts_5700k', 'gather_args', 'gather_taugas',
           'rt_sources', 'spectrum_args', 'reflected_args', 'thermal_args',
           'sh_args', 'scene_from_arrays', 'scene_from_case', 'build_problem',
           'MOLECULES_16', 'MIX_16']


class SceneTensors(NamedTuple):
    """All per-scene tensors (CGS), field for field as in the JAX package."""
    tlevel: torch.Tensor          # [nlevel]
    plevel: torch.Tensor          # [nlevel] dyne/cm^2
    tlayer: torch.Tensor          # [nlayer]
    player: torch.Tensor          # [nlayer] dyne/cm^2
    colden: torch.Tensor          # [nlayer] g/cm^2
    mmw_layer: torch.Tensor       # [nlayer] amu
    mix: torch.Tensor             # [nmol, nlayer] mixing ratios
    electrons: torch.Tensor       # [nlayer]
    z: torch.Tensor               # [nlevel] cm
    dz: torch.Tensor              # [nlevel] cm
    cld_opd: torch.Tensor         # [nlayer, nwno]
    cld_g0: torch.Tensor
    cld_w0: torch.Tensor
    sigma_ray: torch.Tensor       # [nray, nwno] Rayleigh cross sections
    mix_ray: torch.Tensor         # [nray, nlayer]
    ubar0: torch.Tensor           # [ng, nt]
    ubar1: torch.Tensor
    gweight: torch.Tensor
    tweight: torch.Tensor
    F0PI: torch.Tensor            # [nwno]
    surf_reflect: torch.Tensor    # [nwno]
    rstar: torch.Tensor           # scalar (cm)
    cos_theta: torch.Tensor       # scalar cos(phase angle)
    # Raman inputs (empty/neutral when the scene was built without them):
    raman_shifts: torch.Tensor    # [nrow, nwno] stellar shift ratios
    raman_c: torch.Tensor         # [nrow]
    raman_ji: torch.Tensor        # [nrow] int32
    raman_dnu: torch.Tensor       # [nrow]
    raman_pollack_row: torch.Tensor  # [nwno]


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    """Options that shape the computation (static in the JAX package)."""
    mol_indices: Tuple[int, ...]          # rows of grid.log_kappa to use
    continuum_specs: Tuple[assemble.ContinuumSpec, ...]
    cont_indices: Tuple[int, ...]         # rows of grid.cont_opa per spec
    mix_index: Tuple[Tuple[str, int], ...]  # molecule name -> row in mix
    controls: toon.ScatteringControls = toon.ScatteringControls()
    raman: int = 2                        # 0 oklopcic 1 pollack 2 none
    delta_eddington: bool = True
    stream: int = 2
    rt_method: int = 0                    # 0 Toon89, 1 spherical harmonics
    # SH options (config.json approx.rt_params.SH), the JAX defaults
    sh_w_single_form: int = 0
    sh_w_multi_form: int = 0
    sh_psingle_form: int = 0
    sh_w_single_rayleigh: int = 1
    sh_w_multi_rayleigh: int = 1
    sh_psingle_rayleigh: int = 1
    sh_single_form: int = 0
    # SH working precision of the plain path ('auto': f64 for float64
    # inputs, else the f32 incoming grouping; rt/sh.py precision note)
    sh_precision: str = 'auto'
    test_mode: Optional[str] = None
    hard_surface: bool = False
    reflected: bool = True
    thermal: bool = True
    transmission: bool = False
    # the hand-written kernels (CUDA tensors) or their twins (CPU tensors);
    # False runs the plain reference path
    use_kernels: bool = True
    # build the optics inside the RT kernels; False runs combine_optics and
    # the kernels that read its RTProps (as does any test_mode)
    fuse_optics: bool = True

    def mix_row(self, name):
        """Row of ``SceneTensors.mix`` that holds molecule ``name``;
        ``KeyError`` for a molecule the scene does not carry."""
        return dict(self.mix_index)[name]


def _check_config(config: SpectrumConfig):
    if config.rt_method not in (0, 1):
        raise ValueError(f'unknown rt_method {config.rt_method}')
    if config.rt_method == 1 and config.stream not in (2, 4):
        raise ValueError(f'SH RT takes stream 2 or 4, got {config.stream}')
    if config.raman not in (0, 1, 2):
        raise ValueError(f'unknown raman mode {config.raman}')
    if config.rt_method == 0 and config.reflected:
        cuda_toon._check_controls(config.controls, config.stream)


def _quantized(grid: OpacityGrid):
    return (grid.log_kappa_blocked is not None
            and grid.log_kappa_blocked.dtype == torch.int16)


def gather_args(scene: SceneTensors, grid: OpacityGrid,
                config: SpectrumConfig):
    """The arguments of the gather kernel the grid routes to: (log_kappa,
    idx, t_w, p_w, mixcol) for ``interp_tau``, or (q, idx, t_w, p_w,
    mixcol, qparams) for ``interp_tau_q`` when the grid carries the int16
    table (picaso_tpu/pipeline.py:165-168): neighbour rows and weights of
    every layer, and the mix * colden / mmw column weight of every table
    molecule (zero for unused ones)."""
    nlayer = scene.tlayer.shape[0]
    rows = [dict(config.mix_index)[grid.molecules[i]]
            for i in config.mol_indices]
    t_w, p_w, idx = _find_indices(grid.pt, scene.tlayer,
                                  scene.player / PCONV)
    colw = scene.colden / scene.mmw_layer
    mixcol = torch.zeros((len(grid.molecules), nlayer),
                         dtype=scene.mix.dtype, device=scene.mix.device)
    mixcol[list(config.mol_indices)] = scene.mix[rows] * colw
    if _quantized(grid):
        return (grid.log_kappa_blocked, idx, t_w, p_w, mixcol,
                grid.blocked_qparams)
    return grid.log_kappa, idx, t_w, p_w, mixcol


def gather_taugas(scene: SceneTensors, grid: OpacityGrid,
                  config: SpectrumConfig):
    """The molecular-opacity stage alone: taugas [nlayer, nwno].  With
    ``use_kernels`` the gather kernel of :func:`gather_args` (K8 on an
    int16 grid, else K1); without, the plain float path on ``log_kappa``,
    as in the JAX package.  Recorded as the span ``picaso.gather``."""
    with profiling.span('picaso.gather'):
        if config.use_kernels:
            gather = interp_tau_q if _quantized(grid) else interp_tau
            return gather(*gather_args(scene, grid, config))
        rows = [dict(config.mix_index)[grid.molecules[i]]
                for i in config.mol_indices]
        kappa = interp_molecular(grid, scene.tlayer, scene.player / PCONV)
        kappa = kappa[list(config.mol_indices)]
        return assemble.molecular_tau(kappa, scene.mix[rows], scene.colden,
                                      scene.mmw_layer)


def rt_sources(scene: SceneTensors, grid: OpacityGrid,
               config: SpectrumConfig):
    """Per-source optical depths (taugas with continua, tauray) and the
    Raman factor, each [nlayer, nwno] and contiguous.  The spans
    ``picaso.gather`` (:func:`gather_taugas`) and ``picaso.sources`` (the
    rest) record the two stages."""
    nlayer = scene.tlayer.shape[0]
    dtype = scene.cld_opd.dtype
    dev = scene.cld_opd.device

    taugas = gather_taugas(scene, grid, config)
    with profiling.span('picaso.sources'):
        if config.continuum_specs:
            cont = nearest_continuum(grid, scene.tlayer)
            # layer gravity from the column-density definition colden =
            # dP/g
            gravity_layer = ((scene.plevel[1:] - scene.plevel[:-1])
                             / scene.colden)
            coef1 = assemble.amagat_coef1(
                scene.tlevel, scene.plevel / PCONV, scene.tlayer,
                scene.player / PCONV, gravity_layer, scene.mmw_layer)
            mix_named = {name: scene.mix[row]
                         for name, row in config.mix_index}
            cont_kappa = {spec.name: cont[ci] for spec, ci in
                          zip(config.continuum_specs, config.cont_indices)}
            for spec in config.continuum_specs:
                for m in (spec.mol1, spec.mol2):
                    if m and m not in mix_named:
                        mix_named[m] = torch.zeros(nlayer, dtype=dtype,
                                                   device=dev)
            taugas = taugas + assemble.continuum_tau(
                config.continuum_specs, cont_kappa, mix_named,
                scene.electrons, coef1, scene.player, scene.tlayer,
                scene.colden, scene.mmw_layer)
        tauray = assemble.rayleigh_tau(scene.sigma_ray, scene.mix_ray,
                                       scene.colden, scene.mmw_layer)
        rf = _raman_factor(config, scene, grid.wno)
        return (taugas.to(dtype).contiguous(),
                tauray.to(dtype).contiguous(), rf.contiguous())


def _raman_factor(config, scene: SceneTensors, wno):
    """Raman single-scattering factor [nlayer, nwno]
    (picaso_tpu/pipeline.py:119-135): 0 = Oklopcic, from the scene's
    stellar shift ratios; 1 = Pollack, the scene's precomputed row;
    2 = none.  Capped at 0.99999."""
    nlayer = scene.tlayer.shape[0]
    nwno = wno.shape[0]
    dtype = scene.cld_opd.dtype
    if config.raman == 0:
        rf = raman_mod.raman_factor_oklopcic(
            wno, scene.raman_shifts.T, scene.tlayer, scene.raman_c,
            scene.raman_ji, scene.raman_dnu)
        return torch.clamp(rf, max=0.99999).to(dtype)
    if config.raman == 1:
        row = torch.clamp(scene.raman_pollack_row, max=0.99999).to(dtype)
        return row[None, :].expand(nlayer, nwno)
    return torch.full((nlayer, nwno), 0.99999, dtype=dtype,
                      device=scene.cld_opd.device)


def _planck_args(scene: SceneTensors, grid: OpacityGrid):
    """Level Planck function all_b [nlevel, nwno] and the top-boundary
    factor ptfac = p0 / (p1 - p0) the thermal kernels take."""
    all_b = toon.blackbody(scene.tlevel, 1.0 / grid.wno).to(
        scene.cld_opd.dtype)
    ptfac = scene.plevel[0] / (scene.plevel[1] - scene.plevel[0])
    return all_b, ptfac


def spectrum_args(scene: SceneTensors, grid: OpacityGrid, config, tg, tr,
                  rf):
    """The Toon spectrum kernel's arguments and options, as ``forward``
    passes them: (args, kwargs) for ``spectrum_toon``."""
    all_b, ptfac = _planck_args(scene, grid)
    args = (all_b, tg, tr, scene.cld_opd, scene.cld_w0, scene.cld_g0, rf,
            ptfac, scene.surf_reflect, scene.ubar0, scene.ubar1,
            scene.cos_theta, scene.F0PI)
    kwargs = dict(controls=config.controls, stream=config.stream,
                  delta_eddington=config.delta_eddington,
                  hard_surface=config.hard_surface)
    return args, kwargs


def reflected_args(scene: SceneTensors, config, tg, tr, rf, props=None):
    """The Toon reflected kernel's arguments and options, as ``forward``
    passes them: (args, kwargs) for ``reflected_toon`` (K3), or, given the
    RTProps ``props``, for ``reflected_toon_props`` (K5) and the plain
    ``toon.reflected_1d``."""
    geom = (scene.surf_reflect, scene.ubar0, scene.ubar1, scene.cos_theta,
            scene.F0PI)
    if props is not None:
        return (tuple(getattr(props, f) for f in REFLECTED_FIELDS) + geom,
                dict(controls=config.controls))
    return ((tg, tr, scene.cld_opd, scene.cld_w0, scene.cld_g0, rf) + geom,
            dict(controls=config.controls, stream=config.stream,
                 delta_eddington=config.delta_eddington))


def thermal_args(scene: SceneTensors, grid: OpacityGrid, config, tg, tr,
                 props=None):
    """The Toon thermal kernel's arguments and options, as ``forward``
    passes them: (args, kwargs) for ``thermal_toon`` (K4), or, given the
    RTProps ``props``, for ``thermal_toon_props`` (K6) with the above-model
    tau_top of ``pipeline.py:390-391``."""
    all_b, ptfac = _planck_args(scene, grid)
    kwargs = dict(hard_surface=config.hard_surface)
    if props is not None:
        tau_top = (props.dtau_og[0] * scene.plevel[0]
                   / (scene.plevel[1] - scene.plevel[0]))
        return ((all_b, props.dtau_og, props.w0_no_raman, props.cosb_og,
                 tau_top, scene.surf_reflect, scene.ubar1), kwargs)
    return ((all_b, tg, tr, scene.cld_opd, scene.cld_w0, scene.cld_g0,
             ptfac, scene.surf_reflect, scene.ubar1), kwargs)


def _props(scene: SceneTensors, config, tg, tr, rf):
    return combine_optics(tg, tr, scene.cld_opd, scene.cld_w0, scene.cld_g0,
                          rf, test_mode=config.test_mode,
                          delta_eddington=config.delta_eddington,
                          stream=config.stream)


def _toon_rt(scene: SceneTensors, grid: OpacityGrid, config, tg, tr, rf):
    """Toon branch (picaso_tpu/pipeline.py:214-274, 328-408): (xint or
    None, thermal flux or None, total extinction for transit)."""
    xint = flux_top = None
    fused = config.fuse_optics and config.test_mode is None
    if config.use_kernels and fused:
        if config.reflected and config.thermal:
            args, kwargs = spectrum_args(scene, grid, config, tg, tr, rf)
            xint, flux_top = spectrum_toon(*args, **kwargs)
        elif config.reflected:
            args, kwargs = reflected_args(scene, config, tg, tr, rf)
            xint = cuda_toon.reflected_toon(*args, **kwargs)
        elif config.thermal:
            args, kwargs = thermal_args(scene, grid, config, tg, tr)
            flux_top = cuda_toon.thermal_toon(*args, **kwargs)
        return xint, flux_top, tg + tr + scene.cld_opd
    props = _props(scene, config, tg, tr, rf)
    if config.reflected:
        args, kwargs = reflected_args(scene, config, tg, tr, rf, props)
        xint = (cuda_toon.reflected_toon_props(*args, **kwargs)
                if config.use_kernels else toon.reflected_1d(*args, **kwargs))
    if config.thermal:
        if config.use_kernels:
            args, kwargs = thermal_args(scene, grid, config, tg, tr, props)
            flux_top = cuda_toon.thermal_toon_props(*args, **kwargs)
        else:
            flux_top = toon.thermal_1d(
                scene.tlevel, props.dtau_og, props.w0_no_raman,
                props.cosb_og, scene.plevel, scene.ubar1, scene.surf_reflect,
                grid.wno, hard_surface=config.hard_surface)
    return xint, flux_top, props.dtau_og


def sh_args(scene: SceneTensors, grid: OpacityGrid, config, tg, tr, rf):
    """The SH kernels' arguments and options, as ``forward`` passes them:
    ((args, kwargs) of ``reflected_sh{4,2}``, (args, kwargs) of
    ``thermal_sh{4,2}``)."""
    strips = (tg, tr, scene.cld_opd, scene.cld_w0, scene.cld_g0, rf)
    refl = (strips + (scene.surf_reflect, scene.ubar0, scene.ubar1,
                      scene.cos_theta, scene.F0PI),
            dict(controls=config.controls,
                 delta_eddington=config.delta_eddington,
                 w_single_form=config.sh_w_single_form,
                 w_multi_form=config.sh_w_multi_form,
                 psingle_form=config.sh_psingle_form,
                 w_single_rayleigh=config.sh_w_single_rayleigh,
                 w_multi_rayleigh=config.sh_w_multi_rayleigh,
                 psingle_rayleigh=config.sh_psingle_rayleigh,
                 single_form=config.sh_single_form))
    all_b, ptfac = _planck_args(scene, grid)
    therm = ((all_b,) + strips + (ptfac, scene.surf_reflect, scene.ubar1),
             dict(hard_surface=config.hard_surface,
                  delta_eddington=config.delta_eddington))
    return refl, therm


def _sh_rt(scene: SceneTensors, grid: OpacityGrid, config, tg, tr, rf):
    """SH branch (picaso_tpu/pipeline.py:276-365): (xint or None, thermal
    flux or None, total extinction for transit)."""
    xint = flux_top = None
    if config.use_kernels and config.fuse_optics and config.test_mode is None:
        (r_args, r_kw), (t_args, t_kw) = sh_args(scene, grid, config, tg,
                                                 tr, rf)
        if config.stream == 4:
            refl_k, therm_k = cuda_sh.reflected_sh4, cuda_sh.thermal_sh4
        else:
            refl_k, therm_k = cuda_sh.reflected_sh2, cuda_sh.thermal_sh2
        if config.reflected:
            xint = refl_k(*r_args, **r_kw)
        if config.thermal:
            flux_top = therm_k(*t_args, **t_kw)
        return xint, flux_top, tg + tr + scene.cld_opd
    # SH kernels build the default-branch optics themselves; test modes
    # and unfused optics take the plain SH path (pipeline.py:276-277)
    props = _props(scene, config, tg, tr, rf)
    if config.reflected:
        xint = sh.reflected_sh(
            props, scene.surf_reflect, scene.ubar0, scene.ubar1,
            scene.cos_theta, scene.F0PI, stream=config.stream,
            controls=config.controls,
            w_single_form=config.sh_w_single_form,
            w_multi_form=config.sh_w_multi_form,
            psingle_form=config.sh_psingle_form,
            w_single_rayleigh=config.sh_w_single_rayleigh,
            w_multi_rayleigh=config.sh_w_multi_rayleigh,
            psingle_rayleigh=config.sh_psingle_rayleigh,
            single_form=config.sh_single_form,
            precision=config.sh_precision)
    if config.thermal:
        flux_top = sh.thermal_sh(
            scene.tlevel, props, scene.plevel, scene.ubar1,
            scene.surf_reflect, grid.wno, stream=config.stream,
            hard_surface=config.hard_surface,
            precision=config.sh_precision)
    return xint, flux_top, props.dtau_og


def forward_parts(scene: SceneTensors, grid: OpacityGrid,
                  config: SpectrumConfig):
    """``forward`` but the transit depth: (the dict of albedo and thermal,
    the total optical depth [nlayer, nwno] that the transit depth reads).
    ``parallel.sharded_forward`` runs this per wave shard and the transit
    depth once over the gathered optical depths.  Spans: ``picaso.gather``,
    ``picaso.sources``, ``picaso.rt`` and ``picaso.disco``, in that
    order."""
    _check_config(config)
    tg, tr, rf = rt_sources(scene, grid, config)
    rt = _sh_rt if config.rt_method == 1 else _toon_rt
    with profiling.span('picaso.rt'):
        xint, flux_top, dtau_total = rt(scene, grid, config, tg, tr, rf)
    out = {}
    with profiling.span('picaso.disco'):
        if xint is not None:
            out['albedo'] = disco_mod.compress_disco(
                xint, scene.gweight, scene.tweight, scene.cos_theta,
                scene.F0PI)
        if flux_top is not None:
            out['thermal'] = disco_mod.compress_thermal(
                flux_top, scene.gweight, scene.tweight)
    return out, dtau_total


def scene_transit_depth(scene: SceneTensors, dtau_total):
    """The transit depth [nwno] of ``scene`` from its total optical depth
    [nlayer, nwno] (``forward_parts``)."""
    return transit_depth(scene.z, scene.dz, scene.rstar, scene.mmw_layer,
                         scene.plevel, scene.tlevel, scene.colden,
                         dtau_total)


def forward(scene: SceneTensors, grid: OpacityGrid, config: SpectrumConfig):
    """Full 1D spectrum: a dict of tensors albedo [nwno] (when
    ``config.reflected``), thermal [nwno] (when ``config.thermal``) and,
    with ``config.transmission``, transit_depth [nwno].  Recorded as the
    span ``picaso.forward``, the transit depth inside it as
    ``picaso.transit``."""
    with profiling.span('picaso.forward'):
        return _forward(scene, grid, config)


def _forward(scene: SceneTensors, grid: OpacityGrid,
             config: SpectrumConfig):
    out, dtau_total = forward_parts(scene, grid, config)
    if config.transmission:
        with profiling.span('picaso.transit'):
            out['transit_depth'] = scene_transit_depth(scene, dtau_total)
    return out


# small per-scene geometry fields, each with its UNBATCHED rank
# (picaso_tpu/pipeline.py:450-451): stack_scenes leaves a batch-constant
# one at this rank, and forward_batch reads only the rank to tell a shared
# field from a batched one
_SCALARISH_RANK = {'ubar0': 2, 'ubar1': 2, 'gweight': 1, 'tweight': 1,
                   'cos_theta': 0, 'F0PI': 1, 'surf_reflect': 1}


def stack_scenes(scenes):
    """Stack same-shaped SceneTensors along a new leading batch axis
    (picaso_tpu/pipeline.py:411-441): phase-curve points, retrieval live
    points, grid members.  A geometry-like field (``_SCALARISH_RANK``) that
    is the same in every scene -- the retrieval case -- stays unbatched;
    one that varies -- phase curves -- gains the axis like every other
    field.  Recorded as the span ``picaso.stack_scenes``."""
    with profiling.span('picaso.stack_scenes'):
        fields = {}
        for name in SceneTensors._fields:
            leaves = [getattr(s, name) for s in scenes]
            first = leaves[0]
            if name in _SCALARISH_RANK and all(
                    leaf is first or torch.equal(leaf, first)
                    for leaf in leaves[1:]):
                fields[name] = first
            else:
                fields[name] = torch.stack(leaves)
        return SceneTensors(**fields)


def forward_batch(scenes: SceneTensors, grid: OpacityGrid,
                  config: SpectrumConfig):
    """``forward`` over a batch from :func:`stack_scenes`: every field has a
    leading batch axis except the batch-constant geometry fields, which sit
    at their unbatched rank (picaso_tpu/pipeline.py:454-475).  Outputs gain
    the batch axis.  The scenes run one after another through ``forward``
    (each launching its kernels); a batch axis inside the kernels is
    ROADMAP Queue 6 item 3.  Spans: ``picaso.forward_batch`` around the
    call, ``picaso.forward`` around each scene's unstacking and forward,
    ``picaso.outputs`` around the final stack."""
    with profiling.span('picaso.forward_batch'):
        outs = []
        for b in range(scenes.tlevel.shape[0]):
            with profiling.span('picaso.forward'):
                outs.append(_forward(unstack_scene(scenes, b), grid, config))
        with profiling.span('picaso.outputs'):
            return {key: torch.stack([o[key] for o in outs])
                    for key in outs[0]}


def unstack_scene(scenes: SceneTensors, b) -> SceneTensors:
    """Scene ``b`` of a :func:`stack_scenes` batch (a batch-constant
    geometry field, at its unbatched rank, is shared)."""
    return SceneTensors(**{
        name: val if _SCALARISH_RANK.get(name) == val.dim() else val[b]
        for name, val in scenes._asdict().items()})


def with_geometry(scene: SceneTensors, geom):
    """``scene`` with the disk geometry ``geom`` (a ``disco.Geometry``), as
    the JAX package's bench builds phase-curve scenes
    (bench.py:627-636).  Recorded as the span ``picaso.with_geometry``."""
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=scene.ubar0.dtype,
                               device=scene.ubar0.device)
    with profiling.span('picaso.with_geometry'):
        return scene._replace(ubar0=t(geom.ubar0), ubar1=t(geom.ubar1),
                              gweight=t(geom.gweight),
                              tweight=t(geom.tweight),
                              cos_theta=t(geom.cos_theta))


@profiling.counted('scene_from_arrays')
def scene_from_arrays(profile_bar, t_level, mix_named, grid: OpacityGrid,
                      gravity, radius=np.nan, mass=np.nan, p_reference=1.0,
                      num_gangle=10, cld=None, F0PI=None, rstar=np.nan,
                      rayleigh_species=None, dtype=None, geom=None,
                      surf_reflect=None, raman_shifts=None, raman_db=None,
                      raman_pollack_row=None, device=None):
    """Build (SceneTensors, SpectrumConfig) from plain arrays on the host
    (numpy), then move the scene to ``device`` (default: the grid's).

    Raman inputs as in the JAX package: ``raman_shifts`` [nwno, nrow] from
    ``raman.compute_stellar_shifts``, ``raman_db`` the dict of
    ``raman.load_raman_db``, ``raman_pollack_row`` [nwno].

    Recorded as the span ``picaso.scene_from_arrays``; every call adds its
    host seconds to ``profiling.counters()['scene_from_arrays']``."""
    from .atmosphere import build_atmosphere
    from .rayleigh import RAYLEIGH_MOLECULES, rayleigh_sigma_table

    device = grid.wno.device if device is None else torch.device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    prof = {'pressure': profile_bar, 'temperature': t_level}
    prof.update(mix_named)
    wno = grid.wno.detach().cpu().numpy()
    # without clouds the Atmosphere carries none (its [nlayer, nwno] host
    # zeros are made on the device below)
    atm = build_atmosphere(prof, gravity=gravity, radius=radius, mass=mass,
                           p_reference=p_reference,
                           wno=None if cld is None else wno,
                           cld_profile=cld,
                           cld_wno=None if cld is None else wno)
    if geom is None:
        geom = disco_mod.make_geometry(0.0, num_gangle=num_gangle,
                                       num_tangle=1)

    used = [m for m in atm.molecules if m in grid.molecules]
    mol_indices = tuple(grid.molecules.index(m) for m in used)
    mix_index = tuple((m, i) for i, m in enumerate(atm.molecules))
    pairs = atm.continuum_pairs(grid.continuum_molecules)
    specs = tuple(assemble.classify_continuum(pairs))
    cont_indices = tuple(grid.continuum_molecules.index(s.name)
                         for s in specs)

    ray_species = (rayleigh_species if rayleigh_species is not None
                   else atm.rayleigh_species(RAYLEIGH_MOLECULES))
    sig_table = rayleigh_sigma_table(wno, ray_species)
    sigma_ray = (np.stack([sig_table[m] for m in ray_species])
                 if ray_species else np.zeros((0, len(wno))))
    mix_ray = (np.stack([atm.mixing_ratio_layer(m) for m in ray_species])
               if ray_species else np.zeros((0, atm.nlayer)))

    nwno = len(wno)

    def t(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    def cloud(x):
        # a cloud-free scene's zeros: from the host they cost a float
        # conversion and a copy each
        return (t(x) if x is not None else
                torch.zeros((atm.nlayer, nwno), dtype=dtype, device=device))

    scene = SceneTensors(
        tlevel=t(atm.temperature), plevel=t(atm.pressure),
        tlayer=t(atm.t_layer), player=t(atm.p_layer),
        colden=t(atm.colden), mmw_layer=t(atm.mmw_layer),
        mix=t(atm.mixingratios_layer.T),
        electrons=t(atm.electrons_layer if atm.electrons_layer is not None
                    else np.zeros(atm.nlayer)),
        z=t(atm.z), dz=t(atm.dz),
        cld_opd=cloud(atm.cld_opd), cld_g0=cloud(atm.cld_g0),
        cld_w0=cloud(atm.cld_w0),
        sigma_ray=t(sigma_ray), mix_ray=t(mix_ray),
        ubar0=t(geom.ubar0), ubar1=t(geom.ubar1),
        gweight=t(geom.gweight), tweight=t(geom.tweight),
        F0PI=t(F0PI if F0PI is not None else np.ones(nwno)),
        surf_reflect=t(np.zeros(nwno) if surf_reflect is None
                       else np.broadcast_to(surf_reflect, (nwno,))),
        rstar=t(rstar), cos_theta=t(getattr(geom, 'cos_theta', 1.0)),
        raman_shifts=t(np.zeros((0, nwno)) if raman_shifts is None
                       else np.asarray(raman_shifts).T),
        raman_c=t(np.zeros(0) if raman_db is None else raman_db['c']),
        raman_ji=t(np.zeros(0) if raman_db is None else raman_db['ji'],
                   torch.int32),
        raman_dnu=t(np.zeros(0) if raman_db is None
                    else raman_db['deltanu']),
        raman_pollack_row=t(np.ones(nwno) if raman_pollack_row is None
                            else raman_pollack_row))
    config = SpectrumConfig(mol_indices=mol_indices, continuum_specs=specs,
                            cont_indices=cont_indices, mix_index=mix_index,
                            transmission=bool(np.isfinite(rstar)))
    return scene, config


def scene_from_case(case, opa):
    """(SceneTensors, SpectrumConfig) from a ``justdoit.inputs`` bundle and
    its ``justdoit.Opacity`` connection (picaso_tpu/pipeline.py:573-656):
    the profile and the clouds (regridded onto the connection's
    wavenumbers), the planet, the star, the geometry and the surface, and
    the whole approx tree (Toon/SH and stream, the phase-function
    controls, delta-Eddington, the Raman mode) in the config, so
    ``forward`` runs the physics of the stepwise facade.  The scene lies on
    the connection's device, in its dtype."""
    from .refdata import refdata_path
    from .wavelength import regrid

    prof = case.inputs['atmosphere']['profile']
    mix = {c: np.asarray(prof[c]) for c in prof.keys()
           if c not in ('pressure', 'temperature')}
    wno = np.asarray(opa.wno)
    cld = None
    if case.inputs['clouds'].get('profile') is not None:
        cp = case.inputs['clouds']['profile']
        nlayer = len(prof['pressure']) - 1
        cld_wno = case.inputs['clouds']['wavenumber']
        cld = {k: regrid(np.reshape(np.asarray(cp[k]),
                                    (nlayer, len(cld_wno))),
                         cld_wno, wno).ravel()
               for k in ('opd', 'g0', 'w0')}
    planet = case.inputs['planet']
    approx = case.inputs['approx']
    common = approx['rt_params']['common']
    toon_p = approx['rt_params']['toon']
    sh_p = approx['rt_params']['SH']
    raman = common['raman']

    raman_shifts = raman_db = pollack_row = None
    if raman == 0:
        if getattr(opa, 'raman_stellar_shifts', None) is None:
            raise ValueError("raman='oklopcic' needs star() run first")
        raman_shifts = np.asarray(opa.raman_stellar_shifts)
        raman_db = opa.raman_db
    elif raman == 1:
        pollack_row = raman_mod.raman_factor_pollack(
            1, 1e4 / wno, refdata_dir=os.path.dirname(os.path.dirname(
                refdata_path('opacities', 'raman.txt'))))[0]

    rstar = case.inputs['star'].get('radius', np.nan)
    scene, config = scene_from_arrays(
        np.asarray(prof['pressure']), np.asarray(prof['temperature']), mix,
        opa.grid, gravity=planet['gravity'] or np.nan,
        radius=planet['radius'] or np.nan, mass=planet['mass'] or np.nan,
        p_reference=approx['p_reference'], cld=cld,
        F0PI=(np.asarray(opa.relative_flux)
              if opa.relative_flux is not None else None),
        rstar=rstar if isinstance(rstar, float) else np.nan,
        geom=case.inputs.get('disco'),
        surf_reflect=case.inputs.get('surface_reflect', 0.0),
        raman_shifts=raman_shifts, raman_db=raman_db,
        raman_pollack_row=pollack_row)

    frac = common['TTHG_params']['fraction']
    controls = toon.ScatteringControls(
        single_phase=toon_p['single_phase'],
        multi_phase=toon_p['multi_phase'],
        toon_coefficients=toon_p.get('toon_coefficients', 0),
        frac_a=frac[0], frac_b=frac[1], frac_c=frac[2],
        constant_back=common['TTHG_params']['constant_back'],
        constant_forward=common['TTHG_params']['constant_forward'])
    config = dataclasses.replace(
        config, controls=controls, raman=raman,
        delta_eddington=common['delta_eddington'], stream=common['stream'],
        rt_method=1 if approx['rt_method'] == 'SH' else 0,
        sh_w_single_form=sh_p['w_single_form'],
        sh_w_multi_form=sh_p['w_multi_form'],
        sh_psingle_form=sh_p['psingle_form'],
        sh_w_single_rayleigh=sh_p['w_single_rayleigh'],
        sh_w_multi_rayleigh=sh_p['w_multi_rayleigh'],
        sh_psingle_rayleigh=sh_p['psingle_rayleigh'],
        sh_single_form=sh_p['single_form'],
        hard_surface=bool(case.inputs.get('hard_surface', 0)))
    return scene, config


# the production problem of the JAX package's bench.py:94-142
MOLECULES_16 = ('H2O', 'CH4', 'CO', 'NH3', 'CO2', 'H2S', 'TiO', 'VO',
                'Na', 'K', 'FeH', 'C2H2', 'HCN', 'PH3', 'SO2', 'CrH')
MIX_16 = {'H2O': 1e-3, 'CH4': 5e-4, 'CO': 3e-4, 'NH3': 1e-4, 'CO2': 1e-5,
          'H2S': 3e-5, 'TiO': 1e-7, 'VO': 1e-8, 'Na': 1e-6, 'K': 1e-7,
          'FeH': 1e-8, 'C2H2': 1e-7, 'HCN': 1e-7, 'PH3': 1e-6,
          'SO2': 1e-8, 'CrH': 1e-9}


def stellar_shifts_5700k(wno, raman_db):
    """Oklopcic stellar shift ratios [nwno, nrow] of a 5700 K blackbody
    star, on the fine grid and with the binning the JAX package's
    ``inputs.star`` uses (justdoit.py:337-358): no stellar grid files."""
    from .constants import PLANCK_C1, PLANCK_C2
    wno = np.asarray(wno, dtype=float)
    wno_star = np.linspace(max(np.min(wno) - 2500, 10.0),
                           np.max(wno) + 7000, len(wno) * 5 + 1000)
    lam = 1.0 / wno_star
    flux_star = (np.pi * PLANCK_C1 / lam ** 5
                 / (np.exp(PLANCK_C2 / (lam * 5700.0)) - 1.0))
    fine_wno = np.linspace(np.min(wno) - 2000, np.max(wno) + 6000,
                           len(wno) * 5)
    fine_flux = np.interp(fine_wno, wno_star, flux_star)
    shifts, _ = raman_mod.compute_stellar_shifts(wno, raman_db, fine_wno,
                                                 fine_flux)
    return shifts


def build_problem(nwno, nlevel=91, production=True, device='cuda',
                  dtype=None, raman=2, reflected=True, thermal=True,
                  test_mode=None, blocked='f32'):
    """Scene + grid + config at the requested size, as ``bench.py``'s
    ``build_problem`` builds them for the JAX package.

    production=True: the ragged 1060-point (T, P) grid with 16 molecules
    (the real table shape; 3.4 GB in float32 at nwno = 50 000), 2 CIA
    continua, Rayleigh, a cloud deck, 5 disk angles, transmission on.
    production=False: a small regular 15 x 10 grid with 6 molecules.

    raman: 2 none (the default here, as in bench.py); 1 Pollack (the row
    from ``raman_fortran.txt``); 0 Oklopcic (shift ratios of a 5700 K
    blackbody star, :func:`stellar_shifts_5700k`).  reflected, thermal and
    test_mode go into the config as given.  blocked='int16' attaches the
    int16 fixed-point table (``with_blocked_table(quantize=True)``), which
    ``forward`` then gathers from (bench.py:103,141); 'f32' gathers from
    the float table.  ``device`` defaults to the card and raises where
    there is none.
    """
    from .opacities import factory

    if blocked not in ('f32', 'int16'):
        raise ValueError(f"blocked must be 'f32' or 'int16', got {blocked!r}")
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    wno = np.linspace(300.0, 33000.0, nwno)  # ~0.3-33 um
    if production:
        grid = factory.synthetic_opacity_grid_ragged(
            wno, molecules=MOLECULES_16, dtype=dtype, device=device)
        mix_vals = MIX_16
    else:
        grid = factory.synthetic_opacity_grid(
            wno, molecules=('H2O', 'CH4', 'CO', 'NH3', 'CO2', 'H2S'),
            ntemp=15, npress=10, dtype=dtype, device=device)
        mix_vals = {m: MIX_16[m] for m in grid.molecules}
    pressure = np.logspace(-6, 2.5, nlevel)
    temperature = np.clip(1200.0 * (pressure / 50.0) ** 0.08, 150.0, None)
    mix = {'H2': np.zeros(nlevel) + 0.84, 'He': np.zeros(nlevel) + 0.155}
    for m, v in mix_vals.items():
        mix[m] = np.zeros(nlevel) + v
    nlayer = nlevel - 1
    cld = {'opd': np.repeat(np.linspace(0.0, 1.0, nlayer) ** 2, nwno),
           'g0': np.zeros(nlayer * nwno) + 0.85,
           'w0': np.zeros(nlayer * nwno) + 0.95}
    scene, config = scene_from_arrays(
        pressure, temperature, mix, grid, gravity=2500.0,
        radius=7.1492e9, mass=1.898e30, cld=cld, rstar=6.96e10,
        dtype=dtype, device=device)
    config = dataclasses.replace(config, reflected=reflected,
                                 thermal=thermal, test_mode=test_mode)
    grid = grid.with_blocked_table(quantize=(blocked == 'int16'))
    return with_raman(scene, grid, config, raman)


def with_raman(scene: SceneTensors, grid: OpacityGrid, config, raman):
    """(scene, grid, config) for Raman mode ``raman``, with the scene's
    Raman inputs made as :func:`build_problem` makes them: 1 Pollack (the
    row of ``raman_fortran.txt``), 0 Oklopcic (the table and the shift
    ratios of a 5700 K blackbody star, :func:`stellar_shifts_5700k`),
    2 none (the inputs left as they are)."""
    wno = grid.wno.detach().cpu().numpy().astype(float)

    def t(x, dt=scene.cld_opd.dtype):
        return torch.tensor(np.asarray(x), dtype=dt,
                            device=scene.cld_opd.device)
    if raman == 1:
        scene = scene._replace(raman_pollack_row=t(
            raman_mod.raman_factor_pollack(1, 1e4 / wno)[0]))
    elif raman == 0:
        db = raman_mod.load_raman_db()
        scene = scene._replace(
            raman_shifts=t(stellar_shifts_5700k(wno, db).T),
            raman_c=t(db['c']), raman_ji=t(db['ji'], torch.int32),
            raman_dnu=t(db['deltanu']))
    return scene, grid, dataclasses.replace(config, raman=raman)
