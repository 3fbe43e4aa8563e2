"""The whole spectrum from the benchmark's raw inputs, in plain PyTorch:
the scene (levels, layers, column densities, mean molecular weight,
heights, Rayleigh cross sections), the molecular gather, the continuum,
Rayleigh and cloud optics, the RT solve (Toon or spherical harmonics;
reflected and thermal), the disk integration and the transit depth.

It follows the plain path of picaso_tpu_torch/pipeline.py at commit
d22d65a (``forward`` with ``use_kernels=False``), re-deriving everything
from the raw inputs that the benchmark hands to both sides; it reads no
weight, table or scene that the port made.  Every wavenumber column is
independent, so :func:`spectrum` runs in blocks of columns and fits any
width.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import assemble, atmosphere, disco, opacity, optics, sh, toon
from .constants import PCONV
from .rayleigh import RAYLEIGH_MOLECULES, rayleigh_sigma_table
from .transit import transit_depth


class Table(NamedTuple):
    """The raw opacity data both sides read."""
    wno: np.ndarray                 # [nwno] cm^-1, float64
    log_kappa: torch.Tensor         # [nmol, npt, nwno] log10 cm^2/molecule
    temps_flat: np.ndarray          # [npt] K
    press_flat: np.ndarray          # [npt] bar
    molecules: Tuple[str, ...]
    cia: np.ndarray                 # [ncont, ntcia, nwno] cm^-1 amagat^-2
    cia_temps: np.ndarray           # [ntcia] K
    continuum: Tuple[str, ...]      # CIA pair names, e.g. 'H2H2'


class Atmos(NamedTuple):
    """One atmosphere: levels, mixing ratios (constant with height) and a
    grey cloud deck."""
    pressure_bar: np.ndarray        # [nlevel]
    temperature: np.ndarray         # [nlevel] K
    mix: Tuple[Tuple[str, float], ...]   # (molecule, mixing ratio)
    cloud_opd: np.ndarray           # [nlayer]
    cloud_g0: float
    cloud_w0: float


class Planet(NamedTuple):
    gravity: float                  # cm/s^2
    radius: float                   # cm
    mass: float                     # g
    rstar: float                    # cm (nan: no transit depth)
    p_reference: float              # bar


class Options(NamedTuple):
    """The RT options of a configuration (SpectrumConfig's fields)."""
    method: str = 'toon'            # 'toon' | 'sh'
    stream: int = 2
    delta_eddington: bool = True
    controls: toon.ScatteringControls = toon.ScatteringControls()
    sh: Tuple[Tuple[str, int], ...] = ()   # w_single_form=..., etc.


class Scene(NamedTuple):
    """What :func:`derive` works out of an atmosphere (numpy float64)."""
    tlevel: np.ndarray
    plevel: np.ndarray              # dyne/cm^2
    tlayer: np.ndarray
    player: np.ndarray
    colden: np.ndarray
    mmw_layer: np.ndarray
    z: np.ndarray
    dz: np.ndarray
    mix: dict                       # molecule -> [nlayer]
    ray_species: tuple
    continuum_specs: tuple


def derive(atm: Atmos, table: Table, planet: Planet) -> Scene:
    """The scene of ``atm``: hydrostatic heights, layer means, column
    densities and mean molecular weight (atmosphere.py's build), the CIA
    pairs present and the Rayleigh species."""
    prof = {'pressure': atm.pressure_bar, 'temperature': atm.temperature}
    for name, value in atm.mix:
        prof[name] = np.zeros(len(atm.pressure_bar)) + value
    a = atmosphere.build_atmosphere(prof, gravity=planet.gravity,
                                    radius=planet.radius, mass=planet.mass,
                                    p_reference=planet.p_reference)
    mix = {m: a.mixingratios_layer[:, i] for i, m in enumerate(a.molecules)}
    specs = tuple(assemble.classify_continuum(
        a.continuum_pairs(table.continuum)))
    return Scene(a.temperature, a.pressure, a.t_layer, a.p_layer, a.colden,
                 a.mmw_layer, a.z, a.dz, mix,
                 tuple(a.rayleigh_species(RAYLEIGH_MOLECULES)), specs)


def _block_width(nlayer, nang, method):
    """Columns per block: ~4e8 bytes per [nlayer, nang, cols] float64
    array (the SH path holds tens of them)."""
    per_col = nlayer * max(nang, 1) * 8 * (4 if method == 'sh' else 1)
    return int(max(256, min(1 << 16, 4e8 // per_col)))


def spectrum(table: Table, atm: Atmos, planet: Planet, geom, opts: Options,
             outputs=('albedo', 'thermal', 'transit_depth'), device='cpu',
             precision='f64'):
    """{output: numpy float64 [nwno]} for one atmosphere seen in the disk
    geometry ``geom`` (a :class:`disco.Geometry`).

    ``precision='f64'`` is the reference.  The others are the same steps
    in float32: ``'f32'`` as they are; the controls ``'bf16'``, with the
    gathered table rows and the per-layer optical depths (gas, Rayleigh,
    cloud) rounded to bfloat16, and ``'f16'``, with the gathered table
    rows rounded to float16 (a table stored in 16 bits; deep layers'
    optical depths, past 1e6, lie beyond float16's range); and ``'tf32'``,
    the float32 steps with TF32 matmuls (the sums over molecules and the
    transit's path lengths), the configuration stating TF32 off."""
    if precision == 'tf32':
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return spectrum(table, atm, planet, geom, opts, outputs, device,
                            'f32')
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
    if precision not in ('f64', 'f32', 'bf16', 'f16'):
        raise ValueError(f'unknown precision {precision!r}')
    dtype = torch.float64 if precision == 'f64' else torch.float32
    store = {'bf16': torch.bfloat16, 'f16': torch.float16}.get(precision)
    tau_store = torch.bfloat16 if precision == 'bf16' else None
    dev = torch.device(device)
    s = derive(atm, table, planet)
    nlayer, nwno = len(s.tlayer), len(table.wno)
    nang = geom.ubar0.size

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def rounded(x):
        return x if tau_store is None else x.to(tau_store).to(dtype)

    grid = opacity.ragged_grid(table.temps_flat, table.press_flat)
    t_w, p_w, idx = opacity.bracket(grid, s.tlayer, s.player / PCONV)
    weights = opacity.corner_weights(t_w, p_w)
    mix_mol = np.stack([s.mix.get(m, np.zeros(nlayer))
                        for m in table.molecules])       # [nmol, nlayer]
    it_cia = opacity.nearest_temperature(table.cia_temps, s.tlayer)
    gravity_layer = (s.plevel[1:] - s.plevel[:-1]) / s.colden
    coef1 = assemble.amagat_coef1(
        t(s.tlevel), t(s.plevel / PCONV), t(s.tlayer), t(s.player / PCONV),
        t(gravity_layer), t(s.mmw_layer))
    mix_named = {m: t(v) for m, v in s.mix.items()}
    sig = rayleigh_sigma_table(table.wno, list(s.ray_species))
    sigma_ray = np.stack([sig[m] for m in s.ray_species])
    mix_ray = np.stack([s.mix[m] for m in s.ray_species])

    u0, u1 = t(geom.ubar0), t(geom.ubar1)
    gw, tw = t(geom.gweight), t(geom.tweight)
    cos_theta = t(geom.cos_theta)
    colden, mmw = t(s.colden), t(s.mmw_layer)
    opd = t(atm.cloud_opd)[:, None]
    width = _block_width(nlayer, nang, opts.method)
    parts = {k: [] for k in outputs}
    for w0 in range(0, nwno, width):
        cols = slice(w0, min(nwno, w0 + width))
        nc = cols.stop - cols.start
        wno = t(table.wno[cols])
        kappa = opacity.cross_sections(table.log_kappa, idx, weights, cols,
                                       dtype, store)
        taugas = assemble.molecular_tau(kappa, t(mix_mol), colden, mmw)
        cia = {spec.name: t(table.cia[table.continuum.index(spec.name)]
                            [it_cia][:, cols]) for spec in s.continuum_specs}
        taugas = taugas + assemble.continuum_tau(
            s.continuum_specs, cia, mix_named, t(np.zeros(nlayer)), coef1,
            t(s.player), t(s.tlayer), colden, mmw)
        tauray = assemble.rayleigh_tau(t(sigma_ray[:, cols]), t(mix_ray),
                                       colden, mmw)
        cld = rounded(opd.expand(nlayer, nc))
        g0 = torch.full((nlayer, nc), atm.cloud_g0, dtype=dtype, device=dev)
        w0c = torch.full((nlayer, nc), atm.cloud_w0, dtype=dtype, device=dev)
        rf = torch.full((nlayer, nc), 0.99999, dtype=dtype, device=dev)
        taugas, tauray = rounded(taugas), rounded(tauray)
        props = optics.combine_optics(taugas, tauray, cld, w0c, g0, rf,
                                      delta_eddington=opts.delta_eddington,
                                      stream=opts.stream)
        surf = torch.zeros(nc, dtype=dtype, device=dev)
        f0pi = torch.ones(nc, dtype=dtype, device=dev)
        if 'albedo' in outputs:
            if opts.method == 'sh':
                xint = sh.reflected_sh(props, surf, u0, u1, cos_theta, f0pi,
                                       stream=opts.stream,
                                       controls=opts.controls,
                                       **dict(opts.sh))
            else:
                xint = toon.reflected_1d(
                    props.dtau, props.tau, props.w0, props.cosb, props.gcos2,
                    props.ftau_cld, props.ftau_ray, props.dtau_og,
                    props.tau_og, props.w0_og, props.cosb_og, surf, u0, u1,
                    cos_theta, f0pi, controls=opts.controls)
            parts['albedo'].append(disco.compress_disco(xint, gw, tw,
                                                        cos_theta, f0pi))
        if 'thermal' in outputs:
            if opts.method == 'sh':
                flux = sh.thermal_sh(t(s.tlevel), props, t(s.plevel), u1,
                                     surf, wno, stream=opts.stream)
            else:
                flux = toon.thermal_1d(t(s.tlevel), props.dtau_og,
                                       props.w0_no_raman, props.cosb_og,
                                       t(s.plevel), u1, surf, wno)
            parts['thermal'].append(disco.compress_thermal(flux, gw, tw))
        if 'transit_depth' in outputs:
            parts['transit_depth'].append(transit_depth(
                t(s.z), t(s.dz), t(planet.rstar), mmw, t(s.plevel),
                t(s.tlevel), colden, props.dtau_og))
    return {k: torch.cat(v).double().cpu().numpy() for k, v in parts.items()}


def geometry(phase_deg, num_gangle, num_tangle):
    """The disk geometry of ``disco.make_geometry`` at a phase in degrees."""
    return disco.make_geometry(math.radians(phase_deg), num_gangle,
                               num_tangle)
