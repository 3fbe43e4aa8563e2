# Frozen copy of picaso_tpu_torch/opacities/assemble.py at commit d22d65a, with its
# imports made local to this package.  The benchmark's yardstick:
# edit only to fix a fault of the copy, never to follow the port.
"""Per-source optical depth assembly (molecular, continuum, Rayleigh).

Port of ``picaso_tpu/opacities/assemble.py`` (reference picaso
optics.py:132-315).  The host decides which species take part (static
metadata); the device does the arithmetic.

Continuum unit conventions preserved exactly:
* standard CIA pairs use the amagat^2 integral COEF1 (optics.py:155-164)
  with R_gas in SI, pressures in bar, gravity in m/s^2;
* H-bf, H-ff, H2- special cases follow optics.py:175-219.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import AMU, K_B, R_GAS

__all__ = ['ContinuumSpec', 'classify_continuum', 'amagat_coef1',
           'continuum_tau', 'molecular_tau', 'rayleigh_tau']


class ContinuumSpec(NamedTuple):
    """Static description of one continuum source."""
    name: str          # e.g. 'H2H2', 'H-bf', 'H-ff', 'H2-'
    kind: str          # 'cia' | 'H-bf' | 'H-ff' | 'H2-'
    mol1: str          # first collider (mixing-ratio column)
    mol2: str          # second collider ('' for specials)


def classify_continuum(pairs):
    """[(m1, m2)] from Atmosphere.continuum_pairs -> list[ContinuumSpec]."""
    specs = []
    for m1, m2 in pairs:
        if m1 == 'H-' and m2 == 'bf':
            specs.append(ContinuumSpec('H-bf', 'H-bf', 'H-', ''))
        elif m1 == 'H-' and m2 == 'ff':
            specs.append(ContinuumSpec('H-ff', 'H-ff', 'H', ''))
        elif m1 == 'H2-':
            specs.append(ContinuumSpec('H2-', 'H2-', 'H2', ''))
        else:
            specs.append(ContinuumSpec(m1 + m2, 'cia', m1, m2))
    return specs


def amagat_coef1(tlevel, plevel_bar, tlayer, player_bar, gravity_cgs,
                 mmw_layer):
    """COEF1 amagat^2 path integral per layer (optics.py:144-164)."""
    gravity_si = gravity_cgs / 100.0
    ACOEF = (tlayer / (tlevel[:-1] * tlevel[1:])) * (
        tlevel[1:] * plevel_bar[1:] - tlevel[:-1] * plevel_bar[:-1]) / (
        plevel_bar[1:] - plevel_bar[:-1])
    BCOEF = (tlayer / (tlevel[:-1] * tlevel[1:])) * (
        tlevel[:-1] - tlevel[1:]) / (plevel_bar[1:] - plevel_bar[:-1])
    COEF1 = R_GAS * 273.15 ** 2 * 0.5e5 * (
        ACOEF * (plevel_bar[1:] ** 2 - plevel_bar[:-1] ** 2)
        + BCOEF * (2.0 / 3.0) * (plevel_bar[1:] ** 3 - plevel_bar[:-1] ** 3)
    ) / (1.01325 ** 2 * gravity_si * tlayer * mmw_layer)
    return COEF1


def continuum_tau(specs, cont_kappa, mix, electrons_layer, coef1,
                  player_cgs, tlayer, colden, mmw_layer):
    """Summed continuum optical depth [nlayer, nwno], or None for no specs.

    cont_kappa: dict name -> [nlayer, nwno] continuum opacity at the layer
    temperatures; mix: dict molecule -> [nlayer] mixing ratio.
    """
    tau = None
    for spec in specs:
        k = cont_kappa[spec.name]
        if spec.kind == 'cia':
            add = k * (coef1 * mix[spec.mol1] * mix[spec.mol2])[:, None]
        elif spec.kind == 'H-bf':
            add = k * (mix['H-'] * colden / (mmw_layer * AMU))[:, None]
        elif spec.kind == 'H-ff':
            add = k * (player_cgs * mix['H'] * electrons_layer * colden
                       / (tlayer * mmw_layer * AMU * K_B))[:, None]
        elif spec.kind == 'H2-':
            add = k * (player_cgs * mix['H2'] * electrons_layer * colden
                       / (mmw_layer * AMU))[:, None]
        else:
            raise ValueError(spec.kind)
        tau = add if tau is None else tau + add
    return tau


def molecular_tau(kappa, mix_cols, colden, mmw_layer):
    """Summed molecular optical depth [nlayer, nwno].

    kappa: [nmol, nlayer, nwno] Avogadro-scaled cross sections;
    mix_cols: [nmol, nlayer].
    """
    w = mix_cols * colden[None, :] / mmw_layer[None, :]
    return torch.einsum('mlw,ml->lw', kappa, w.to(kappa.dtype))


def rayleigh_tau(sigma, mix_cols, colden, mmw_layer):
    """Rayleigh optical depth [nlayer, nwno] (optics.py:264-271).

    sigma: [nmol_ray, nwno] cross sections; mix_cols: [nmol_ray, nlayer].
    """
    w = mix_cols * colden[None, :] / mmw_layer[None, :]
    return torch.einsum('mw,ml->lw', sigma, w.to(sigma.dtype))
