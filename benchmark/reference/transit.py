# Frozen copy of picaso_tpu_torch/rt/transit.py at commit d22d65a, with its
# imports made local to this package.  The benchmark's yardstick:
# edit only to fix a fault of the copy, never to follow the port.
"""Transmission spectroscopy: tangent-path slant optical depths.

Port of ``picaso_tpu/rt/transit.py`` (reference picaso ``get_transit_1d``,
fluxes.py:2582-2663, Brown 2001 eqn 11).  The chord-segment matrix is one
masked broadcast expression and the per-wavelength accumulation a single
[nlevel, nlayer] x [nlayer, nwno] matmul (TF32 is off, see the package
``__init__``).

The chord segment sqrt(outer^2 - ref^2) is computed as
sqrt((outer-ref)*(outer+ref)), which avoids squaring ~1e9 cm radii first
and keeps float32 accurate.
"""

from __future__ import annotations

import torch

from .constants import AMU, K_B

__all__ = ['transit_depth', 'chord_matrix']


def chord_matrix(z, plevel, tlevel):
    """M [nlevel, nlayer]: path-weighted chord segments (fluxes.py:2624-2644).

    M[i, k] is the contribution of layer k (levels k, k+1) to the slant
    column at impact level i: segment length x p/(T k_B), nonzero for k < i.
    """
    nlevel = z.shape[0]
    zi = z[:, None]            # reference shell (impact radius)
    zk_out = z[None, :-1]      # outer shell of layer k
    zk_in = z[None, 1:]        # inner shell of layer k

    def seg(outer, ref):
        d = (outer - ref) * (outer + ref)
        return torch.sqrt(torch.clamp(d, min=0.0))

    segment = seg(zk_out, zi) - seg(zk_in, zi)
    k_idx = torch.arange(nlevel - 1, device=z.device)[None, :]
    i_idx = torch.arange(nlevel, device=z.device)[:, None]
    weight = plevel[None, :-1] / tlevel[None, :-1] / K_B
    return torch.where(k_idx < i_idx, segment * weight,
                       torch.zeros((), dtype=z.dtype, device=z.device))


def transit_depth(z, dz, rstar, mmw_layer, plevel, tlevel, colden, dtau):
    """(Rp/Rs)^2 transit spectrum [nwno] (fluxes.py:2582-2663).

    dtau: [nlayer, nwno] total layer optical depth (gas + Rayleigh + cloud,
    no delta-Eddington); z/dz per level (cm).
    """
    mmw_g = mmw_layer * AMU
    M = chord_matrix(z, plevel, tlevel)                      # [nlevel, nlayer]
    xsec = dtau * (mmw_g / colden)[:, None]                  # [nlayer, nwno]
    tau_slant = 2.0 * M.to(xsec.dtype) @ xsec                # [nlevel, nwno]
    transmitted = torch.exp(-tau_slant)
    return ((torch.min(z) / rstar) ** 2
            + 2.0 / rstar ** 2 * ((1.0 - transmitted).T @ (z * dz)))
