"""Eddy diffusion (Kzz) from mixing-length theory.

Port of ``picaso_tpu/climate/kzz.py`` (reference ``get_kzz``,
climate.py:331-493): convective heat
flux reconstructed from the net IR fluxes (with the 1/3-per-scale-height
overshoot floor and the target-Teff rescale), MLT
kz = (1/3) H (l/H)^{4/3} (R chf / rho cp)^{1/3}, and the +-2-scale-height
window averaging of the radiative-zone kz.  Host numpy (runs once per
profile iteration on ~90 levels) around one adiabat lookup
(``did_grad_cp``) on the adiabat table's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .adiabat import did_grad_cp

__all__ = ['get_kzz']

SIGMA_SB = 0.56687e-4


def get_kzz(pressure_bar, temp, grav_si, tidal, flux_net_ir_layer,
            flux_plus_ir_attop, adiabat, nstr, mmw_layer, dtdp,
            moist_grad_fn=None):
    """Kzz [cm^2/s] per level (climate.py:331-493 semantics).

    pressure_bar/temp per level; grav in SI (m/s^2) like the reference's
    ``grav`` argument; flux_plus_ir_attop already dwni-summed;
    ``moist_grad_fn(t_layer, p_layer_bar)`` (numpy in, (grad, cp) out)
    replaces the dry gradient.
    """
    pressure = np.asarray(pressure_bar, float)
    temp = np.asarray(temp, float)
    mmw = np.asarray(mmw_layer, float)
    grav_cgs = grav_si * 1e2
    p_cgs = pressure * 1e6
    nlevel = len(temp)
    nz = nlevel - 1

    r_atmos = 8.3143e7 / mmw
    p_layer = np.sqrt(p_cgs[1:] * p_cgs[:-1])
    t_layer = 0.5 * (temp[1:] + temp[:-1])
    p_layer_bar = np.sqrt(pressure[1:] * pressure[:-1])

    f_sum = float(np.sum(flux_plus_ir_attop))
    target_teff = (abs(tidal[0]) / SIGMA_SB) ** 0.25
    flx_min = SIGMA_SB * (target_teff * 0.05) ** 4

    chf = np.zeros(nlevel)
    chf[nz - 1] = f_sum
    for iz in range(nz - 2, -1, -1):
        chf[iz] = f_sum - flux_net_ir_layer[iz]
        ratio_min = (1.0 / 3.0) * p_layer[iz] / p_layer[iz + 1]
        if chf[iz] < ratio_min * chf[iz + 1]:
            chf[iz] = ratio_min * chf[iz + 1]

    f_target = abs(tidal[0])
    f_actual = chf[nz - 1]
    ratio = f_target / f_actual
    for iz in range(nz - 1, -1, -1):
        chf[iz] = max(chf[iz] * ratio, flx_min)

    if moist_grad_fn is not None:
        grad_x, _ = moist_grad_fn(t_layer, p_layer_bar)
    else:
        like = adiabat.grad
        grad_x, _ = did_grad_cp(
            torch.as_tensor(t_layer, dtype=like.dtype, device=like.device),
            torch.as_tensor(p_layer_bar, dtype=like.dtype,
                            device=like.device), adiabat)
    grad_x = np.asarray(grad_x.cpu() if isinstance(grad_x, torch.Tensor)
                        else grad_x, dtype=np.float64)
    lapse_ratio = np.minimum(1.0, np.asarray(dtdp)[:nz] / grad_x)

    rho_atmos = p_layer / (r_atmos * t_layer)
    c_p = (7.0 / 2.0) * r_atmos
    scale_h = r_atmos * t_layer / grav_cgs
    mixl = np.maximum(0.1, lapse_ratio) * scale_h
    kz = ((1.0 / 3.0) * scale_h * (mixl / scale_h) ** (4.0 / 3.0)
          * (r_atmos * chf[:nz] / (rho_atmos * c_p)) ** (1.0 / 3.0))
    kz = np.append(kz, kz[-1])

    # +-2-scale-height window smoothing in the radiative zones
    # (climate.py:457-491)
    dz = scale_h[1:] * np.log(p_layer[:-1] / p_layer[1:])
    z = np.zeros(nlevel - 1)
    z[0] = dz[0]
    for i in range(1, nlevel - 2):
        z[i] = z[i - 1] + dz[i]

    def window_mean(lo, hi):
        vals = []
        for i in range(lo, hi):
            above = abs(i - int(np.abs(z - (z[i] + 2 * scale_h[i])
                                       ).argmin()))
            below = abs(i - int(np.abs(z - (z[i] - 2 * scale_h[i])
                                       ).argmin()))
            s = max(lo, i - above)
            e = min(hi, i + below)
            vals.append(np.mean(kz[s:e]) if e > s else kz[i])
        return np.array(vals)

    if nstr[1] > nstr[0]:
        kz[nstr[0]:nstr[1]] = window_mean(nstr[0], nstr[1])
    if nstr[3] != 0 and nstr[4] > nstr[3]:
        kz[nstr[3]:nstr[4]] = window_mean(nstr[3], nstr[4])
    return kz
