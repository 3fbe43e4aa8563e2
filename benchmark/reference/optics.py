# Frozen copy of picaso_tpu_torch/optics.py at commit d22d65a, with its
# imports made local to this package.  The benchmark's yardstick:
# edit only to fix a fault of the copy, never to follow the port.
"""Optical-property assembly (single-scattering inputs for the RT solvers).

Port of ``picaso_tpu/optics.py`` (reference picaso optics.py:26-432): fuses
the per-source optical depths (gas, Rayleigh, cloud) into the 13-field
bundle the Toon solvers take, with the delta-Eddington rescaling.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ['RTProps', 'combine_optics']


class RTProps(NamedTuple):
    """Per-layer single-scattering properties (optics.py:423).

    All [nlayer, nwno] except tau/tau_og, which are [nlevel, nwno].
    ``*_og`` fields are the values without the delta-Eddington correction;
    w0_no_raman additionally omits the Raman correction.
    """
    dtau: torch.Tensor
    tau: torch.Tensor
    w0: torch.Tensor
    cosb: torch.Tensor
    ftau_cld: torch.Tensor
    ftau_ray: torch.Tensor
    gcos2: torch.Tensor
    dtau_og: torch.Tensor
    tau_og: torch.Tensor
    w0_og: torch.Tensor
    cosb_og: torch.Tensor
    w0_no_raman: torch.Tensor
    f_deltaM: torch.Tensor

    def slice_gauss(self, ig):
        """Select one correlated-k gauss point (leading axis)."""
        return RTProps(*(x[ig] for x in self))


def _cumtau(dtau):
    """Cumulative tau from the top: [..., nlayer, nwno] -> [..., nlevel, nwno]."""
    zero = torch.zeros_like(dtau[..., :1, :])
    return torch.cat([zero, torch.cumsum(dtau, dim=-2)], dim=-2)


def combine_optics(taugas, tauray, taucld, w0_cld, g0_cld, raman_factor,
                   test_mode: Optional[str] = None,
                   delta_eddington: bool = True, stream: int = 2) -> RTProps:
    """Fuse per-source optical depths into the RT property bundle
    (optics.py:327-431), delta-Eddington on or off, with the 'rayleigh'
    and 'constant_tau' (any other string) test modes."""
    DTAU = taugas + tauray + taucld
    ftau_cld = (w0_cld * taucld) / (w0_cld * taucld + tauray)
    COSB = g0_cld
    ftau_ray = tauray / (tauray + w0_cld * taucld)
    GCOS2 = 0.5 * ftau_ray  # Hansen & Travis 1974
    W0 = (tauray * raman_factor + taucld * w0_cld) / DTAU
    W0_no_raman = (tauray * 0.99999 + taucld * w0_cld) / DTAU

    if test_mode is not None:
        # literature-table hooks (optics.py:372-399): analytic opacities in
        # place of the physical ones, for validation against Dlugach &
        # Yanovitskij / Madhu & Burrows
        if test_mode == 'rayleigh':
            DTAU = tauray
            GCOS2 = torch.full_like(DTAU, 0.5)
            ftau_ray = torch.ones_like(DTAU)
            ftau_cld = torch.zeros_like(DTAU)
        else:  # 'constant_tau' and anything else: the cloud opd alone
            DTAU = taucld
            GCOS2 = torch.zeros_like(DTAU)
            ftau_ray = torch.zeros_like(DTAU)
            ftau_cld = torch.ones_like(DTAU)
        w0_test = torch.where(w0_cld <= 0, 1e-10, w0_cld)
        DTAU = torch.where(DTAU <= 0, 1e-10, DTAU)
        COSB = g0_cld
        W0 = w0_test
        W0_no_raman = w0_test

    TAU = _cumtau(DTAU)
    if delta_eddington:
        # Joseph, Wiscombe & Weinman 1976 forward-peak rescaling
        f_deltaM = COSB ** stream
        w0_dedd = W0 * (1.0 - f_deltaM) / (1.0 - W0 * f_deltaM)
        cosb_dedd = (COSB - f_deltaM) / (1.0 - f_deltaM)
        dtau_dedd = DTAU * (1.0 - W0 * f_deltaM)
        return RTProps(dtau=dtau_dedd, tau=_cumtau(dtau_dedd), w0=w0_dedd,
                       cosb=cosb_dedd, ftau_cld=ftau_cld, ftau_ray=ftau_ray,
                       gcos2=GCOS2, dtau_og=DTAU, tau_og=TAU, w0_og=W0,
                       cosb_og=COSB, w0_no_raman=W0_no_raman,
                       f_deltaM=f_deltaM)
    return RTProps(dtau=DTAU, tau=TAU, w0=W0, cosb=COSB, ftau_cld=ftau_cld,
                   ftau_ray=ftau_ray, gcos2=GCOS2, dtau_og=DTAU, tau_og=TAU,
                   w0_og=W0, cosb_og=COSB, w0_no_raman=W0_no_raman,
                   f_deltaM=0.0 * COSB)
