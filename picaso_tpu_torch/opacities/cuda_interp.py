"""Gather-fused molecular opacity interpolation: taugas [nlayer, nwno].

Counterpart of ``picaso_tpu/opacities/pallas_interp.py``.  One kernel,
``csrc/interp_tau.cu``, replaces both TPU kernels there:
``interp_tau_pallas_blocked`` (the main path, blocked table) and
``interp_tau_pallas`` (the flat-table fallback), because it reads the flat
``[nmol, npt, nwno]`` table directly.

:func:`interp_tau` is the public wrapper: it runs the plain twin
:func:`interp_tau_plain` for CPU tensors and launches the CUDA kernel for
CUDA tensors (or raises); there is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from .db import LOG_AVO, corner_weights

__all__ = ['interp_tau', 'interp_tau_plain']

_LN10 = float(np.log(10.0))


def interp_tau_plain(log_kappa, idx, t_w, p_w, mixcol):
    """Plain PyTorch twin of the gather kernel, same arithmetic order:
    the four corner products summed left to right, ``exp(ln10 * (logk +
    log10 N_A))``, then the column-weighted sum over molecules in order.

    log_kappa [nmol, npt, nwno]; idx [4, nlayer] flat-grid rows in the
    corner order of ``db._find_indices``; t_w/p_w [nlayer]; mixcol
    [nmol, nlayer].  Returns taugas [nlayer, nwno].
    """
    w4 = corner_weights(t_w, p_w).to(log_kappa.dtype)
    mixcol = mixcol.to(log_kappa.dtype)
    idx = idx.long()
    acc = None
    for m in range(log_kappa.shape[0]):
        rows = log_kappa[m][idx]                     # [4, nlayer, nwno]
        logk = (w4[0, :, None] * rows[0] + w4[1, :, None] * rows[1]
                + w4[2, :, None] * rows[2] + w4[3, :, None] * rows[3])
        term = mixcol[m, :, None] * torch.exp(_LN10 * (logk + LOG_AVO))
        acc = term if acc is None else acc + term
    return acc


def interp_tau(log_kappa, idx, t_w, p_w, mixcol):
    """taugas [nlayer, nwno] from the flat log-opacity table.

    Same contract as ``interp_tau_pallas``.  CPU tensors take the plain
    twin; CUDA tensors launch ``csrc/interp_tau.cu`` (float32, contiguous)
    and raise on anything the kernel does not take.

    Left out of the TPU kernels, with the reason:
    - the blocked ``[npt, nwb, nmol, block_w]`` repack: it made each TPU
      row fetch one contiguous DMA; here a warp's loads of a flat-table row
      are already contiguous, and the repack would cost a second 3.4 GB
      copy of the table;
    - ``_parity_slots``: it let Mosaic elide re-fetches of rows shared by
      consecutive layers; here such rows are re-read from L2;
    - the (8, 128) unit axes: a TPU tiling rule with no CUDA counterpart;
    - the SMEM scalar-prefetch of idx/weights: each block loads its own
      layer's row ids and weights into shared memory;
    - the int16 table (``_blocked_kernel_q``): not on the main path
      (ROADMAP Queue 2).
    """
    if log_kappa.device.type == 'cpu':
        return interp_tau_plain(log_kappa, idx, t_w, p_w, mixcol)
    if log_kappa.device.type != 'cuda':
        raise ValueError(f'interp_tau: unsupported device {log_kappa.device}')
    nmol, npt, nwno = log_kappa.shape
    nlayer = idx.shape[1]
    dev = log_kappa.device
    w4 = corner_weights(t_w, p_w).to(torch.float32).contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    mixcol = mixcol.to(torch.float32).contiguous()
    if log_kappa.dtype != torch.float32:
        raise TypeError(f'interp_tau: log_kappa must be float32, got '
                        f'{log_kappa.dtype}')
    if not log_kappa.is_contiguous():
        raise ValueError('interp_tau: log_kappa must be contiguous')
    if idx.shape != (4, nlayer) or mixcol.shape != (nmol, nlayer):
        raise ValueError(f'interp_tau: idx {tuple(idx.shape)} / mixcol '
                         f'{tuple(mixcol.shape)} do not match nmol={nmol}, '
                         f'nlayer={nlayer}')
    for name, t in (('idx', idx32), ('w4', w4), ('mixcol', mixcol)):
        if t.device != dev:
            raise ValueError(f'interp_tau: {name} on {t.device}, table on '
                             f'{dev}')
    if nlayer > 65535:
        raise ValueError(f'interp_tau: {nlayer} layers exceed the grid limit')
    from .._build import check, library
    out = torch.empty((nlayer, nwno), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().interp_tau_launch(
            log_kappa.data_ptr(), idx32.data_ptr(), w4.data_ptr(),
            mixcol.data_ptr(), out.data_ptr(), nmol, npt, nwno, nlayer,
            _LN10, LOG_AVO, stream)
    check(code, 'interp_tau')
    interp_tau.launches += 1
    return out


interp_tau.launches = 0
