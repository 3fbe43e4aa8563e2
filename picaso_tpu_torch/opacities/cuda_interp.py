"""Gather-fused molecular opacity interpolation: taugas [nlayer, nwno].

Counterpart of ``picaso_tpu/opacities/pallas_interp.py``.  One CUDA source,
``csrc/interp_tau.cu``, replaces its three TPU kernels, because it reads
the flat ``[nmol, npt, nwno]`` table directly:

* K1, ``interp_tau``: ``interp_tau_pallas_blocked`` (the main path,
  blocked float32 table) and ``interp_tau_pallas`` (the flat-table
  fallback);
* K8, ``interp_tau_q``: ``_blocked_kernel_q``, the gather over the int16
  fixed-point table that :func:`quantize_table` makes
  (``OpacityGrid.with_blocked_table(quantize=True)``).

Each public wrapper runs its plain twin (``*_plain``) for CPU tensors and
launches its CUDA kernel for CUDA tensors (or raises); there is no
fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from .db import LOG_AVO, corner_weights

__all__ = ['interp_tau', 'interp_tau_plain', 'interp_tau_q',
           'interp_tau_q_plain', 'quantize_table']

_LN10 = float(np.log(10.0))


def _blend_sum(rows_of, w4, mixcol, logk_of=None):
    """sum_m mixcol[m] * exp(ln10 * (logk_m + log10 N_A)) with logk_m the
    four corner rows ``rows_of(m)`` blended left to right by ``w4``
    (``logk_of`` maps the blend to log10 kappa).  Molecules in order."""
    acc = None
    for m in range(mixcol.shape[0]):
        rows = rows_of(m)                            # [4, nlayer, nwno]
        logk = (w4[0, :, None] * rows[0] + w4[1, :, None] * rows[1]
                + w4[2, :, None] * rows[2] + w4[3, :, None] * rows[3])
        if logk_of is not None:
            logk = logk_of(logk)
        term = mixcol[m, :, None] * torch.exp(_LN10 * (logk + LOG_AVO))
        acc = term if acc is None else acc + term
    return acc


def interp_tau_w4_plain(log_kappa, idx, w4, mixcol):
    """K1's arithmetic from given corner weights ``w4 [4, nlayer]``: the
    twin of ``interp_tau`` and of the gather probe's layer-inner kernel
    (which takes slot-permuted idx/w4)."""
    idx = idx.long()
    return _blend_sum(lambda m: log_kappa[m][idx], w4.to(log_kappa.dtype),
                      mixcol.to(log_kappa.dtype))


def interp_tau_plain(log_kappa, idx, t_w, p_w, mixcol):
    """Plain PyTorch twin of the gather kernel, same arithmetic order:
    the four corner products summed left to right, ``exp(ln10 * (logk +
    log10 N_A))``, then the column-weighted sum over molecules in order.

    log_kappa [nmol, npt, nwno]; idx [4, nlayer] flat-grid rows in the
    corner order of ``db._find_indices``; t_w/p_w [nlayer]; mixcol
    [nmol, nlayer].  Returns taugas [nlayer, nwno].
    """
    return interp_tau_w4_plain(log_kappa, idx, corner_weights(t_w, p_w),
                               mixcol)


def _check_gather(name, table, dtype, idx, mixcol, extra=()):
    """Shapes, dtypes and devices the gather kernels take; returns (nmol,
    npt, nwno, nlayer)."""
    nmol, npt, nwno = table.shape
    nlayer = idx.shape[1]
    if table.dtype != dtype:
        raise TypeError(f'{name}: table must be {dtype}, got {table.dtype}')
    if not table.is_contiguous():
        raise ValueError(f'{name}: table must be contiguous')
    if idx.shape != (4, nlayer) or mixcol.shape != (nmol, nlayer):
        raise ValueError(f'{name}: idx {tuple(idx.shape)} / mixcol '
                         f'{tuple(mixcol.shape)} do not match nmol={nmol}, '
                         f'nlayer={nlayer}')
    for label, t in (('idx', idx), ('mixcol', mixcol)) + tuple(extra):
        if t.device != table.device:
            raise ValueError(f'{name}: {label} on {t.device}, table on '
                             f'{table.device}')
    if nlayer > 65535:
        raise ValueError(f'{name}: {nlayer} layers exceed the grid limit')
    return nmol, npt, nwno, nlayer


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
      consecutive layers; here each block takes a chunk of consecutive
      layers and its prologue numbers the chunk's distinct rows, so each
      is read from device memory once per chunk and tile (the CUDA
      counterpart of that DMA elision; no host sync, no extra launch);
    - the (8, 128) unit axes: a TPU tiling rule with no CUDA counterpart;
    - the SMEM scalar-prefetch of idx/weights: each block loads its own
      chunk's row ids and weights into shared memory.
    """
    if log_kappa.device.type == 'cpu':
        return interp_tau_plain(log_kappa, idx, t_w, p_w, mixcol)
    if log_kappa.device.type != 'cuda':
        raise ValueError(f'interp_tau: unsupported device {log_kappa.device}')
    w4 = corner_weights(t_w, p_w).to(torch.float32).contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    mixcol = mixcol.to(torch.float32).contiguous()
    nmol, npt, nwno, nlayer = _check_gather(
        'interp_tau', log_kappa, torch.float32, idx32, mixcol,
        (('w4', w4),))
    from .._build import check, library
    dev = log_kappa.device
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


def quantize_table(log_kappa):
    """The int16 fixed-point table of ``log_kappa [nmol, npt, nwno]``:
    ``(q int16 [nmol, npt, nwno], qparams float32 [scale, offset])``.

    Gives the same codes as the JAX package's ``_repack_quantized``
    (pallas_interp.py:175-192): ``lo``/``hi`` over the table cast to
    float32, ``scale = max(hi - lo, 1e-6) / 65534`` in float32,
    ``round((log_kappa - lo) / scale) - 32767`` in the table's dtype with
    round-half-to-even, clipped to +-32767, and ``offset = 32767 * scale +
    lo`` (the re-centering folded into the offset, since the bilinear
    weights sum to 1).  One molecule at a time, so the temporaries stay a
    sixteenth of the 3.4 GB production table; the flat layout is kept
    (``OpacityGrid.with_blocked_table``).
    """
    lo = log_kappa.min().to(torch.float32)
    hi = log_kappa.max().to(torch.float32)
    scale = torch.clamp(hi - lo, min=1e-6) / 65534.0
    lo_t, scale_t = lo.to(log_kappa.dtype), scale.to(log_kappa.dtype)
    q = torch.empty(log_kappa.shape, dtype=torch.int16,
                    device=log_kappa.device)
    for m in range(log_kappa.shape[0]):
        code = torch.round((log_kappa[m] - lo_t) / scale_t) - 32767.0
        q[m] = torch.clamp(code, -32767, 32767).to(torch.int16)
    qparams = torch.stack([scale, 32767.0 * scale + lo]).to(torch.float32)
    return q, qparams


def interp_tau_q_plain(q, idx, t_w, p_w, mixcol, qparams):
    """Plain twin of K8 (``_blocked_kernel_q``, pallas_interp.py:243-259),
    all in float32 whatever the inputs' dtype (the JAX kernel's ``wdtype``
    for int16): ``qbar = w0*q0 + w1*q1 + w2*q2 + w3*q3`` left to right on
    the codes as float32, ``logk = qbar * scale + offset``, then
    ``exp(ln10 * (logk + log10 N_A))`` and the column-weighted sum over
    molecules in order.  Returns taugas [nlayer, nwno] float32."""
    f32 = torch.float32
    w4 = corner_weights(t_w, p_w).to(f32)
    qp = qparams.to(f32)
    idx = idx.long()
    return _blend_sum(lambda m: q[m][idx].to(f32), w4, mixcol.to(f32),
                      lambda qbar: qbar * qp[0] + qp[1])


def interp_tau_q(q, idx, t_w, p_w, mixcol, qparams=None):
    """taugas [nlayer, nwno] float32 from the int16 table ``q`` and its
    ``qparams`` (``quantize_table``); K8, the counterpart of
    ``interp_tau_pallas_blocked`` on an int16 table.

    CPU tensors take :func:`interp_tau_q_plain`; CUDA tensors launch
    ``interp_tau_q_launch`` of ``csrc/interp_tau.cu`` (K1's kernel staging
    int16 rows) and raise on anything it does not take.  A missing
    ``qparams`` raises ``ValueError``, as in the JAX package.
    """
    if qparams is None:
        raise ValueError('int16 table requires qparams')
    if q.device.type == 'cpu':
        return interp_tau_q_plain(q, idx, t_w, p_w, mixcol, qparams)
    if q.device.type != 'cuda':
        raise ValueError(f'interp_tau_q: unsupported device {q.device}')
    w4 = corner_weights(t_w, p_w).to(torch.float32).contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    mixcol = mixcol.to(torch.float32).contiguous()
    qp = qparams.to(torch.float32).contiguous()
    if qp.shape != (2,):
        raise ValueError(f'interp_tau_q: qparams {tuple(qp.shape)}, want (2,)')
    nmol, npt, nwno, nlayer = _check_gather(
        'interp_tau_q', q, torch.int16, idx32, mixcol,
        (('w4', w4), ('qparams', qp)))
    from .._build import check, library
    dev = q.device
    out = torch.empty((nlayer, nwno), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().interp_tau_q_launch(
            q.data_ptr(), idx32.data_ptr(), w4.data_ptr(), mixcol.data_ptr(),
            qp.data_ptr(), out.data_ptr(), nmol, npt, nwno, nlayer, _LN10,
            LOG_AVO, stream)
    check(code, 'interp_tau_q')
    interp_tau_q.launches += 1
    return out


interp_tau_q.launches = 0
