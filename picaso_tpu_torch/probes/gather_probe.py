"""Gather probe: how many table rows does a profile need, and does reading
each one once per column beat K1's re-reads through L2?

Port of ``scripts/gather_probe.py`` (the TPU DMA-elision probe).  At the
production shape (16 molecules, ragged 1060-point grid, nwno = 50 000, 90
layers) it reports:

1. the row fetches of the gather: naive (4 per layer), with a slot's
   repeat between consecutive layers skipped on the raw corner order, on
   greedily stabilised slots (:func:`stabilize_slots`), on parity slots
   (:func:`parity_slots`), and the distinct rows -- and the byte floor of
   each for the float32 table;
2. CUDA-event times of K1 (float32 table), K8 (int16 table) and the
   layer-innermost kernel :func:`interp_tau_layer_inner`
   (``csrc/gather_probe.cu``) on raw, stabilised, parity and constant
   row ids;
3. the stabilised kernel's max relative deviation from K1.

    python -m picaso_tpu_torch.probes.gather_probe [nwno] [n_iter]

Needs a CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import pipeline
from . import cuda_ms, max_rel
from ..constants import PCONV
from ..opacities.cuda_interp import (_LN10, _check_gather, interp_tau,
                                     interp_tau_q, interp_tau_w4_plain)
from ..opacities.db import LOG_AVO, _find_indices, corner_weights

__all__ = ['stabilize_slots', 'fetch_stats', 'parity_slots',
           'interp_tau_layer_inner', 'interp_tau_layer_inner_plain',
           'report', 'main']

MAX_MOL = 16   # csrc/gather_probe.cu kMaxMol


def stabilize_slots(idx, w4):
    """Permute each layer's 4 (row, weight) pairs (numpy [4, nlayer]) so
    slot q keeps the same row id as the previous layer wherever the sets
    overlap (scripts/gather_probe.py:83-110, greedy, in order)."""
    idx = idx.copy()
    w4 = w4.copy()
    nlayer = idx.shape[1]
    for l in range(1, nlayer):
        prev = idx[:, l - 1]
        cur = idx[:, l].copy()
        cw = w4[:, l].copy()
        assign = [-1] * 4
        used = [False] * 4
        placed = [False] * 4
        for j in range(4):
            for i in range(4):
                if not used[i] and cur[j] == prev[i]:
                    assign[i] = j
                    used[i] = True
                    placed[j] = True
                    break
        for j in range(4):
            if not placed[j]:
                i = used.index(False)
                assign[i] = j
                used[i] = True
        idx[:, l] = cur[assign]
        w4[:, l] = cw[assign]
    return idx, w4


def fetch_stats(idx):
    """(slot fetches when a repeat of the previous layer's row is skipped,
    naive fetches 4 * nlayer, distinct rows) of numpy idx [4, nlayer]
    (scripts/gather_probe.py:113-117)."""
    nlayer = idx.shape[1]
    changes = 4 + int((idx[:, 1:] != idx[:, :-1]).sum())
    uniq = len(np.unique(idx))
    return changes, 4 * nlayer, uniq


def parity_slots(idx, w4, t_par, p_par):
    """Each layer's four (row, weight) pairs moved to the slot of the
    corner's own grid parity, slot = 2 * (t % 2) + (p % 2), so a (T, P)
    row sits in the same slot in every layer that touches it (the JAX
    package's ``_parity_slots``, pallas_interp.py:195-228).  ``idx``/``w4``
    [4, nlayer] in the corner order of ``db._find_indices``; ``t_par``,
    ``p_par`` the base-corner parities of ``_find_indices(...,
    return_parity=True)``.  A pure permutation: the pairs travel together.
    """
    a = t_par.to(torch.int32)
    b = p_par.to(torch.int32)
    slot = torch.stack([2 * a + b, 2 * (1 - a) + b,
                        2 * (1 - a) + (1 - b), 2 * a + (1 - b)], 0)
    onehot = slot[:, None, :] == torch.arange(4, device=slot.device)[
        None, :, None]
    idx_st = (idx[:, None, :] * onehot).sum(0)
    w_st = (w4[:, None, :] * onehot).sum(0)
    return idx_st, w_st


# the twin of the layer-inner kernel: K1's arithmetic in slot order on the
# given (possibly slot-permuted) idx/w4 [4, nlayer]
interp_tau_layer_inner_plain = interp_tau_w4_plain


def interp_tau_layer_inner(log_kappa, idx, w4, mixcol):
    """taugas [nlayer, nwno] by ``csrc/gather_probe.cu`` (one thread per
    wavenumber walking the layers, a slot reloaded only when its row id
    changes), the counterpart of ``interp_tau_swapped``.  CPU tensors take
    the twin; CUDA tensors launch the kernel (float32, at most 16
    molecules) or raise."""
    if log_kappa.device.type == 'cpu':
        return interp_tau_layer_inner_plain(log_kappa, idx, w4, mixcol)
    if log_kappa.device.type != 'cuda':
        raise ValueError(f'interp_tau_layer_inner: unsupported device '
                         f'{log_kappa.device}')
    w4 = w4.to(torch.float32).contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    mixcol = mixcol.to(torch.float32).contiguous()
    nmol, npt, nwno, nlayer = _check_gather(
        'interp_tau_layer_inner', log_kappa, torch.float32, idx32, mixcol,
        (('w4', w4),))
    if nmol > MAX_MOL or w4.shape != (4, nlayer):
        raise ValueError(f'interp_tau_layer_inner: nmol {nmol} > {MAX_MOL} '
                         f'or w4 {tuple(w4.shape)}')
    if 4 * (8 + nmol) * nlayer > 48 * 1024:
        raise ValueError(f'interp_tau_layer_inner: {nlayer} layers exceed '
                         f'the shared memory')
    from .._build import check, library
    dev = log_kappa.device
    out = torch.empty((nlayer, nwno), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().interp_tau_layer_inner_launch(
            log_kappa.data_ptr(), idx32.data_ptr(), w4.data_ptr(),
            mixcol.data_ptr(), out.data_ptr(), nmol, npt, nwno, nlayer,
            _LN10, LOG_AVO, stream)
    check(code, 'interp_tau_layer_inner')
    interp_tau_layer_inner.launches += 1
    return out


interp_tau_layer_inner.launches = 0


def slot_inputs(scene, grid, config):
    """(log_kappa, mixcol, {name: (idx, w4)}) of the gather at this scene:
    the raw corner order, greedy stabilised slots, parity slots and a
    constant row (row 0 in every slot and layer, weights as raw)."""
    log_kappa, idx, t_w, p_w, mixcol = pipeline.gather_args(
        scene, grid._replace(log_kappa_blocked=None), config)
    _, _, _, parity = _find_indices(grid.pt, scene.tlayer,
                                    scene.player / PCONV, return_parity=True)
    w4 = corner_weights(t_w, p_w).to(torch.float32)
    idx_np, w4_np = stabilize_slots(idx.cpu().numpy(), w4.cpu().numpy())
    dev = idx.device
    return log_kappa, mixcol, {
        'raw': (idx, w4),
        'stabilized': (torch.as_tensor(idx_np, device=dev),
                       torch.as_tensor(w4_np, device=dev)),
        'parity': parity_slots(idx, w4, *parity),
        'constant': (torch.zeros_like(idx), w4)}


def report(scene, grid, config, n_iter=60, log=print):
    """Fetch counts, byte floors and CUDA-event times of the gathers at
    this problem (module docstring); returns them as a dict.  ``grid``
    may carry the int16 table already; otherwise it is quantized here."""
    log_kappa, mixcol, slots = slot_inputs(scene, grid, config)
    nmol, _, nwno = log_kappa.shape
    nlayer = mixcol.shape[1]
    stats = {name: fetch_stats(ix.cpu().numpy())
             for name, (ix, _) in slots.items()}
    _, naive, distinct = stats['raw']
    fetches = {'naive': naive, 'raw_repeat': stats['raw'][0],
               'stabilized': stats['stabilized'][0],
               'parity': stats['parity'][0], 'distinct': distinct}
    row_bytes = nmol * nwno * log_kappa.element_size()
    floors_gb = {k: v * row_bytes / 1e9 for k, v in fetches.items()}
    log(f'gather probe: nmol {nmol}, nlayer {nlayer}, nwno {nwno}; row '
        f'fetches {fetches}')
    log('  byte floors (float32 rows, GB): '
        + ', '.join(f'{k} {v:.4f}' for k, v in floors_gb.items()))

    gq = grid if grid.log_kappa_blocked is not None else \
        grid.with_blocked_table(quantize=True)
    g_args = pipeline.gather_args(scene, grid._replace(
        log_kappa_blocked=None), config)
    q_args = pipeline.gather_args(scene, gq, config)
    ms = {'K1 interp_tau (f32)': cuda_ms(lambda: interp_tau(*g_args),
                                         n_iter),
          'K8 interp_tau_q (int16)': cuda_ms(lambda: interp_tau_q(*q_args),
                                             n_iter)}
    for name, (ix, w) in slots.items():
        ms[f'layer-inner ({name})'] = cuda_ms(
            lambda: interp_tau_layer_inner(log_kappa, ix, w, mixcol), n_iter)
    for label, t in ms.items():
        log(f'  {label}: {t:.4f} ms')
    ref = interp_tau(*g_args)
    dev_rel = {name: max_rel(interp_tau_layer_inner(log_kappa, *slots[name],
                                                    mixcol), ref)
               for name in ('raw', 'stabilized', 'parity')}
    log(f'  layer-inner vs K1, max rel: '
        + ', '.join(f'{k} {v:.3e}' for k, v in dev_rel.items()))
    return {'fetches': fetches, 'floors_gb': floors_gb, 'ms': ms,
            'max_rel_vs_k1': dev_rel}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    nwno = int(argv[0]) if argv else 50_000
    n_iter = int(argv[1]) if len(argv) > 1 else 60
    if not torch.cuda.is_available():
        raise SystemExit('gather_probe: needs a CUDA device')
    scene, grid, config = pipeline.build_problem(nwno, device='cuda',
                                                 blocked='int16')
    print(torch.cuda.get_device_name(0))
    report(scene, grid, config, n_iter)


if __name__ == '__main__':
    main()
