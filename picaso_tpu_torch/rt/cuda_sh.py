"""Spherical-harmonics (SH2/SH4) reflected and thermal solves in CUDA
kernels, with their plain twins.

Counterpart of ``picaso_tpu/rt/pallas_sh.py``: ``csrc/sh_spectrum.cu``
replaces the four TPU kernels ``reflected_sh4_pallas``,
``thermal_sh4_pallas``, ``reflected_sh2_pallas`` and
``thermal_sh2_pallas``.  From the six per-source strips each kernel builds
the optics (``pallas_toon._optics_block`` with stream 4 or 2), the SH
coefficients, the block-tridiagonal system in the 'incoming' grouping
(every pivot block nonsingular at float32), solves it by block-Thomas
elimination with pivoted Gauss-Jordan steps on the s x s blocks, and runs
the per-angle TOA intensity sweep.  Each kernel is two launches on the
current stream: stage A, one thread per wavenumber column; stage B, one
thread per (column, disk angle).  Reflected: stage A builds the optics and
factorises the block rows (Cp and each step's replay record); stage B
replays the record on the angle's right-hand side, substitutes back and
sweeps.  Thermal: stage A builds the optics, computes each layer's
coefficients once, eliminates the one thermal right-hand side with the
block rows and substitutes back (X); stage B sweeps the angle over X.

The ``*_plain`` functions are the twins: the Pallas kernels' arithmetic in
eager PyTorch (``_expm1`` as a 4th-order Taylor below |x| < 0.05 and a
difference above, integer powers as ``lax.integer_pow``'s products, the
clipped exponentials of the sweeps, the half-zero A/C blocks of the
incoming grouping), with ``torch.cumsum`` for the cumulative optical depth
where the TPU kernel uses a triangular matmul.  The disk angles are an
axis instead of a Python loop.

Each public wrapper runs its twin for CPU tensors and launches its kernel
for CUDA tensors (float32, contiguous), or raises.  Each counts its own
launches in ``<wrapper>.launches`` (one per call; both stages of a kernel
are one).  The wrappers take ``split_event``, a ``torch.cuda.Event``
recorded between the stages, so a caller can time them apart.
"""

from __future__ import annotations

import math

import torch

from ..optics import _cumtau
from .sh import _CLIP, _clip, _gj_solve, _ipow, _schur
from .toon import ScatteringControls, _dither_u0

__all__ = ['reflected_sh4', 'thermal_sh4', 'reflected_sh2', 'thermal_sh2',
           'reflected_sh4_plain', 'thermal_sh4_plain', 'reflected_sh2_plain',
           'thermal_sh2_plain']

PI = math.pi


def _pow_noint(x, fc):
    if float(fc).is_integer():
        return _ipow(x, int(fc))
    return torch.exp(float(fc) * torch.log(torch.abs(x)))


def _expm1(x):
    """exp(x) - 1 as the TPU kernel computes it (pallas_sh.py:64-75)."""
    small = torch.abs(x) < 0.05
    xs = torch.where(small, x, torch.zeros_like(x))
    series = xs * (1.0 + xs * (0.5 + xs * (1.0 / 6.0 + xs / 24.0)))
    return torch.where(small, series, torch.exp(x) - 1.0)


def _scaled_bet(exptrm_lam, trans_u1, beta, dtau, eps=1e-4):
    """Growing-mode source integral (pallas_sh.py:78-88)."""
    bd = beta * dtau
    near = torch.abs(bd) < 1.0
    em = -_expm1(-torch.clamp(bd, -1.0, 1.0))
    small = torch.abs(beta) < eps
    safe = torch.where(small, torch.ones_like(beta), beta)
    quotient = torch.where(small, dtau * (1.0 - 0.5 * bd),
                           torch.where(near, em, torch.ones_like(em)) / safe)
    far = (exptrm_lam - trans_u1) / torch.where(
        beta == 0.0, torch.ones_like(beta), beta)
    return torch.where(near, exptrm_lam * quotient, far)


def _legP(mu):
    return (1.0, mu, (3 * _ipow(mu, 2) - 1) / 2,
            (5 * _ipow(mu, 3) - 3 * mu) / 2)


def _optics_block(taugas, tauray, copd, cw0, cg0, rf, stream,
                  delta_eddington):
    """pallas_toon.py:_optics_block, the fields the SH kernels read."""
    dtau_og = taugas + tauray + copd
    cldw = cw0 * copd
    ftau_cld = cldw / (cldw + tauray)
    ftau_ray = tauray / (tauray + cldw)
    w0_og = (tauray * rf + cldw) / dtau_og
    cosb_og = cg0
    tau_og = _cumtau(dtau_og)
    if delta_eddington:
        f = _ipow(cosb_og, int(stream))
        w0 = w0_og * (1.0 - f) / (1.0 - w0_og * f)
        dtau = dtau_og * (1.0 - w0_og * f)
        tau = _cumtau(dtau)
    else:
        w0, dtau, tau = w0_og, dtau_og, tau_og
    return dict(dtau=dtau, tau=tau, w0=w0, ftau_cld=ftau_cld,
                ftau_ray=ftau_ray, dtau_og=dtau_og, tau_og=tau_og,
                w0_og=w0_og, cosb_og=cosb_og)


def _w_expansions_blk(w_form, rayleigh_on, cosb_og, ftau_cld, ftau_ray,
                      f_deltaM, controls, stream):
    """Legendre expansion weights (pallas_sh.py:101-124), a list."""
    w = [torch.ones_like(cosb_og) for _ in range(stream)]
    if w_form == 1:  # OTHG
        for l in range(1, stream):
            wl = (2 * l + 1) * _ipow(cosb_og, l)
            w[l] = (wl - (2 * l + 1) * f_deltaM) / (1 - f_deltaM)
    elif w_form == 0:  # TTHG
        g_forward = controls.constant_forward * cosb_og
        g_back = controls.constant_back * cosb_og
        f = controls.frac_a + controls.frac_b * _pow_noint(
            g_back, controls.frac_c)
        fdm = f_deltaM * (f * controls.constant_forward ** stream
                          + (1 - f) * controls.constant_back ** stream)
        for l in range(1, stream):
            wl = (2 * l + 1) * (f * _ipow(g_forward, l)
                                + (1 - f) * _ipow(g_back, l))
            w[l] = (wl - (2 * l + 1) * fdm) / (1 - fdm)
    if rayleigh_on == 1:
        for l in range(1, stream):
            w[l] = w[l] * ftau_cld
        if stream == 4:
            w[2] = w[2] + 0.5 * ftau_ray
    return w


def _rows(T):
    return torch.stack([torch.stack(r, 0) for r in T], 0)


def _sh2_coeffs(w0, dtau, w_multi):
    """Angle-independent SH2 set (pallas_sh.py:127-141); T and Fm are
    [2, 2, nlayer, nwno], row order [mn, pl]."""
    a = [(2 * l + 1) - w0 * w_multi[l] for l in range(2)]
    lam = torch.sqrt(a[0] * a[1])
    exptrm = torch.exp(-torch.clamp(lam * dtau, 0.0, _CLIP))
    q = lam / a[1]
    Q1 = (0.5 + q) * 2 * PI
    Q2 = (0.5 - q) * 2 * PI
    T = _rows(((Q1, Q2 * exptrm), (Q2, Q1 * exptrm)))
    Fm = _rows(((Q1 * exptrm, Q2), (Q2 * exptrm, Q1)))
    return dict(a=a, lam=lam, q=q, exptrm=exptrm, Q1=Q1, Q2=Q2, T=T, Fm=Fm)


def _sh4_coeffs(w0, dtau, w_multi):
    """Angle-independent SH4 set (pallas_sh.py:144-181); row order
    [z1mn, z2mn, z1pl, z2pl]."""
    a = [(2 * l + 1) - w0 * w_multi[l] for l in range(4)]
    beta = a[0] * a[1] + 4 * a[0] * a[3] / 9 + a[2] * a[3] / 9
    gama = a[0] * a[1] * a[2] * a[3] / 9
    root = torch.sqrt(_ipow(beta, 2) - 4 * gama)
    lam1 = torch.sqrt((beta + root) / 2)
    lam2 = torch.sqrt((beta - root) / 2)
    exptrm1 = torch.exp(-torch.clamp(lam1 * dtau, 0.0, _CLIP))
    exptrm2 = torch.exp(-torch.clamp(lam2 * dtau, 0.0, _CLIP))
    R1, R2 = -a[0] / lam1, -a[0] / lam2
    Q1 = 0.5 * (a[0] * a[1] / _ipow(lam1, 2) - 1)
    Q2 = 0.5 * (a[0] * a[1] / _ipow(lam2, 2) - 1)
    S1 = -3 / (2 * a[3]) * (a[0] * a[1] / lam1 - lam1)
    S2 = -3 / (2 * a[3]) * (a[0] * a[1] / lam2 - lam2)
    p1pl = (0.5 + R1 + 5 * Q1 / 8) * 2 * PI
    p2pl = (0.5 + R2 + 5 * Q2 / 8) * 2 * PI
    q1pl = (-0.125 + 5 * Q1 / 8 + S1) * 2 * PI
    q2pl = (-0.125 + 5 * Q2 / 8 + S2) * 2 * PI
    p1mn = (0.5 - R1 + 5 * Q1 / 8) * 2 * PI
    p2mn = (0.5 - R2 + 5 * Q2 / 8) * 2 * PI
    q1mn = (-0.125 + 5 * Q1 / 8 - S1) * 2 * PI
    q2mn = (-0.125 + 5 * Q2 / 8 - S2) * 2 * PI
    T = _rows(((p1mn, p1pl * exptrm1, p2mn, p2pl * exptrm2),
               (q1mn, q1pl * exptrm1, q2mn, q2pl * exptrm2),
               (p1pl, p1mn * exptrm1, p2pl, p2mn * exptrm2),
               (q1pl, q1mn * exptrm1, q2pl, q2mn * exptrm2)))
    Fm = _rows(((p1mn * exptrm1, p1pl, p2mn * exptrm2, p2pl),
                (q1mn * exptrm1, q1pl, q2mn * exptrm2, q2pl),
                (p1pl * exptrm1, p1mn, p2pl * exptrm2, p2mn),
                (q1pl * exptrm1, q1mn, q2pl * exptrm2, q2mn)))
    one = torch.ones_like(R1)
    A4 = ((one, one, one, one), (R1, -R1, R2, -R2), (Q1, Q1, Q2, Q2),
          (S1, -S1, S2, -S2))
    return dict(a=a, beta=beta, gama=gama, lam1=lam1, lam2=lam2,
                exptrm1=exptrm1, exptrm2=exptrm2, A4=A4, T=T, Fm=Fm)


def _eta_sources(c, u0, w0, w_single, F0PI):
    """SH4 beam particular solution (pallas_sh.py:351-375); u0 [nr, 1, 1]
    gives eta, z and u0b with a leading angle axis."""
    a = c['a']
    u0b = _dither_u0(c['lam2'], _dither_u0(c['lam1'], u0))
    u0i = 1.0 / u0b
    Del = 9 * (_ipow(u0i, 4) - c['beta'] * _ipow(u0i, 2) + c['gama'])
    Pu0 = _legP(-u0)
    b = [(F0PI * (w0 * w_single[l])) * Pu0[l] / (4 * PI) for l in range(4)]
    u0i2 = _ipow(u0i, 2)
    Dels0 = ((a[1] * b[0] - b[1] * u0i) * (a[2] * a[3] - 9 * u0i2)
             + 2 * (a[3] * b[2] - 2 * a[3] * b[0] - 3 * b[3] * u0i) * u0i2)
    Dels1 = ((a[0] * b[1] - b[0] * u0i) * (a[2] * a[3] - 9 * u0i2)
             - 2 * a[0] * (a[3] * b[2] - 3 * b[3] * u0i) * u0i)
    Dels2 = ((a[3] * b[2] - 3 * b[3] * u0i) * (a[0] * a[1] - u0i2)
             - 2 * a[3] * (a[0] * b[1] - b[0] * u0i) * u0i)
    Dels3 = ((a[2] * b[3] - 3 * b[2] * u0i) * (a[0] * a[1] - u0i2)
             + 2 * (3 * a[0] * b[1] - 2 * a[0] * b[3] - 3 * b[0] * u0i)
             * u0i2)
    eta = [Dels0 / Del, Dels1 / Del, Dels2 / Del, Dels3 / Del]
    z = [(eta[0] / 2 - eta[1] + 5 * eta[2] / 8) * 2 * PI,
         (-eta[0] / 8 + 5 * eta[2] / 8 - eta[3]) * 2 * PI,
         (eta[0] / 2 + eta[1] + 5 * eta[2] / 8) * 2 * PI,
         (-eta[0] / 8 + 5 * eta[2] / 8 + eta[3]) * 2 * PI]
    return eta, z, u0b


def _eta2_sources(c, u0, w0, w_single, F0PI):
    """SH2 beam particular solution (pallas_sh.py:772-785)."""
    a = c['a']
    u0b = _dither_u0(c['lam'], u0)
    Del = _ipow(1.0 / u0b, 2) - a[0] * a[1]
    Pu0 = _legP(-u0)
    b = [(F0PI * (w0 * w_single[l])) * Pu0[l] / (4 * PI) for l in range(2)]
    eta = [(b[1] / u0b - a[1] * b[0]) / Del,
           (b[0] / u0b - a[0] * b[1]) / Del]
    z = [(0.5 * eta[0] - eta[1]) * 2 * PI, (0.5 * eta[0] + eta[1]) * 2 * PI]
    return eta, z, u0b


def _stage_system(c, z_down, z_up, btv, bsv, sr, s):
    """The incoming-grouping block rows (pallas_sh.py:296-348).

    z_down/z_up [s, nr, nlayer, nw]; btv/bsv [h, nr, nw].  Returns B
    [s, s, n, nw], A (top h rows of A[k], k >= 1) [h, s, n-1, nw], C
    (bottom h rows of C[k], k <= n-2) [h, s, n-1, nw] and D [s, nr, n, nw].
    """
    h = s // 2
    T, Fm = c['T'], c['Fm']
    B = torch.cat([
        torch.cat([T[:h, :, :1], -T[:h, :, 1:]], 2),
        torch.cat([Fm[h:, :, :-1], Fm[h:, :, -1:] - sr * Fm[:h, :, -1:]],
                  2)], 0)
    A = Fm[:h, :, :-1]
    C = -T[h:, :, 1:]
    D = torch.cat([
        torch.cat([(btv - z_down[:h, :, 0])[:, :, None],
                   z_down[:h, :, 1:] - z_up[:h, :, :-1]], 2),
        torch.cat([z_down[h:, :, 1:] - z_up[h:, :, :-1],
                   (bsv - z_up[h:, :, -1] + sr * z_up[:h, :, -1])[:, :, None]],
                  2)], 0)
    return B, A, C, D


def _solve_sh_staged(B, A, C, D, s):
    """Block-Thomas on the staged system (pallas_sh.py:218-293): the
    Schur update touches only the top h rows (A's bottom rows are zero)
    and C contributes only its bottom h rows.  Returns X [s, nr, n, nw]."""
    h = s // 2
    n = B.shape[2]
    zeros = torch.zeros_like(B[:h, :, 0])
    Cps, Dps = [], []
    for k in range(n):
        Mb, Md = B[:, :, k], D[:, :, k]
        if k > 0:
            Ak = A[:, :, k - 1]
            Mb = torch.cat([_schur(Mb[:h], Ak, Cps[-1]), Mb[h:]], 0)
            Md = torch.cat([_schur(Md[:h], Ak, Dps[-1]), Md[h:]], 0)
        Ck = torch.cat([zeros, C[:, :, k] if k < n - 1 else zeros], 0)
        sol = _gj_solve(torch.cat([Mb, Ck, Md], 1), s)
        Cps.append(sol[:, :s])
        Dps.append(sol[:, s:])
    ys = [Dps[-1]]
    for k in range(n - 2, -1, -1):
        ys.append(_schur(Dps[k], Cps[k], ys[-1]))
    return torch.stack(ys[::-1], 2)                      # [s, nr, n, nw]


def _p_single(w_single, Pu0, Pu1, cosb_og, ftau_cld, ftau_ray, ct, controls,
              psingle_form, psingle_rayleigh, single_form, stream):
    p_single = torch.zeros_like(cosb_og)
    if single_form == 0:
        if psingle_form == 1:  # OTHG
            p_single = (1 - _ipow(cosb_og, 2)) / _ipow(torch.sqrt(
                1 + _ipow(cosb_og, 2) + 2 * cosb_og * ct), 3)
        elif psingle_form == 0:  # TTHG
            g_forward = controls.constant_forward * cosb_og
            g_back = controls.constant_back * cosb_og
            f = controls.frac_a + controls.frac_b * _pow_noint(
                g_back, controls.frac_c)
            p_single = (f * (1 - _ipow(g_forward, 2))
                        / torch.sqrt(_ipow(1 + _ipow(g_forward, 2)
                                           + 2 * g_forward * ct, 3))
                        + (1 - f) * (1 - _ipow(g_back, 2))
                        / torch.sqrt(_ipow(1 + _ipow(g_back, 2)
                                           + 2 * g_back * ct, 3)))
        if psingle_rayleigh == 1:
            p_single = (ftau_cld * p_single
                        + ftau_ray * (0.75 * (1 + ct * ct)))
    else:  # legendre form
        for l in range(stream):
            p_single = p_single + w_single[l] * Pu0[l] * Pu1[l]
    return p_single


def _sweep(x, trans, src):
    """Bottom-up TOA recursion x <- x * trans[k] + src[k] over layers
    ([nr, n, nw] inputs, x [nr, nw])."""
    for k in range(trans.shape[1] - 1, -1, -1):
        x = x * trans[:, k] + src[:, k]
    return x


def _check_options(stream, w_single_form=0, w_multi_form=0, psingle_form=0,
                   single_form=0):
    if stream not in (2, 4):
        raise ValueError(f'SH stream must be 2 or 4, got {stream}')
    for name, v, ok in (('w_single_form', w_single_form, (0, 1, 2)),
                        ('w_multi_form', w_multi_form, (0, 1, 2)),
                        ('psingle_form', psingle_form, (0, 1, 2)),
                        ('single_form', single_form, (0, 1))):
        if v not in ok:
            raise ValueError(f'{name} must be one of {ok}, got {v}')


def _reflected_plain(stream, taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                     surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                     controls=ScatteringControls(), b_top=0.0,
                     delta_eddington=True, w_single_form=0, w_multi_form=0,
                     psingle_form=0, w_single_rayleigh=1, w_multi_rayleigh=1,
                     psingle_rayleigh=1, single_form=0):
    """_sh4_reflected_kernel / _sh2_reflected_kernel in eager PyTorch."""
    _check_options(stream, w_single_form, w_multi_form, psingle_form,
                   single_form)
    s, h = stream, stream // 2
    dtype, dev = taugas.dtype, taugas.device
    ng, nt = ubar0.shape
    nwno = taugas.shape[1]
    u0 = ubar0.reshape(-1, 1, 1).to(dtype)
    u1 = ubar1.reshape(-1, 1, 1).to(dtype)
    nr = u0.shape[0]
    ct = torch.as_tensor(cos_theta, dtype=dtype, device=dev)
    o = _optics_block(taugas, tauray, cld_opd, cld_w0, cld_g0, rf, s,
                      delta_eddington)
    dtau, tau, w0 = o['dtau'], o['tau'], o['w0']
    cosb_og, ftc, ftr = o['cosb_og'], o['ftau_cld'], o['ftau_ray']
    f_deltaM = (_ipow(cosb_og, s) if delta_eddington
                else torch.zeros_like(cosb_og))
    w_single = _w_expansions_blk(w_single_form, w_single_rayleigh, cosb_og,
                                 ftc, ftr, f_deltaM, controls, s)
    w_multi = _w_expansions_blk(w_multi_form, w_multi_rayleigh, cosb_og,
                                ftc, ftr, f_deltaM, controls, s)
    if s == 4:
        c = _sh4_coeffs(w0, dtau, w_multi)
        eta, z, u0b = _eta_sources(c, u0, w0, w_single, F0PI)
    else:
        c = _sh2_coeffs(w0, dtau, w_multi)
        eta, z, u0b = _eta2_sources(c, u0, w0, w_single, F0PI)
    ex_dn = torch.exp(-_clip(tau[:-1] / u0b))
    ex_up = torch.exp(-_clip(tau[1:] / u0b))
    z_down = torch.stack([zj * ex_dn for zj in z])       # [s, nr, n, nw]
    z_up = torch.stack([zj * ex_up for zj in z])
    bsurf = surf_reflect * u0[:, 0] * F0PI * torch.exp(
        -_clip(tau[-1] / u0[:, 0]))                      # [nr, nw]
    bt = torch.full((nr, nwno), float(b_top), dtype=dtype, device=dev)
    if s == 4:
        btv = torch.stack([bt, -bt / 4.0])
        bsv = torch.stack([bsurf, -bsurf / 4.0])
    else:
        btv, bsv = bt[None], bsurf[None]
    X = _solve_sh_staged(*_stage_system(c, z_down, z_up, btv, bsv,
                                        surf_reflect, s), s)

    Pu0, Pu1 = _legP(-u0), _legP(u1)
    Fm = c['Fm']
    flux_bot = Fm[h][0][-1] * X[0][:, -1]
    for m in range(1, s):
        flux_bot = flux_bot + Fm[h][m][-1] * X[m][:, -1]
    flux_bot = flux_bot + z_up[h][:, -1]
    mus = (u1 + u0b) / (u1 * u0b)
    exptrm_mus = -_expm1(-_clip(mus * dtau)) / mus
    expon1 = exptrm_mus * torch.exp(-_clip(tau[:-1] / u0b))
    trans_u1 = torch.exp(-_clip(dtau / u1))
    if s == 4:
        multi_scat = _multi_scat4(c, w_multi, Pu1, X, u1, dtau, trans_u1)
        for j in range(4):
            multi_scat = multi_scat + w_multi[j] * Pu1[j] * eta[j] * expon1
    else:
        lam, q = c['lam'], c['q']
        alpha, beta_ = 1 / u1 + lam, 1 / u1 - lam
        exptrm_alp = -_expm1(-_clip(alpha * dtau)) / alpha
        exptrm_bet = _scaled_bet(c['exptrm'], trans_u1, beta_, dtau)
        multi_scat = (
            X[0] * (w_multi[0] - w_multi[1] * Pu1[1] * q) * exptrm_alp
            + X[1] * (w_multi[0] + w_multi[1] * Pu1[1] * q) * exptrm_bet
            + w_multi[0] * (eta[0] * expon1)
            + w_multi[1] * Pu1[1] * (eta[1] * expon1))
    p_single = _p_single(w_single, Pu0, Pu1, cosb_og, ftc, ftr, ct, controls,
                         psingle_form, psingle_rayleigh, single_form, s)
    em_mus1 = -_expm1(-_clip(mus * o['dtau_og']))
    intgrl = (w0 * multi_scat
              + o['w0_og'] * F0PI / (4 * PI) * p_single
              * em_mus1 * torch.exp(-_clip(o['tau_og'][:-1] / u0)) / mus)
    xint = _sweep(flux_bot / PI, trans_u1.expand_as(intgrl), intgrl / u1)
    return xint.reshape(ng, nt, nwno)


def _multi_scat4(c, w_multi, Pu1, X, u1, dtau, trans):
    """The four homogeneous-mode terms of the SH4 source integral."""
    lam1, lam2, A4 = c['lam1'], c['lam2'], c['A4']
    alpha1, alpha2 = 1 / u1 + lam1, 1 / u1 + lam2
    beta1, beta2 = 1 / u1 - lam1, 1 / u1 - lam2
    e = [-_expm1(-_clip(alpha1 * dtau)) / alpha1 * X[0],
         _scaled_bet(c['exptrm1'], trans, beta1, dtau) * X[1],
         -_expm1(-_clip(alpha2 * dtau)) / alpha2 * X[2],
         _scaled_bet(c['exptrm2'], trans, beta2, dtau) * X[3]]
    multi_scat = None
    for mode in range(4):
        coeff = None
        for j in range(4):
            term = w_multi[j] * Pu1[j] * A4[j][mode]
            coeff = term if coeff is None else coeff + term
        t = coeff * e[mode]
        multi_scat = t if multi_scat is None else multi_scat + t
    return multi_scat


def _thermal_plain(stream, all_b, taugas, tauray, cld_opd, cld_w0, cld_g0,
                   rf, ptfac, surf_reflect, ubar1, hard_surface=False,
                   delta_eddington=True):
    """_sh4_thermal_kernel / _sh2_thermal_kernel in eager PyTorch, on the
    delta-scaled dtau/w0 (not the OG fields the Toon thermal uses)."""
    _check_options(stream)
    s = stream
    dtype, dev = taugas.dtype, taugas.device
    ng, nt = ubar1.shape
    nwno = taugas.shape[1]
    u1 = ubar1.reshape(-1, 1, 1).to(dtype)
    pt = torch.as_tensor(ptfac, dtype=dtype, device=dev)
    o = _optics_block(taugas, tauray, cld_opd, cld_w0, cld_g0, rf, s,
                      delta_eddington)
    dtau, w0, cosb_og = o['dtau'], o['w0'], o['cosb_og']
    mu1 = 0.5
    b0 = all_b[:-1]
    b1 = (all_b[1:] - b0) / dtau
    ff = _ipow(cosb_og, s) if delta_eddington else torch.zeros_like(cosb_og)
    w_multi = [(2 * l + 1) * (_ipow(cosb_og, l) - ff) / (1 - ff)
               for l in range(s)]
    c = (_sh4_coeffs if s == 4 else _sh2_coeffs)(w0, dtau, w_multi)
    a = c['a']
    tau_top = dtau[0] * pt
    b_top = PI * (1.0 - torch.exp(-tau_top / mu1)) * all_b[0]
    if hard_surface:
        b_surface = PI * all_b[-1]
    else:
        b_surface = PI * (all_b[-1] + b1[-1] * mu1)
    pref = (1 - w0) / a[0] * 2 * PI
    zmn_dn = pref * (b0 / 2 - b1 / a[1])
    zpl_dn = pref * (b0 / 2 + b1 / a[1])
    zmn_up = pref * (b0 / 2 - b1 / a[1] + b1 * dtau / 2)
    zpl_up = pref * (b0 / 2 + b1 / a[1] + b1 * dtau / 2)
    if s == 4:
        pref2 = -0.5 * (1 - w0) / (4 * a[0]) * 2 * PI
        z_down = [zmn_dn, pref2 * b0, zpl_dn, pref2 * b0]
        z2_up = pref2 * (b0 + b1 * dtau)
        z_up = [zmn_up, z2_up, zpl_up, z2_up]
        btv = torch.stack([b_top, -b_top / 4.0])[:, None]
        bsv = torch.stack([b_surface, -PI * all_b[-1] / 4])[:, None]
    else:
        z_down, z_up = [zmn_dn, zpl_dn], [zmn_up, zpl_up]
        btv, bsv = b_top[None, None], b_surface[None, None]
    z_down = torch.stack(z_down)[:, None]                # [s, 1, n, nw]
    z_up = torch.stack(z_up)[:, None]
    X = _solve_sh_staged(*_stage_system(c, z_down, z_up, btv, bsv,
                                        surf_reflect, s), s)  # [s,1,n,nw]

    Pu1 = _legP(u1)
    em = -_expm1(-_clip(dtau / u1))                      # [nr, n, nw]
    expdtau = 1.0 - em
    planck_int = b0 * em + b1 * (u1 - (dtau + u1) * expdtau)
    if s == 4:
        multi_scat = _multi_scat4(c, w_multi, Pu1, X, u1, dtau, expdtau)
        Nint0 = w_multi[0] * ((1 - w0) * u1 / a[0] * planck_int)
        Nint1 = w_multi[1] * u1 * ((1 - w0) * u1 / a[0]
                                   * (b1 * em / a[1]))
        multi_scat = multi_scat + Nint0 + Nint1
    else:
        lam, q = c['lam'], c['q']
        alpha, beta_ = 1 / u1 + lam, 1 / u1 - lam
        exptrm_alp = -_expm1(-_clip(alpha * dtau)) / alpha
        exptrm_bet = _scaled_bet(c['exptrm'], expdtau, beta_, dtau)
        multi_scat = (
            X[0] * (w_multi[0] - w_multi[1] * u1 * q) * exptrm_alp
            + X[1] * (w_multi[0] + w_multi[1] * u1 * q) * exptrm_bet
            + w_multi[0] * ((1 - w0) * u1 / a[0] * planck_int)
            + w_multi[1] * u1 * ((1 - w0) * u1 / a[0]
                                 * (b1 * em / a[1])))
    intgrl = (w0 * multi_scat * 2 * PI
              + 2 * PI * (1 - w0) * u1 * planck_int)
    if hard_surface:
        x = (all_b[-1] * 2 * PI).expand(u1.shape[0], nwno)
    else:
        x = (all_b[-1] + b1[-1] * u1[:, 0]) * 2 * PI
    flux = _sweep(x, expdtau, intgrl / u1)
    return flux.reshape(ng, nt, nwno)


def reflected_sh4_plain(*args, **kwargs):
    """Twin of ``reflected_sh4_pallas``: xint [ng, nt, nwno]."""
    return _reflected_plain(4, *args, **kwargs)


def reflected_sh2_plain(*args, **kwargs):
    """Twin of ``reflected_sh2_pallas``: xint [ng, nt, nwno]."""
    return _reflected_plain(2, *args, **kwargs)


def thermal_sh4_plain(*args, **kwargs):
    """Twin of ``thermal_sh4_pallas``: TOA flux [ng, nt, nwno]."""
    return _thermal_plain(4, *args, **kwargs)


def thermal_sh2_plain(*args, **kwargs):
    """Twin of ``thermal_sh2_pallas``: TOA flux [ng, nt, nwno]."""
    return _thermal_plain(2, *args, **kwargs)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_STRIPS = ('taugas', 'tauray', 'cld_opd', 'cld_w0', 'cld_g0', 'rf')


def _check_cuda(name, strips, rows, nwno, ubar, extra):
    """Device, dtype, shape and contiguity checks of a CUDA launch."""
    dev = strips['taugas'].device
    nlayer = strips['taugas'].shape[0]
    if nlayer < 2:
        raise ValueError(f'{name}: needs at least 2 layers')
    for key, t in {**strips, **extra, 'ubar': ubar}.items():
        if t.device != dev:
            raise ValueError(f'{name}: {key} on {t.device}, taugas on {dev}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name}: {key} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {key} must be contiguous')
    for key, t in strips.items():
        if t.shape != (nlayer, nwno):
            raise ValueError(f'{name}: {key} {tuple(t.shape)} != '
                             f'{(nlayer, nwno)}')
    for key, t in extra.items():
        want = rows.get(key, (nwno,))
        if t.shape != want:
            raise ValueError(f'{name}: {key} {tuple(t.shape)} != {want}')
    if ubar.dim() != 2:
        raise ValueError(f'{name}: angles must be [ng, nt]')
    return dev, nlayer


def _scalar(name, v, dev):
    if isinstance(v, torch.Tensor) and (v.device != dev or v.numel() != 1):
        raise ValueError(f'{name} must be one value on {dev}')
    return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)


def _run_stages(name, dev, entry, args, split_event):
    """entry(*args, stage, stream) for stage 0 (A), then stage 1 (B), on
    the current stream, each launch checked before the next (the error
    names the stage); ``split_event`` is recorded between them."""
    from .._build import check
    with torch.cuda.device(dev):
        cuda_stream = torch.cuda.current_stream(dev)
        for stage in (0, 1):
            if stage == 1 and split_event is not None:
                split_event.record(cuda_stream)
            check(entry(*args, stage, cuda_stream.cuda_stream),
                  f'{name} stage {"AB"[stage]}')


def _launch_reflected(name, stream, taugas, tauray, cld_opd, cld_w0, cld_g0,
                      rf, surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                      controls=ScatteringControls(), b_top=0.0,
                      delta_eddington=True, w_single_form=0, w_multi_form=0,
                      psingle_form=0, w_single_rayleigh=1,
                      w_multi_rayleigh=1, psingle_rayleigh=1, single_form=0,
                      split_event=None):
    """The two stages of reflected_sh{4,2} (:func:`_run_stages`)."""
    _check_options(stream, w_single_form, w_multi_form, psingle_form,
                   single_form)
    strips = dict(zip(_STRIPS, (taugas, tauray, cld_opd, cld_w0, cld_g0,
                                rf)))
    nwno = taugas.shape[1]
    dev, nlayer = _check_cuda(name, strips, {'ubar1': tuple(ubar0.shape)},
                              nwno, ubar0, dict(
        surf_reflect=surf_reflect, F0PI=F0PI, ubar1=ubar1))
    ct = _scalar(f'{name}: cos_theta', cos_theta, dev)
    ng, nt = ubar0.shape
    nang = ng * nt

    from .._build import library
    lib = library()
    out = torch.empty((nang, nwno), dtype=torch.float32, device=dev)
    scratch = torch.empty((lib.sh_reflected_scratch_slots(stream, nang),
                           nlayer + 1, lib.sh_scratch_row(nwno)),
                          dtype=torch.float32, device=dev)
    c = controls
    args = (
        stream, taugas.data_ptr(), tauray.data_ptr(), cld_opd.data_ptr(),
        cld_w0.data_ptr(), cld_g0.data_ptr(), rf.data_ptr(),
        surf_reflect.data_ptr(), F0PI.data_ptr(),
        ubar0.reshape(-1).data_ptr(), ubar1.reshape(-1).data_ptr(),
        ct.data_ptr(), out.data_ptr(), scratch.data_ptr(), nlayer, nwno, nang,
        int(bool(delta_eddington)), int(w_single_form), int(w_multi_form),
        int(psingle_form), int(w_single_rayleigh), int(w_multi_rayleigh),
        int(psingle_rayleigh), int(single_form), c.frac_a, c.frac_b,
        c.frac_c, c.constant_back, c.constant_forward, float(b_top),
        c.constant_forward ** stream, c.constant_back ** stream)
    _run_stages(name, dev, lib.sh_reflected_launch, args, split_event)
    return out.reshape(ng, nt, nwno)


def _launch_thermal(name, stream, all_b, taugas, tauray, cld_opd, cld_w0,
                    cld_g0, rf, ptfac, surf_reflect, ubar1,
                    hard_surface=False, delta_eddington=True,
                    split_event=None):
    """The two stages of thermal_sh{4,2} (:func:`_run_stages`)."""
    _check_options(stream)
    strips = dict(zip(_STRIPS, (taugas, tauray, cld_opd, cld_w0, cld_g0,
                                rf)))
    nlayer, nwno = taugas.shape
    dev, nlayer = _check_cuda(name, strips, {'all_b': (nlayer + 1, nwno)},
                              nwno, ubar1, dict(all_b=all_b,
                                                surf_reflect=surf_reflect))
    pt = _scalar(f'{name}: ptfac', ptfac, dev)
    ng, nt = ubar1.shape
    nang = ng * nt

    from .._build import library
    lib = library()
    out = torch.empty((nang, nwno), dtype=torch.float32, device=dev)
    scratch = torch.empty((lib.sh_thermal_scratch_slots(stream),
                           nlayer + 1, lib.sh_scratch_row(nwno)),
                          dtype=torch.float32, device=dev)
    args = (stream, all_b.data_ptr(), taugas.data_ptr(), tauray.data_ptr(),
            cld_opd.data_ptr(), cld_w0.data_ptr(), cld_g0.data_ptr(),
            rf.data_ptr(), surf_reflect.data_ptr(),
            ubar1.reshape(-1).data_ptr(), pt.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), nlayer, nwno, nang,
            int(bool(delta_eddington)), int(bool(hard_surface)))
    _run_stages(name, dev, lib.sh_thermal_launch, args, split_event)
    return out.reshape(ng, nt, nwno)


def _dispatch(wrapper, twin, launch, stream, taugas, args, kwargs,
              **launch_kwargs):
    """The twin for CPU tensors; else the kernel, with ``launch_kwargs``
    (options the twin does not take)."""
    dev = taugas.device
    if dev.type == 'cpu':
        return twin(*args, **kwargs)
    if dev.type != 'cuda':
        raise ValueError(f'{wrapper.__name__}: unsupported device {dev}')
    out = launch(wrapper.__name__, stream, *args, **kwargs, **launch_kwargs)
    wrapper.launches += 1
    return out


def reflected_sh4(taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect,
                  ubar0, ubar1, cos_theta, F0PI, split_event=None, **kwargs):
    """SH4 reflected TOA intensity [ng, nt, nwno]; same contract and
    options as ``reflected_sh4_pallas`` (``controls``, ``b_top``,
    ``delta_eddington``, the seven SH form switches).  CPU tensors take
    the twin, CUDA tensors ``csrc/sh_spectrum.cu`` (two stages;
    ``split_event`` is recorded between them).

    Left out of the TPU kernel, with the reason: the wavelength blocks and
    their VMEM staging (a thread owns a column in stage A, a column and an
    angle in stage B; per-layer values in global scratch [slot, row,
    column], rows padded to 128 bytes); the staged A/B/C blocks (stage A
    builds each block row from the layer's coefficients, computed once
    and stored with the beam's angle-free factors for stage B); the
    angle-stacked right-hand sides (stage B replays each block row's
    recorded Gauss-Jordan step on one angle's); the triangular-matmul
    cumsum (a running sum); the SMEM angle operands (small device arrays
    read by every thread).
    """
    args = (taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect,
            ubar0, ubar1, cos_theta, F0PI)
    return _dispatch(reflected_sh4, reflected_sh4_plain, _launch_reflected,
                     4, taugas, args, kwargs, split_event=split_event)


def reflected_sh2(taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect,
                  ubar0, ubar1, cos_theta, F0PI, split_event=None, **kwargs):
    """SH2 reflected TOA intensity; :func:`reflected_sh4` with 2 x 2
    blocks (``reflected_sh2_pallas``)."""
    args = (taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect,
            ubar0, ubar1, cos_theta, F0PI)
    return _dispatch(reflected_sh2, reflected_sh2_plain, _launch_reflected,
                     2, taugas, args, kwargs, split_event=split_event)


def thermal_sh4(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, ptfac,
                surf_reflect, ubar1, split_event=None, **kwargs):
    """SH4 thermal TOA flux [ng, nt, nwno]; same contract as
    ``thermal_sh4_pallas`` (``hard_surface``, ``delta_eddington``); the
    solve uses the delta-scaled dtau/w0.  CPU tensors take the twin, CUDA
    tensors ``csrc/sh_spectrum.cu`` (two stages; ``split_event`` is
    recorded between them).

    Left out of the TPU kernel, with the reason: the wavelength blocks and
    their VMEM staging (a thread owns a column in stage A, a column and an
    angle in stage B; per-layer values in global scratch [slot, row,
    column], rows padded to 128 bytes); the staged A/B/C/D blocks (stage
    A builds each block row and its source rows in registers from the
    coefficients of three layers, each computed once); the per-angle
    sources of all layers at once (stage B sweeps its angle layer by
    layer over the layer values stage A stored); the triangular-matmul
    cumsum (not needed: the thermal solve reads no cumulative depth); the
    SMEM angle operands (small device arrays read by every thread).
    """
    args = (all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, ptfac,
            surf_reflect, ubar1)
    return _dispatch(thermal_sh4, thermal_sh4_plain, _launch_thermal, 4,
                     taugas, args, kwargs, split_event=split_event)


def thermal_sh2(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, ptfac,
                surf_reflect, ubar1, split_event=None, **kwargs):
    """SH2 thermal TOA flux; :func:`thermal_sh4` with 2 x 2 blocks
    (``thermal_sh2_pallas``)."""
    args = (all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, ptfac,
            surf_reflect, ubar1)
    return _dispatch(thermal_sh2, thermal_sh2_plain, _launch_thermal, 2,
                     taugas, args, kwargs, split_event=split_event)


for _w in (reflected_sh4, reflected_sh2, thermal_sh4, thermal_sh2):
    _w.launches = 0
