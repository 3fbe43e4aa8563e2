# Frozen copy of picaso_tpu_torch/rt/sh.py at commit d22d65a, with its
# imports made local to this package.  The benchmark's yardstick:
# edit only to fix a fault of the copy, never to follow the port.
"""Spherical-harmonics radiative transfer (Rooney et al. 2023a,b), 2 and 4
stream, plain PyTorch.

Port of ``picaso_tpu/rt/sh.py`` (reference picaso fluxes.py:2675-3628):
the SH systems are assembled in block-tridiagonal form (s x s blocks,
s = stream) and solved by block-Thomas elimination; the block matrix is
angle-independent, so every disk angle rides one elimination as an extra
right-hand side.

This is the plain reference path of the port (``use_kernels=False``), the
counterpart of the JAX scan path.  Differences of form, not of arithmetic:

- the layer scans are Python loops over layers; the per-angle ``vmap`` is
  a leading angle axis ([nr, ...]);
- the Gauss-Jordan rows are one stacked tensor [s, ncols, ...] instead of
  lists of lanes-last slices, so ``_rows``/``_stack`` have no counterpart:
  every row operation acts on all columns of a row at once (columns left
  of the pivot are never read again, so the solution is the same).

Precision (``picaso_tpu/rt/sh.py:44-60``): the 'classic' block-row
grouping (the reference's banded layout) goes singular at float32 for
optically thin layers; the 'incoming' grouping keeps every pivot block
nonsingular.  ``precision='auto'`` computes in float64 when the inputs are
float64 (classic grouping, the JAX f64 numbers) and in float32 otherwise
(incoming grouping); 'f64' and 'f32' cast and restore the input dtype.
"""

from __future__ import annotations

import math

import torch

from .toon import ScatteringControls, _dither_u0, blackbody

__all__ = ['block_tridiag_solve', 'reflected_sh', 'thermal_sh', 'legP']

PI = math.pi
_CLIP = 35.0


def _float_dtypes(x):
    """The floating dtypes of the tensors in a nested tuple / list."""
    if isinstance(x, torch.Tensor):
        return {x.dtype} if x.is_floating_point() else set()
    if isinstance(x, (tuple, list)):
        return set().union(*(_float_dtypes(y) for y in x))
    return set()


def _cast(x, target):
    """``x`` (nested tuple / NamedTuple) with its floating tensors in
    ``target``."""
    if isinstance(x, torch.Tensor):
        return x.to(target) if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*[_cast(y, target) for y in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_cast(y, target) for y in x)
    return x


def _promote(arrays, precision):
    """Cast a (nested tuple / NamedTuple) of SH inputs per ``precision``.

    Returns (cast, restore); restore(x) casts an output back to the
    floating dtype of the inputs.  (Module-level helpers, not recursive
    closures: a closure that calls itself is a reference cycle, which kept
    every input alive until the garbage collector ran.)
    """
    dt = (torch.float64 if torch.float64 in _float_dtypes(arrays)
          else torch.float32)
    if precision == 'auto':
        precision = 'f64' if dt == torch.float64 else 'f32'
    if precision not in ('f64', 'f32'):
        raise ValueError(f"SH precision must be 'auto', 'f64' or 'f32', "
                         f'got {precision!r}')
    target = torch.float64 if precision == 'f64' else torch.float32
    if target == dt:
        return _cast(arrays, target), lambda x: x
    return _cast(arrays, target), lambda x: x.to(dt)


def _ipow(x, n):
    """x**n for an integer n with the products of ``lax.integer_pow``
    (binary exponentiation: x**3 = x*(x*x), x**4 = (x*x)*(x*x)); torch's
    pow rounds x**4 once instead."""
    if n == 0:
        return torch.ones_like(x)
    recip, n = n < 0, abs(n)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return 1.0 / acc if recip else acc


def legP(mu, nmax=4):
    """Legendre polynomials P_0..P_{nmax-1} (fluxes.py:3639-3647)."""
    one = torch.ones_like(mu) if isinstance(mu, torch.Tensor) else 1.0
    polys = [one, mu, (3 * mu ** 2 - 1) / 2, (5 * mu ** 3 - 3 * mu) / 2]
    return polys[:nmax]


def _clip(x):
    return torch.clamp(x, -_CLIP, _CLIP)


def _scaled_bet(exptrm_lam, trans_u1, beta, dtau, eps=1e-4):
    """Growing-mode source integral with the per-layer scaling applied
    (picaso_tpu/rt/sh.py:103-127): the expm1 departure form for
    |beta*dtau| < 1, the Taylor limit for |beta| < eps, the plain clipped
    difference otherwise."""
    bd = beta * dtau
    near = torch.abs(bd) < 1.0
    em = -torch.expm1(-torch.clamp(bd, -1.0, 1.0))
    small = torch.abs(beta) < eps
    safe = torch.where(small, torch.ones_like(beta), beta)
    quotient = torch.where(small, dtau * (1.0 - 0.5 * bd),
                           torch.where(near, em, torch.ones_like(em)) / safe)
    far = (exptrm_lam - trans_u1) / torch.where(
        beta == 0.0, torch.ones_like(beta), beta)
    return torch.where(near, exptrm_lam * quotient, far)


# ---------------------------------------------------------------------------
# block-tridiagonal solver
# ---------------------------------------------------------------------------

def _gj_solve(M, s, pivot=True):
    """Gauss-Jordan on the augmented rows M [s, s + ncols, ...] (a new
    tensor is returned; M is not modified).  Partial pivoting is a chain
    of compare-and-swap row exchanges on |column i|.  Returns the solution
    columns [s, ncols, ...]."""
    rows = list(M.unbind(0))
    for i in range(s):
        if pivot:
            for r in range(i + 1, s):
                swap = torch.abs(rows[r][i]) > torch.abs(rows[i][i])
                top, bot = rows[i], rows[r]
                rows[i] = torch.where(swap, bot, top)
                rows[r] = torch.where(swap, top, bot)
        inv = 1.0 / rows[i][i]
        rows[i] = rows[i] * inv
        for r in range(s):
            if r == i:
                continue
            fac = rows[r][i]
            rows[r] = rows[r] - fac * rows[i]
    return torch.stack(rows, 0)[:, s:]


def _schur(Bk, Ak, Xp):
    """Bk - Ak @ Xp with the sum taken kk = 0..s-1 in order:
    Bk [s, m, ...], Ak [s, s, ...], Xp [s, m, ...]."""
    acc = Bk
    for kk in range(Ak.shape[1]):
        acc = acc - Ak[:, kk:kk + 1] * Xp[kk:kk + 1]
    return acc


def block_tridiag_solve(A, B, C, D, pivot=True):
    """Solve the block-tridiagonal system with s x s blocks, lanes-last.

    A, B, C: [n, s, s, nw] (A[0] and C[-1] ignored); D: [n, s, nw] for one
    right-hand side or [n, s, nr, nw] for nr of them.  One forward
    elimination serves every right-hand side.  Returns y with D's shape.
    """
    single = D.dim() == 3
    if single:
        D = D[:, :, None, :]
    n, s = D.shape[0], D.shape[1]
    Cps, Dps = [], []
    for k in range(n):
        if k == 0:
            Mb, Md = B[0], D[0]
        else:
            Mb = _schur(B[k], A[k], Cps[-1])
            Md = _schur(D[k], A[k], Dps[-1])
        sol = _gj_solve(torch.cat([Mb, C[k], Md], 1), s, pivot)
        Cps.append(sol[:, :s])
        Dps.append(sol[:, s:])
    ys = [Dps[-1]]
    for k in range(n - 2, -1, -1):
        ys.append(_schur(Dps[k], Cps[k], ys[-1]))
    y = torch.stack(ys[::-1], 0)                         # [n, s, nr, nw]
    return y[:, :, 0, :] if single else y


# ---------------------------------------------------------------------------
# 2-stream pieces (fluxes.py:3189-3333)
# ---------------------------------------------------------------------------

def _sh2_system(w0, dtau, tau, a, b, b_top, b_surface, surf_reflect, ubar0,
                calculation, b0=None, b1=None):
    """2-stream SH block system (picaso_tpu/rt/sh.py:250-317).

    Reflected (``calculation=0``): ``ubar0`` holds nr beam angles and
    ``b[l]`` is [nr, n, nw]; the sources gain the nr axis, the blocks T/Fm
    stay angle-independent.  Thermal (``calculation=1``) has nr = 1.
    """
    nlayer, nwno = dtau.shape
    lam = torch.sqrt(a[0] * a[1])
    if calculation == 0:
        u0b = _dither_u0(lam, ubar0[:, None, None])      # [nr, n, nw]
        Del = (1.0 / u0b) ** 2 - a[0] * a[1]
        eta = torch.stack([(b[1] / u0b - a[1] * b[0]) / Del,
                           (b[0] / u0b - a[0] * b[1]) / Del])
    else:
        u0b = torch.ones((1, nlayer, nwno), dtype=dtau.dtype,
                         device=dtau.device)
        eta = torch.zeros((2, 1, nlayer, nwno), dtype=dtau.dtype,
                          device=dtau.device)

    exptrm = torch.exp(-torch.clamp(lam * dtau, 0.0, _CLIP))
    q = lam / a[1]
    Q1 = (0.5 + q) * 2 * PI
    Q2 = (0.5 - q) * 2 * PI
    Q1mn, Q2mn = Q1 * exptrm, Q2 * exptrm

    if calculation == 0:
        zmn = (0.5 * eta[0] - eta[1]) * 2 * PI
        zpl = (0.5 * eta[0] + eta[1]) * 2 * PI
        zmn_up, zpl_up = (zmn * torch.exp(-tau[1:] / u0b),
                          zpl * torch.exp(-tau[1:] / u0b))
        zmn_down, zpl_down = (zmn * torch.exp(-tau[:-1] / u0b),
                              zpl * torch.exp(-tau[:-1] / u0b))
    else:
        pref = (1 - w0) / a[0] * 2 * PI
        zmn_down = (pref * (b0 / 2 - b1 / a[1]))[None]
        zmn_up = (pref * (b0 / 2 - b1 / a[1] + b1 * dtau / 2))[None]
        zpl_down = (pref * (b0 / 2 + b1 / a[1]))[None]
        zpl_up = (pref * (b0 / 2 + b1 / a[1] + b1 * dtau / 2))[None]

    # growing mode scaled per layer (picaso_tpu/rt/sh.py:295-302)
    def rows(m00, m01, m10, m11):
        return torch.stack([torch.stack([m00, m01], 1),
                            torch.stack([m10, m11], 1)], 1)  # [n, 2, 2, nw]

    T = rows(Q1, Q2mn, Q2, Q1mn)
    Fm = rows(Q1mn, Q2, Q2mn, Q1)
    z_down = torch.stack([zmn_down, zpl_down], 2)        # [nr, n, 2, nw]
    z_up = torch.stack([zmn_up, zpl_up], 2)
    nr = z_down.shape[0]
    b_top_vec = torch.as_tensor(b_top, dtype=dtau.dtype,
                                device=dtau.device).expand(nr, 1, nwno)
    b_surf_vec = torch.reshape(b_surface, (nr, 1, nwno))
    aux = dict(lam=lam, q=q, eta=eta, Q1=Q1, Q2=Q2,
               zpl_up=zpl_up, exptrm=exptrm, u0b=u0b)
    return T, Fm, z_down, z_up, b_top_vec, b_surf_vec, aux


# ---------------------------------------------------------------------------
# 4-stream pieces (fluxes.py:3336-3607)
# ---------------------------------------------------------------------------

def _sh4_system(w0, dtau, tau, a, b, b_top, b_surface, b_surface_sh4,
                surf_reflect, ubar0, calculation, b0=None, b1=None):
    """4-stream SH block system (picaso_tpu/rt/sh.py:324-435); angle and
    source layout as :func:`_sh2_system`."""
    nlayer, nwno = dtau.shape
    beta = a[0] * a[1] + 4 * a[0] * a[3] / 9 + a[2] * a[3] / 9
    gama = a[0] * a[1] * a[2] * a[3] / 9
    root = torch.sqrt(beta ** 2 - 4 * gama)
    lam1 = torch.sqrt((beta + root) / 2)
    lam2 = torch.sqrt((beta - root) / 2)

    if calculation == 0:
        u0v = ubar0[:, None, None]
        u0b = _dither_u0(lam2, _dither_u0(lam1, u0v))    # [nr, n, nw]
        u0i = 1.0 / u0b
        Del = 9 * (_ipow(u0i, 4) - beta * u0i ** 2 + gama)
        Dels0 = ((a[1] * b[0] - b[1] * u0i) * (a[2] * a[3] - 9 * u0i ** 2)
                 + 2 * (a[3] * b[2] - 2 * a[3] * b[0] - 3 * b[3] * u0i)
                 * u0i ** 2)
        Dels1 = ((a[0] * b[1] - b[0] * u0i) * (a[2] * a[3] - 9 * u0i ** 2)
                 - 2 * a[0] * (a[3] * b[2] - 3 * b[3] * u0i) * u0i)
        Dels2 = ((a[3] * b[2] - 3 * b[3] * u0i) * (a[0] * a[1] - u0i ** 2)
                 - 2 * a[3] * (a[0] * b[1] - b[0] * u0i) * u0i)
        Dels3 = ((a[2] * b[3] - 3 * b[2] * u0i) * (a[0] * a[1] - u0i ** 2)
                 + 2 * (3 * a[0] * b[1] - 2 * a[0] * b[3] - 3 * b[0] * u0i)
                 * u0i ** 2)
        eta = torch.stack([Dels0 / Del, Dels1 / Del, Dels2 / Del,
                           Dels3 / Del])                 # [4, nr, n, nw]
        z1pl = (eta[0] / 2 + eta[1] + 5 * eta[2] / 8) * 2 * PI
        z1mn = (eta[0] / 2 - eta[1] + 5 * eta[2] / 8) * 2 * PI
        z2pl = (-eta[0] / 8 + 5 * eta[2] / 8 + eta[3]) * 2 * PI
        z2mn = (-eta[0] / 8 + 5 * eta[2] / 8 - eta[3]) * 2 * PI
    else:
        eta = torch.zeros((4, 1, nlayer, nwno), dtype=dtau.dtype,
                          device=dtau.device)

    exptrm1 = torch.exp(-torch.clamp(lam1 * dtau, 0.0, _CLIP))
    exptrm2 = torch.exp(-torch.clamp(lam2 * dtau, 0.0, _CLIP))

    R1, R2 = -a[0] / lam1, -a[0] / lam2
    Q1 = 0.5 * (a[0] * a[1] / lam1 ** 2 - 1)
    Q2 = 0.5 * (a[0] * a[1] / lam2 ** 2 - 1)
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

    f2 = (p1pl * exptrm1, p1mn, p2pl * exptrm2, p2mn)
    Fm_rows = ((p1mn * exptrm1, p1pl, p2mn * exptrm2, p2pl),
               (q1mn * exptrm1, q1pl, q2mn * exptrm2, q2pl),
               f2,
               (q1pl * exptrm1, q1mn, q2pl * exptrm2, q2mn))

    if calculation == 0:
        ex_up = torch.exp(-_clip(tau[1:] / u0b))
        ex_dn = torch.exp(-_clip(tau[:-1] / u0b))
        z1mn_up, z2mn_up = z1mn * ex_up, z2mn * ex_up
        z1pl_up, z2pl_up = z1pl * ex_up, z2pl * ex_up
        z1mn_down, z2mn_down = z1mn * ex_dn, z2mn * ex_dn
        z1pl_down, z2pl_down = z1pl * ex_dn, z2pl * ex_dn
    else:
        u0b = torch.ones((1, nlayer, nwno), dtype=dtau.dtype,
                         device=dtau.device)
        pref = (1 - w0) / a[0] * 2 * PI
        pref2 = -0.5 * (1 - w0) / (4 * a[0]) * 2 * PI
        z1mn_up = (pref * (b0 / 2 - b1 / a[1] + b1 * dtau / 2))[None]
        z2mn_up = (pref2 * (b0 + b1 * dtau))[None]
        z1pl_up = (pref * (b0 / 2 + b1 / a[1] + b1 * dtau / 2))[None]
        z2pl_up = (pref2 * (b0 + b1 * dtau))[None]
        z1mn_down = (pref * (b0 / 2 - b1 / a[1]))[None]
        z2mn_down = (pref2 * b0)[None]
        z1pl_down = (pref * (b0 / 2 + b1 / a[1]))[None]
        z2pl_down = (pref2 * b0)[None]

    def rows4(*rs):
        return torch.stack([torch.stack(r, 1) for r in rs], 1)

    T = rows4((p1mn, p1pl * exptrm1, p2mn, p2pl * exptrm2),
              (q1mn, q1pl * exptrm1, q2mn, q2pl * exptrm2),
              (p1pl, p1mn * exptrm1, p2pl, p2mn * exptrm2),
              (q1pl, q1mn * exptrm1, q2pl, q2mn * exptrm2))
    Fm = rows4(*Fm_rows)
    z_down = torch.stack([z1mn_down, z2mn_down, z1pl_down, z2pl_down], 2)
    z_up = torch.stack([z1mn_up, z2mn_up, z1pl_up, z2pl_up], 2)
    nr = z_down.shape[0]
    bt = torch.as_tensor(b_top, dtype=dtau.dtype,
                         device=dtau.device).expand(nr, nwno)
    b_top_vec = torch.stack([bt, -bt / 4.0], 1)          # [nr, 2, nw]
    b_surf_vec = torch.stack([torch.reshape(b_surface, (nr, nwno)),
                              torch.reshape(b_surface_sh4, (nr, nwno))], 1)

    ones = torch.ones_like(R1)
    A = [[ones, ones, ones, ones], [R1, -R1, R2, -R2], [Q1, Q1, Q2, Q2],
         [S1, -S1, S2, -S2]]                             # A[j][mode]
    aux = dict(lam1=lam1, lam2=lam2, eta=eta, A=A, z1pl_up=z1pl_up, f2=f2,
               exptrm1=exptrm1, exptrm2=exptrm2, u0b=u0b)
    return T, Fm, z_down, z_up, b_top_vec, b_surf_vec, aux


def _default_grouping(dtype):
    """Row-pairing choice by working precision (see _solve_sh)."""
    return 'classic' if dtype == torch.float64 else 'incoming'


def _solve_sh(T, Fm, z_down, z_up, b_top_vec, b_surf_vec, surf_reflect,
              stream, grouping=None):
    """Assemble the block-tridiagonal system and solve for X
    (picaso_tpu/rt/sh.py:443-545).

    T, Fm: [n, s, s, nw]; z_down/z_up: [nr, n, s, nw]; b_top_vec and
    b_surf_vec: [nr, h, nw].  Returns X [n, s, nr, nw].  ``grouping``:
    'classic' (the reference's banded layout, block-row k = [interface-k
    pl-rows; interface-(k+1) mn-rows]) or 'incoming' (block-row k =
    [interface-k mn-rows; interface-(k+1) pl-rows], every diagonal block
    the layer's nonsingular incoming-field matrix); None picks by dtype.
    """
    n, s, _, nw = T.shape
    h = s // 2
    nr = z_down.shape[0]
    kw = dict(dtype=T.dtype, device=T.device)
    zero_blk = torch.zeros((n - 1, h, s, nw), **kw)
    zero1 = torch.zeros((1, s, s, nw), **kw)
    if grouping is None:
        grouping = _default_grouping(T.dtype)
    if grouping not in ('incoming', 'classic'):
        raise ValueError(f'unknown SH grouping {grouping!r}')
    # incoming: A rows [Fm_mn[k-1]; 0], B rows [T_mn; Fm_pl], C rows
    # [0; -T_pl[k+1]]; classic: A [Fm_pl[k-1]; 0], B [-T_pl; Fm_mn],
    # C [0; -T_mn[k+1]] (either way the first block row's top rows are
    # +T_mn (top boundary) and the last one's bottom rows Fm_pl with the
    # surface-reflection correction)
    lo, hi = (slice(None, h), slice(h, None))
    a_rows, b_top_rows, b_bot_rows, c_rows = (
        (lo, lo, hi, hi) if grouping == 'incoming' else (hi, hi, lo, lo))
    A = torch.cat([zero1, torch.cat([Fm[:-1, a_rows], zero_blk], 1)], 0)
    B_first = torch.cat([T[0, :h][None], Fm[0, b_bot_rows][None]], 1)
    B_mid = (torch.cat([-T[1:-1, b_top_rows], Fm[1:-1, b_bot_rows]], 1)
             if n > 2 else torch.zeros((0, s, s, nw), **kw))
    B_last = torch.cat([-T[-1, b_top_rows][None],
                        (Fm[-1, h:] - surf_reflect * Fm[-1, :h])[None]], 1)
    B = torch.cat([B_first, B_mid, B_last], 0)
    C = torch.cat([torch.cat([zero_blk, -T[1:, c_rows]], 1), zero1], 0)

    D_first = torch.cat([b_top_vec - z_down[:, 0, :h],
                         z_down[:, 1, b_bot_rows] - z_up[:, 0, b_bot_rows]],
                        1)[:, None]
    if n > 2:
        D_mid = torch.cat([
            z_down[:, 1:-1, b_top_rows] - z_up[:, :-2, b_top_rows],
            z_down[:, 2:, b_bot_rows] - z_up[:, 1:-1, b_bot_rows]], 2)
    else:
        D_mid = torch.zeros((nr, 0, s, nw), **kw)
    D_last = torch.cat([
        z_down[:, -1, b_top_rows] - z_up[:, -2, b_top_rows],
        (b_surf_vec - z_up[:, -1, h:] + surf_reflect * z_up[:, -1, :h])],
        1)[:, None]
    D = torch.cat([D_first, D_mid, D_last], 1)
    D = torch.movedim(D, 0, 2)                           # [n, s, nr, nw]
    return block_tridiag_solve(A, B, C, D)


def _w_expansions(stream, w_form, rayleigh_on, cosb_og, ftau_cld, ftau_ray,
                  f_deltaM, controls: ScatteringControls):
    """Legendre expansion weights w_l (fluxes.py:2803-2840): [s, n, nw]."""
    w = [torch.ones_like(cosb_og) for _ in range(stream)]
    if w_form == 1:  # OTHG
        for l in range(1, stream):
            wl = (2 * l + 1) * cosb_og ** l
            w[l] = (wl - (2 * l + 1) * f_deltaM) / (1 - f_deltaM)
    elif w_form == 0:  # TTHG
        g_forward = controls.constant_forward * cosb_og
        g_back = controls.constant_back * cosb_og
        f = controls.frac_a + controls.frac_b * g_back ** controls.frac_c
        fdm = f_deltaM * (f * controls.constant_forward ** stream
                          + (1 - f) * controls.constant_back ** stream)
        for l in range(1, stream):
            wl = (2 * l + 1) * (f * g_forward ** l + (1 - f) * g_back ** l)
            w[l] = (wl - (2 * l + 1) * fdm) / (1 - fdm)
    # isotropic (2): weights stay at ones, as in the reference
    if rayleigh_on == 1:
        for l in range(1, stream):
            w[l] = w[l] * ftau_cld
        if stream == 4:
            w[2] = w[2] + 0.5 * ftau_ray
    return torch.stack(w)


def _sh_intensity(props, X, eta, u0b, u0, u1, cos_theta, F0PI, stream, aux,
                  w_single, w_multi, controls, psingle_form,
                  psingle_rayleigh, single_form, flux_bot):
    """TOA intensity recursion for every outgoing angle at once
    (fluxes.py:2900-2972; picaso_tpu/rt/sh.py:575-664).

    X [nr, n, s, nw], eta [nr, s, n, nw], u0b [nr, n, nw], u0/u1 [nr, 1, 1]
    (u0 raw, undithered), flux_bot [nr, nw].  Returns [nr, nw].
    """
    dtau, tau = props.dtau, props.tau
    w0, cosb_og, w0_og = props.w0, props.cosb_og, props.w0_og
    dtau_og, tau_og = props.dtau_og, props.tau_og
    ftau_cld, ftau_ray = props.ftau_cld, props.ftau_ray
    Pu0 = legP(-u0)
    Pu1 = legP(u1)

    mus = (u1 + u0b) / (u1 * u0b)
    exptrm_mus = -torch.expm1(-_clip(mus * dtau)) / mus
    exptau_mu = torch.exp(-_clip(tau[:-1] / u0b))
    expon1 = exptrm_mus * exptau_mu

    trans_u1 = torch.exp(-_clip(dtau / u1))
    if stream == 2:
        lam, q = aux['lam'], aux['q']
        alpha = 1 / u1 + lam
        beta_ = 1 / u1 - lam
        exptrm_alp = -torch.expm1(-_clip(alpha * dtau)) / alpha
        exptrm_bet = _scaled_bet(aux['exptrm'], trans_u1, beta_, dtau)
        Aint0 = (X[:, :, 0] * (w_multi[0] - w_multi[1] * Pu1[1] * q)
                 * exptrm_alp)
        Aint1 = (X[:, :, 1] * (w_multi[0] + w_multi[1] * Pu1[1] * q)
                 * exptrm_bet)
        Nint0 = w_multi[0] * (eta[:, 0] * expon1)
        Nint1 = w_multi[1] * Pu1[1] * (eta[:, 1] * expon1)
        multi_scat = Aint0 + Nint0 + Aint1 + Nint1
    else:
        lam1, lam2, A4 = aux['lam1'], aux['lam2'], aux['A']
        alpha1, alpha2 = 1 / u1 + lam1, 1 / u1 + lam2
        beta1, beta2 = 1 / u1 - lam1, 1 / u1 - lam2
        e = [-torch.expm1(-_clip(alpha1 * dtau)) / alpha1 * X[:, :, 0],
             _scaled_bet(aux['exptrm1'], trans_u1, beta1, dtau) * X[:, :, 1],
             -torch.expm1(-_clip(alpha2 * dtau)) / alpha2 * X[:, :, 2],
             _scaled_bet(aux['exptrm2'], trans_u1, beta2, dtau) * X[:, :, 3]]
        coeff = [sum(w_multi[j] * Pu1[j] * A4[j][m] for j in range(4))
                 for m in range(4)]
        Aint = [coeff[m] * e[m] for m in range(4)]
        Nints = sum(w_multi[j] * Pu1[j] * eta[:, j] * expon1
                    for j in range(4))
        multi_scat = Aint[0] + Aint[1] + Aint[2] + Aint[3] + Nints

    p_single = torch.zeros_like(cosb_og)
    if single_form == 0:
        if psingle_form == 1:  # OTHG
            p_single = (1 - cosb_og ** 2) / (torch.sqrt(
                1 + cosb_og ** 2 + 2 * cosb_og * cos_theta) ** 3)
        elif psingle_form == 0:  # TTHG
            g_forward = controls.constant_forward * cosb_og
            g_back = controls.constant_back * cosb_og
            f = controls.frac_a + controls.frac_b * g_back ** controls.frac_c
            p_single = (f * (1 - g_forward ** 2)
                        / torch.sqrt((1 + g_forward ** 2
                                      + 2 * g_forward * cos_theta) ** 3)
                        + (1 - f) * (1 - g_back ** 2)
                        / torch.sqrt((1 + g_back ** 2
                                      + 2 * g_back * cos_theta) ** 3))
        if psingle_rayleigh == 1:
            p_single = (ftau_cld * p_single
                        + ftau_ray * (0.75 * (1 + cos_theta ** 2.0)))
    else:  # legendre form
        for l in range(stream):
            p_single = p_single + w_single[l] * Pu0[l] * Pu1[l]

    em_mus1 = -torch.expm1(-_clip(mus * dtau_og))
    intgrl = (w0 * multi_scat
              + w0_og * F0PI / (4 * PI) * p_single
              * em_mus1 * torch.exp(-tau_og[:-1] / u0) / mus)

    trans = torch.exp(-dtau / u1)                        # [nr, n, nw]
    x = flux_bot / PI
    u1v = u1[:, 0]
    for i in range(dtau.shape[0] - 1, -1, -1):
        x = x * trans[:, i] + intgrl[:, i] / u1v
    return x


def reflected_sh(props, surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                 stream=2, controls=ScatteringControls(), w_single_form=0,
                 w_multi_form=0, psingle_form=0, w_single_rayleigh=1,
                 w_multi_rayleigh=1, psingle_rayleigh=1, single_form=0,
                 b_top=0.0, precision='auto'):
    """Reflected light, SH 2/4-stream (fluxes.py:2675-2976): TOA intensity
    [ng, nt, nwno].  The block matrix is factored once; the ng x nt disk
    angles are extra right-hand sides."""
    if stream not in (2, 4):
        raise ValueError(f'SH stream must be 2 or 4, got {stream}')
    ng, nt = ubar0.shape
    cos_theta = torch.as_tensor(cos_theta, dtype=props.dtau.dtype,
                                device=props.dtau.device)
    ((props, surf_reflect, ubar0, ubar1, F0PI, cos_theta),
     restore) = _promote((props, surf_reflect, ubar0, ubar1, F0PI,
                          cos_theta), precision)
    dtau, tau, w0 = props.dtau, props.tau, props.w0
    cosb_og = props.cosb_og
    ftau_cld, ftau_ray, f_deltaM = (props.ftau_cld, props.ftau_ray,
                                    props.f_deltaM)
    u0s = ubar0.reshape(-1)                              # [nr]
    u1s = ubar1.reshape(-1)

    w_single = _w_expansions(stream, w_single_form, w_single_rayleigh,
                             cosb_og, ftau_cld, ftau_ray, f_deltaM, controls)
    w_multi = _w_expansions(stream, w_multi_form, w_multi_rayleigh,
                            cosb_og, ftau_cld, ftau_ray, f_deltaM, controls)

    a = torch.stack([(2 * l + 1) - w0 * w_multi[l] for l in range(stream)])
    Pu0s = legP(-u0s[:, None, None])
    # the beam source expands in the SINGLE-scattering moments, the sink
    # term a in the multi-scattering ones (fluxes.py:2859-2860)
    b = torch.stack([(F0PI * (w0 * w_single[l]))[None] * Pu0s[l] / (4 * PI)
                     for l in range(stream)])
    b_surface = (0.0 + surf_reflect * u0s[:, None] * F0PI
                 * torch.exp(-tau[-1][None] / u0s[:, None]))  # [nr, nw]
    b_surface_sh4 = -b_surface / 4

    if stream == 2:
        T, Fm, z_down, z_up, btv, bsv, aux = _sh2_system(
            w0, dtau, tau, a, b, b_top, b_surface, surf_reflect, u0s, 0)
    else:
        T, Fm, z_down, z_up, btv, bsv, aux = _sh4_system(
            w0, dtau, tau, a, b, b_top, b_surface, b_surface_sh4,
            surf_reflect, u0s, 0)
    X = _solve_sh(T, Fm, z_down, z_up, btv, bsv, surf_reflect, stream)
    X = torch.movedim(X, 2, 0)                           # [nr, n, s, nw]

    # flux at the bottom, the base of the intensity recursion
    if stream == 2:
        Q2mn = aux['Q2'] * aux['exptrm']
        flux_bot = (Q2mn[-1] * X[:, -1, 0] + aux['Q1'][-1] * X[:, -1, 1]
                    + aux['zpl_up'][:, -1])
    else:
        f20, f21, f22, f23 = aux['f2']
        flux_bot = (f20[-1] * X[:, -1, 0] + f21[-1] * X[:, -1, 1]
                    + f22[-1] * X[:, -1, 2] + f23[-1] * X[:, -1, 3]
                    + aux['z1pl_up'][:, -1])

    eta = torch.movedim(aux['eta'], 1, 0)                # [nr, s, n, nw]
    xint = _sh_intensity(props, X, eta, aux['u0b'], u0s[:, None, None],
                         u1s[:, None, None], cos_theta, F0PI, stream, aux,
                         w_single, w_multi, controls, psingle_form,
                         psingle_rayleigh, single_form, flux_bot)
    return restore(xint.reshape(ng, nt, -1))


def thermal_sh(tlevel, props, plevel, ubar1, surf_reflect, wno, stream=2,
               hard_surface=False, precision='auto'):
    """Thermal emission, SH 2/4-stream (fluxes.py:2979-3186): TOA flux
    [ng, nt, nwno].  (The JAX function also returns a ``None`` level-flux
    slot; the port returns the flux alone, as ``toon.thermal_1d`` does.)
    """
    if stream not in (2, 4):
        raise ValueError(f'SH stream must be 2 or 4, got {stream}')
    ((tlevel, props, plevel, ubar1, surf_reflect, wno),
     restore) = _promote((tlevel, props, plevel, ubar1, surf_reflect, wno),
                         precision)
    dtau, w0 = props.dtau, props.w0
    cosb, cosb_og = props.cosb, props.cosb_og
    nlayer, nwno = dtau.shape
    mu1 = 0.5
    kw = dict(dtype=dtau.dtype, device=dtau.device)

    all_b = blackbody(tlevel, 1.0 / wno).to(dtau.dtype)
    b0 = all_b[:-1]
    b1 = (all_b[1:] - b0) / dtau

    tau_top = dtau[0] * plevel[0] / (plevel[1] - plevel[0])
    b_top = PI * (1.0 - torch.exp(-tau_top / mu1)) * all_b[0]
    if hard_surface:
        b_surface = PI * all_b[-1]
    else:
        b_surface = PI * (all_b[-1] + b1[-1] * mu1)
    b_surface_sh4 = -PI * all_b[-1] / 4

    # delta-corrected fraction (fluxes.py:3072-3075)
    ff = torch.where(torch.all(cosb == cosb_og), 0.0 * cosb_og,
                     _ipow(cosb_og, stream))
    w_multi = torch.stack([(2 * l + 1) * (cosb_og ** l - ff) / (1 - ff)
                           for l in range(stream)])
    a = torch.stack([(2 * l + 1) - w0 * w_multi[l] for l in range(stream)])
    bb = torch.zeros((stream, 1, nlayer, nwno), **kw)
    one = torch.ones((1,), **kw)
    if stream == 2:
        T, Fm, z_down, z_up, btv, bsv, aux = _sh2_system(
            w0, dtau, None, a, bb, b_top, b_surface, surf_reflect, one, 1,
            b0=b0, b1=b1)
    else:
        T, Fm, z_down, z_up, btv, bsv, aux = _sh4_system(
            w0, dtau, None, a, bb, b_top, b_surface, b_surface_sh4,
            surf_reflect, one, 1, b0=b0, b1=b1)
    X = _solve_sh(T, Fm, z_down, z_up, btv, bsv, surf_reflect,
                  stream)[:, :, 0, :]                    # [n, s, nw]

    u1 = ubar1.reshape(-1)[:, None, None]                # [nr, 1, 1]
    Pu1 = legP(u1)
    # em = 1 - e^{-dtau/u1} via expm1: exact for optically thin layers
    em = -torch.expm1(-_clip(dtau / u1))
    expdtau = 1.0 - em
    planck_int = b0 * em + b1 * (u1 - (dtau + u1) * expdtau)
    Nint0 = w_multi[0] * ((1 - w0) * u1 / a[0] * planck_int)
    if stream == 2:
        lam, q = aux['lam'], aux['q']
        alpha = 1 / u1 + lam
        beta_ = 1 / u1 - lam
        exptrm_alp = -torch.expm1(-_clip(alpha * dtau)) / alpha
        exptrm_bet = _scaled_bet(aux['exptrm'], expdtau, beta_, dtau)
        Aint0 = X[:, 0] * (w_multi[0] - w_multi[1] * Pu1[1] * q) * exptrm_alp
        Aint1 = X[:, 1] * (w_multi[0] + w_multi[1] * Pu1[1] * q) * exptrm_bet
        Nint1 = w_multi[1] * Pu1[1] * ((1 - w0) * u1 / a[0]
                                       * (b1 * em / a[1]))
        multi_scat = Aint0 + Nint0 + Aint1 + Nint1
    else:
        lam1, lam2, A4 = aux['lam1'], aux['lam2'], aux['A']
        alpha1, alpha2 = 1 / u1 + lam1, 1 / u1 + lam2
        beta1, beta2 = 1 / u1 - lam1, 1 / u1 - lam2
        e = [-torch.expm1(-_clip(alpha1 * dtau)) / alpha1 * X[:, 0],
             _scaled_bet(aux['exptrm1'], expdtau, beta1, dtau) * X[:, 1],
             -torch.expm1(-_clip(alpha2 * dtau)) / alpha2 * X[:, 2],
             _scaled_bet(aux['exptrm2'], expdtau, beta2, dtau) * X[:, 3]]
        coeff = [sum(w_multi[j] * Pu1[j] * A4[j][m] for j in range(4))
                 for m in range(4)]
        Aint = [coeff[m] * e[m] for m in range(4)]
        Nint1 = w_multi[1] * u1 * ((1 - w0) * u1 / a[0] * (b1 * em / a[1]))
        multi_scat = Aint[0] + Aint[1] + Aint[2] + Aint[3] + Nint0 + Nint1

    intgrl = (w0 * multi_scat * 2 * PI
              + 2 * PI * (1 - w0) * u1 * planck_int)     # [nr, n, nw]
    if hard_surface:
        x = (all_b[-1] * 2 * PI).expand(u1.shape[0], nwno)
    else:
        x = (all_b[-1] + b1[-1] * u1[:, 0]) * 2 * PI
    u1v = u1[:, 0]
    for i in range(nlayer - 1, -1, -1):
        x = x * expdtau[:, i] + intgrl[:, i] / u1v
    ng, nt = ubar1.shape
    return restore(x.reshape(ng, nt, nwno))
