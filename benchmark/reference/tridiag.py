# Frozen copy of picaso_tpu_torch/rt/tridiag.py at commit d22d65a, with its
# imports made local to this package.  The benchmark's yardstick:
# edit only to fix a fault of the copy, never to follow the port.
"""Tridiagonal solvers for the Toon89 two-stream systems (plain PyTorch).

Port of ``picaso_tpu/rt/tridiag.py``.  The reference solves one 2*nlayer
tridiagonal system per wavelength (picaso fluxes.py:289-323); here every
trailing axis (wavelength, and the disk angles where the caller stacks
them) is solved at once and the rows are a Python loop.  The elimination
order matches the reference: a reverse sweep (last row first), then a
forward substitution.
"""

from __future__ import annotations

import torch

__all__ = ['tridiag_solve', 'setup_tri_diag', 'solve_two_stream']


def tridiag_solve(a, b, c, d):
    """Solve a[i]*x[i-1] + b[i]*x[i] + c[i]*x[i+1] = d[i] along axis 0.

    All inputs are [L, ...]; fluxes.py:289-323.
    """
    L = a.shape[0]
    # per-row views, taken once (each index would be a dispatch)
    a, b, c, d = a.unbind(0), b.unbind(0), c.unbind(0), d.unbind(0)
    AS = [None] * L
    DS = [None] * L
    AS[-1] = a[-1] / b[-1]
    DS[-1] = d[-1] / b[-1]
    for i in range(L - 2, -1, -1):
        x = 1.0 / (b[i] - c[i] * AS[i + 1])
        AS[i] = a[i] * x
        DS[i] = (d[i] - c[i] * DS[i + 1]) * x
    XK = [DS[0]]
    for i in range(1, L):
        XK.append(DS[i] - AS[i] * XK[-1])
    return torch.stack(XK, 0)


def setup_tri_diag(c_plus_up, c_minus_up, c_plus_down, c_minus_down,
                   b_top, b_surface, surf_reflect, gama, dtau,
                   exptrm_positive, exptrm_minus):
    """Toon89 eqn 44 interleaved coefficients A, B, C, D [2*nlayer, ...].

    Layer arrays are [nlayer, ...]; b_top, b_surface and surf_reflect
    broadcast against one row (fluxes.py:89-183).
    """
    (c_plus_up, c_minus_up, c_plus_down, c_minus_down, gama,
     exptrm_positive, exptrm_minus) = torch.broadcast_tensors(
        c_plus_up, c_minus_up, c_plus_down, c_minus_down, gama,
        exptrm_positive, exptrm_minus)
    row = gama.shape[1:]
    e1 = exptrm_positive + gama * exptrm_minus
    e2 = exptrm_positive - gama * exptrm_minus
    e3 = gama * exptrm_positive + exptrm_minus
    e4 = gama * exptrm_positive - exptrm_minus
    zrow = torch.zeros((1,) + row, dtype=gama.dtype, device=gama.device)
    b_top = torch.as_tensor(b_top, dtype=gama.dtype, device=gama.device)
    b_surface = torch.as_tensor(b_surface, dtype=gama.dtype,
                                device=gama.device)
    sr = surf_reflect

    A_odd = torch.cat([zrow, 2.0 * (1.0 - gama[:-1] ** 2)], 0)
    B_odd = torch.cat([gama[:1] + 1.0,
                       (e1[:-1] - e3[:-1]) * (gama[1:] + 1.0)], 0)
    C_odd = torch.cat([gama[:1] - 1.0,
                       (e1[:-1] + e3[:-1]) * (gama[1:] - 1.0)], 0)
    D_odd = torch.cat([
        (b_top.expand(row) - c_minus_up[0])[None],
        e3[:-1] * (c_plus_up[1:] - c_plus_down[:-1])
        + e1[:-1] * (c_minus_down[:-1] - c_minus_up[1:])], 0)

    A_even = torch.cat([(e1[:-1] + e3[:-1]) * (gama[1:] - 1.0),
                        (e1[-1] - sr * e3[-1])[None]], 0)
    B_even = torch.cat([(e2[:-1] + e4[:-1]) * (gama[1:] - 1.0),
                        (e2[-1] - sr * e4[-1])[None]], 0)
    C_even = torch.cat([2.0 * (1.0 - gama[1:] ** 2), zrow], 0)
    D_even = torch.cat([
        (gama[1:] - 1.0) * (c_plus_up[1:] - c_plus_down[:-1])
        + (1.0 - gama[1:]) * (c_minus_down[:-1] - c_minus_up[1:]),
        (b_surface.expand(row) - c_plus_down[-1]
         + sr * c_minus_down[-1])[None]], 0)

    def interleave(odd, even):
        return torch.stack([odd, even], 1).reshape((-1,) + row)

    return (interleave(A_odd, A_even), interleave(B_odd, B_even),
            interleave(C_odd, C_even), interleave(D_odd, D_even))


def solve_two_stream(c_plus_up, c_minus_up, c_plus_down, c_minus_down,
                     b_top, b_surface, surf_reflect, gama, dtau,
                     exptrm_positive, exptrm_minus):
    """Set up and solve the Toon89 system; returns (positive, negative),
    each [nlayer, ...] (fluxes.py:1202-1208)."""
    A, B, C, D = setup_tri_diag(c_plus_up, c_minus_up, c_plus_down,
                                c_minus_down, b_top, b_surface, surf_reflect,
                                gama, dtau, exptrm_positive, exptrm_minus)
    X = tridiag_solve(A, B, C, D)
    Xo = X[0::2]
    Xe = X[1::2]
    return Xo + Xe, Xo - Xe
