"""Does the resort-rebin mix scale by the gases' total mixing ratio?

One absorbing gas at VMR x, in both packages on the CPU in float64, on
the synthetic CK table's first per-gas table (every 8th bin): the
molecular taugas of the resort-rebin path (``resortrebin_kappa`` with the
gas at x, times colden / mmw, as ``ck_taugas`` takes it) against the
premixed path's from a table built from the same per-gas table at x
(ln k + ln x, ``interp_premix``).  The resort-rebin mix is the VMR-weighted
mean k of the gases (``mix_2_gases``), never multiplied by their total
VMR, so its taugas is the premixed one over x, in the JAX package as in
the port (ROADMAP Queue 3, shared with the reference).  The test holds
that ratio, and the port to the JAX package at rtol 1e-12.
"""

import numpy as np
import pytest
import torch

from picaso_tpu.opacities import ck as jck
from picaso_tpu.opacities import resortrebin as jrr

from picaso_tpu_torch.opacities import ck as tck
from picaso_tpu_torch.opacities import resortrebin as trr

from torch_climate_modes_cases import port_table

torch.set_num_threads(1)

NLAYER = 12


@pytest.fixture(scope='module')
def tables():
    jt = jck.synthetic_ck_table(dtype=np.float64, with_per_gas=True)
    sl = np.s_[::8]
    a = jt.arrays
    js = jck.CKTable(
        a._replace(wno=a.wno[sl], delta_wno=a.delta_wno[sl],
                   ln_kappa=a.ln_kappa[:, :, sl, :],
                   cont_opa=a.cont_opa[:, :, sl]),
        jt.molecules, jt.full_abunds, jt.gauss_pts, jt.temps, jt.pressures,
        per_gas=jt.per_gas[:, :, :, sl, :],
        per_gas_molecules=jt.per_gas_molecules, wno=jt.wno[sl],
        delta_wno=jt.delta_wno[sl], gauss_wts=jt.gauss_wts)
    return js, port_table(js)


def _layers():
    tlayer = np.linspace(400.0, 2400.0, NLAYER)
    player = np.logspace(-3, 2, NLAYER)
    colw = np.linspace(1e24, 3e24, NLAYER)      # colden / mmw per layer
    return tlayer, player, colw


def _port(ts, x):
    a = ts.arrays
    tlayer, player, colw = (torch.tensor(v) for v in _layers())
    gas = ts.per_gas[:1]
    rr = trr.resortrebin_kappa(
        gas, a.t_inv_grid, a.p_log_grid, a.nc_p,
        torch.tensor(ts.gauss_pts), torch.tensor(ts.gauss_wts),
        torch.full((1, NLAYER), x, dtype=torch.float64), tlayer, player)
    premixed = tck.interp_premix(
        a._replace(ln_kappa=gas[0] + np.log(x)), tlayer, player)
    return ((k * colw[:, None, None]).numpy() for k in (rr, premixed))


def _jax(js, x):
    import jax.numpy as jnp
    a = js.arrays
    tlayer, player, colw = _layers()
    gas = jnp.asarray(js.per_gas[:1])
    rr = jrr.resortrebin_kappa(
        gas, a.t_inv_grid, a.p_log_grid, a.nc_p,
        jnp.asarray(js.gauss_pts), jnp.asarray(js.gauss_wts),
        jnp.full((1, NLAYER), x), jnp.asarray(tlayer), jnp.asarray(player))
    premixed = jck.interp_premix(
        a._replace(ln_kappa=gas[0] + np.log(x)), jnp.asarray(tlayer),
        jnp.asarray(player))
    return (np.asarray(k) * colw[:, None, None] for k in (rr, premixed))


@pytest.mark.parametrize('x', [1e-4, 1e-2, 0.5])
def test_resortrebin_taugas_is_premixed_over_vmr(tables, x):
    js, ts = tables
    rr, premixed = _port(ts, x)
    jrr_tau, jpremixed = _jax(js, x)
    assert np.isfinite(rr).all() and rr.min() > 0
    # the fault: the resort-rebin taugas misses the factor x
    np.testing.assert_allclose(rr * x, premixed, rtol=1e-12)
    np.testing.assert_allclose(jrr_tau * x, jpremixed, rtol=1e-12)
    # shared with the reference: the port equals the JAX package
    np.testing.assert_allclose(rr, jrr_tau, rtol=1e-12)
    np.testing.assert_allclose(premixed, jpremixed, rtol=1e-12)
