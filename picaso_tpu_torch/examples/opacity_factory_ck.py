"""Opacity factory: monochromatic DB -> correlated-k tables -> climate
connection.

Port of examples/opacity_factory_ck.py to picaso_tpu_torch: the
reference's opacity-factory notebook category (opacity_factory.py): build
a reference-schema sqlite database, generate premixed correlated-k
tables from it (double-Gauss, order 4, gfrac 0.95), write the hdf5 (where
h5py is installed), reconnect through ``opannection(method=
'preweighted')``, and check k-distribution bin means against the
line-by-line truth, the cross sections interpolated on the card.

    python picaso_tpu_torch/examples/opacity_factory_ck.py [cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import importlib.util
import tempfile

import numpy as np
import torch

from picaso_tpu_torch import justdoit as jdi
from picaso_tpu_torch.opacities import factory
from picaso_tpu_torch.opacities.ck import (double_gauss_points,
                                           synthetic_ck_table)
from picaso_tpu_torch.opacities.db import interp_molecular, load_opacity_db

device = sys.argv[1] if len(sys.argv) > 1 else 'cuda'
workdir = tempfile.mkdtemp()
mono_db = os.path.join(workdir, 'mono.db')
wno = np.linspace(300.0, 15000.0, 4000)
factory.build_synthetic_db(mono_db, wno, molecules=('H2O', 'CH4', 'CO'),
                           ntemp=8, npress=6, device=device)
print(f'built monochromatic DB: {os.path.getsize(mono_db)/1e6:.1f} MB')

# --- per-molecule CK generation (opacity_factory.py:1748) ---
bin_edges = np.linspace(wno[0], wno[-1], 31)
ck_h2o = factory.compute_ck_molecular(mono_db, 'H2O', bin_edges)
print('H2O ln-k cube:', ck_h2o['kcoeffs'].shape,
      '(npress, ntemp, nbins, ngauss)')

# --- premixed table at fixed abundances (compute_sum_molecular) ---
abunds = {'H2O': 1e-3, 'CH4': 3e-4, 'CO': 1e-4}
ck_mix = factory.compute_sum_molecular(mono_db, abunds, bin_edges)
if importlib.util.find_spec('h5py') is not None:
    ck_path = os.path.join(workdir, 'premixed_ck.hdf5')
    factory.write_ck_hdf5(ck_path, ck_mix, list(abunds), abunds)
    print('premixed CK written:', os.path.basename(ck_path))
else:
    print('premixed CK not written: h5py is not installed')

# --- k-distribution check: gauss-weighted mean == line-by-line bin mean ---
gpts, gwts = double_gauss_points()
grid = load_opacity_db(mono_db, device=device)
tl = torch.tensor([900.0], dtype=grid.wno.dtype, device=grid.wno.device)
pl = torch.tensor([0.5], dtype=grid.wno.dtype, device=grid.wno.device)
im = grid.molecules.index('H2O')
sigma = interp_molecular(grid, tl, pl)[im, 0].double().cpu().numpy()
grid_wno = grid.wno.double().cpu().numpy()
centers = 0.5 * (bin_edges[:-1] + bin_edges[1:])
ibin = np.digitize(grid_wno, bin_edges) - 1
worst = 0.0
for b in range(len(centers)):
    lbl = sigma[ibin == b].mean()
    # the k-distribution built directly from this (T, P) for the check
    kdist = factory.compute_k_distribution(
        sigma[None, :], grid_wno, bin_edges, gpts)[0, b]
    ck_mean = float((kdist * gwts).sum())
    worst = max(worst, abs(ck_mean - lbl) / lbl)
print(f'k-distribution bin-mean vs line-by-line: worst rel err {worst:.2e}')
assert worst < 5e-2

# --- reconnect the premixed table as a climate-style opacity source ---
ck_table = synthetic_ck_table(device=device)
opa_ck = jdi.opannection(ck_table=ck_table, method='preweighted',
                         device=device)
print(f'preweighted connection: {opa_ck.nwno} bins x {opa_ck.ngauss} gauss, '
      f'{len(opa_ck.molecules)} molecules, full_abunds '
      f'{"present" if opa_ck.ck.full_abunds is not None else "missing"}')
assert opa_ck.ngauss == 8
print('PASS opacity factory -> CK pipeline')
