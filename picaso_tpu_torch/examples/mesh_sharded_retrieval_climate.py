"""Device mesh: sharded retrieval likelihoods and a sharded RCE solve.

Port of examples/mesh_sharded_retrieval_climate.py to picaso_tpu_torch,
the two whole-workload mesh surfaces (the counterparts of the
reference's MPI likelihood pool and its serial climate loop):

1. A nested-sampling retrieval whose likelihood batches shard live points
   over the mesh's 'batch' axis and wavelengths over 'wave'
   (``parallel.sharded_loglike``, a drop-in for
   ``sampler.nested_sample``; replaces driver.py:406-427's MPIPool).  Each
   point is one sharded forward (``parallel.sharded_forward``: the
   opacity gather K1 and the fused Toon kernel K2 once per wave shard).
2. A whole radiative-convective climate solve (both profile passes and
   the find_strat zone search) over the mesh via
   ``case.climate(opa, mesh=...)``, in float64.

The mesh is 2 x 4 (batch x wave) over the visible cards, the first card
named again where there are fewer than 8, as the JAX example's 8 virtual
CPU devices.  On the card the retrieval runs in float32 (the kernels');
with ``cpu`` every shard is the CPU and the kernels' twins run in
float64.  It prints how many sharded forwards the retrieval made and, last,
the launches of the hand-written kernels in this process: K1 and K2 once
per forward and wave shard on the card, none on the CPU.

    python picaso_tpu_torch/examples/mesh_sharded_retrieval_climate.py [cpu]
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np
import torch

from picaso_tpu_torch import _build, checked_device, default_dtype
from picaso_tpu_torch import justdoit as jdi
from picaso_tpu_torch import parallel, pipeline
from picaso_tpu_torch.opacities import factory
from picaso_tpu_torch.opacities.ck import synthetic_ck_table
from picaso_tpu_torch.sampler import nested_sample

TRUTH = 1.05          # retrieved parameter: a temperature scale factor


def retrieval_problem(device):
    """The JAX example's scene: 256 bins from 2000 to 18000 cm^-1, 25
    levels, its mix, gravity, radius, mass and stellar radius (reflected,
    thermal and transmission on)."""
    wno = np.linspace(2000.0, 18000.0, 256)
    grid = factory.synthetic_opacity_grid(
        wno, ntemp=6, npress=5, dtype=default_dtype(device), device=device)
    nlevel = 25
    pressure = np.logspace(-6, 2, nlevel)
    temperature = 1000.0 * (pressure / 10.0) ** 0.1 + 300.0
    mix = {'H2': np.zeros(nlevel) + 0.85, 'He': np.zeros(nlevel) + 0.14,
           'H2O': np.zeros(nlevel) + 5e-4, 'CH4': np.zeros(nlevel) + 3e-4}
    scene, config = pipeline.scene_from_arrays(
        pressure, temperature, mix, grid, gravity=2500.0, radius=7.1e9,
        mass=1.9e30, rstar=6.96e10)
    return scene, grid, config


def retrieve(mesh, device, nlive=50, dlogz=0.5):
    """Nested sampling of the temperature scale over
    ``sharded_loglike``: every point one sharded forward of the scene with
    ``tlevel`` and ``tlayer`` scaled, on its batch row's wave shards.
    Returns the sampler's result, the posterior mean and the number of
    sharded forwards (the truth's and one per point, padding included)."""
    scene, grid, config = retrieval_problem(device)
    scene_s = parallel.shard_scene(scene, mesh)
    grid_s = parallel.shard_grid(grid, mesh)
    forwards = [0]

    def albedo(s, b):
        forwards[0] += 1
        scaled = scene_s.row(b).map(lambda sc: sc._replace(
            tlevel=sc.tlevel * s.to(sc.tlevel.device),
            tlayer=sc.tlayer * s.to(sc.tlevel.device)))
        return parallel.sharded_forward(scaled, grid_s.row(b), config,
                                        mesh.row(b))['albedo']

    dtype = scene.tlevel.dtype
    y = albedo(torch.tensor(TRUTH, dtype=dtype), 0)

    def loglike_row(x, b):
        x = x.to(dtype)
        y_b = y.to(x.device)
        return torch.stack([-0.5 * ((albedo(s[0], b) - y_b) ** 2).sum()
                            / 1e-6 for s in x])

    res = nested_sample(parallel.sharded_loglike(loglike_row, mesh),
                        lambda u: 0.9 + 0.3 * u, 1, nlive=nlive, seed=3,
                        dlogz=dlogz)
    return (res, float((res.samples[:, 0] * res.weights).sum()),
            forwards[0])


def climate_case(device):
    """The JAX example's sharded solve: the 700 K brown dwarf at log g 4
    on the synthetic CK table cut to every 4th of its first 192 bins (48,
    which the 4 wave shards divide), 41 levels."""
    ck = synthetic_ck_table(device=device)
    ck = ck.take_bins(np.s_[:(ck.nwno // 16) * 16:4])
    opa = jdi.opannection(ck_table=ck, method='preweighted', device=device)
    case = jdi.inputs(calculation='brown', climate=True)
    case.phase_angle(0)
    case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.effective_temp(700.0)
    case.setup_nostar()
    case.setup_climate()
    nlevel = 41
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    case.inputs_climate(temp_guess=guess, pressure=pressure,
                        rcb_guess=nlevel - 8, rfacv=0.0)
    return case, opa


def main(argv):
    device = checked_device(argv[0] if argv else 'cuda')
    devices = parallel.mesh_devices(8, device)
    mesh = parallel.make_mesh(n_wave=4, n_batch=2, devices=devices)
    holder = (torch.cuda.get_device_name(device) if device.type == 'cuda'
              else 'cpu')
    print(f'devices: {len(set(devices))} ({holder}) hold the '
          f'{len(devices)} shards')
    print(f'mesh: {dict(mesh.shape)}')

    # ---- 1. mesh-sharded retrieval ------------------------------------
    res, mean, forwards = retrieve(mesh, device)
    print(f'retrieved scale = {mean:.4f} (truth {TRUTH}), '
          f'logz = {res.logz:.2f}, {len(res.samples)} posterior samples')
    print(f'sharded forwards: {forwards}')
    assert abs(mean - TRUTH) < 2e-2

    # ---- 2. full sharded climate solve --------------------------------
    case, opa = climate_case(device)
    out = case.climate(opa, verbose=False, mesh=mesh)
    temp = np.asarray(out['temperature'])
    print(f"sharded RCE: converged={bool(out['converged'])}, "
          f'T = {temp.min():.0f}..{temp.max():.0f} K, '
          f"conv zones at nstr={[int(i) for i in out['cvz_locs']]}")
    assert out['converged']
    print('ok')
    launched = {name: w.launches
                for name, w in _build.kernel_wrappers().items()
                if w.launches}
    print(f'kernel launches: {json.dumps(launched)}')


if __name__ == '__main__':
    main(sys.argv[1:])
