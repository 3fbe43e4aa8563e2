"""Device-mesh parallelism for spectra, phase curves, retrievals and the
climate.

Port of ``picaso_tpu/parallel.py``.  The parallel axes are those of the
JAX package's ('batch', 'wave') mesh:

* ``wave`` -- the wavenumber grid.  Every kernel of the forward treats
  wavenumber as its column axis, so a wave shard runs the forward on its
  slice and no shard reads another's; only the transit depth's slant-path
  matrix product runs once over the gathered optical depths (its cuBLAS
  summation order may change with the width).  The climate's spectral
  integrals (the net fluxes summed over the CK bins) are the only
  reductions across it.
* ``batch`` -- independent scenes (phase-curve points, live points of a
  retrieval) and the climate Jacobian's perturbed profiles.

The JAX package places arrays with ``NamedSharding``s and lets XLA split
the program and insert the collectives.  PyTorch has no such propagation,
so here every step is explicit: :func:`shard_scene` and :func:`shard_grid`
cut the arrays and copy each piece, contiguous, onto its device;
:func:`sharded_forward` launches ``pipeline.forward_parts`` on every
shard from one host thread, with no host read between two shards'
launches (shards on different cards overlap), then gathers the pieces
onto the mesh's first device; the climate's wave sums are partial sums
per shard, added on the first device in shard order
(:class:`ClimateShards`).

A mesh may name one device several times: the CPU tests put 8 shards on
``torch.device('cpu')`` and ``chip_smoke.py`` puts them on ``cuda:0`` where
there is one card, the counterpart of the JAX tests' virtual devices.  A
width the mesh does not divide raises, as the JAX package's
``device_put`` does.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from .climate import fused
from .climate.core import thermal_level_fluxes, visible_fluxes
from .opacities.db import OpacityGrid, PTGrid
from .pipeline import (_SCALARISH_RANK, SceneTensors, forward_parts,
                       scene_transit_depth, unstack_scene)

__all__ = ['Mesh', 'make_mesh', 'mesh_devices', 'ShardedScene', 'ShardedGrid',
           'shard_scene', 'shard_grid', 'sharded_forward',
           'sharded_forward_batch', 'sharded_loglike', 'ClimateShards',
           'shard_climate', 'shard_climate_state', 'sharded_profile_step']


class Mesh:
    """An (n_batch, n_wave) array of ``torch.device``s with the axis names
    ('batch', 'wave'), as the JAX ``Mesh`` of ``make_mesh``."""

    axis_names = ('batch', 'wave')

    def __init__(self, devices):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2 or 0 in self.devices.shape:
            raise ValueError(f'a mesh needs a 2-D array of devices, got '
                             f'shape {self.devices.shape}')

    @property
    def shape(self):
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def first(self):
        """The device that gathers results and holds replicated state."""
        return self.devices[0, 0]

    def row(self, b):
        """The (1, n_wave) mesh of batch row ``b``."""
        return Mesh(self.devices[b:b + 1])

    def __repr__(self):
        return (f'Mesh(batch={self.shape["batch"]}, '
                f'wave={self.shape["wave"]}, devices='
                f'{[[str(d) for d in r] for r in self.devices]})')


def make_mesh(n_wave=None, n_batch=1, devices=None) -> Mesh:
    """('batch', 'wave') mesh over ``devices`` (default: every visible
    CUDA card, as the JAX package takes ``jax.devices()``).  ``devices``
    may name a device more than once.  Asking for more shards than there
    are devices raises; nothing falls back to the CPU."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError('make_mesh: no CUDA device is visible; pass '
                               'devices= (e.g. [torch.device("cpu")] * 8)')
        devices = [torch.device('cuda', i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_wave is None:
        n_wave = len(devices) // n_batch
    if n_wave < 1 or n_batch < 1 or n_batch * n_wave > len(devices):
        raise ValueError(f'make_mesh: {n_batch} x {n_wave} shards need '
                         f'{n_batch * n_wave} devices, {len(devices)} given')
    grid = np.empty((n_batch, n_wave), dtype=object)
    for i, d in enumerate(devices[:n_batch * n_wave]):
        grid[i // n_wave, i % n_wave] = d
    return Mesh(grid)



def mesh_devices(n, device='cuda'):
    """``n`` devices for :func:`make_mesh`: the visible cards, the first
    named again where there are fewer cards than shards (as the JAX
    examples' virtual CPU devices); ``n`` times the CPU for a CPU
    ``device``.  No card and a CUDA ``device`` raises."""
    device = torch.device(device)
    if device.type == 'cpu':
        return [device] * n
    cards = [torch.device('cuda', i)
             for i in range(torch.cuda.device_count())]
    if not cards:
        raise RuntimeError('mesh_devices: no CUDA device is visible')
    return (cards + [cards[0]] * n)[:n]

def _split(x, n, dim, what):
    """``x`` cut into ``n`` equal pieces along ``dim``; raises where ``n``
    does not divide the axis, as the JAX package's ``device_put``."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f'{what}: axis {dim} of size {size} does not divide '
                         f'over {n} shards (the JAX package raises likewise)')
    return torch.tensor_split(x, n, dim)


def _put(x, device):
    """``x`` on ``device``, contiguous: the piece a shard owns (a slice is
    copied, so each device holds only its part)."""
    return x.to(device).contiguous()


def _moved(x, device):
    """A tensor, or a NamedTuple / tuple / list of them (other leaves as
    they are), on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*(_moved(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_moved(v, device) for v in x)
    return x


def _rows_of(first_row, mesh: Mesh):
    """[b][w] copies of row 0's shards: row ``b`` takes row 0's piece of
    column ``w`` on its own device (the same tensors where the device is
    the same)."""
    nb, nw = mesh.devices.shape
    return tuple(
        tuple(first_row[w] if b == 0 else _moved(first_row[w],
                                                   mesh.devices[b, w])
              for w in range(nw))
        for b in range(nb))


# ---------------------------------------------------------------------------
# spectra
# ---------------------------------------------------------------------------

def _wave_sharded_fields():
    """SceneTensors fields carrying a trailing wavenumber axis
    (picaso_tpu/parallel.py:42-45)."""
    return {'cld_opd', 'cld_g0', 'cld_w0', 'sigma_ray', 'F0PI',
            'surf_reflect', 'raman_shifts', 'raman_pollack_row'}


class ShardedScene(NamedTuple):
    """A scene (or a stacked batch of them) cut over a mesh:
    ``shards[b][w]`` is the SceneTensors of batch row ``b``'s scenes on
    wave slice ``w``, on ``mesh.devices[b, w]``.  An unbatched scene is
    the same on every batch row."""
    shards: tuple
    mesh: Mesh
    batched: bool

    def row(self, b):
        """The scene of batch row ``b`` on that row's (1, n_wave) mesh."""
        return ShardedScene((self.shards[b],), self.mesh.row(b),
                            self.batched)

    def map(self, fn):
        """``fn`` applied to every shard's SceneTensors (for edits of
        wave-independent fields, e.g. scaling the temperatures)."""
        return self._replace(shards=tuple(tuple(fn(s) for s in r)
                                          for r in self.shards))


class ShardedGrid(NamedTuple):
    """An opacity grid cut over the mesh's wave axis: ``shards[b][w]`` is
    the OpacityGrid of wave slice ``w`` on ``mesh.devices[b, w]`` (one copy
    per distinct device)."""
    shards: tuple
    mesh: Mesh

    def row(self, b):
        return ShardedGrid((self.shards[b],), self.mesh.row(b))


def shard_scene(scene: SceneTensors, mesh: Mesh,
                batched: bool = False) -> ShardedScene:
    """Place scene arrays (picaso_tpu/parallel.py:48-67): the fields of
    :func:`_wave_sharded_fields` cut on their last axis over 'wave', the
    rest replicated.  With ``batched`` (a :func:`pipeline.stack_scenes`
    batch) the leading axis cuts over 'batch', except the batch-constant
    geometry fields at their unbatched rank (``pipeline._SCALARISH_RANK``),
    which replicate."""
    nb, nw = mesh.devices.shape
    wave = _wave_sharded_fields()
    rows = nb if batched else 1     # an unbatched scene: row 0's pieces
    pieces = {}
    for name, val in scene._asdict().items():
        rank = _SCALARISH_RANK.get(name)
        lead = (batched and val.dim() > 0
                and not (rank is not None and val.dim() == rank))
        blocks = (_split(val, nb, 0, f'shard_scene {name} over batch')
                  if lead else (val,) * rows)
        pieces[name] = [
            (_split(r, nw, r.dim() - 1, f'shard_scene {name} over wave')
             if name in wave else (r,) * nw) for r in blocks]
    shards = tuple(
        tuple(SceneTensors(**{name: _put(p[b][w], mesh.devices[b, w])
                              for name, p in pieces.items()})
              for w in range(nw))
        for b in range(rows))
    if not batched:
        shards = _rows_of(shards[0], mesh)
    return ShardedScene(shards, mesh, batched)


def shard_grid(grid: OpacityGrid, mesh: Mesh) -> ShardedGrid:
    """Cut the opacity grid over the mesh's 'wave' axis
    (picaso_tpu/parallel.py:70-93): ``wno``, ``log_kappa``, ``cont_opa``
    and the int16 table on their last axis; the (T, P) grid, the CIA
    temperatures and the int16 scale pair replicated.  The port's int16
    table is flat ``[nmol, npt, nwno]`` (``opacities/db.py``), so it cuts
    like ``log_kappa``.  Each piece is a contiguous copy on its device, as
    the gather kernels take it."""
    nw = mesh.devices.shape[1]

    def cut(x, what):
        return _split(x, nw, x.dim() - 1, f'shard_grid {what} over wave')

    wno, lk, cont = (cut(grid.wno, 'wno'), cut(grid.log_kappa, 'log_kappa'),
                     cut(grid.cont_opa, 'cont_opa'))
    q = (None if grid.log_kappa_blocked is None
         else cut(grid.log_kappa_blocked, 'the int16 table'))
    first = []
    for w in range(nw):
        dev = mesh.devices[0, w]
        first.append(grid._replace(
            wno=_put(wno[w], dev), log_kappa=_put(lk[w], dev),
            pt=PTGrid(*(x.to(dev) for x in grid.pt)),
            cont_opa=_put(cont[w], dev), cia_temps=grid.cia_temps.to(dev),
            log_kappa_blocked=None if q is None else _put(q[w], dev),
            blocked_qparams=(None if grid.blocked_qparams is None
                             else grid.blocked_qparams.to(dev))))
    return ShardedGrid(_rows_of(first, mesh), mesh)


def _check_mesh(what, mesh: Mesh, *sharded):
    for s in sharded:
        if s.mesh.devices.shape != mesh.devices.shape:
            raise ValueError(f'{what}: placed on a {s.mesh}, called with '
                             f'{mesh}')


def _gather(outs, first):
    """[b][w] dicts of tensors -> one dict on ``first``: wave pieces
    concatenated on the last axis, batch rows on the first."""
    keys = outs[0][0].keys()
    rows = [{k: torch.cat([o[k].to(first) for o in r], -1) for k in keys}
            for r in outs]
    if len(rows) == 1:
        return rows[0]
    return {k: torch.cat([r[k] for r in rows], 0) for k in keys}


def _forward_row(scenes, grids, config, nscene):
    """One batch row over its wave shards: ``scenes[w]`` (one scene, or
    with ``nscene`` a stacked batch of that many) on ``grids[w]``.  Every
    shard runs ``pipeline.forward_parts`` on its slice, launched one after
    another with no host read between them; the transit depth then runs
    once per scene over the optical depths gathered on the row's first
    device.  Its slant-path matrix product is the one step whose numbers
    a narrower width could change: cuBLAS may pick another kernel, and so
    another summation order, for another width (a wave-sharded transit
    depth came out 1 ulp off on an H100), so it runs over the whole width,
    as unsharded.  Returns ([w] dicts of the other outputs, the transit
    depth or None)."""
    idx = [None] if nscene is None else range(nscene)

    def one(s, i):
        return s if i is None else unstack_scene(s, i)

    parts = [[forward_parts(one(s, i), g, config) for i in idx]
             for s, g in zip(scenes, grids)]
    outs = [{k: (p[0][0][k] if nscene is None
                 else torch.stack([q[0][k] for q in p])) for k in p[0][0]}
            for p in parts]
    if not config.transmission:
        return outs, None
    dev = scenes[0].tlevel.device
    depth = [scene_transit_depth(one(scenes[0], i), torch.cat(
        [p[j][1].to(dev) for p in parts], -1)) for j, i in enumerate(idx)]
    return outs, depth[0] if nscene is None else torch.stack(depth)


def sharded_forward(scene_s: ShardedScene, grid_s: ShardedGrid, config,
                    mesh: Mesh):
    """``pipeline.forward`` over the mesh (picaso_tpu/parallel.py:96-111):
    every wave shard runs the forward on its slice on its device,
    launched one after another from this thread with no host read between
    them, then the pieces are gathered onto the mesh's first device in
    wave order (the transit depth as ``_forward_row`` says).  Nothing else
    of the forward reduces across wavenumbers, so the result is bitwise
    the unsharded one.  The scene (not ``batched``) runs on batch row 0
    only: the other rows would repeat it."""
    _check_mesh('sharded_forward', mesh, scene_s, grid_s)
    if scene_s.batched:
        raise ValueError('sharded_forward takes one scene; a stacked batch '
                         'goes to sharded_forward_batch')
    outs, depth = _forward_row(scene_s.shards[0], grid_s.shards[0], config,
                               None)
    got = _gather([outs], mesh.first)
    if depth is not None:
        got['transit_depth'] = depth.to(mesh.first)
    return got


def sharded_forward_batch(scene_s: ShardedScene, grid_s: ShardedGrid,
                          config, mesh: Mesh):
    """``pipeline.forward_batch`` over the mesh: shard (b, w) runs its
    batch row's scenes on its wave slice; the outputs gather onto the
    first device, batch rows in order on the leading axis and wave slices
    on the last.  Bitwise the unsharded ``forward_batch``."""
    _check_mesh('sharded_forward_batch', mesh, scene_s, grid_s)
    if not scene_s.batched:
        raise ValueError('sharded_forward_batch takes a stacked batch '
                         '(shard_scene(..., batched=True))')
    rows = [_forward_row(srow, grow, config, srow[0].tlevel.shape[0])
            for srow, grow in zip(scene_s.shards, grid_s.shards)]
    got = _gather([outs for outs, _ in rows], mesh.first)
    if config.transmission:
        got['transit_depth'] = torch.cat([d.to(mesh.first)
                                          for _, d in rows], 0)
    return got


def sharded_loglike(loglike_vec, mesh: Mesh):
    """Wrap a vectorized log-likelihood so each batch of points shards over
    the mesh's 'batch' axis (picaso_tpu/parallel.py:133-155): a drop-in
    ``loglike_fn`` for ``sampler.nested_sample(vectorized=True)``.

    Calling convention (torch has no sharded arrays, so the shard is
    named): the wrapper pads the [n, ndim] batch to a multiple of the
    mesh's batch size by repeating its last row, cuts it into one block per
    batch row, and calls ``loglike_vec(x_b, b)`` once per row ``b`` with
    ``x_b`` a float64 tensor on ``mesh.devices[b, 0]``.  The callable
    evaluates its block on row ``b`` (``scene_s.row(b)``,
    ``grid_s.row(b)`` and ``mesh.row(b)`` for a wave-sharded forward there)
    and returns a [len(x_b)] tensor without reading it on the host.  Every
    row is launched before any result is read; the results are gathered
    on the first device in row order, and the first n come back as host
    numpy."""
    nb = int(mesh.shape['batch'])

    def wrapped(x):
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        npad = (-n) % nb
        xp = (np.concatenate([x, np.repeat(x[-1:], npad, 0)])
              if npad else x)
        outs = [loglike_vec(torch.as_tensor(block,
                                            device=mesh.devices[b, 0]), b)
                for b, block in enumerate(np.split(xp, nb))]
        out = torch.cat([o.reshape(-1).to(mesh.first) for o in outs])
        return out.cpu().numpy()[:n]

    return wrapped


# ---------------------------------------------------------------------------
# the climate
# ---------------------------------------------------------------------------

# ClimateData fields with a trailing CK-bin axis (picaso_tpu/parallel.py:
# 180-186); CKArrays' are wno, delta_wno, ln_kappa (axis 2 of
# [npress, ntemp, nwno, ngauss]) and cont_opa ([ncont, ntcia, nwno])
_CLIMATE_WAVE_FIELDS = ('F0PI', 'surf_reflect', 'sigma_ray', 'cld_opd',
                        'cld_g0', 'cld_w0')
_CK_WAVE_AXES = {'wno': 0, 'delta_wno': 0, 'ln_kappa': 2, 'cont_opa': 2}


class ShardedProps(NamedTuple):
    """RTProps cut over the mesh: ``rows[b][w]`` on ``devices[b, w]``."""
    rows: tuple


class ClimateShards(fused.WaveSums):
    """The wave shards of a climate problem and the two cross-shard
    reductions of a flux evaluation (picaso_tpu/parallel.py:114-131,
    158-205): ``data[b][w]`` (ClimateData with its CK-bin fields cut, the
    rest replicated) and ``ck[b][w]`` (CKArrays likewise) on
    ``mesh.devices[b, w]``.  As a ClimateData's ``wave`` it takes the
    steps of ``fused.WaveSums`` over the mesh (their whole-grid ``data``
    and ``ck`` arguments are not read: each shard has its own);
    everything else (the chemistry, the profile re-stitch, the Newton
    step, the line search, ``find_strat``) stays on the mesh's first
    device."""

    def __init__(self, mesh: Mesh, data, ck):
        self.mesh = mesh
        self.data = data
        self.ck = ck

    def row(self, b):
        """The shards of batch row ``b`` on its (1, n_wave) mesh."""
        return ClimateShards(self.mesh.row(b), (self.data[b],),
                             (self.ck[b],))

    def _reduce(self, parts):
        """Partial sums added on the first device, in shard order."""
        first = self.mesh.first
        acc = parts[0].to(first)
        for p in parts[1:]:
            acc = acc + p.to(first)
        return acc

    def opacities(self, chemistry, data, ck, config):
        """RTProps of every shard from the layer chemistry computed once on
        the first device (``fused.layer_chemistry``), copied to each wave
        shard's device; row 0 builds them, the other rows take copies."""
        first = [fused.opacities_from_chemistry(
            _moved(chemistry, self.mesh.devices[0, w]), self.data[0][w],
            self.ck[0][w], config) for w in range(len(self.data[0]))]
        return ShardedProps(_rows_of(first, self.mesh))

    def split_props(self, props):
        """Full RTProps on the first device cut over 'wave' (the host-
        assembled optics of the diseq and cloudy modes)."""
        nw = self.mesh.devices.shape[1]
        cuts = [_split(x, nw, x.dim() - 1, 'props over wave') for x in props]
        first = [type(props)(*(_put(c[w], self.mesh.devices[0, w])
                               for c in cuts)) for w in range(nw)]
        return ShardedProps(_rows_of(first, self.mesh))

    def thermal_fluxes(self, temp, props: ShardedProps, data, geom, ck):
        """``core.thermal_fluxes`` with the bin sums as partial sums per
        wave shard added on the first device.  A batch of profiles
        [P, nlevel] (the Jacobian's) is cut over the batch rows; one
        profile runs on row 0.  Every shard is launched before any
        reduction."""
        batched = temp.dim() == 2
        t = temp if batched else temp[None]
        blocks = torch.tensor_split(t, len(self.data) if batched else 1, 0)
        launched = []
        for b, block in enumerate(blocks):
            if block.shape[0] == 0:
                continue
            row = []
            for w, (d, ck) in enumerate(zip(self.data[b], self.ck[b])):
                dev = self.mesh.devices[b, w]
                fp, fm, fpm, fmm = thermal_level_fluxes(
                    block.to(dev), props.rows[b][w], d.plevel,
                    _moved(geom, dev), ck.wno, ck.delta_wno, ck.gauss_wts,
                    d.surf_reflect)
                row.append((((fp - fm) * ck.delta_wno).sum(-1),
                            ((fpm - fmm) * ck.delta_wno).sum(-1),
                            fp[0] * ck.delta_wno))
            launched.append(row)
        first = self.mesh.first
        fni = torch.cat([self._reduce([p[0] for p in r]) for r in launched],
                        1).T
        fnil = torch.cat([self._reduce([p[1] for p in r]) for r in launched],
                         1).T
        fpit = torch.cat([torch.cat([p[2].to(first) for p in r], -1)
                          for r in launched], 0)
        if not batched:
            return fni[0], fnil[0], fpit[0]
        return fni, fnil, fpit

    def visible_fluxes(self, props: ShardedProps, data, ck, controls):
        """``core.visible_fluxes`` on row 0, its bin sums added across the
        wave shards on the first device."""
        parts = [visible_fluxes(props.rows[0][w], d.plevel, d.F0PI,
                                ck.gauss_wts, d.surf_reflect, controls)
                 for w, (d, ck) in enumerate(zip(self.data[0], self.ck[0]))]
        return (self._reduce([p[0] for p in parts]),
                self._reduce([p[1] for p in parts]))


def shard_climate(temps, data, ck_arrays, mesh: Mesh):
    """Place a climate problem on the mesh (picaso_tpu/parallel.py:
    158-205).  Returns (temps, data, ck_arrays):

    * ``temps`` [n, nlevel] cut over 'batch': a list of one [n / n_batch,
      nlevel] block per batch row on the row's first device (None stays
      None; :func:`sharded_profile_step` runs them);
    * ``data`` the ClimateData on the first device with ``wave`` set to
      a :class:`ClimateShards`: its CK-bin fields and those of
      ``ck_arrays`` cut over 'wave', the rest replicated on every device;
    * ``ck_arrays`` on the first device, whole (the fused path reads only
      its shards; the host-assembled optics are built from the whole table
      and then cut).
    """
    nb, nw = mesh.devices.shape
    first = mesh.first
    if temps is not None:
        temps = [_put(t, mesh.devices[b, 0]) for b, t in enumerate(
            _split(torch.as_tensor(temps), nb, 0, 'shard_climate temps '
                   'over batch'))]
    base = data._replace(wave=fused.ONE_DEVICE)
    d_cut = {f: _split(getattr(base, f), nw, getattr(base, f).dim() - 1,
                       f'shard_climate {f} over wave')
             for f in _CLIMATE_WAVE_FIELDS if getattr(base, f) is not None}
    c_cut = {f: _split(getattr(ck_arrays, f), nw, axis,
                       f'shard_climate ck {f} over wave')
             for f, axis in _CK_WAVE_AXES.items()}
    d_first, c_first = [], []
    for w in range(nw):
        dev = mesh.devices[0, w]
        d_first.append(_moved(base, dev)._replace(
            **{f: _put(c[w], dev) for f, c in d_cut.items()}))
        c_first.append(_moved(ck_arrays, dev)._replace(
            **{f: _put(c[w], dev) for f, c in c_cut.items()}))
    shards = ClimateShards(mesh, _rows_of(d_first, mesh),
                           _rows_of(c_first, mesh))
    return (temps, _moved(base, first)._replace(wave=shards),
            _moved(ck_arrays, first))


def shard_climate_state(state, mesh: Mesh):
    """Shard a ``climate.api._ClimateState`` in place so the whole climate
    solve (``run_climate``: every profile pass and ``find_strat``) runs
    over the mesh (picaso_tpu/parallel.py:114-131): ``state.data``'s
    ``wave`` becomes its :class:`ClimateShards`.  The state's CK table is
    left as it is (the host-assembled optics read it whole, then cut), so
    the caller's opacity connection keeps its arrays, as the JAX package's
    shallow copy ensures there.  The state must live on the mesh's first device."""
    if state.data.plevel.device != mesh.first:
        raise ValueError(f'shard_climate_state: the state is on '
                         f'{state.data.plevel.device}, the mesh starts at '
                         f'{mesh.first}')
    _, state.data, _ = shard_climate(None, state.data, state.ck.arrays, mesh)
    return state


def sharded_profile_step(temps, zones, data, chem, ck, geom, adiabat,
                         config, counts=None):
    """``fused.profile_step`` for every profile of ``shard_climate``'s
    ``temps`` blocks: batch row ``b`` steps its profiles on its own
    (1, n_wave) row of the mesh (its wave shards; replicated state moved
    to the row's first device).  Returns profile_step's outputs stacked
    over the profiles on the mesh's first device, ``converged`` as a list
    of bools."""
    shards = data.wave
    first = shards.mesh.first
    outs = []
    for b, block in enumerate(temps):
        dev = shards.mesh.devices[b, 0]
        row = shards.row(b)
        d_b = _moved(data._replace(wave=fused.ONE_DEVICE),
                     dev)._replace(wave=row)
        args = [_moved(x, dev) for x in (chem, ck, geom, adiabat)]
        for t in block:
            outs.append(fused.profile_step(
                t, zones, d_b, args[0], args[1], args[2], args[3], config,
                counts))
    t, conv, dtdp, fnil, fnvl, fpit = zip(*outs)
    return (torch.stack([x.to(first) for x in t]), [bool(c) for c in conv],
            *(torch.stack([x.to(first) for x in part])
              for part in (dtdp, fnil, fnvl, fpit)))
