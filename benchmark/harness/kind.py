"""A request kind: how a traffic mix's requests are made of the pool's
atmospheres, run by the program and worked out again by the reference.
A kind is a file ``requests/<kind>.py`` whose class ``Requests``
subclasses :class:`Kind`; a traffic file names it as ``request.kind``
(``disk`` where it names none).

A request is one call of the program; it gives one or more spectra, and
each spectrum is made of one or more scenes, each a pool atmosphere at
one of the mix's geometries.  ``spectra[gi]`` lists request ``gi``'s
spectra, each as its scenes ``[(atmosphere, geometry)]`` in the order
the program runs them; the per-layer readers count these (a scene is one
gather and one RT solve) and resolve a geometry index by ``geom_args``.

The plan (``geom_args``, ``spectra``) is made from the mix alone; the
program's state comes with :meth:`Kind.setup` and goes with
:meth:`Kind.release`, before the reference runs."""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

from ..reference import spectrum as ref

Scene = Tuple[int, int]          # (pool atmosphere, geometry index)


class Kind:
    """What every kind shares: the mix's geometries, the pool's scenes
    made once at the first geometry, a request's scenes stacked into one
    ``forward_batch``, and the reference's spectrum of one scene."""

    def __init__(self, cfg, traffic, pool):
        self.cfg, self.traffic, self.pool = cfg, traffic, pool
        self.req = traffic['request']
        self.geom_args = [(float(ph), *self.req['disk'])
                          for ph in self.req['phases_deg']]
        self.spectra: List[List[List[Scene]]] = self.plan()
        self.port = None

    def plan(self) -> List[List[List[Scene]]]:
        """Per request, per spectrum, its scenes."""
        raise NotImplementedError

    def scenes(self, gi) -> List[Scene]:
        """Request ``gi``'s scenes, flattened in the order run."""
        return [sc for spectrum in self.spectra[gi] for sc in spectrum]

    # the program's side

    def setup(self, port):
        """The program's scene of every pool atmosphere at the first
        geometry, and each request's batch where ``request.stack`` is
        ``setup``."""
        self.port = port
        self.geoms = [port.geometry(*g) for g in self.geom_args]
        # the cloud's g0 and w0 [nlayer, nwno] live as long as the
        # program's state, as every scene shares them
        self._cloud = port.cloud_constants(self.cfg['levels'] - 1,
                                           self.traffic['cloud']['g0'],
                                           self.traffic['cloud']['w0'])
        self._scenes = [port.scene(a, self.geoms[0], *self._cloud)
                        for a in self.pool]
        self._stacks = None
        if self.req['stack'] == 'setup':
            self._stacks = [self._stack(gi)
                            for gi in range(len(self.spectra))]
            self._scenes = None
            gc.collect()

    def _stack(self, gi):
        scenes = self.scenes(gi)
        if len(self.geoms) == 1:
            return self.port.stack([self._scenes[a] for a, _ in scenes])
        return self.port.stack([
            self.port.with_geometry(self._scenes[a], self.geoms[p])
            for a, p in scenes])

    def batch(self, gi):
        """What the program takes for request ``gi`` (all that
        :meth:`forward` is given of it)."""
        if self._stacks is not None:
            return self._stacks[gi]
        return self._stack(gi)

    def forward(self, batch) -> Dict[str, object]:
        """The program's spectra of a request's ``batch``: {output:
        [spectra, nwno]} on the device.  Here one scene is one spectrum."""
        return self.port.forward_batch(batch)

    def release(self):
        """Drop the program's state."""
        self.port = self.geoms = self._cloud = None
        self._scenes = self._stacks = None

    # the reference's side

    def scene_reference(self, scene, table, planet, opts, outputs, device,
                        precision):
        """The reference's spectra {output: [nwno]} of one scene."""
        a, p = scene
        return ref.spectrum(table, self.pool[a], planet,
                            ref.geometry(*self.geom_args[p]), opts,
                            outputs=outputs, device=device,
                            precision=precision)

    def reference(self, scenes, table, planet, opts, outputs, device,
                  precision='f64'):
        """The reference's spectrum {output: [nwno]} of the spectrum made
        of ``scenes``, in ``precision``."""
        raise NotImplementedError
