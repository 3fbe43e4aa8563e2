"""The system under test: picaso_tpu_torch, driven through its public
entry points (``pipeline.scene_from_arrays``, ``stack_scenes``,
``with_geometry``, ``forward_batch`` and ``disco.make_geometry``).  The
harness hands it the raw inputs and takes back its spectra; nothing here
is read by the reference."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _modules():
    from picaso_tpu_torch import disco, pipeline
    from picaso_tpu_torch.opacities import db
    from picaso_tpu_torch.rt import toon
    return pipeline, disco, db, toon


class Port:
    """One cell's grid, scenes and config in the port's types; with
    ``int16`` the grid carries the program's int16 table, which its
    gather (K8) then reads: a traffic's ``program_table`` ``int16``, or
    ``readings.py``'s control on a float cell."""

    def __init__(self, table, planet, cfg, outputs, device, int16=False):
        pipeline, disco, db, toon = _modules()
        self.pipeline, self.disco = pipeline, disco
        self.device = torch.device(device)
        self.planet = planet
        self.outputs = tuple(outputs)
        dev = self.device
        # the ragged grid's axes in the port's layout (PTGrid): ascending
        # temperatures, each one's first flat row and pressure count, the
        # log10 pressures of the longest row
        temps, t_offset, nc_p = np.unique(table.temps_flat,
                                          return_index=True,
                                          return_counts=True)
        imax = int(np.argmax(nc_p))
        p_row = table.press_flat[t_offset[imax]:t_offset[imax] + nc_p[imax]]
        self.dtype = (torch.float64 if dev.type == 'cpu'
                      else torch.float32)

        def t(x, dt=self.dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
        pt = db.PTGrid(t_inv_grid=t(1.0 / temps),
                       p_log_grid=t(np.log10(p_row)),
                       nc_p=t(nc_p, torch.int32),
                       t_offset=t(t_offset, torch.int32))
        self.grid = db.OpacityGrid(
            wno=t(table.wno), log_kappa=table.log_kappa, pt=pt,
            cont_opa=t(table.cia), cia_temps=t(table.cia_temps),
            molecules=tuple(table.molecules),
            continuum_molecules=tuple(table.continuum))
        if int16:
            # the program's own 16-bit table path (K8)
            self.grid = self.grid.with_blocked_table(quantize=True)
        rt = cfg['rt']
        self.rt = dict(
            rt_method=1 if rt['method'] == 'sh' else 0,
            stream=rt['stream'], delta_eddington=rt['delta_eddington'],
            raman=2, controls=toon.ScatteringControls(**rt['controls']),
            **{f'sh_{k}': v for k, v in rt.get('sh', {}).items()},
            reflected='albedo' in outputs, thermal='thermal' in outputs,
            transmission='transit_depth' in outputs)
        self.config = None

    def geometry(self, phase_deg, num_gangle, num_tangle):
        return self.disco.make_geometry(math.radians(phase_deg), num_gangle,
                                        num_tangle)

    def scene(self, atm, geom, g0, w0):
        """The port's scene of one atmosphere; its cloud deck, made by the
        harness on the device, is put in place of the scene's zeros."""
        nlevel = len(atm.pressure_bar)
        mix = {m: np.zeros(nlevel) + v for m, v in atm.mix}
        transit = 'transit_depth' in self.outputs
        scene, config = self.pipeline.scene_from_arrays(
            atm.pressure_bar, atm.temperature, mix, self.grid,
            gravity=self.planet.gravity, radius=self.planet.radius,
            mass=self.planet.mass, p_reference=self.planet.p_reference,
            rstar=self.planet.rstar if transit else np.nan, geom=geom,
            dtype=self.dtype, device=self.device)
        nwno = self.grid.wno.shape[0]
        opd = torch.as_tensor(atm.cloud_opd, dtype=self.dtype,
                              device=self.device)[:, None].expand(
                                  -1, nwno).contiguous()
        if self.config is None:
            self.config = dataclasses.replace(config, **self.rt)
        return scene._replace(cld_opd=opd, cld_g0=g0, cld_w0=w0)

    def cloud_constants(self, nlayer, g0, w0):
        nwno = self.grid.wno.shape[0]
        return (torch.full((nlayer, nwno), g0, dtype=self.dtype,
                           device=self.device),
                torch.full((nlayer, nwno), w0, dtype=self.dtype,
                           device=self.device))

    def stack(self, scenes):
        return self.pipeline.stack_scenes(scenes)

    def with_geometry(self, scene, geom):
        return self.pipeline.with_geometry(scene, geom)

    def forward_batch(self, stacked):
        return self.pipeline.forward_batch(stacked, self.grid, self.config)
