"""The ``disk`` kind (a traffic file that names no ``request.kind``):
each spectrum is one pool atmosphere at one geometry, the program's
disk integration of that one scene.  A request takes
``request.atmospheres`` consecutive pool atmospheres, each at every
phase of ``request.phases_deg``, atmosphere by atmosphere."""

from benchmark.harness.kind import Kind


class Requests(Kind):

    def plan(self):
        per = self.req['atmospheres']
        phases = range(len(self.geom_args))
        return [[[(a, p)] for a in range(i, i + per) for p in phases]
                for i in range(0, len(self.pool), per)]

    def reference(self, scenes, table, planet, opts, outputs, device,
                  precision='f64'):
        (scene,) = scenes
        return self.scene_reference(scene, table, planet, opts, outputs,
                                    device, precision)
