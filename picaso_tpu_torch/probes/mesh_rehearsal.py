"""``chip_smoke.py``'s phases 50-54 (the device mesh and photochemistry)
alone, on one CUDA device, in a few minutes instead of the whole script's
run.

The unsharded results those phases hold the sharded runs against are made
first, as the script makes them: phase 6's and phase 19's forwards at the
production shape, phase 24's climate solve (196 bins, 91 levels, f64) and
phase 34's diseq T dwarf (``diseq_t900_91``).  Then ``chip_smoke.
mesh_phases`` runs with every kernel wrapper counted, as in the script.
From the root of a checkout:

    python3 picaso_tpu_torch/probes/mesh_rehearsal.py

It prints the script's lines for those phases, then one JSON line with
the phases' summary (the script's ``{"mesh": ...}`` line) and the wall
seconds of the references and of phases 50-54; a failed gate raises.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('mesh_rehearsal: no CUDA device')
    import chip_smoke as cs
    from picaso_tpu_torch import _build, pipeline
    from picaso_tpu_torch import justdoit as jdi
    from picaso_tpu_torch.opacities.ck import synthetic_ck_table
    from picaso_tpu_torch.probes.climate_jacobian import modes_case

    card = cs.subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(card)
    dev = torch.device('cuda')
    wrappers = _build.kernel_wrappers()

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    t_ref = time.perf_counter()
    _build.library()
    scene, grid, config = pipeline.build_problem(
        cs.NWNO, nlevel=cs.NLEVEL, production=True, device=dev)
    g16 = grid.with_blocked_table(quantize=True)
    s0 = cs.perturbed(scene, 1)[0]
    cs.REUSED['toon'] = (s0, pipeline.forward(s0, grid, config))
    cs.REUSED['int16'] = (s0, pipeline.forward(s0, g16, config))
    ck = synthetic_ck_table(device=dev)
    out, numbers = cs.climate_run(
        '[24] 196 bins, 91 levels, defaults (f64)',
        cs.climate_inputs(cs.CLIMATE_NLEVEL), ck, None, dev, reset_counts,
        counts)
    cs.REUSED['climate'] = dict(temperature=out['temperature'],
                                numbers=numbers, ck=ck)
    with open(os.path.join(ROOT, cs.CLIMATE_MODES_REFERENCE)) as f:
        spec = json.load(f)[cs.PHOTOCHEM_BASE]['case']
    d_ck = synthetic_ck_table(grid661=(spec['table'] == 661),
                              device=torch.device('cpu'), with_per_gas=True)
    if spec['slice']:
        d_ck = d_ck.take_bins(slice(None, spec['slice'][1],
                                    spec['slice'][0]))
    opa = jdi.opannection(ck_table=d_ck, device=dev)
    out = modes_case(jdi, spec).climate(
        opa, diseq_chem=spec['diseq_chem'], with_spec=spec['with_spec'],
        verbose=False, save_all_profiles=True)
    cs.REUSED['diseq'] = dict(temperature=out['temperature'], opa=opa)
    ref_s = time.perf_counter() - t_ref
    cs.log(f'references in {ref_s:.1f} s')
    summary = cs.mesh_phases(dev, grid, g16, config, reset_counts, counts,
                             card)
    print(json.dumps({'mesh': summary, 'references_s': ref_s}), flush=True)


if __name__ == '__main__':
    main()
