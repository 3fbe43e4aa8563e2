"""The JAX package's float64 results for the host tools: the records
chip_smoke.py holds the port's card runs against (phases 45, 47-49).

Recorded, on the CPU, with the inputs the port's generators write (the
same bytes on every machine):

- ``ingest``: a raw source tree from
  ``picaso_tpu_torch.opacities.ingest.synthetic_raw_tree`` (the 1460
  (T, P) points, ``NWAVE`` wavenumbers per point) ingested by the JAX
  package's ``ingest_molecular_1460`` (H2O from .npy files, CH4 from
  fortran binaries), ``ingest_cia_grid`` (the EGP grid, the overtone band,
  the Linsky fill, H2-, H- bound-free and free-free) and
  ``ingest_hitran_cia`` (N2N2), then ``ingest.table_digests`` of the DB:
  per table the SHA-256 of its float64 bytes, shape, sum, min, max and 16
  sampled values;
- ``build_3d``: ``regrid_xarray``, ``regrid_to_gauss_cheby``,
  ``rebin_mitgcm_pt`` and ``rebin_mitgcm_cld`` onto the 10 x 10
  Gauss-Chebyshev facets of ``build_3d_input.synthetic_gcm()`` (128 lon x
  64 lat x 53 levels) and of the MITgcm-layout files
  ``write_mitgcm_pt`` / ``write_mitgcm_cld`` write: the same record of
  each array (``ingest.array_digest``);
- ``model_compare``: ``dlugach_test`` and ``madhu_test`` in full and
  ``thermal_sh_test`` over its whole w0 x g0 grid, Toon, in float64: every
  cell;
- ``examples``: the JAX package's ``examples/retrieval_nested.py`` run as
  a script (its own float32): its exit code and the posterior line it
  prints.  Its assert on that posterior fails (T median 1411 K against
  the truth's 1150 +- 250), so the port's copy is held to the same line
  instead of to exit 0.

It takes about two minutes (most of it the model_compare sweeps, the
example and writing the raw tree, ~0.5 GB under a temporary directory).
Not a test.

    python tests/host_tools_record.py --save tests/host_tools_reference.json
    python tests/host_tools_record.py --parts ingest
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

PARTS = ('ingest', 'build_3d', 'model_compare', 'examples')
# JAX examples whose own asserts fail: the port's copies are held to the
# line each prints (EXAMPLE_LINES) instead of to exit 0
EXAMPLE_LINES = {'retrieval_nested.py': 'posterior medians'}
NWAVE = 20_000
INGEST = dict(min_wavelength=0.8, max_wavelength=5.0, new_R=2e3, old_R=2e4)
GAUSS_CHEBY = dict(num_gangle=10, num_tangle=10)


def ingest_db(ingest, root, db):
    """The ingestion chip_smoke.py's phase 45 runs, through ``ingest`` (the
    JAX module or the port's): returns the header's wavenumber grid."""
    for mol in ('H2O', 'CH4'):
        ingest.ingest_molecular_1460(
            mol, INGEST['min_wavelength'], INGEST['max_wavelength'], root,
            db, new_R=INGEST['new_R'], old_R=INGEST['old_R'])
    cur, conn = ingest.connect(db)
    cur.execute('SELECT wavenumber_grid FROM header')
    wno = cur.fetchone()[0]
    conn.close()
    from picaso_tpu_torch.opacities.ingest import RAW_CIA_COLUMNS
    ingest.ingest_cia_grid(os.path.join(root, 'master_cia.dat'),
                           list(RAW_CIA_COLUMNS), wno, db)
    ingest.ingest_hitran_cia(os.path.join(root, 'N2-N2_2018.cia'), 'N2N2',
                             db, wno)
    ingest.add_metadata(db, version='synthetic', resolution=INGEST['new_R'],
                        wavemin=INGEST['min_wavelength'],
                        wavemax=INGEST['max_wavelength'])
    return wno


def record_ingest(tmp):
    from picaso_tpu.opacities import ingest
    from picaso_tpu_torch.opacities.ingest import (synthetic_raw_tree,
                                                   table_digests)
    root = synthetic_raw_tree(os.path.join(tmp, 'raw'), nwave=NWAVE)
    db = os.path.join(tmp, 'ingested.db')
    t0 = time.perf_counter()
    ingest_db(ingest, root, db)
    return dict(nwave=NWAVE, params=INGEST, seconds=time.perf_counter() - t0,
                metadata=[[k, v] for k, v in ingest.get_metadata(db)],
                tables=table_digests(db))


def jax_dataset(ds):
    from picaso_tpu.ncio import NCDataset, NCVar
    return NCDataset(
        data_vars={k: NCVar(*v) for k, v in ds.data_vars.items()},
        coords={k: NCVar(*v) for k, v in ds.coords.items()},
        attrs=dict(ds.attrs), dims=dict(ds.dims))


def record_build_3d(tmp):
    from picaso_tpu import build_3d_input as b3d
    from picaso_tpu_torch import build_3d_input as port
    from picaso_tpu_torch.opacities.ingest import array_digest as stats
    ds = port.synthetic_gcm()
    pt_file = port.write_mitgcm_pt(os.path.join(tmp, 'pt.txt'), ds)
    cld_file = port.write_mitgcm_cld(os.path.join(tmp, 'cld.txt'))
    out = {}
    reg = b3d.regrid_xarray(jax_dataset(ds), phase_angle=0.0,
                            **GAUSS_CHEBY)
    out.update({f'regrid_xarray {k}': stats(v) for k, v in reg.items()})
    _, cube = b3d.regrid_to_gauss_cheby(
        ds.coords['lat'].values, ds.coords['lon'].values,
        ds.data_vars['temperature'].values, phase=0.0, **GAUSS_CHEBY)
    out['regrid_to_gauss_cheby temperature'] = stats(cube)
    pt = b3d.rebin_mitgcm_pt(pt_file, phase=0.0, **GAUSS_CHEBY)
    out.update({f'rebin_mitgcm_pt {k}': stats(v) for k, v in pt.items()})
    cld = b3d.rebin_mitgcm_cld(cld_file, phase=0.0, **GAUSS_CHEBY)
    out.update({f'rebin_mitgcm_cld {k}': stats(v) for k, v in cld.items()})
    return out


def record_model_compare():
    from picaso_tpu import model_compare as mc
    t0 = time.perf_counter()
    real, dlugach = mc.dlugach_test()
    madhu = mc.madhu_test()
    thermal = mc.thermal_sh_test()

    def table(df, index):
        return {index: [str(i) for i in df.index],
                **{str(c): [float(x) for x in df[c]] for c in df.columns}}
    return dict(
        dlugach=table(dlugach, 'asy'),
        dlugach_table=table(real, 'asy'),
        madhu={str(c): [float(x) for x in madhu[c]] for c in madhu.columns},
        thermal=table(thermal, 'asy'),
        seconds=time.perf_counter() - t0)


def record_examples():
    import subprocess
    out = {}
    for name, prefix in EXAMPLE_LINES.items():
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, 'examples', name)],
            capture_output=True, text=True, cwd=ROOT,
            env=dict(os.environ, JAX_PLATFORMS='cpu'))
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith(prefix))
        out[name] = dict(returncode=proc.returncode,
                         line=line.split('  (')[0])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--save', help='write the JSON here')
    ap.add_argument('--parts', default=','.join(PARTS))
    args = ap.parse_args()
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)

    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        for part in args.parts.split(','):
            t0 = time.perf_counter()
            if part == 'ingest':
                record[part] = record_ingest(tmp)
            elif part == 'build_3d':
                record[part] = record_build_3d(tmp)
            elif part == 'model_compare':
                record[part] = record_model_compare()
            elif part == 'examples':
                record[part] = record_examples()
            else:
                raise SystemExit(f'unknown part {part!r}')
            print(f'{part}: {time.perf_counter() - t0:.1f} s', flush=True)
    text = json.dumps(record, indent=1, sort_keys=True)
    if args.save:
        old = {}
        if os.path.exists(args.save):
            with open(args.save) as f:
                old = json.load(f)
        old.update(record)
        with open(args.save, 'w') as f:
            f.write(json.dumps(old, indent=1, sort_keys=True) + '\n')
    else:
        print(text)


if __name__ == '__main__':
    main()
