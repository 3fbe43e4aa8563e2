"""picaso_tpu_torch.opacities.ingest against picaso_tpu.opacities.ingest.

The same raw source trees (the synthetic tree of tests/test_ingest.py,
one tree per source format, a 1060-grid fortran tree, Karkoschka tables)
are ingested by both packages into sqlite databases, and the tables are
compared: bitwise where the inputs are binary and the arithmetic is
``np.interp``, clamps and strides; at rtol 1e-12 where ``10**``, ``log``
or ``exp`` enter, or where the inputs are decimal text (pandas' C parser
rounds some decimal strings one ulp away from the nearest double; the
port parses with Python's ``float``, which rounds to the nearest).  Then the
port's database goes through the port's ``load_opacity_db`` and a CPU
float64 spectrum against the JAX database and spectrum (the front-door
tolerance of tests/torch_facade_cases.py).
"""

import os
import sqlite3

import h5py
import numpy as np
import pytest

from picaso_tpu import justdoit as jdi
from picaso_tpu import raman as jraman
from picaso_tpu.opacities import db as jdb
from picaso_tpu.opacities import ingest as jing

from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch.opacities import ingest as ting

from torch_facade_cases import RTOL

CIA_COLS = ['wno', 'H2H2', 'H2He', 'H2H', 'H2CH4', 'H2N2']
RTOL_TRANSCENDENTAL = 1e-12
FORMATS = ('python', 'fortran_binary', 'h5', 'lupu_txt', 'rfree_fort',
           'alkali_csv')
TEXT_FORMATS = ('lupu_txt', 'rfree_fort', 'alkali_csv')


def cross_sections(rng, og_wno, temps):
    """Lorentzian bands on a 1e-30 floor, one row per (T, P) point."""
    rows = []
    for t in temps:
        c = rng.uniform(og_wno.min(), og_wno.max(), 6)
        s = 10 ** rng.uniform(-24, -21, 6)
        rows.append(1e-30 + sum(a / (1 + ((og_wno - cc) / 300.0) ** 2)
                                for a, cc in zip(s, c)) * (t / 1000.0))
    return np.array(rows)


def write_raw_tree(root):
    """tests/test_ingest.py's raw source tree (its lines 32-95): an
    EGP-format CIA grid with a gap for the Linsky fill, a HITRAN CIA file,
    and grid1460.csv with H2O and CH4 in hdf5."""
    rng = np.random.default_rng(42)
    old_wno = np.arange(20.0, 15000.0, 40.0)
    temps = [200.0, 500.0, 1000.0, 1500.0]
    lines = [f'{len(old_wno)} {len(temps)}']
    for t in temps:
        lines.append(f'{t}')
        for w in old_wno:
            vals = [-7 - 3 * np.exp(-((w - c) / 2000.0) ** 2)
                    + 0.2 * np.log10(t / 500.0)
                    for c in (2000.0, 5000.0, 8000.0, 11000.0, 14000.0)]
            if w > 9000:
                vals[0] = -33.0
            lines.append('  '.join([f'{w:.1f}'] +
                                   [f'{v:.4f}' for v in vals]))
    (root / 'master_cia.dat').write_text('\n'.join(lines) + '\n')

    hitran_lines = []
    for t in (100.0, 200.0, 300.0):
        wno_h = np.arange(500.0, 3000.0, 25.0)
        cx = 1e-46 * np.exp(-((wno_h - 1500.0) / 600.0) ** 2) \
            * (t / 200.0) ** 0.7
        hitran_lines.append('N2-N2'.ljust(20)
                            + f'{wno_h.min():10.3f}{wno_h.max():10.3f}'
                            + f'{len(wno_h):7d}' + f'{t:7.1f}'
                            + '   ref note')
        hitran_lines += [f' {w:12.4f} {c:12.4e}'
                         for w, c in zip(wno_h, cx)]
    (root / 'N2-N2_2018.cia').write_text('\n'.join(hitran_lines) + '\n')

    write_grid(root, 'grid1460.csv')
    temps_m, _, og_wno = grid_points()
    for mol in ('H2O', 'CH4'):
        with h5py.File(root / f'{mol}.h5', 'w') as f:
            f.create_dataset('cxs', data=cross_sections(rng, og_wno, temps_m))
    return str(root)


def grid_points(numw=5000, delwn=4.0, start=300.0):
    temps = np.repeat([300.0, 700.0, 1200.0, 2000.0], 2)
    pres = np.tile([0.1, 10.0], 4)
    return temps, pres, np.arange(numw) * delwn + start


def write_grid(root, name, numw=5000, delwn=4.0, start=300.0):
    temps, pres, _ = grid_points(numw, delwn, start)
    rows = ['file_number,temperature_K,pressure_bar,number_wave_pts,'
            'delta_wavenumber,start_wavenumber']
    rows += [f'{i + 1},{t},{p},{numw},{delwn},{start}'
             for i, (t, p) in enumerate(zip(temps, pres))]
    (root / name).write_text('\n'.join(rows) + '\n')


def write_format_tree(root, fmt, mol):
    """One molecule's cross sections in source format ``fmt``, on the
    8-point grid of ``write_grid``."""
    rng = np.random.default_rng(7)
    write_grid(root, 'grid1460.csv')
    temps, pres, og_wno = grid_points()
    cxs = cross_sections(rng, og_wno, temps)
    mol_dir = root / ('alkalis' if fmt == 'alkali_csv' else mol)
    if fmt == 'h5':
        with h5py.File(root / f'{mol}.h5', 'w') as f:
            f.create_dataset('cxs', data=cxs)
        return
    mol_dir.mkdir()
    if fmt == 'lupu_txt':
        (mol_dir / 'wavelengths.txt').write_text(
            'wavelength\n'
            + '\n'.join(f'{float(w)!r}' for w in 1e4 / og_wno) + '\n')
    for i, (t, p) in enumerate(zip(temps, pres), start=1):
        cx = cxs[i - 1]
        if fmt == 'python':
            np.save(mol_dir / f'{i}.npy', cx)
        elif fmt == 'fortran_binary':
            cx.tofile(mol_dir / f'p_{i}')
        elif fmt == 'lupu_txt':
            name = f'{mol}_{p * 1e3:.2e}mbar_{t:.0f}K.txt'
            (mol_dir / name).write_text(
                'header one\nheader two\n'
                + '\n'.join(f'{float(c)!r},0' for c in cx) + '\n')
        elif fmt == 'rfree_fort':
            head = ''.join(f'comment {k}\n' for k in range(27))
            (mol_dir / f'fort.{i}').write_text(head + '\n'.join(
                f'  {float(w)!r}   {float(c)!r}'
                for w, c in zip(og_wno, cx)) + '\n')
        elif fmt == 'alkali_csv':
            (mol_dir / f'p_{i}').write_text(f'wno,{mol}\n' + '\n'.join(
                f'{float(w)!r},{float(c)!r}'
                for w, c in zip(og_wno, cx)) + '\n')


def rows(db, table, mol=None):
    conn = sqlite3.connect(db)
    from picaso_tpu_torch.opacities.db import _convert_array
    if table == 'molecular':
        cur = conn.execute('SELECT ptid, temperature, pressure, opacity '
                           'FROM molecular WHERE molecule=? ORDER BY ptid',
                           (mol,))
    else:
        cur = conn.execute('SELECT molecule, temperature, opacity FROM '
                           'continuum ORDER BY molecule, temperature')
    out = [r[:-1] + (_convert_array(r[-1]),) for r in cur.fetchall()]
    conn.close()
    return out


def header(db):
    cur, conn = ting.connect(db)
    cur.execute('SELECT * FROM header')
    out = cur.fetchall()
    conn.close()
    return out


def assert_tables_equal(got, want, rtol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]
        if rtol:
            np.testing.assert_allclose(g[-1], w[-1], rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(g[-1], w[-1])


@pytest.fixture(scope='module')
def raw_dir(tmp_path_factory):
    return write_raw_tree(tmp_path_factory.mktemp('rawsrc'))


@pytest.fixture(scope='module')
def ingested(raw_dir, tmp_path_factory):
    """The raw tree ingested by each package: {'jax': db, 'port': db}."""
    out = {}
    for name, mod in (('jax', jing), ('port', ting)):
        db = str(tmp_path_factory.mktemp(name) / 'full.db')
        for mol in ('H2O', 'CH4'):
            mod.ingest_molecular_1460(mol, 0.7, 20.0, raw_dir, db,
                                      new_R=1e4)
        wno = header(db)[0][3]
        mod.ingest_cia_grid(os.path.join(raw_dir, 'master_cia.dat'),
                            CIA_COLS, wno, db)
        mod.ingest_hitran_cia(os.path.join(raw_dir, 'N2-N2_2018.cia'),
                              'N2N2', db, wno)
        mod.add_metadata(db, version='4.0-syn', resolution='1e4',
                         wavemin='0.7', wavemax='20',
                         zenodo_doi='10.5281/zenodo.synthetic')
        out[name] = db
    return out


def test_continuum_matches_jax(ingested):
    """ingest_cia_grid (the overtone band, Linsky fill and median filter,
    H2-, H-bf, H-ff) and ingest_hitran_cia: rtol 1e-12 (10**, log)."""
    got = rows(ingested['port'], 'continuum')
    want = rows(ingested['jax'], 'continuum')
    assert_tables_equal(got, want, rtol=RTOL_TRANSCENDENTAL)
    assert {m for m, _, _ in got} == set(CIA_COLS[1:]) | {
        'H2-', 'H-bf', 'H-ff', 'N2N2'}


def test_molecular_and_header_match_jax(ingested):
    """ingest_molecular_1460 from hdf5, and the header: bitwise."""
    for mol in ('H2O', 'CH4'):
        assert_tables_equal(rows(ingested['port'], 'molecular', mol),
                            rows(ingested['jax'], 'molecular', mol))
    (hp,), (hj,) = header(ingested['port']), header(ingested['jax'])
    assert hp[:3] + hp[4:] == hj[:3] + hj[4:]
    np.testing.assert_array_equal(hp[3], hj[3])


def test_metadata_and_db_tools_match_jax(ingested, tmp_path):
    """get_metadata, molecular_avail, continuum_avail, delete_molecule,
    build_skeleton and insert_wno_grid; each package reads the other's
    blobs."""
    port, jax_db = ingested['port'], ingested['jax']
    assert ting.get_metadata(port) == jing.get_metadata(jax_db)
    assert ting.molecular_avail(port) == jing.molecular_avail(jax_db)
    assert ting.continuum_avail(port) == jing.continuum_avail(jax_db)
    for mod, other in ((ting, jing), (jing, ting)):
        db = str(tmp_path / f'{mod.__name__}.db')
        mod.build_skeleton(db)
        mod.insert_wno_grid(db, np.linspace(1.0, 2.0, 7))
        mod.insert_wno_grid(db, np.linspace(5.0, 6.0, 3))    # no-op
        cur, conn = other.connect(db)
        cur.execute('SELECT wavenumber_grid FROM header')
        np.testing.assert_array_equal(cur.fetchone()[0],
                                      np.linspace(1.0, 2.0, 7))
        conn.close()
    for mod, db in ((ting, port), (jing, jax_db)):
        copy = str(tmp_path / f'del_{mod.__name__}.db')
        with sqlite3.connect(db) as src, sqlite3.connect(copy) as dst:
            src.backup(dst)
        assert mod.delete_molecule('CH4', copy) == 8
        assert mod.molecular_avail(copy) == ['H2O']


def test_ingested_db_spectrum_matches_jax(ingested):
    """The port's DB through the port's loader and a float64 thermal
    spectrum against the JAX DB through the JAX package."""
    grid = jdb.load_opacity_db(ingested['jax'], wave_range=[1, 10],
                               dtype=np.float64)
    jopa = jdi.Opacity(np.asarray(grid.wno), grid=grid,
                       raman_db=jraman.load_raman_db(
                           jdi.refdata_path('opacities', 'raman.txt')))
    topa = tdi.opannection(filename_db=ingested['port'], wave_range=[1, 10],
                           device='cpu')
    out = {}
    for name, mod, opa in (('jax', jdi, jopa), ('port', tdi, topa)):
        case = mod.inputs(calculation='browndwarf')
        case.phase_angle(0)
        case.gravity(gravity=200, gravity_unit=mod.u.Unit('m/(s**2)'))
        case.atmosphere(filename=mod.brown_dwarf_pt(), sep=r'\s+')
        out[name] = np.asarray(case.spectrum(opa,
                                             calculation='thermal')['thermal'])
    assert np.isfinite(out['port']).all() and (out['port'] > 0).all()
    np.testing.assert_allclose(out['port'], out['jax'], rtol=RTOL)


@pytest.mark.parametrize('fmt', FORMATS)
def test_molecular_formats_match_jax(fmt, tmp_path):
    """Each source format through ingest_molecular_1460 (new_R; and
    insert_direct for the python format): bitwise from binary files, rtol
    1e-12 from text."""
    mol = 'Na' if fmt == 'alkali_csv' else 'H2O'
    root = tmp_path / 'raw'
    root.mkdir()
    write_format_tree(root, fmt, mol)
    if fmt != 'alkali_csv':
        assert ting._detect_format(str(root / mol)) == fmt
    kws = [dict(new_R=1e4)]
    if fmt == 'python':
        kws.append(dict(insert_direct=True))
    for i, kw in enumerate(kws):
        dbs = {}
        for name, mod in (('jax', jing), ('port', ting)):
            dbs[name] = str(tmp_path / f'{name}{i}.db')
            grid = mod.ingest_molecular_1460(mol, 0.7, 20.0, str(root),
                                             dbs[name], **kw)
            dbs[name + '_grid'] = grid
        rtol = RTOL_TRANSCENDENTAL if fmt in TEXT_FORMATS else 0.0
        np.testing.assert_allclose(dbs['port_grid'], dbs['jax_grid'],
                                   rtol=rtol, atol=0)
        assert_tables_equal(rows(dbs['port'], 'molecular', mol),
                            rows(dbs['jax'], 'molecular', mol), rtol=rtol)


@pytest.fixture(scope='module')
def tree_1060(tmp_path_factory):
    """tests/test_ingest.py's 1060-format tree: fortran-binary p_N files
    on 6 (T, P) points and grid1060.csv."""
    root = tmp_path_factory.mktemp('raw1060')
    rng = np.random.default_rng(5)
    npt = 6
    temps = np.repeat([300.0, 900.0, 1800.0], 2)
    pres = np.tile([0.5, 50.0], 3)
    numw, delwn, start = 120000, 0.01, 4000.0
    rows_ = ['file_number,temperature_K,pressure_bar,number_wave_pts,'
             'delta_wavenumber,start_wavenumber']
    rows_ += [f'{i + 1},{t},{p},{numw},{delwn},{start}'
              for i, (t, p) in enumerate(zip(temps, pres))]
    (root / 'grid1060.csv').write_text('\n'.join(rows_) + '\n')
    og_wno = np.arange(numw) * delwn + start
    (root / 'CH4').mkdir()
    for i in range(1, npt + 1):
        c = rng.uniform(og_wno.min(), og_wno.max(), 5)
        cx = 1e-30 + sum(
            a / (1 + ((og_wno - cc) / 20.0) ** 2)
            for a, cc in zip(10 ** rng.uniform(-24, -22, 5), c))
        cx.astype(np.float64).tofile(root / 'CH4' / f'p_{i}')
    return str(root)


@pytest.mark.parametrize('variant', ['stride', 'median'])
def test_1060_ingest_matches_jax(tree_1060, tmp_path, variant):
    """ingest_molecular_1060 (new_R stride) and
    ingest_molecular_1060_median: bitwise."""
    dbs = {}
    for name, mod in (('jax', jing), ('port', ting)):
        db = str(tmp_path / f'{name}.db')
        if variant == 'stride':
            grid = mod.ingest_molecular_1060('CH4', 2.0, 2.3, 2000.0,
                                             tree_1060, db, old_R=2e5)
        else:
            grid = mod.ingest_molecular_1060_median('CH4', 2.0, 2.3, 2000.0,
                                                    tree_1060, db)
        dbs[name] = (db, grid)
    np.testing.assert_array_equal(dbs['port'][1], dbs['jax'][1])
    assert_tables_equal(rows(dbs['port'][0], 'molecular', 'CH4'),
                        rows(dbs['jax'][0], 'molecular', 'CH4'))


def test_analytic_continua_match_jax():
    """fit_linsky, h2minus_cx, hminus_bf, hminus_ff, h2h2_overtone:
    rtol 1e-12."""
    wno = np.linspace(300.0, 30000.0, 997)
    for t in (300.0, 700.0, 1000.0, 2500.0):
        for fn in ('fit_linsky', 'h2minus_cx', 'hminus_ff'):
            np.testing.assert_allclose(getattr(ting, fn)(t, wno),
                                       getattr(jing, fn)(t, wno),
                                       rtol=RTOL_TRANSCENDENTAL, atol=0)
        got, want = ting.h2h2_overtone(t, wno), jing.h2h2_overtone(t, wno)
        assert got[2] == want[2]
        if got[2]:
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0],
                                       rtol=RTOL_TRANSCENDENTAL)
    np.testing.assert_allclose(ting.hminus_bf(wno), jing.hminus_bf(wno),
                               rtol=RTOL_TRANSCENDENTAL, atol=0)


def test_optical_patches_match_jax(tmp_path):
    """kark_ch4 and optical_o3 on the bundled tables, and both patches
    through _ingest_molecular (CH4 below 500 K, O3): rtol 1e-12."""
    kark = ting.refdata_path('opacities', 'KarkCH4TempDependent.csv')
    o3 = ting.refdata_path('opacities', 'O3_visible.txt')
    wno = np.linspace(1e4 / 0.99, 1e4 / 0.4, 500)
    current = np.zeros(len(wno))
    for t in (100.0, 198.0, 296.0):
        (gv, gl), (wv, wl) = (ting.kark_ch4(kark, wno, t, current),
                              jing.kark_ch4(kark, wno, t, current))
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gv, wv, rtol=RTOL_TRANSCENDENTAL)
    np.testing.assert_allclose(ting.optical_o3(o3, wno),
                               jing.optical_o3(o3, wno),
                               rtol=RTOL_TRANSCENDENTAL, atol=0)

    root = tmp_path / 'raw'
    root.mkdir()
    write_format_tree(root, 'python', 'CH4')
    _, _, og_wno = grid_points()
    for f in (root / 'CH4').iterdir():     # no line-list data below 1 um
        cx = np.load(f)
        np.save(f, np.where(og_wno > 1e4, 0.0, cx))
    (root / 'O3').symlink_to(root / 'CH4')
    for mol, kw in (('CH4', dict(dir_kark_ch4=kark)),
                    ('O3', dict(dir_optical_o3=o3))):
        dbs = {}
        for name, mod in (('jax', jing), ('port', ting)):
            dbs[name] = str(tmp_path / f'{mol}_{name}.db')
            mod.ingest_molecular_1460(mol, 0.5, 20.0, str(root), dbs[name],
                                      new_R=1e4, **kw)
        assert_tables_equal(rows(dbs['port'], 'molecular', mol),
                            rows(dbs['jax'], 'molecular', mol),
                            rtol=RTOL_TRANSCENDENTAL)


@pytest.fixture(scope='module')
def kark_dir(tmp_path_factory):
    """tests/test_ingest.py's synthetic Karkoschka band-model tables."""
    root = tmp_path_factory.mktemp('kark')
    rng = np.random.default_rng(7)
    bases = np.arange(520.0, 600.0, 10.0)
    beers_rows = ['wavelength(nm) 0 2 4 6 8']
    four_rows = ['wavelength(nm) coef1 coef2 coef3 coef4']
    two_rows = ['wavelength(nm) coef1 coef2']
    for k, b in enumerate(bases):
        cells = []
        for j, c in enumerate((0.0, 2.0, 4.0, 6.0, 8.0)):
            iw = b + c
            kind = (k + j) % 3
            if kind == 0:
                cells.append(f'{rng.uniform(0.01, 2.0):.4f}')
            elif kind == 1:
                cells.append('=')
                four_rows.append(f'{iw:.1f} ' + ' '.join(
                    f'{v:.5f}' for v in rng.uniform(0.01, 1.0, 4)))
            else:
                cells.append('*')
                two_rows.append(f'{iw:.1f} ' + ' '.join(
                    f'{v:.5f}' for v in rng.uniform(0.01, 1.0, 2)))
        beers_rows.append(f'{b:.1f} ' + ' '.join(cells))
    (root / 'kark_beers.csv').write_text('\n'.join(beers_rows) + '\n')
    (root / 'kark_four_term.csv').write_text('\n'.join(four_rows) + '\n')
    (root / 'kark_two_term.csv').write_text('\n'.join(two_rows) + '\n')
    (root / 'kark_gauss_weights.csv').write_text(
        'number 1 2 3 4\n2 0.6 0.4 0 0\n4 0.35 0.3 0.2 0.15\n')
    return str(root)


def test_kark_ch4_noT_matches_jax(kark_dir):
    new_wno = np.linspace(1e4 / 0.61, 1e4 / 0.50, 400)
    got = ting.kark_ch4_noT(kark_dir, new_wno, 296.0)
    np.testing.assert_allclose(got, jing.kark_ch4_noT(kark_dir, new_wno),
                               rtol=RTOL_TRANSCENDENTAL)
    assert got.min() > 0


def test_synthetic_raw_tree_digests_match_jax(tmp_path):
    """chip_smoke.py's phase 45 at 200 wavenumbers per (T, P) point: the
    port's ingest and the JAX package's on the same synthetic tree give the
    same table_digests, bitwise for the molecular tables and the header,
    at rtol 1e-12 for the continuum."""
    import host_tools_record as rec
    root = ting.synthetic_raw_tree(str(tmp_path / 'raw'), nwave=200,
                                   delta_wno=190.0)
    digests = {}
    for name, mod in (('jax', jing), ('port', ting)):
        db = str(tmp_path / f'{name}.db')
        rec.ingest_db(mod, root, db)
        digests[name] = ting.table_digests(db)
    assert list(digests['port']) == list(digests['jax'])
    for key, got in digests['port'].items():
        want = digests['jax'][key]
        assert got['shape'] == want['shape']
        if key.startswith('continuum'):
            np.testing.assert_allclose(got['samples'], want['samples'],
                                       rtol=RTOL_TRANSCENDENTAL)
        else:
            assert got['sha256'] == want['sha256'], key
