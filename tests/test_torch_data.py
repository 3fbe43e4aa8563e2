"""picaso_tpu_torch.data against picaso_tpu.data: the catalog, a download
through a ``file://`` catalog (no network), the bundled reference tree,
the default-opacity lookup and the environment checks."""

import os
import tarfile

import numpy as np
import pytest

from picaso_tpu import data as jdata

from picaso_tpu_torch import data as tdata
from picaso_tpu_torch.opacities.factory import build_synthetic_db


def test_catalog_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv('PYSYN_CDBS', str(tmp_path / 'stellar'))
    assert tdata.data_catalog(str(tmp_path)) == jdata.data_catalog(
        str(tmp_path))
    assert tdata.data_catalog() == jdata.data_catalog()


def test_get_data_through_a_file_catalog(tmp_path, capsys):
    src = tmp_path / 'src'
    src.mkdir()
    (src / 'hello.txt').write_text('payload')
    tgz = tmp_path / 'bundle.tar.gz'
    with tarfile.open(tgz, 'w:gz') as tf:
        tf.add(src / 'hello.txt', arcname='hello.txt')
    plain = tmp_path / 'table.csv'
    plain.write_text('a,b\n1,2\n')
    out = {}
    for name, mod in (('jax', jdata), ('port', tdata)):
        dest = tmp_path / name
        catalog = {'test': {'default': {
            'description': 'local mirror',
            'default_destination': str(dest),
            'url': {'bundle.tar.gz': f'file://{tgz}',
                    'table.csv': f'file://{plain}'}}}}
        paths = mod.get_data('test', catalog=catalog, progress=False)
        assert (dest / 'hello.txt').read_text() == 'payload'
        assert (dest / 'table.csv').read_text() == 'a,b\n1,2\n'
        out[name] = [os.path.relpath(p, dest) for p in paths]
        assert mod.get_data(catalog=catalog) is None       # the listing
    assert out['port'] == out['jax'] == ['bundle.tar.gz', 'table.csv']
    listing = capsys.readouterr().out
    assert listing.count('test / default: local mirror') == 2


def test_get_reference_and_default_opacity(tmp_path, capsys):
    ref = tmp_path / 'refdata'
    out = tdata.get_reference(str(ref))
    assert os.path.exists(os.path.join(out, 'config.json'))
    with pytest.raises(FileExistsError):
        tdata.get_reference(str(ref))
    assert sorted(os.listdir(ref)) == sorted(os.listdir(
        jdata.bundled_refdata()))
    for mod in (tdata, jdata):
        assert mod.check_default_opacity(str(ref), verbose=False) is None
    build_synthetic_db(str(ref / 'opacities' / 'opacities.db'),
                       np.linspace(1000, 5000, 40), device='cpu')
    capsys.readouterr()
    found = tdata.check_default_opacity(str(ref))
    text_port = capsys.readouterr().out
    assert found == jdata.check_default_opacity(str(ref))
    assert found.endswith('opacities.db')
    assert text_port == capsys.readouterr().out
    assert 'molecules' in text_port


def test_check_environ_matches_jax(monkeypatch, tmp_path):
    for env in (None, str(tmp_path / 'missing'), str(tmp_path)):
        for var in ('picaso_refdata', 'picaso_tpu_refdata'):
            monkeypatch.delenv(var, raising=False)
        if env is not None:
            monkeypatch.setenv('picaso_refdata', env)
        got = tdata.check_environ(verbose=False)
        want = jdata.check_environ(verbose=False)
        assert got == [m.replace('picaso_tpu.data', 'picaso_tpu_torch.data')
                       for m in want]
        assert got
