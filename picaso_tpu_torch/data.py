"""Data distribution: catalog + downloader for the large science artifacts.

Copy of ``picaso_tpu/data.py`` for the PyTorch port, which must not import
the JAX package (the port's ``refdata`` and ``opacities.ingest``).  As
there, a port of the reference ``data.py``: the same Zenodo/STScI catalog
of opacity databases, correlated-k tables, stellar grids, virga Mie files
and Sonora model grids, downloaded with urllib (no pooch) and un-tarred
into the reference-compatible directory layout that
:mod:`picaso_tpu_torch.refdata` resolves.  ``get_data(catalog=...)``
takes another catalog, e.g. a local mirror of ``file://`` URLs.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request

from .refdata import bundled_refdata, external_refdata

__all__ = ['data_catalog', 'check_environ', 'get_data',
           'check_default_opacity', 'get_reference']


def data_catalog(refdata=None):
    """Catalog of downloadable artifacts (data.py:71-265)."""
    refdata = refdata or external_refdata() or bundled_refdata()
    opa_dir = os.path.join(refdata, 'opacities')
    stellar = os.environ.get('PYSYN_CDBS', os.path.join(refdata,
                                                        'stellar_grids'))
    return {
        'resampled_opacity': {
            'default': {
                'url': {'opacities_0.3_15_R15000.db.tar.gz':
                        'https://zenodo.org/records/14861730/files/'
                        'opacities_0.3_15_R15000.db.tar.gz'},
                'description': '7.34 GB, R=15,000, 0.3-15um resampled '
                               'monochromatic opacity database (default).',
                'default_destination': opa_dir},
            'R60000,0.6-6um': {
                'url': {'all_opacities_0.6_6_R60000.db.tar.gz':
                        'https://zenodo.org/records/6928501/files/'
                        'all_opacities_0.6_6_R60000.db.tar.gz'},
                'description': '38.3 GB, R=60,000, 0.6-6um.',
                'default_destination': os.path.join(opa_dir, 'resampled')},
            'R20000,4.8-15um': {
                'url': {'all_opacities_4.8_15_R20000.db.tar.gz':
                        'https://zenodo.org/records/6928501/files/'
                        'all_opacities_4.8_15_R20000.db.tar.gz'},
                'description': '7.0 GB, R=20,000, 4.8-15um.',
                'default_destination': os.path.join(opa_dir, 'resampled')},
        },
        'preweighted_ck': {
            'default': {
                'url': {'sonora_2020_feh+000_co_100.data.196.hdf5':
                        'https://zenodo.org/records/15008800/files/'
                        'sonora_2020_feh%2B000_co_100.data.196.hdf5'},
                'description': 'Premixed correlated-k table, solar '
                               'composition, 196-bin grid.',
                'default_destination': os.path.join(opa_dir,
                                                    'preweighted')},
        },
        'resortrebin_ck': {
            'default': {
                'url': {'picaso_661_kcoefficients.tar.gz':
                        'https://zenodo.org/records/15008800/files/'
                        'picaso_661_kcoefficients.tar.gz'},
                'description': 'Per-molecule CK tables (661 grid) for '
                               'on-the-fly resort-rebin mixing.',
                'default_destination': os.path.join(opa_dir,
                                                    'resortrebin')},
        },
        'stellar_grids': {
            'phoenix': {
                'url': {'synphot5.tar.gz':
                        'http://ssb.stsci.edu/trds/tarfiles/'
                        'synphot5.tar.gz'},
                'description': 'Phoenix stellar atlas.',
                'default_destination': os.path.join(stellar, 'grid')},
            'ck04models': {
                'url': {'synphot3.tar.gz':
                        'http://ssb.stsci.edu/trds/tarfiles/'
                        'synphot3.tar.gz'},
                'description': 'Castelli & Kurucz 2004 stellar atlas.',
                'default_destination': os.path.join(stellar, 'grid')},
        },
        'virga_mieff': {
            'default': {
                'url': {'virga.zip':
                        'https://zenodo.org/record/3992294/files/'
                        'virga.zip'},
                'description': 'Mie coefficient files for virga cloud '
                               'condensates.',
                'default_destination': os.path.join(refdata, 'virga')},
        },
        'sonora_grids': {
            'bobcat': {
                'url': {'spectra.tar.gz':
                        'https://zenodo.org/records/5063476/files/'
                        'spectra.tar.gz'},
                'description': 'Sonora Bobcat brown-dwarf spectra grid.',
                'default_destination': os.path.join(refdata,
                                                    'sonora_grids')},
        },
    }


def check_default_opacity(refdata=None, verbose=True):
    """Locate the default monochromatic DB and summarize its metadata
    (data.py check_default_opacity).  Returns the path or None."""
    import glob as _glob

    refdata = refdata or external_refdata() or bundled_refdata()
    hits = sorted(_glob.glob(os.path.join(refdata, 'opacities',
                                          'opacities*.db')))
    if not hits:
        if verbose:
            print('no opacities*.db found under '
                  f'{os.path.join(refdata, "opacities")}; use '
                  'get_data("resampled_opacity") or build one with '
                  'opacities.factory')
        return None
    path = hits[0]
    if verbose:
        if len(hits) > 1:
            print(f'multiple opacity DBs found; using {path}')
        try:
            from .opacities.ingest import get_metadata
            for k, v in get_metadata(path):
                print(f'{k}: {v}')
        except Exception as e:
            print(f'{path}: metadata unreadable ({e})')
    return path


def get_reference(path_to_picaso_refdata=None):
    """Populate an external $picaso_refdata directory from the bundled
    reference tree (data.py get_reference downloads the same layout from
    GitHub; the bundle ships in-package so no network is needed)."""
    import shutil

    dest = path_to_picaso_refdata or os.environ.get('picaso_refdata')
    if not dest:
        raise ValueError('pass a destination or set picaso_refdata')
    if os.path.exists(os.path.join(dest, 'config.json')):
        raise FileExistsError(
            f'{dest} already holds reference data; clear it first')
    shutil.copytree(bundled_refdata(), dest, dirs_exist_ok=True)
    return dest


def check_environ(verbose=True):
    """Sanity checks on refdata environment (data.py:286-404)."""
    messages = []
    ext = external_refdata()
    if ext is None:
        messages.append(
            'picaso_refdata is not set; using the bundled (small) '
            'reference data only. Large opacity databases must be pointed '
            'to explicitly or via picaso_refdata.')
    elif not os.path.isdir(ext):
        messages.append(f'picaso_refdata={ext} is not a directory.')
    opa = os.path.join(ext or bundled_refdata(), 'opacities',
                       'opacities.db')
    if not os.path.exists(opa):
        messages.append(
            'No default monochromatic opacity database found '
            f'({opa}); run picaso_tpu_torch.data.get_data("resampled_opacity") '
            'or build a synthetic one with opacities.factory.')
    if verbose:
        for m in messages:
            print(m)
    return messages


def get_data(category_download=None, target_download='default',
             final_destination_dir=None, progress=True, catalog=None):
    """Download + extract a catalog artifact (data.py:452-598).

    ``catalog`` overrides the built-in Zenodo/STScI catalog — e.g. a
    local mirror with file:// URLs (how the download/extract path is
    exercised in CI without egress)."""
    catalog = catalog or data_catalog()
    if category_download is None:
        for cat, targets in catalog.items():
            for tgt, info in targets.items():
                print(f'{cat} / {tgt}: {info["description"]}')
        return None
    info = catalog[category_download][target_download]
    dest = final_destination_dir or info['default_destination']
    os.makedirs(dest, exist_ok=True)
    out_paths = []
    for fname, url in info['url'].items():
        out = os.path.join(dest, fname)
        if not os.path.exists(out):
            if progress:
                print(f'downloading {url} -> {out}')
            urllib.request.urlretrieve(url, out)
        if fname.endswith(('.tar.gz', '.tgz')):
            with tarfile.open(out) as tf:
                tf.extractall(dest)
        out_paths.append(out)
    return out_paths
