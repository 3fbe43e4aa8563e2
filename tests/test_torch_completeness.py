"""The port does all that the JAX package does: every module of
``picaso_tpu/``, every top-level public function and class and every
public method has a counterpart of the same name at the same path in
``picaso_tpu_torch/``, or an entry in ``EXEMPT`` that says why not and
which ROADMAP list it belongs to; every JAX example has its port; every
file that holds a ``pl.pallas_call`` has its kernels named in
``chip_smoke.py``'s ``KERNELS``, each at a ``def``.

Both packages are read as source (``ast``), and ``chip_smoke.py`` as
text: nothing here imports them but the port's list of its kernel
wrappers, held to ``KERNELS``."""

import ast
import functools
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = 'picaso_tpu', 'picaso_tpu_torch'

_PALLAS = ('a Pallas kernel module: its kernels are CUDA C++ in the port, '
           'behind picaso_tpu_torch/{}')
_PYTREE = ('a pytree registration: the port\'s {} is a plain Python '
           'object, which torch needs no registration for')
_BLOCKED = 'needs {}, which the repository does not hold'
# the two lists of ROADMAP.md Queue 1 that hold what the port lacks
JAX_ONLY = 'JAX-only mechanics that need no counterpart'
BLOCKED = 'Blocked, not queued'
# path in picaso_tpu (module, module:name or module:Class.method) ->
# (reason, the ROADMAP list it stands in)
EXEMPT = {
    'opacities/pallas_interp.py': (
        _PALLAS.format('opacities/cuda_interp.py'), JAX_ONLY),
    'rt/pallas_toon.py': (_PALLAS.format('rt/cuda_toon.py'), JAX_ONLY),
    'rt/pallas_sh.py': (_PALLAS.format('rt/cuda_sh.py'), JAX_ONLY),
    **{f'{mod}:{cls}.{meth}': (_PYTREE.format(cls), JAX_ONLY)
       for mod, cls in (('chemistry.py', 'ChemGrid'),
                        ('opacities/ck.py', 'CKArrays'),
                        ('opacities/db.py', 'OpacityGrid'))
       for meth in ('tree_flatten', 'tree_unflatten')},
    'climate/api.py:inputs_climate': (
        'the port keeps it as the method justdoit.inputs.inputs_climate, '
        'as the reference does', JAX_ONLY),
    'justdoit.py:Opacity.full_abunds': (
        'the port reads the table\'s own full_abunds '
        '(Opacity.ck.full_abunds)', JAX_ONLY),
    'justdoit.py:HJ_pt_3d': (_BLOCKED.format('its bundled pickle'),
                             BLOCKED),
    'chemistry.py:run_vulcan': (_BLOCKED.format(
        'the external VULCAN package'), BLOCKED),
    **{f'justdoit.py:{name}': (_BLOCKED.format(
        'the exoplanet archive, over the network'), BLOCKED)
       for name in ('get_targets', 'load_planet', 'all_planets')},
}


def _modules(pkg):
    """{path relative to the package: {top-level name: set of method names
    (None for a function or another binding)}} of every .py file."""
    base = os.path.join(ROOT, pkg)
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            if not f.endswith('.py'):
                continue
            path = os.path.join(d, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            out[os.path.relpath(path, base).replace(os.sep, '/')] = \
                _top_level(tree)
    return out


def _bound(node):
    """Names a statement binds at its level: a def, a class, an assignment,
    or an import from inside the port (a re-export of its own code; a
    name imported from elsewhere is no counterpart)."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [
            node.target]
        return [t.id for t in targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.ImportFrom) and (
            node.level or (node.module or '').split('.')[0] == PORT):
        return [a.asname or a.name for a in node.names]
    return []


def _top_level(tree):
    names = {}
    for node in tree.body:
        for name in _bound(node):
            names[name] = ({n for m in node.body for n in _bound(m)}
                           if isinstance(node, ast.ClassDef) else None)
    return names


def _public_defs(tree):
    """(name, [public methods]) of the top-level public functions and
    classes."""
    for node in tree.body:
        if node.name.startswith('_') if hasattr(node, 'name') else True:
            continue
        if isinstance(node, ast.ClassDef):
            yield node.name, [m.name for m in node.body
                              if isinstance(m, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))
                              and not m.name.startswith('_')]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, []


def _jax_names():
    """Every module, public function, class and method of picaso_tpu, by
    its path: 'module', 'module:name', 'module:Class.method'."""
    base = os.path.join(ROOT, JAX)
    for d, _, files in os.walk(base):
        for f in sorted(files):
            if not f.endswith('.py'):
                continue
            path = os.path.join(d, f)
            mod = os.path.relpath(path, base).replace(os.sep, '/')
            yield mod, (mod, None, None)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for name, methods in _public_defs(tree):
                yield f'{mod}:{name}', (mod, name, None)
                for m in methods:
                    yield f'{mod}:{name}.{m}', (mod, name, m)


@functools.lru_cache(maxsize=None)
def _missing():
    port = _modules(PORT)
    missing = []
    for key, (mod, name, meth) in _jax_names():
        if mod not in port:
            found = False
        elif name is None:
            found = True
        elif meth is None:
            found = name in port[mod]
        else:
            found = meth in (port[mod].get(name) or ())
        if not found:
            missing.append(key)
    return tuple(missing)


def _exempted(key):
    """The EXEMPT entry that covers ``key``: its own, or its module's."""
    return EXEMPT.get(key) or EXEMPT.get(key.split(':')[0])


def test_every_public_name_has_its_counterpart():
    """Each module, public function, class and method of picaso_tpu is in
    picaso_tpu_torch at the same path, or exempt with a reason."""
    missing = _missing()
    unexplained = [k for k in missing if not _exempted(k)]
    assert not unexplained, ('no counterpart in picaso_tpu_torch and no '
                             f'EXEMPT entry: {unexplained}')


@pytest.mark.parametrize('key', sorted(EXEMPT))
def test_exempt_entry_is_needed_and_explained(key):
    """An EXEMPT entry names something that picaso_tpu has and the port
    lacks, gives a reason and a ROADMAP list; a Pallas module's entry
    names a port module that exists."""
    jax_keys = dict(_jax_names())
    assert key in jax_keys, f'{key}: not in picaso_tpu'
    assert key in _missing() or any(
        k.startswith(key + ':') for k in _missing()), (
        f'{key}: the port has it, so the EXEMPT entry goes')
    reason, where = EXEMPT[key]
    assert reason
    with open(os.path.join(ROOT, 'ROADMAP.md')) as f:
        assert where in f.read(), f'{where}: not a list of ROADMAP.md'
    if key.endswith('.py'):
        port = re.search(r'picaso_tpu_torch/(\S+\.py)', reason).group(1)
        assert os.path.isfile(os.path.join(ROOT, PORT, port)), port


def test_every_example_has_its_port():
    def names(d):
        return {f for f in os.listdir(os.path.join(ROOT, d))
                if f.endswith('.py')}
    assert names('examples') == names(os.path.join(PORT, 'examples'))


def _chip_smoke_kernels():
    """``KERNELS`` of chip_smoke.py, from its source: the assignments of
    KERNELS and the tables it reads, run alone in an empty namespace."""
    with open(os.path.join(ROOT, 'chip_smoke.py')) as f:
        tree = ast.parse(f.read())
    wanted = {'SH_REPLACES', 'SPLIT_REPLACES', 'KERNELS'}
    body = [n for n in tree.body if isinstance(n, ast.Assign)
            and {t.id for t in n.targets if isinstance(t, ast.Name)}
            & wanted]
    ns = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), 'chip_smoke.py',
                 'exec'), ns)
    return ns['KERNELS']


def _pallas_files():
    """Python files of the JAX side (the package, its scripts, examples
    and the root's scripts) that call ``pl.pallas_call``."""
    out = set()
    for d in (JAX, 'scripts', 'examples', '.'):
        for dirpath, _, files in os.walk(os.path.join(ROOT, d)):
            if d == '.' and dirpath != os.path.join(ROOT, d):
                continue
            for f in files:
                if f.endswith('.py'):
                    path = os.path.join(dirpath, f)
                    with open(path) as fh:
                        if 'pl.pallas_call(' in fh.read():
                            out.add(os.path.relpath(path, ROOT))
    return out


def test_chip_smoke_kernels_name_every_pallas_kernel():
    """Each KERNELS entry's file:line is a ``def`` there and its CUDA
    source exists; every file with a ``pl.pallas_call`` is named."""
    kernels = _chip_smoke_kernels()
    assert kernels
    named = set()
    for name, (source, where) in kernels.items():
        assert os.path.isfile(os.path.join(ROOT, PORT, 'csrc', source)), (
            name, source)
        path, line = re.fullmatch(r'(.+\.py):(\d+)', where).groups()
        with open(os.path.join(ROOT, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.lstrip().startswith('def '), (name, where, text)
        named.add(path)
    pallas = _pallas_files()
    assert pallas and pallas <= named, sorted(pallas - named)


def test_kernel_wrappers_are_chip_smokes_kernels():
    """``_build.kernel_wrappers()``, whose launch counters chip_smoke.py and
    the mesh example read, names each kernel of ``KERNELS`` once, each
    with its counter."""
    from picaso_tpu_torch import _build

    wrappers = _build.kernel_wrappers()
    assert sorted(wrappers) == sorted(_chip_smoke_kernels())
    assert all(isinstance(w.launches, int) for w in wrappers.values())
