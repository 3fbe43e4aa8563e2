"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port either; module names are compared
whole by their top-level part (picaso_tpu_torch is not picaso_tpu)."""

import ast
import os

import pytest

from benchmark.harness.cli import forbidden_modules

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {'jax', 'jaxlib', 'flax', 'picaso_tpu'}


def _files(folder):
    for dirpath, _, names in os.walk(folder):
        for n in sorted(names):
            if n.endswith('.py'):
                yield os.path.join(dirpath, n)


def _imports(path):
    """(top-level module names, relative import levels) of a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names, levels = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                levels.add(node.level)
            else:
                names.add(node.module.split('.')[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'attr', getattr(node.func, 'id', ''))
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split('.')[0])
    return names, levels


@pytest.mark.parametrize('path', sorted(_files(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    names, _ = _imports(path)
    assert not names & JAX, f'{path} imports {names & JAX}'


@pytest.mark.parametrize('path', sorted(_files(os.path.join(BENCH,
                                                            'reference'))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    names, levels = _imports(path)
    assert names <= {'__future__', 'dataclasses', 'functools', 'math',
                     'numpy', 're', 'torch', 'typing'}, names
    assert levels <= {1}, 'the reference reaches outside its package'


def test_forbidden_modules_compares_whole_names():
    loaded = ['jax.numpy', 'picaso_tpu_torch.pipeline', 'picaso_tpu',
              'jaxtyping', 'flax.linen', 'numpy']
    assert forbidden_modules(loaded) == ['flax', 'jax', 'picaso_tpu']
    assert forbidden_modules(['picaso_tpu_torch', 'jaxlib_x']) == []
