"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole, since the port's name begins with the JAX package's."""

import ast
import os

import pytest

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {'jax', 'jaxlib', 'flax', 'pyimsegm_tpu'}
PORT = 'pyimsegm_tpu_torch'


def _sources(top):
    for root, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)


def _imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) in (
                'import_module', '__import__') and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            yield node.args[0].value.split('.')[0]


@pytest.mark.parametrize('path', sorted(_sources(HERE)),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not set(_imported(path)) & JAX


@pytest.mark.parametrize(
    'path', sorted(_sources(os.path.join(HERE, 'reference'))),
    ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(_imported(path))


def test_whole_name_comparison():
    assert run.forbidden_modules({'pyimsegm_tpu_torch': 0,
                                  'pyimsegm_tpu_torch.ops': 0}) == []
    assert run.forbidden_modules({'pyimsegm_tpu.ops': 0, 'jaxlib': 0,
                                  'jaxtyping': 0}) == ['jaxlib',
                                                       'pyimsegm_tpu']
