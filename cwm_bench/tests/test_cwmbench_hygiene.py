"""The benchmark imports no JAX, flax, optax or JAX package, compared by
the top-level name whole, and its reference imports nothing of the
port."""
import ast
import os

import pytest

from cwm_bench import harness

PORT = 'counterfactualworldmodels_tpu_torch'


def _sources(sub=''):
    root = os.path.join(harness.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(['jax.numpy', 'os']) == ['jax']
    assert harness.forbidden_modules([PORT, PORT + '.models']) == []
    assert harness.forbidden_modules(['counterfactualworldmodels_tpu.ops']) \
        == ['counterfactualworldmodels_tpu']
    assert harness.forbidden_modules(['jaxtyping', 'flaxen']) == []


@pytest.mark.parametrize('path', list(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_import(path):
    found = set(_imports(path)) & set(harness.FORBIDDEN)
    assert not found, f'{path} imports {found}'


@pytest.mark.parametrize('path', list(_sources('reference')),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_reference_stands_alone(path):
    assert PORT not in set(_imports(path)), path


@pytest.mark.parametrize('sub', ['counts', 'traffic', 'metrics'])
def test_yardstick_imports_no_port(sub):
    for path in _sources(sub):
        assert PORT not in set(_imports(path)), path
