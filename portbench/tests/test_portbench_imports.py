"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'viabel_tpu'}


def _sources(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
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
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'attr', getattr(node.func, 'id', ''))
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split('.')[0]


@pytest.mark.parametrize('path', sorted(_sources(HERE)),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize('path', sorted(_sources(
    os.path.join(HERE, 'reference'))), ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert 'viabel_tpu_torch' not in set(_imports(path))


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / 'bad.py'
    bad.write_text('import viabel_tpu.bounds\nimport viabel_tpu_torch\n')
    assert set(_imports(str(bad))) == {'viabel_tpu', 'viabel_tpu_torch'}
