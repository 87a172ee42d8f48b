"""Guards on the port as a whole: what it imports, where it runs, and its
matmul precision."""
import ast
import os

import numpy as np
import pytest
import torch

import viabel_tpu_torch as pt
from viabel_tpu_torch import _device
from viabel_tpu_torch.models import eight_schools_cp_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# tools of the JAX package (they run it on the CPU to give the port a
# reference band); nothing of the port imports them
JAX_TOOLS = ('tools/jax_khat_band.py',)


def _port_sources():
    for top in ('viabel_tpu_torch', 'tools'):
        for dirpath, _, files in os.walk(os.path.join(ROOT, top)):
            for f in files:
                path = os.path.join(dirpath, f)
                if f.endswith('.py') and \
                        os.path.relpath(path, ROOT) not in JAX_TOOLS:
                    yield path
    yield os.path.join(ROOT, 'chip_smoke.py')


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        for mod in _imported_modules(path):
            top = mod.split('.')[0]
            assert top not in ('jax', 'jaxlib', 'viabel_tpu'), (
                '{} imports {}'.format(os.path.relpath(path, ROOT), mod))
            assert mod.split('.')[-1] not in ('jax_khat_band',), (
                '{} imports a tool of the JAX package'.format(
                    os.path.relpath(path, ROOT)))


@pytest.mark.parametrize('module', ['__init__', 'distributed', 'mesh',
                                    'sharded_bounds', 'sharded_psis',
                                    'sharded_chains'])
def test_parallel_modules_are_scanned_and_import_no_jax(module):
    """The multi-device layer is among the scanned sources, imports
    neither JAX nor the JAX package (its own copies of the host helpers,
    e.g. `mesh._largest_divisor_leq`), and exports the JAX package's
    names."""
    path = os.path.join(ROOT, 'viabel_tpu_torch', 'parallel',
                        module + '.py')
    assert path in set(_port_sources())
    for mod in _imported_modules(path):
        assert mod.split('.')[0] not in ('jax', 'jaxlib', 'viabel_tpu'), mod
    with open(path) as f:
        assert 'viabel_tpu.' not in f.read().replace('viabel_tpu/', '')
    from viabel_tpu_torch import parallel
    assert {'make_mesh', 'shard_over', 'fetch_global', 'auto_mesh',
            'sharded_log_weight_stats', 'sharded_sample_stats',
            'sharded_all_bounds', 'sharded_bound_psis',
            'shard_chain_inputs', 'psislw_sharded', 'psisloo_sharded',
            'sharded_psis_moments', 'initialize_distributed',
            'local_device_count', 'process_info'} <= set(parallel.__all__)


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = eight_schools_cp_model()
    fam = pt.mean_field_t_variational_family(10, 40)
    obj = pt.black_box_klvi(fam, model, 5, presampled=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.validated_vi(model, fam, np.zeros(20), 10)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.adagrad_optimize(10, obj, np.zeros(20))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.get_samples_and_log_weights(model, fam, np.zeros(20), 10)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.run_experiment(model, fam, np.zeros(20), model.true_mean,
                          model.true_cov, n_iters=10)
    assert pt.resolve_device('cpu') == torch.device('cpu')


def test_cuda_resolution_applies_the_fp32_matmul_policy(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision('high')
        assert _device.resolve_device(None) == torch.device('cuda')
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == 'highest'
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize('source,module', [('lw_stats', 'lw_stats'),
                                           ('gaussian_lw', 'gaussian_lw'),
                                           ('adagrad', 'adagrad')])
def test_ctypes_signatures_match_the_c_entry_points(source, module):
    """Every entry point's declared ctypes arguments plus the stream are
    the C function's parameters, one for one: an argument left out of
    argtypes is passed as a C int, which cuts a 64-bit stream handle."""
    import importlib
    import re
    ops = importlib.import_module('viabel_tpu_torch.ops.' + module)
    with open(os.path.join(ROOT, 'viabel_tpu_torch', 'csrc',
                           source + '.cu')) as f:
        src = f.read()
    for name, argtypes in ops._SIGNATURES.items():
        for suffix in ('f32', 'f64'):
            params = re.search(r'\bint {}_{}\(([^)]*)\)'.format(name, suffix),
                               src).group(1).split(',')
            assert params[-1].split() == ['void*', 'stream']
            assert len(params) == len(argtypes) + 1, name


EXAMPLE_MODULES = ('__init__', '_common', 'normal_mixture',
                   'robust_regression', 'funnel', 'eight_schools',
                   'linear_regression_ia', 'eight_schools_ia',
                   'chivi_experiments', 'multistart_pipeline', 'pod_layout',
                   'large_d')


@pytest.mark.parametrize('module', EXAMPLE_MODULES)
def test_example_modules_are_scanned_and_import_no_jax(module):
    """The example layer is among the scanned sources and imports neither
    JAX, nor the JAX package, nor the JAX package's examples/: only torch,
    numpy, scipy and the port (relative imports)."""
    path = os.path.join(ROOT, 'viabel_tpu_torch', 'examples',
                        module + '.py')
    assert path in set(_port_sources())
    for mod in _imported_modules(path):
        assert mod.split('.')[0] not in ('jax', 'jaxlib', 'viabel_tpu',
                                         'examples'), mod
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            assert node.level <= 2, 'reaches outside the port'


def _example_calls():
    from viabel_tpu_torch.examples import (
        chivi_experiments, eight_schools, eight_schools_ia, funnel, large_d,
        linear_regression_ia, multistart_pipeline, normal_mixture,
        pod_layout, robust_regression)
    return {
        'normal_mixture': normal_mixture.main,
        'robust_regression': robust_regression.main,
        'funnel': funnel.main,
        'eight_schools': eight_schools.main,
        'linear_regression_ia': linear_regression_ia.main,
        'linear_regression_ia.protocol2': linear_regression_ia.protocol2,
        'eight_schools_ia': eight_schools_ia.main,
        'eight_schools_ia.run_full_rank': eight_schools_ia.run_full_rank,
        'chivi_experiments': chivi_experiments.main,
        'multistart_pipeline': multistart_pipeline.main,
        'pod_layout': lambda: pod_layout.main(['--quick']),
        'large_d': large_d.main,
    }


@pytest.mark.parametrize('name', sorted(_example_calls()))
def test_example_entry_points_refuse_to_run_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _example_calls()[name]()
