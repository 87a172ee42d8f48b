"""The port's native C++ log densities (viabel_tpu_torch/native) against
the JAX package's native ones and the port's torch models, float64 on the
CPU.  The C++ sources are the port's own copies, built with g++ under
``viabel_tpu_torch/_build/native/``; the tests skip only where no C++
toolchain builds them, as the JAX package's native tests do.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu_torch as pt
from viabel_tpu import native as jnative
from viabel_tpu_torch import native
from viabel_tpu_torch.models import (eight_schools_cp_model,
                                     robust_regression_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def library():
    try:
        return native.build_native_library()
    except RuntimeError:
        pytest.skip('no C++ toolchain available')


def _pairs(name):
    """(port native, JAX native, port torch model) of one density."""
    if name == 'eight_schools_cp':
        return (native.native_eight_schools_cp_log_density(),
                jnative.native_eight_schools_cp_log_density(),
                eight_schools_cp_model())
    return (native.native_robust_regression_log_density(),
            jnative.native_robust_regression_log_density(),
            robust_regression_model())


def test_library_is_built_from_the_ports_sources(library):
    """The library lives under viabel_tpu_torch/_build/native/, its name
    keyed by a hash of the port's own sources, which are copies of the
    JAX package's and not paths into it."""
    build = os.path.join(ROOT, 'viabel_tpu_torch', '_build', 'native')
    assert os.path.dirname(library) == build
    assert library == native._target()
    assert os.path.basename(library).startswith('libviabel_native-')
    for src in native._SRCS:
        assert os.path.dirname(src) == os.path.join(ROOT, 'viabel_tpu_torch',
                                                    'native')
        assert os.path.isfile(src)
    assert sorted(os.path.basename(s) for s in native._SRCS) == [
        'eight_schools.cpp', 'regression.cpp']
    assert native._load() is native._load()


@pytest.mark.parametrize('name', ['eight_schools_cp', 'robust_regression'])
def test_native_matches_jax_native_and_torch_model(library, name):
    """Values and gradients at rtol 1e-12 against the JAX package's native
    density and the port's torch model; a float32 input comes back in
    float32."""
    t_native, j_native, model = _pairs(name)
    x = np.random.RandomState(2).randn(6, model.dim)
    got = t_native(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_native(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(got.numpy(),
                               model.log_prob(torch.tensor(x)).numpy(),
                               rtol=1e-12)
    g = torch.func.grad(lambda z: t_native(z).sum())(torch.tensor(x))
    j_g = jax.grad(lambda z: jnp.sum(j_native(z)))(jnp.asarray(x))
    t_g = torch.func.grad(lambda z: model.log_prob(z).sum())(
        torch.tensor(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(g.numpy(), t_g.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert t_native(torch.tensor(x, dtype=torch.float32)).dtype == \
        torch.float32
    assert t_native.host_callback


def test_native_backend_in_full_vi_loop(library):
    """The counterpart of tests/test_extras.py:345: the native CP density
    drives a KLVI optimization (mf-t(40), n_mc 20, 100 iterations) that
    lowers the loss; the same run on the torch CP model gives the same fit
    (rtol 1e-9)."""
    fam = pt.mean_field_t_variational_family(10, 40)
    outs = []
    for density in (native.native_eight_schools_cp_log_density(),
                    eight_schools_cp_model()):
        obj = pt.black_box_klvi(fam, density, 20)
        outs.append(pt.adagrad_optimize(
            100, obj, torch.zeros(20, dtype=torch.float64),
            generator=torch.Generator().manual_seed(4), learning_rate=.05,
            device='cpu'))
    opt, _, values, _ = outs[0]
    assert np.all(np.isfinite(opt.numpy()))
    assert values[-20:].mean() < values[:20].mean()
    for got, want in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_validated_vi_on_native_regression_matches_torch_model(library):
    """`validated_vi` on the native robust regression (eager adagrad, K3
    and the combine's plain versions) against the same pipeline on the
    torch model (K1's plain version) with the same generator, rtol 1e-9."""
    fam = pt.mean_field_t_variational_family(2, 40)
    outs = [pt.validated_vi(density, fam, torch.zeros(4, dtype=torch.float64),
                            200, n_mc_samples=20, n_bound_samples=5000,
                            generator=torch.Generator().manual_seed(9),
                            device='cpu')
            for density in (native.native_robust_regression_log_density(),
                            robust_regression_model())]
    for key in ('opt_param', 'log_weights', 'q_mean'):
        np.testing.assert_allclose(outs[0][key].numpy(),
                                   outs[1][key].numpy(), rtol=1e-9,
                                   atol=1e-12)
    for key in ('d2', 'W2'):
        assert outs[0]['bounds'][key] == pytest.approx(
            outs[1]['bounds'][key], rel=1e-9)
    assert outs[0]['khat'] == pytest.approx(outs[1]['khat'], rel=1e-9)


def test_native_robust_regression_rejects_partial_data():
    """tests/test_extras.py:400's checks: x without y (or y without x)
    and a y of the wrong length are errors."""
    X = np.ones((5, 2))
    with pytest.raises(ValueError, match='both x and y'):
        native.native_robust_regression_log_density(x=X)
    with pytest.raises(ValueError, match='both x and y'):
        native.native_robust_regression_log_density(y=np.ones(5))
    with pytest.raises(ValueError, match='one response per row'):
        native.native_robust_regression_log_density(x=X, y=np.ones(4))
