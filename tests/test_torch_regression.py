"""The port's regression models against viabel_tpu.models.regression,
float64.

The data generators draw with numpy's legacy RandomState in both packages,
so the data must be identical; the log densities are compared at seeded
coefficients at rtol 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viabel_tpu.models import regression as jr
from viabel_tpu_torch.models import regression as tr

RTOL = 1e-12


@pytest.mark.parametrize('kw', [
    dict(N=100, D=10, alpha=1.0, noise_variance=0.25, rho=0.5, seed=42),
    dict(N=200, D=20, alpha=1.0, noise_variance=0.16, rho=0.5, seed=5080),
    dict(N=7, D=3)])
def test_data_generator_linear_is_identical(kw):
    got, want = tr.data_generator_linear(**kw), jr.data_generator_linear(**kw)
    assert set(got) == set(want) == {'X', 'Y', 'W'}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_robust_notebook_data_is_identical():
    for got, want in zip(tr.robust_regression_notebook_data(),
                         jr.robust_regression_notebook_data()):
        np.testing.assert_array_equal(got, want)


def _betas(D, n=64, seed=0):
    return np.random.RandomState(seed).normal(0, 1.5, (n, D))


def _models():
    data = jr.data_generator_linear(N=100, D=10, seed=42)
    x, y = data['X'], data['Y']
    rs = np.random.RandomState(9)
    xr, yr = rs.randn(30, 3), rs.randn(30)
    return [
        ('linear', jr.linear_regression_model(x, y),
         tr.linear_regression_model(x, y)),
        ('linear, other scales',
         jr.linear_regression_model(x, y, noise_scale=1.3, prior_std=2.0),
         tr.linear_regression_model(x, y, noise_scale=1.3, prior_std=2.0)),
        ('robust, notebook data', jr.robust_regression_model(),
         tr.robust_regression_model()),
        ('robust, given data',
         jr.robust_regression_model(xr, yr, df=5.0, prior_std=3.0,
                                    noise_scale=0.7),
         tr.robust_regression_model(xr, yr, df=5.0, prior_std=3.0,
                                    noise_scale=0.7)),
    ]


@pytest.mark.parametrize('case', range(4))
def test_log_densities_match(case):
    _, jm, tm = _models()[case]
    assert tm.dim == jm.dim and tm.name == jm.name
    assert tm.param_names == jm.param_names
    b = _betas(jm.dim, seed=case)
    np.testing.assert_allclose(tm.log_prob(torch.as_tensor(b)).numpy(),
                               np.asarray(jm.log_prob(jnp.asarray(b))),
                               rtol=RTOL)
    one = tm(torch.as_tensor(b[0]))  # one point: a scalar
    assert one.dim() == 0
    np.testing.assert_allclose(float(one), float(jm(jnp.asarray(b[0]))),
                               rtol=RTOL)


@pytest.mark.parametrize('case', range(4))
def test_true_moments_and_kernel_data(case):
    _, jm, tm = _models()[case]
    for got, want in ((tm.true_mean, jm.true_mean),
                      (tm.true_cov, jm.true_cov)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL)
    assert tm.kernel == 'regression'
    x, y, df, noise_scale, prior_std = tm.kernel_data
    assert x.dtype == y.dtype == torch.float64
    assert tuple(x.shape) == (y.shape[0], tm.dim)
    # the kernel data scores as the model does
    b = torch.as_tensor(_betas(tm.dim, 8, seed=case))
    np.testing.assert_allclose(
        tr.regression_log_density(b, x, y, df, noise_scale,
                                  prior_std).numpy(),
        tm.log_prob(b).numpy(), rtol=RTOL)


@pytest.mark.parametrize('n_rows, d, tagged', [
    (100, 32, True), (50, 33, False), (50, 40, False), (1000, 10, True),
    (2000, 10, False)])
def test_kernel_tag_only_where_the_score_kernels_take_the_data(n_rows, d,
                                                               tagged):
    """x and y stage in 96 KiB of shared memory beside the 2 x 32 values of
    mean and scale, in float64, and d is at most 32."""
    data = tr.data_generator_linear(N=n_rows, D=d, seed=3)
    tm = tr.linear_regression_model(data['X'], data['Y'])
    assert (tm.kernel, tm.kernel_data is not None) == (
        ('regression', True) if tagged else (None, False))


def test_linear_truth_is_the_conjugate_posterior():
    from viabel_tpu.diagnostics import compute_posterior_moments
    data = tr.data_generator_linear(N=100, D=10, seed=42)
    tm = tr.linear_regression_model(data['X'], data['Y'])
    mean, cov = compute_posterior_moments(np.zeros(10), 100.0 * np.eye(10),
                                          0.25, data['X'], data['Y'])
    np.testing.assert_allclose(tm.true_mean, mean, rtol=RTOL)
    np.testing.assert_allclose(tm.true_cov, cov, rtol=RTOL)
    np.testing.assert_allclose(tr._ROBUST_TRUE_MEAN, jr._ROBUST_TRUE_MEAN)
    np.testing.assert_allclose(tr._ROBUST_TRUE_COV, jr._ROBUST_TRUE_COV)


def test_log_prob_under_vmap_and_autograd():
    """The IA optimizers differentiate the model under torch.func.vmap."""
    data = tr.data_generator_linear(N=20, D=4, seed=1)
    tm = tr.linear_regression_model(data['X'], data['Y'])
    b = torch.as_tensor(_betas(4, 6, seed=2)).reshape(2, 3, 4)
    batched = torch.func.vmap(lambda bb: tm.log_prob(bb).sum())(b)
    np.testing.assert_allclose(
        batched.numpy(),
        tm.log_prob(b.reshape(6, 4)).reshape(2, 3).sum(1).numpy(),
        rtol=RTOL)
