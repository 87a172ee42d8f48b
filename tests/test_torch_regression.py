"""The port's regression models against viabel_tpu.models.regression,
float64.

The data generators draw with numpy's legacy RandomState in both packages,
so the data must be identical; the log densities are compared at seeded
coefficients at rtol 1e-12.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viabel_tpu.models import regression as jr
from viabel_tpu_torch.models import regression as tr
from viabel_tpu_torch.ops import limits
from viabel_tpu_torch.ops import lw_stats as lw_ops

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


# --------------------------------------------------------------------------
# the staged-bytes rule of the score kernels, after the padded rows
# --------------------------------------------------------------------------

_CUH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'viabel_tpu_torch', 'csrc', 'bound_pass.cuh')


def _kernel_takes(d, n_rows, itemsize, maxd):
    """The rule the score kernels apply at launch, restated from
    csrc/bound_pass.cuh: ``regression_row`` pads x_k, y_k to whole 16-byte
    words, ``ModelArgs::staged_values`` is n_rows such rows, and
    ``launch_score_at`` refuses ``score_smem_bytes`` = ring + sizeof(T) (2
    MAXD + staged_values) above ring + sizeof(T) 2 MAXD +
    MAX_STAGED_BYTES."""
    word = 16 // itemsize
    staged = n_rows * ((d + 1 + word - 1) // word * word)
    return itemsize * (2 * maxd + staged) <= (itemsize * 2 * maxd
                                              + limits.MAX_STAGED_BYTES)


def test_the_restated_rule_is_the_kernels():
    with open(_CUH) as f:
        src = f.read()
    for line in ('return (d + 1 + W - 1) / W * W;',
                 'return kind == REGRESSION ? n_rows * regression_row<T>(d)',
                 'sizeof(T) * (2 * MAXD + m.staged_values(d));',
                 'sizeof(T) * 2 * MAXD + MAX_STAGED_BYTES;'):
        assert line in src, line


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('d', [1, 2, 3, 4, 7, 10, 11, 31, 32])
def test_fits_and_check_kernel_model_follow_the_padded_rows(d, itemsize):
    """Around the largest row count the host lets through: `limits.fits`,
    `check_kernel_model` and the kernels' rule (at every instance's MAXD)
    agree that it fits, the next row count does not fit the host's rule,
    and the host never passes what a kernel would refuse."""
    assert limits.regression_row(d, itemsize) % (16 // itemsize) == 0
    word_values = 16 // itemsize
    assert limits.regression_row(d, itemsize) == (
        -(-(d + 1) // word_values) * word_values)
    most = (limits.MAX_STAGED_BYTES // itemsize - 2 * limits.MAX_DIM) \
        // limits.regression_row(d, itemsize)
    for n_rows in (1, most - 1, most, most + 1):
        fits = limits.fits(d, n_rows * limits.regression_row(d, itemsize),
                           itemsize)
        assert fits == (n_rows <= most)
        x, y = torch.zeros(n_rows, d), torch.zeros(n_rows)
        data = (x, y, None, 1.0, 1.0)
        if fits:
            lw_ops.check_kernel_model('regression', data, d, itemsize)
            for maxd in {d if d in (2, 10) else 32, 32}:
                assert _kernel_takes(d, n_rows, itemsize, maxd)
        else:
            with pytest.raises(ValueError):
                lw_ops.check_kernel_model('regression', data, d, itemsize)


@pytest.mark.parametrize('d', [2, 10, 32])
def test_kernel_tag_just_inside_and_just_outside_the_staging_limit(d):
    """The most rows whose float64 padded rows fit keep the tag; one more
    row loses it (d = 10: 1018 rows of 12 values; unpadded, 1111 would
    have fit)."""
    most = (limits.MAX_STAGED_BYTES // 8 - 2 * limits.MAX_DIM) \
        // limits.regression_row(d, 8)
    data = tr.data_generator_linear(N=most + 1, D=d, seed=4)
    inside = tr.linear_regression_model(data['X'][:most], data['Y'][:most])
    outside = tr.linear_regression_model(data['X'], data['Y'])
    assert inside.kernel == 'regression' and outside.kernel is None
    assert outside.kernel_data is None
    if d == 10:
        assert most == 1018


@pytest.mark.parametrize('case', range(4))
def test_repo_models_keep_their_tag_and_plain_lw(case):
    """The padding moves no model of the repo across the limit (each kept
    the tag it had under the unpadded rule), and the plain path scores
    them as the model's own density does."""
    _, _, tm = _models()[case]
    x, y = tm.kernel_data[:2]
    n_rows, d = x.shape
    unpadded = limits.fits(d, n_rows * (d + 1), 8)
    assert unpadded and tm.kernel == 'regression'
    rng = np.random.RandomState(case)
    z = torch.as_tensor(rng.randn(50, d))
    mean = torch.as_tensor(rng.randn(d))
    log_scale = torch.as_tensor(0.1 * rng.randn(d))
    lw, _ = lw_ops.transform_score_partials(z, mean, log_scale, tm.kernel,
                                            tm.kernel_data)
    xs = mean + torch.exp(log_scale) * z
    logq = (-0.5 * torch.sum(z * z + np.log(2 * np.pi), dim=1)
            - torch.sum(log_scale))
    np.testing.assert_allclose(lw.numpy(), (tm.log_prob(xs) - logq).numpy(),
                               rtol=RTOL)
