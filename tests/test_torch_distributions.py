"""viabel_tpu_torch.distributions against viabel_tpu.distributions.

Densities: the same numpy inputs through both packages at float64, rtol
1e-12.  Samplers: the generators differ, so the port's draws are held to
scipy's distributions by KS tests, as tests/test_distributions.py holds the
JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

from viabel_tpu import distributions as jd
from viabel_tpu_torch import distributions as td

RTOL = 1e-12


def _inputs(seed=0, n=64, d=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (n, d)), rng.normal(0, 1, d),
            rng.normal(-0.3, 0.5, d))


def _t(a):
    return torch.as_tensor(a)


def test_normal_and_student_t_logpdf():
    x, loc, log_scale = _inputs()
    scale = np.exp(log_scale)
    np.testing.assert_allclose(
        td.normal_logpdf(_t(x), _t(loc), _t(scale)).numpy(),
        np.asarray(jd.normal_logpdf(jnp.asarray(x), loc, scale)), rtol=RTOL)
    np.testing.assert_allclose(
        td.normal_logpdf(_t(x), 0.0, 5.0).numpy(),
        np.asarray(jd.normal_logpdf(jnp.asarray(x), 0.0, 5.0)), rtol=RTOL)
    for df in (3.0, 40.0):
        np.testing.assert_allclose(
            td.student_t_logpdf(_t(x), df, _t(loc), _t(scale)).numpy(),
            np.asarray(jd.student_t_logpdf(jnp.asarray(x), df, loc, scale)),
            rtol=RTOL)


def test_diag_densities():
    x, mean, log_scale = _inputs(1)
    np.testing.assert_allclose(
        td.diag_normal_logpdf(_t(x), _t(mean), _t(log_scale)).numpy(),
        np.asarray(jd.diag_normal_logpdf(jnp.asarray(x), mean, log_scale)),
        rtol=RTOL)
    np.testing.assert_allclose(
        td.diag_student_t_logpdf(_t(x), 40.0, _t(mean), _t(log_scale))
        .numpy(),
        np.asarray(jd.diag_student_t_logpdf(jnp.asarray(x), 40.0, mean,
                                            log_scale)), rtol=RTOL)
    # scipy as a second, independent reference
    np.testing.assert_allclose(
        td.diag_student_t_logpdf(_t(x), 7.0, _t(mean), _t(log_scale))
        .numpy(),
        sps.t(7.0, mean, np.exp(log_scale)).logpdf(x).sum(-1), rtol=1e-10)


def test_densities_differentiate():
    x, mean, log_scale = _inputs(2)
    p = torch.tensor(np.concatenate([mean, log_scale]), requires_grad=True)
    lp = td.diag_student_t_logpdf(_t(x), 40.0, p[:5], p[5:]).sum()
    grad, = torch.autograd.grad(lp, p)
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize('df', [3, 5, 10, 40, 100])
def test_student_t_sample_distribution(df):
    g = torch.Generator().manual_seed(df)
    x = td.student_t_sample(g, df, (120000,), torch.float64).numpy()
    _, p = sps.kstest(x, sps.t(df).cdf)
    assert p > 0.005, 'KS rejected at df={} (p={})'.format(df, p)
    np.testing.assert_allclose(x.var(), df / (df - 2),
                               rtol=0.1 if df > 4 else 0.35)


@pytest.mark.parametrize('df', [3, 5, 10, 40, 100])
def test_chi2_sample_distribution(df):
    g = torch.Generator().manual_seed(100 + df)
    x = td.chi2_sample(g, df, (120000,), torch.float64).numpy()
    _, p = sps.kstest(x, sps.chi2(df).cdf)
    assert p > 0.005, 'KS rejected at df={} (p={})'.format(df, p)
    np.testing.assert_allclose(x.mean(), df, rtol=0.05)


def test_sampler_shapes_dtype_and_determinism():
    x = td.student_t_sample(torch.Generator().manual_seed(0), 40, (100, 3),
                            torch.float32)
    assert x.shape == (100, 3) and x.dtype == torch.float32
    assert torch.isfinite(x).all()
    y = td.student_t_sample(torch.Generator().manual_seed(0), 40, (100, 3),
                            torch.float32)
    assert torch.equal(x, y)  # the generator is the only source of noise


@pytest.mark.parametrize('df', [4.5, 201, 0])
def test_unported_df_raises(df):
    """Non-integer df and df > 200 take the gamma sampler (the JAX
    package's rejection-sampler fallback), driven by the generator alone;
    a df that is not positive raises."""
    if df <= 0:
        for sampler in (td.student_t_sample, td.chi2_sample):
            with pytest.raises(ValueError, match='positive'):
                sampler(torch.Generator(), df, (10,))
        return
    for sampler in (td.student_t_sample, td.chi2_sample):
        x = sampler(torch.Generator().manual_seed(3), df, (10,))
        assert x.dtype == torch.float32 and torch.isfinite(x).all()
        assert torch.equal(x, sampler(torch.Generator().manual_seed(3), df,
                                      (10,)))
