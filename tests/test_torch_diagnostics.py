"""The port's diagnostics against viabel_tpu.diagnostics, float64.

Both modules are host numpy; the same seeded chains go through each
function of both, compared at rtol 1e-12 (the same arithmetic, so only
summation order could differ).
"""
import numpy as np
import pytest

from viabel_tpu import diagnostics as jd
from viabel_tpu_torch import diagnostics as td

RTOL = 1e-12


def _chains(seed=0, n_chains=4, n_iters=1000, K=6):
    rs = np.random.RandomState(seed)
    # AR(1) chains with chain-specific offsets, so R-hat and ESS are
    # away from their trivial values
    x = np.zeros((n_chains, n_iters, K))
    noise = rs.randn(n_chains, n_iters, K)
    for i in range(1, n_iters):
        x[:, i] = 0.8 * x[:, i - 1] + noise[:, i]
    return x + 0.3 * rs.randn(n_chains, 1, K)


@pytest.mark.parametrize('warmup', [0, 100, 501])
def test_compute_R_hat_matches(warmup):
    c = _chains()
    for got, want in zip(td.compute_R_hat(c, warmup=warmup),
                         jd.compute_R_hat(c, warmup=warmup)):
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize('window', [50, 100, 333, 2000])
def test_compute_R_hat_adaptive_matches(window):
    c = _chains(1)
    got = td.compute_R_hat_adaptive(c, window_size=window)
    np.testing.assert_allclose(got, jd.compute_R_hat_adaptive(
        c, window_size=window), rtol=RTOL)
    assert td.compute_R_hat_adaptive_numpy is td.compute_R_hat_adaptive


@pytest.mark.parametrize('interval,start', [(100, 200), (50, 1000)])
def test_compute_R_hat_halfway_matches(interval, start):
    c = _chains(2)
    np.testing.assert_allclose(
        td.compute_R_hat_halfway(c, interval=interval, start=start),
        jd.compute_R_hat_halfway(c, interval=interval, start=start),
        rtol=RTOL)


def test_split_rhat_needs_four_iterations():
    c = _chains(n_iters=3)
    with pytest.raises(ValueError, match='at least 4'):
        td.compute_R_hat(c, warmup=0)
    with pytest.raises(ValueError):
        jd.compute_R_hat(c, warmup=0)


@pytest.mark.parametrize('shape', [(4, 500), (3, 400, 5), (1, 300, 2)])
def test_effective_sample_size_matches(shape):
    rs = np.random.RandomState(3)
    x = np.cumsum(rs.randn(*shape), axis=1) * 0.1 + rs.randn(*shape)
    np.testing.assert_allclose(td.effective_sample_size(x),
                               jd.effective_sample_size(x), rtol=RTOL)


@pytest.mark.parametrize('start', [0, 10, 299])
def test_stochastic_iterate_averaging_matches(start):
    est = np.random.RandomState(4).randn(300, 7)
    got, got_mean = td.stochastic_iterate_averaging(est, start)
    want, want_mean = jd.stochastic_iterate_averaging(est, start)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got_mean, want_mean, rtol=RTOL)
    with pytest.raises(ValueError):
        td.stochastic_iterate_averaging(est, 300)


def test_compute_posterior_moments_matches():
    rs = np.random.RandomState(5)
    x = rs.randn(40, 4)
    y = x @ rs.randn(4) + 0.5 * rs.randn(40)
    prior_cov = np.diag([4.0, 9.0, 1.0, 2.5])
    args = (rs.randn(4), prior_cov, 0.25, x, y)
    for got, want in zip(td.compute_posterior_moments(*args),
                         jd.compute_posterior_moments(*args)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
