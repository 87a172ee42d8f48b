"""The port's experiment harness against viabel_tpu.experiments, float64.

`improve_with_psis` runs on shared samples: both packages'
`get_samples_and_log_weights` are replaced by one that returns the same
samples and log-weights, so PSIS, the weighted moments (on the device, or
on the host through a `transform`) and the accuracy report compare at
rtol 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu import experiments as je
from viabel_tpu.bounds import _log_weight_stats_arrays
from viabel_tpu.models import regression as jr
from viabel_tpu_torch import experiments as te
from viabel_tpu_torch.bounds import STAT_KEYS
from viabel_tpu_torch.models import regression as tr


def _shared(n=4000, seed=0):
    data = jr.data_generator_linear(N=100, D=10, seed=42)
    jm = jr.linear_regression_model(data['X'], data['Y'])
    rs = np.random.RandomState(seed)
    vp = np.concatenate([jm.true_mean + 0.01 * rs.randn(10),
                         0.5 * np.log(np.diag(jm.true_cov))])
    jf = vt.mean_field_gaussian_variational_family(10)
    x = np.array(jf.transform(jnp.asarray(vp), jnp.asarray(
        rs.randn(n, 10))))
    lw = np.array(jm.log_prob(jnp.asarray(x))
                    - jf.log_prob(jnp.asarray(vp), jnp.asarray(x)))
    return jm, tr.linear_regression_model(data['X'], data['Y']), vp, x, lw


@pytest.mark.parametrize('transform', [None, 'exp'])
def test_improve_with_psis_on_shared_samples(monkeypatch, transform):
    jm, tm, vp, x, lw = _shared()
    monkeypatch.setattr(je, 'get_samples_and_log_weights',
                        lambda *a, **k: (jnp.asarray(x), jnp.asarray(lw)))
    monkeypatch.setattr(te, 'get_samples_and_log_weights',
                        lambda *a, **k: (torch.as_tensor(x),
                                         torch.as_tensor(lw)))
    fn = None if transform is None else np.exp
    jres, jmean, jcov = je.improve_with_psis(
        jm.log_prob, vt.mean_field_gaussian_variational_family(10), vp, 4000,
        jm.true_mean, jm.true_cov, transform=fn)
    tres, tmean, tcov = te.improve_with_psis(
        tm, pt.mean_field_gaussian_variational_family(10), vp, 4000,
        tm.true_mean, tm.true_cov, transform=fn, device='cpu')
    assert isinstance(tmean, np.ndarray) and isinstance(tcov, np.ndarray)
    np.testing.assert_allclose(tmean, np.asarray(jmean), rtol=1e-9)
    np.testing.assert_allclose(tcov, np.asarray(jcov), rtol=1e-9, atol=1e-15)
    assert set(tres) == set(jres)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-9)


@pytest.mark.parametrize('n_rows, d', [(50, 40), (2000, 10)])
def test_models_past_the_kernels_limits_take_the_plain_composition(n_rows,
                                                                   d):
    """A regression model too large for the score kernels carries no kernel
    tag; its bound pass draws from the generator, scores by the plain
    composition and matches the JAX package on those draws (rtol 1e-12 on
    the log-weights, 1e-10 on their statistics)."""
    data = jr.data_generator_linear(N=n_rows, D=d, seed=7)
    jm = jr.linear_regression_model(data['X'], data['Y'])
    tm = tr.linear_regression_model(data['X'], data['Y'])
    assert tm.kernel is None
    vp = torch.as_tensor(np.concatenate(
        [jm.true_mean, 0.5 * np.log(np.diag(jm.true_cov))]))
    fam = pt.mean_field_gaussian_variational_family(d)
    jf = vt.mean_field_gaussian_variational_family(d)
    samples, lw = pt.get_samples_and_log_weights(
        tm, fam, vp, 3000, generator=torch.Generator().manual_seed(1),
        device='cpu')
    z = fam.base_sample(torch.Generator().manual_seed(1), 3000,
                        torch.float64)
    assert torch.equal(samples, fam.transform(vp, z))
    x = jnp.asarray(samples.numpy())
    want = np.asarray(jm.log_prob(x) - jf.log_prob(jnp.asarray(vp.numpy()),
                                                     x))
    np.testing.assert_allclose(lw.numpy(), want, rtol=1e-12, atol=1e-10)
    _, _, stats = te.draw_and_score(tm, fam, vp, z)
    jstats = _log_weight_stats_arrays(jnp.asarray(want), 2.0)
    np.testing.assert_allclose(stats.numpy(),
                               [float(jstats[k]) for k in STAT_KEYS],
                               rtol=1e-10)
    res, _, _ = te.improve_with_psis(
        tm, fam, vp, 3000, tm.true_mean, tm.true_cov,
        generator=torch.Generator().manual_seed(2), device='cpu')
    assert np.isfinite(res['khat']) and np.isfinite(res['mean_error'])


def test_psis_correction_returns_transposed_samples():
    _, tm, vp, _, _ = _shared()
    fam = pt.mean_field_gaussian_variational_family(10)
    samples, slw, khat = pt.psis_correction(
        tm, fam, vp, 3000, generator=torch.Generator().manual_seed(0),
        device='cpu')
    assert samples.shape == (10, 3000) and slw.shape == (3000,)
    np.testing.assert_allclose(float(torch.logsumexp(slw, 0)), 0.0,
                               atol=1e-12)
    assert khat.dim() == 0


def test_check_accuracy_and_reports_match(capsys):
    jm, tm, vp, _, _ = _shared()
    rs = np.random.RandomState(2)
    approx_mean = jm.true_mean + 0.1 * rs.randn(10)
    approx_cov = jm.true_cov * 1.3
    want = je.check_accuracy(jm.true_mean, jm.true_cov, approx_mean,
                             approx_cov, method='x')
    got = te.check_accuracy(torch.as_tensor(jm.true_mean), jm.true_cov,
                            torch.as_tensor(approx_mean), approx_cov,
                            method='x')
    assert set(got) == set(want)
    for k in want:
        if k != 'method':
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    got = te.check_approx_accuracy(
        pt.mean_field_gaussian_variational_family(10), vp, tm.true_mean,
        tm.true_cov)
    want = je.check_approx_accuracy(
        vt.mean_field_gaussian_variational_family(10), jnp.asarray(vp),
        jm.true_mean, jm.true_cov)
    for k in want:  # the std errors are ~1e-17 here: rounding
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-14)
    bounds = dict(W2=0.5, d2=0.1, mean_error=0.3, std_error=None,
                  cov_error=0.04)
    je.print_bounds(bounds)
    jtext = capsys.readouterr().out
    te.print_bounds(bounds)
    assert capsys.readouterr().out == jtext
    te.check_accuracy(jm.true_mean, jm.true_cov, approx_mean, approx_cov,
                      verbose=True)
    assert 'mean error' in capsys.readouterr().out
