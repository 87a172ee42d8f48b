"""The port's bounds against viabel_tpu.bounds, and against analytic
oracles.

`log_weight_stats` on the CPU runs the plain versions of the log-weight
kernels: per-chunk partials, then the rescale-and-Chan combine.  The
inputs here span many chunks, a ragged last chunk and chunks whose
rescale factor underflows, and are held to the JAX package's two-pass
statistics (``bounds._log_weight_stats_arrays``) at float64.  The oracle
tests follow tests/test_bounds.py (closed-form Gaussian alpha-divergences)
at 1e6 samples, with its 5/sqrt(n) Monte Carlo tolerance.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.bounds import _log_weight_stats_arrays
from viabel_tpu_torch import bounds as tb
from viabel_tpu_torch.ops import lw_stats as ops

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')

MC_SAMPLES = 1000000
MC_TOL = 5 / np.sqrt(MC_SAMPLES)


def _lw_cases():
    rng = np.random.default_rng(0)
    n = ops.CHUNK * 37 + 123                 # many chunks, one ragged
    heavy = rng.standard_t(3, n) * 2.0 - 40.0
    under = rng.normal(0, 1, n)
    under[ops.CHUNK * 3:ops.CHUNK * 20] -= 2000.0   # r_b underflows to 0
    return {'heavy': heavy, 'underflow': under,
            'one_chunk': rng.normal(0, 1, 100), 'single': np.array([3.0])}


@pytest.mark.parametrize('case', ['heavy', 'underflow', 'one_chunk',
                                  'single'])
@pytest.mark.parametrize('alpha', [2.0, 3.0])
def test_log_weight_stats_match_two_pass(case, alpha):
    lw = _lw_cases()[case]
    got = pt.log_weight_stats(torch.as_tensor(lw), alpha)
    want = _log_weight_stats_arrays(jnp.asarray(lw), alpha)
    assert got['n'] == lw.size
    for k in tb.STAT_KEYS:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-12,
                                   atol=1e-300, err_msg=k)
        assert np.isfinite(got[k])


# infinite log-weights (a draw outside a model's support, an overflow):
# where the reference's jnp.mean / jnp.std give -inf, +inf or NaN
INF_CASES = {'-inf first': ([0], '-'), '-inf last': ([-1], '-'),
             '-inf at a chunk edge': ([ops.CHUNK - 1, ops.CHUNK], '-'),
             '-inf filling a chunk': (slice(ops.CHUNK, 2 * ops.CHUNK), '-'),
             '+inf': ([5000], '+'), '-inf and +inf': ([7, 9000], '+-')}


def _assert_same_fields(got, want, rtol):
    """Every field: NaN, inf of the same sign, or finite to `rtol`."""
    for k in want:
        g, w = float(got[k]), float(want[k])
        if np.isnan(w) or np.isinf(w):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('case', list(INF_CASES))
def test_infinite_log_weights_match_jax(case, dtype):
    """`log_weight_stats` and `all_bounds` with a log-weight of -inf (at
    the first and last sample, at a chunk edge, filling a whole chunk),
    +inf, or both: the reference's fields, inf and NaN in the same places
    (mean_lw the IEEE mean, std_lw NaN; with -inf, d2 and the W and moment
    bounds inf and log_norm_bound -inf), finite fields to 1e-12 relative
    in float64 and 2e-5 in float32."""
    where, sign = INF_CASES[case]
    lw = np.random.default_rng(2).normal(size=ops.CHUNK * 5 + 100)
    if sign == '+-':
        lw[where[0]], lw[where[1]] = -np.inf, np.inf
    else:
        lw[where] = np.inf if sign == '+' else -np.inf
    lw = lw.astype(dtype)
    rtol = 1e-12 if dtype == np.float64 else 2e-5
    got = pt.log_weight_stats(torch.as_tensor(lw))
    want = _log_weight_stats_arrays(jnp.asarray(lw), 2.0)
    _assert_same_fields(got, want, rtol)
    assert np.isnan(got['std_lw'])
    np.testing.assert_array_equal(
        got['mean_lw'], {'-': -np.inf, '+': np.inf, '+-': np.nan}[sign])
    kw = dict(q_var=np.diag([2.0, 3.0]),
              moment_bound_fn=lambda p: {2: 5.0, 4: 40.0}[p])
    got = pt.all_bounds(torch.as_tensor(lw), **kw)
    want = vt.all_bounds(jnp.asarray(lw), **kw)
    assert sorted(got) == sorted(want)
    _assert_same_fields(got, want, rtol)
    if sign == '-':
        assert got['d2'] == np.inf and got['log_norm_bound'] == -np.inf


def test_partials_layout_and_float32_combine():
    """One row per CHUNK samples (the last ragged), and the float32 combine
    stays within 2e-5 of the float64 two-pass statistics: no one-pass
    variance cancellation."""
    lw = _lw_cases()['heavy']
    parts = ops.lw_partials_plain(torch.as_tensor(lw))
    assert parts.shape == (38, 6)
    np.testing.assert_array_equal(parts[:, 0].numpy(),
                                  [ops.CHUNK] * 37 + [123])
    stats32 = ops.lw_stats(torch.as_tensor(lw, dtype=torch.float32))
    want = _log_weight_stats_arrays(jnp.asarray(lw), 2.0)
    np.testing.assert_allclose(stats32.numpy(),
                               [float(want[k]) for k in tb.STAT_KEYS],
                               rtol=2e-5)


def test_all_bounds_matches_jax():
    rng = np.random.default_rng(1)
    samples = rng.normal(0, 2, (50000, 3))
    lw = -0.5 * np.sum(samples ** 2, 1) / 3.0 + 0.1 * rng.normal(size=50000)
    q_var = np.diag([4.0, 4.0, 4.0])
    for kw in (dict(samples=samples), dict(q_var=q_var, samples=samples),
               dict(q_var=q_var,
                    moment_bound_fn=lambda p: {2: 12.0, 4: 480.0}[p]),
               dict(q_var=q_var, samples=samples, log_norm_bound=-5.0)):
        got = pt.all_bounds(torch.as_tensor(lw), **{
            k: torch.as_tensor(v) if k == 'samples' else v
            for k, v in kw.items()})
        want = vt.all_bounds(lw, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-10,
                                       err_msg=k)


def test_all_bounds_one_dimensional_samples_match_jax():
    """1-D samples: q_var comes from their (1, 1) sample covariance."""
    x = np.random.default_rng(5).normal(0, 1.5, 20000)
    lw = -0.5 * x ** 2 / 2.0 + 0.5 * x ** 2 / 2.25
    got = pt.all_bounds(torch.as_tensor(lw), samples=torch.as_tensor(x))
    want = vt.all_bounds(lw, samples=x)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)


def _gaussian_lw(seed, var1, var2, n=MC_SAMPLES):
    """x ~ N(0, var2); lw = log N(0, var1)(x) - log N(0, var2)(x)."""
    from viabel_tpu_torch.distributions import normal_logpdf
    g = torch.Generator().manual_seed(seed)
    x = np.sqrt(var2) * torch.randn(n, generator=g, dtype=torch.float64)
    return x, (normal_logpdf(x, 0.0, np.sqrt(var1))
               - normal_logpdf(x, 0.0, np.sqrt(var2)))


def _gaussian_alpha_divergence(alpha, var1, var2):
    tmp = alpha * var2 - (alpha - 1) * var1
    return (-0.5 / (alpha - 1) * np.log(tmp)
            + .5 * alpha / (alpha - 1) * np.log(var2) - .5 * np.log(var1))


@pytest.mark.parametrize('alpha', [1.5, 2, 3])
def test_divergence_bound_oracle(alpha):
    var1, var2 = 4, 16
    _, lw = _gaussian_lw(846, var1, var2)
    for elbo in [None, 0]:
        expected = _gaussian_alpha_divergence(alpha, var1, var2)
        if elbo is None:
            expected += alpha / (alpha - 1) * .5 * (
                var2 / var1 + np.log(var1 / var2) - 1)
        np.testing.assert_allclose(pt.divergence_bound(lw, alpha, elbo),
                                   expected, atol=MC_TOL, rtol=MC_TOL)


def test_wasserstein_bounds_oracles():
    d2, stdev = 5.0, 3.5
    samples = stdev * torch.randn(MC_SAMPLES, dtype=torch.float64,
                                  generator=torch.Generator().manual_seed(3))
    res = pt.wasserstein_bounds(d2, samples)
    np.testing.assert_allclose(res['W1'], 2 * stdev * np.sqrt(np.expm1(d2)),
                               rtol=MC_TOL)
    np.testing.assert_allclose(res['W2'],
                               2 * stdev * (3 * np.expm1(d2)) ** 0.25,
                               rtol=2 * MC_TOL)
    moment_fn = lambda p: {2: 4.0, 4: 48.0}[p]
    assert pt.wasserstein_bounds(-1e-4, moment_bound_fn=moment_fn) == {
        'W1': 0.0, 'W2': 0.0}
    res = pt.wasserstein_bounds(1e-17, moment_bound_fn=moment_fn)
    np.testing.assert_allclose(res['W1'], 2 * np.sqrt(4.0 * 1e-17),
                               rtol=1e-12)
    assert np.isinf(pt.wasserstein_bounds(1e6, moment_bound_fn=moment_fn)
                    ['W2'])
    with pytest.raises(ValueError):
        pt.wasserstein_bounds(1.0)


def test_central_moments_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_t(8, (4000, 3))
    got = tb.central_moments(torch.as_tensor(x))
    want = vt.bounds.central_moments(jnp.asarray(x))
    for k in ('C2', 'C4', 'cov'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12)
    assert 'cov' not in tb.central_moments(torch.as_tensor(x), False)


def test_input_validation_and_error_bounds():
    with pytest.raises(ValueError):
        pt.divergence_bound(np.zeros(10), alpha=1.0)
    with pytest.raises(ValueError):
        pt.all_bounds(np.zeros(100), np.zeros(100), alpha=3)
    got = pt.error_bounds(W1=1.0, W2=2.0, q_var=np.eye(2) * 4, p_var=9.0)
    want = vt.error_bounds(W1=1.0, W2=2.0, q_var=np.eye(2) * 4, p_var=9.0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k])


def test_mc_error_warning_category():
    lw = torch.as_tensor(np.random.default_rng(3).normal(0, 10, 100))
    with pytest.warns(tb.MonteCarloErrorWarning, match='ELBO'):
        pt.divergence_bound(lw)


def test_family_moment_bounds_closed_form_and_guard():
    fam = pt.mean_field_t_variational_family(3, 40)
    vp = torch.linspace(-1, 1, 6, dtype=torch.float64)
    fn = pt.family_moment_bounds(fam, vp)
    assert fn(2) == pytest.approx(float(fam.pth_moment(vp, 2)), rel=1e-15)
    assert fn(4) == pytest.approx(float(fam.pth_moment(vp, 4)), rel=1e-15)
    low = pt.mean_field_t_variational_family(3, 3)
    assert pt.family_moment_bounds(low, vp) is None
    assert low in tb._families_without_closed_moments
    assert pt.family_moment_bounds(low, vp) is None   # cached verdict


def test_family_moment_bounds_lru_is_thread_safe():
    """Concurrent callers insert and evict through one lock: no KeyError
    from a move_to_end racing an eviction, and the cap holds."""
    vp = torch.zeros(4, dtype=torch.float64)
    fams = [pt.mean_field_t_variational_family(2, 2.5 + i / 100)
            for i in range(100)]
    errors = []

    def work(offset):
        try:
            for i in range(300):
                pt.family_moment_bounds(fams[(i + offset) % 100], vp)
        except Exception as e:  # record for the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k * 7,))
               for k in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(tb._families_without_closed_moments) <= \
        tb._NO_CLOSED_MOMENTS_CAP
