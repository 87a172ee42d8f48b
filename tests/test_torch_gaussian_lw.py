"""The bound-pass kernels' plain versions with the regression density
against the JAX package's compositions, float64.

K2's plain version draws z from the Philox stream; the same z, handed to
the JAX package, gives ``log p(transform(p, z)) - log q(x)`` through its
models and families, and the statistics go against
``bounds._log_weight_stats_arrays``.  K1's plain version with the
regression density is held the same way under a mean-field t(40) family.
Tolerance: rtol 1e-12 (the same arithmetic; sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.bounds import _log_weight_stats_arrays
from viabel_tpu.models import regression as jr
from viabel_tpu_torch.bounds import STAT_KEYS
from viabel_tpu_torch.models import eight_schools_cp_model
from viabel_tpu_torch.models import regression as tr
from viabel_tpu_torch.ops import gaussian_lw as g
from viabel_tpu_torch.ops import lw_stats as ops
from viabel_tpu_torch.ops.philox import philox_normal_plain, philox_seed

RTOL = 1e-12
SEED, OFFSET = 2 ** 40 + 17, 3


def _linear():
    data = jr.data_generator_linear(N=100, D=10, seed=42)
    return (jr.linear_regression_model(data['X'], data['Y']),
            tr.linear_regression_model(data['X'], data['Y']))


def _robust():
    return jr.robust_regression_model(), tr.robust_regression_model()


def _fit(model, widen=1.0):
    """A q near the posterior: its mean and (widened) marginal scales."""
    return np.concatenate([model.true_mean, 0.5 * np.log(
        widen * np.diag(model.true_cov))])


def _jax_lw(jm, jfam, vp, z):
    x = jfam.transform(jnp.asarray(vp), jnp.asarray(z))
    return np.asarray(jm.log_prob(x) - jfam.log_prob(jnp.asarray(vp), x))


def _assert_stats(stats, lw_np):
    want = _log_weight_stats_arrays(jnp.asarray(lw_np), 2.0)
    np.testing.assert_allclose(stats.numpy(),
                               [float(want[k]) for k in STAT_KEYS],
                               rtol=1e-10)


@pytest.mark.parametrize('make', [_linear, _robust])
@pytest.mark.parametrize('n', [1, 2048, 5000])
def test_k2_plain_matches_jax_composition(make, n):
    jm, tm = make()
    d = tm.dim
    vp = _fit(tm, widen=1.5)
    jfam = vt.mean_field_gaussian_variational_family(d)
    mean, log_std = (torch.as_tensor(a) for a in (vp[:d], vp[d:]))
    lw, parts = g.gaussian_sample_score_partials(
        mean, log_std, n, SEED, OFFSET, tm.kernel, tm.kernel_data)
    z = philox_normal_plain(n, d, SEED, OFFSET, dtype=torch.float64)
    want = _jax_lw(jm, jfam, vp, z.numpy())
    np.testing.assert_allclose(lw.numpy(), want, rtol=RTOL, atol=1e-10)
    assert parts.shape == (-(-n // ops.CHUNK), 6)
    _assert_stats(ops.combine_partials(parts), want)


def test_k2_plain_on_eight_schools_matches_jax():
    from viabel_tpu.models import eight_schools_cp_model as jcp
    jm, tm = jcp(), eight_schools_cp_model()
    vp = _fit(tm)
    jfam = vt.mean_field_gaussian_variational_family(10)
    lw, _ = g.gaussian_sample_score_partials(
        torch.as_tensor(vp[:10]), torch.as_tensor(vp[10:]), 3000, 5, 0,
        tm.kernel, tm.kernel_data)
    z = philox_normal_plain(3000, 10, 5, 0, dtype=torch.float64)
    np.testing.assert_allclose(lw.numpy(), _jax_lw(jm, jfam, vp, z.numpy()),
                               rtol=RTOL, atol=1e-10)


@pytest.mark.parametrize('make', [_linear, _robust])
@pytest.mark.parametrize('df', [40.0, None])
def test_k1_plain_with_the_regression_density_matches_jax(make, df):
    jm, tm = make()
    d = tm.dim
    vp = _fit(tm)
    if df is None:
        jfam = vt.mean_field_gaussian_variational_family(d)
    else:
        jfam = vt.mean_field_t_variational_family(d, df)
    z = np.random.RandomState(1).standard_t(40, (4100, d))
    lw, parts = ops.transform_score_partials(
        torch.as_tensor(z), torch.as_tensor(vp[:d]), torch.as_tensor(vp[d:]),
        tm.kernel, tm.kernel_data, df)
    want = _jax_lw(jm, jfam, vp, z)
    np.testing.assert_allclose(lw.numpy(), want, rtol=RTOL, atol=1e-10)
    _assert_stats(ops.combine_partials(parts), want)


def test_bound_pass_dispatch_on_the_cpu():
    """A Gaussian q of a kernel-tagged model draws from the Philox stream
    of a seed taken from the generator (K2's plain version); its samples
    are that stream's, and its log-weights score them."""
    _, tm = _linear()
    fam = pt.mean_field_gaussian_variational_family(10)
    vp = torch.as_tensor(_fit(tm))
    samples, lw = pt.get_samples_and_log_weights(
        tm, fam, vp, 3000, generator=torch.Generator().manual_seed(4),
        device='cpu')
    seed = philox_seed(torch.Generator().manual_seed(4))
    z = philox_normal_plain(3000, 10, seed, 0, dtype=torch.float64)
    assert torch.equal(samples, fam.transform(vp, z))
    np.testing.assert_allclose(
        lw.numpy(), (tm.log_prob(samples) - fam.log_prob(vp, samples)).numpy(),
        rtol=RTOL, atol=1e-10)
    # an untagged density takes base draws from the generator
    s2, lw2 = pt.get_samples_and_log_weights(
        tm.log_prob, fam, vp, 3000, generator=torch.Generator().manual_seed(4),
        device='cpu')
    z2 = fam.base_sample(torch.Generator().manual_seed(4), 3000,
                         torch.float64)
    assert torch.equal(s2, fam.transform(vp, z2))


def test_wrappers_reject_bad_inputs():
    _, tm = _linear()
    mean, log_std = torch.zeros(10, dtype=torch.float64), torch.zeros(10)
    with pytest.raises(TypeError):  # dtypes differ
        g.gaussian_sample_score_partials(mean, log_std, 10, 0, 0, tm.kernel,
                                         tm.kernel_data)
    log_std = log_std.double()
    with pytest.raises(ValueError):  # no such density
        g.gaussian_sample_score_partials(mean, log_std, 10, 0, 0,
                                         'no_such_density', tm.kernel_data)
    with pytest.raises(ValueError):  # the data's width is not d
        g.gaussian_sample_score_partials(mean[:9], log_std[:9], 10, 0, 0,
                                         tm.kernel, tm.kernel_data)
    def data(n_rows, d):
        return (torch.ones((n_rows, d), dtype=torch.float64),
                torch.ones(n_rows, dtype=torch.float64), None, 0.5, 10.0)

    with pytest.raises(ValueError):  # above the kernels' largest d
        ops.check_kernel_model('regression', data(5, 40), 40, 8)
    with pytest.raises(ValueError):  # too much data for shared memory
        ops.check_kernel_model('regression', data(3000, 10), 10, 8)
    with pytest.raises(ValueError):
        g.gaussian_sample_score_partials(mean, log_std, 0, 0, 0, tm.kernel,
                                         tm.kernel_data)
    with pytest.raises(ValueError):
        g.gaussian_sample_score_partials(mean, log_std, 10, 2 ** 64, 0,
                                         tm.kernel, tm.kernel_data)
