"""The non-centred eight-schools and funnel densities, and the score
kernels' plain versions with them, against the JAX package, float64.

The models' log densities go against ``viabel_tpu.models`` at rtol 1e-12
(funnel points with log_sigma across +-6, where exp(log_sigma) spans five
decades).  K1's plain version with each density, under a Student-t(40)
and a standard normal base, goes against the JAX composition
``model.log_prob(mean + exp(log_scale) z) - family.log_prob(p, x)`` on
shared z, and K2's plain version against the same composition on its own
Philox z: lw at rtol 1e-10, statistics at rtol 1e-10 against
``bounds._log_weight_stats_arrays``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
from viabel_tpu.bounds import _log_weight_stats_arrays
from viabel_tpu.models import eight_schools_ncp_model as jncp
from viabel_tpu.models import funnel_model as jfunnel
from viabel_tpu_torch.bounds import STAT_KEYS
from viabel_tpu_torch.models import eight_schools as te
from viabel_tpu_torch.models import eight_schools_ncp_model as tncp
from viabel_tpu_torch.models import funnel_model as tfunnel
from viabel_tpu_torch.models.funnel import funnel_log_density
from viabel_tpu_torch.ops import gaussian_lw as g
from viabel_tpu_torch.ops import lw_stats as ops
from viabel_tpu_torch.ops.philox import philox_normal_plain

RTOL = 1e-10


def _models(name):
    if name == 'ncp':
        return jncp(), tncp()
    return jfunnel(), tfunnel()


def _fit(name, model):
    """A q the bound pass would meet: near the NCP posterior, or the funnel
    run's start ``[0, -1]`` with unit log-scales (a wide q whose
    log_sigma reaches far into both tails)."""
    if name == 'ncp':
        return np.concatenate([model.true_mean,
                               0.5 * np.log(np.diag(model.true_cov))])
    return np.array([0.0, -1.0, 1.0, 1.0])


def _jax_lw(jm, jfam, vp, z):
    x = jfam.transform(jnp.asarray(vp), jnp.asarray(z))
    return np.asarray(jm.log_prob(x) - jfam.log_prob(jnp.asarray(vp), x))


def _assert_stats(stats, lw_np):
    want = _log_weight_stats_arrays(jnp.asarray(lw_np), 2.0)
    np.testing.assert_allclose(stats.numpy(),
                               [float(want[k]) for k in STAT_KEYS],
                               rtol=RTOL)


def test_ncp_log_density_matches_jax():
    rng = np.random.default_rng(0)
    z = rng.normal(0, 2, (200, 10))
    z[:, 1] = rng.uniform(-6, 4, 200)  # log_tau
    jm, tm = _models('ncp')
    want = np.asarray(jm.log_prob(jnp.asarray(z)))
    y, sigma = tm.kernel_data
    np.testing.assert_allclose(
        te.ncp_log_density(torch.as_tensor(z), y, sigma).numpy(), want,
        rtol=1e-12)
    np.testing.assert_allclose(tm.log_prob(torch.as_tensor(z)).numpy(),
                               want, rtol=1e-12)


@pytest.mark.parametrize('log_sigma_stdev', [1.35, 0.7])
def test_funnel_model_matches_jax(log_sigma_stdev):
    rng = np.random.default_rng(1)
    x = np.stack([rng.normal(0, 30, 400), rng.uniform(-6, 6, 400)], axis=1)
    jm, tm = jfunnel(log_sigma_stdev), tfunnel(log_sigma_stdev)
    want = np.asarray(jm.log_prob(jnp.asarray(x)))
    np.testing.assert_allclose(tm.log_prob(torch.as_tensor(x)).numpy(),
                               want, rtol=1e-12)
    np.testing.assert_allclose(
        funnel_log_density(torch.as_tensor(x), log_sigma_stdev).numpy(),
        want, rtol=1e-12)
    one = tm(torch.as_tensor(x[3]))
    assert one.dim() == 0
    np.testing.assert_allclose(float(one), float(jm.log_prob(
        jnp.asarray(x[3]))), rtol=1e-12)
    assert (tm.dim, tm.name, tm.param_names) == (jm.dim, jm.name,
                                                 jm.param_names)
    np.testing.assert_array_equal(tm.true_mean, jm.true_mean)
    np.testing.assert_allclose(tm.true_cov, jm.true_cov, rtol=1e-15)
    assert tm.kernel == 'funnel'
    assert tm.kernel_data == (log_sigma_stdev,)


def test_kernel_tags():
    assert tncp().kernel == 'eight_schools_ncp'
    np.testing.assert_array_equal(tncp().kernel_data[1].numpy(),
                                  te.EIGHT_SCHOOLS_SIGMA)
    # the CUDA density unrolls J = 8: other school counts carry no kernel
    five = tncp(np.arange(5.0), np.full(5, 2.0))
    assert five.kernel is None and five.kernel_data is None


@pytest.mark.parametrize('name', ['ncp', 'funnel'])
@pytest.mark.parametrize('df', [40.0, None])
def test_k1_plain_matches_jax_composition(name, df):
    jm, tm = _models(name)
    d = tm.dim
    vp = _fit(name, tm)
    jfam = (vt.mean_field_gaussian_variational_family(d) if df is None
            else vt.mean_field_t_variational_family(d, df))
    z = np.random.RandomState(2).standard_t(40, (ops.CHUNK * 2 + 301, d))
    lw, parts = ops.transform_score_partials(
        torch.as_tensor(z), torch.as_tensor(vp[:d]), torch.as_tensor(vp[d:]),
        tm.kernel, tm.kernel_data, df)
    want = _jax_lw(jm, jfam, vp, z)
    np.testing.assert_allclose(lw.numpy(), want, rtol=RTOL)
    assert parts.shape == (3, 6)
    _assert_stats(ops.combine_partials(parts), want)


@pytest.mark.parametrize('name', ['ncp', 'funnel'])
def test_k2_plain_matches_jax_composition(name):
    jm, tm = _models(name)
    d = tm.dim
    vp = _fit(name, tm)
    seed, offset, n = 2 ** 40 + 5, 1, 5000
    lw, parts = g.gaussian_sample_score_partials(
        torch.as_tensor(vp[:d]), torch.as_tensor(vp[d:]), n, seed, offset,
        tm.kernel, tm.kernel_data)
    z = philox_normal_plain(n, d, seed, offset, dtype=torch.float64)
    want = _jax_lw(jm, vt.mean_field_gaussian_variational_family(d), vp,
                   z.numpy())
    np.testing.assert_allclose(lw.numpy(), want, rtol=RTOL)
    _assert_stats(ops.combine_partials(parts), want)


def test_check_kernel_model_takes_each_density_at_its_dimension():
    ncp, funnel = tncp(), tfunnel()
    ops.check_kernel_model(ncp.kernel, ncp.kernel_data, 10, 8)
    ops.check_kernel_model(funnel.kernel, funnel.kernel_data, 2, 4)
    for d in (2, 9, 11):
        with pytest.raises(ValueError, match='d = 10'):
            ops.check_kernel_model(ncp.kernel, ncp.kernel_data, d, 8)
    for d in (1, 3, 10):
        with pytest.raises(ValueError, match='d = 2'):
            ops.check_kernel_model(funnel.kernel, funnel.kernel_data, d, 8)
    with pytest.raises(ValueError, match='8 schools'):
        ops.check_kernel_model(ncp.kernel, (torch.zeros(5), torch.zeros(5)),
                               10, 8)


def test_model_specs_name_the_device_densities():
    """The ModelSpec each tag builds: the kind is the .cuh's ModelKind,
    the NCP stages y and sigma, the funnel stages nothing and carries its
    prior scale and its log."""
    ncp, funnel = tncp(), tfunnel(0.9)
    spec, held = ops.model_spec(ncp.kernel, ncp.kernel_data, 'cpu',
                                torch.float32)
    assert (spec.kind, spec.n_rows) == (2, 8)
    assert spec.a == held[0].data_ptr() and spec.b == held[1].data_ptr()
    spec, held = ops.model_spec(funnel.kernel, funnel.kernel_data, 'cpu',
                                torch.float64)
    assert (spec.kind, spec.n_rows, spec.a, spec.b, held) == (3, 0, None,
                                                              None, ())
    assert spec.prior_std == 0.9 and spec.log_prior == np.log(0.9)
    assert ops.KERNEL_MODELS.index('eight_schools_cp') == 0
    assert ops.KERNEL_MODELS.index('regression') == 1
