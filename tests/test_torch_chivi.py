"""CHIVI, CHIVI under windowed adagrad, and `init_from_moments`, against
the JAX package, float64.

`black_box_chivi`'s value, gradient and log-norm go against the JAX
package's on shared presampled draws at rtol 1e-10.  Adagrad runs on the
JAX package's own draw block (its presampled objective's ``make_draws``
with the key its runner uses) with and without the windowed log-norm
rescaling, for 200 iterations, at rtol 1e-8: the trajectory feeds its own
rounding back for 200 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.models import eight_schools_ncp_model as jncp
from viabel_tpu_torch import interop
from viabel_tpu_torch.models import eight_schools_ncp_model as tncp

N_MC, N_ITERS = 500, 200


def _families(kind):
    if kind == 'mf_t':
        return (vt.mean_field_t_variational_family(10, 40),
                pt.mean_field_t_variational_family(10, 40))
    return (vt.mean_field_gaussian_variational_family(10),
            pt.mean_field_gaussian_variational_family(10))


def _fit(model, shift=0.0):
    return np.concatenate([model.true_mean + shift,
                           0.5 * np.log(np.diag(model.true_cov))])


@pytest.mark.parametrize('kind', ['mf_t', 'mf_gaussian'])
@pytest.mark.parametrize('alpha', [2, 3])
def test_chivi_value_grad_and_log_norm_match_jax(kind, alpha):
    jf, tf = _families(kind)
    jm, tm = jncp(), tncp()
    jobj = vt.black_box_chivi(alpha, jf, jm.log_prob, N_MC, presampled=True)
    tobj = pt.black_box_chivi(alpha, tf, tm, N_MC, presampled=True)
    assert tobj.has_log_norm and tobj.presampled
    z = jf.base_sample(jax.random.PRNGKey(4), N_MC, jnp.float64)
    for shift in (0.0, 0.7):
        vp = _fit(jm, shift)
        jv, jg, jln = jobj(jnp.asarray(vp), z)
        tv, tg, tln = tobj(interop.var_param(vp), interop.base_draws(z))
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-10)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                                   atol=1e-14)
        np.testing.assert_allclose(float(tln), float(jln), rtol=1e-10)
        lw = tobj.compute_log_weights(interop.var_param(vp),
                                      interop.base_draws(z))
        np.testing.assert_allclose(
            lw.numpy(), np.asarray(jobj.compute_log_weights(
                jnp.asarray(vp), z)), rtol=1e-12)


def test_chivi_in_float32_matches_the_float64_value():
    """exp(lw - max)^alpha underflows to 0 for most of 500 draws in
    float32; the mean keeps the max's 1, so the CUBO stays the float64
    one to float32 rounding."""
    jf, tf = _families('mf_t')
    jm, tm = jncp(), tncp()
    z = np.asarray(jf.base_sample(jax.random.PRNGKey(5), N_MC, jnp.float64))
    vp = _fit(jm, 1.5)
    jv = vt.black_box_chivi(2, jf, jm.log_prob, N_MC, presampled=True)(
        jnp.asarray(vp), jnp.asarray(z))[0]
    tobj = pt.black_box_chivi(2, tf, tm, N_MC, presampled=True)
    v32, g32, _ = tobj(interop.var_param(vp, dtype=torch.float32),
                       interop.base_draws(z, dtype=torch.float32))
    assert v32.dtype == torch.float32 and torch.isfinite(g32).all()
    np.testing.assert_allclose(float(v32), float(jv), rtol=1e-5)


def test_chivi_from_a_generator_is_seeded_and_presampled_refuses_one():
    _, tf = _families('mf_t')
    tm = tncp()
    vp = interop.var_param(_fit(tm))
    obj = pt.black_box_chivi(2, tf, tm, 50)
    assert not getattr(obj, 'presampled', False)
    a = obj(vp, torch.Generator().manual_seed(3))
    b = obj(vp, torch.Generator().manual_seed(3))
    c = obj(vp, torch.Generator().manual_seed(4))
    for x, y in zip(a, b):
        assert torch.equal(x, y) and torch.isfinite(x).all()
    assert not torch.equal(a[1], c[1])
    pre = pt.black_box_chivi(2, tf, tm, 50, presampled=True)
    with pytest.raises(TypeError, match='presampled'):
        pre(vp, torch.Generator().manual_seed(3))


@pytest.fixture(scope='module')
def adagrad_reference():
    jf = vt.mean_field_t_variational_family(10, 40)
    jm = jncp()
    jobj = vt.black_box_chivi(2, jf, jm.log_prob, 100, presampled=True)
    init = jnp.asarray(vt.init_from_moments(jf, jm.true_mean, jm.true_cov),
                       dtype=jnp.float64)
    key = jax.random.PRNGKey(21)
    kw = dict(learning_rate=0.01, learning_rate_end=0.001, unroll=1)
    runs = {flag: vt.adagrad_optimize(N_ITERS, jobj, init, key=key,
                                      has_log_norm=flag, **kw)
            for flag in (False, True)}
    draws = interop.presampled_draws(jobj.make_draws(key, N_ITERS,
                                                     jnp.float64))
    return runs, draws, np.array(init)


@pytest.mark.parametrize('has_log_norm', [False, True])
def test_adagrad_with_chivi_matches_jax(adagrad_reference, has_log_norm):
    runs, draws, init = adagrad_reference
    tf = pt.mean_field_t_variational_family(10, 40)
    tobj = pt.black_box_chivi(2, tf, tncp(), 100, presampled=True)
    opt, hist, values, log_norms = pt.adagrad_optimize(
        N_ITERS, tobj, init, has_log_norm=has_log_norm, learning_rate=0.01,
        learning_rate_end=0.001, device='cpu', draws=draws)
    jopt, jhist, jvalues, jlog_norms = runs[has_log_norm]
    np.testing.assert_allclose(opt.numpy(), np.asarray(jopt), rtol=1e-8)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-8)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues),
                               rtol=1e-8)
    np.testing.assert_allclose(log_norms.numpy(), np.asarray(jlog_norms),
                               rtol=1e-8)
    if has_log_norm:  # the rescaling path was taken
        assert np.all(log_norms.numpy() != 0.0)
    else:
        np.testing.assert_array_equal(log_norms.numpy(), 0.0)


def test_adagrad_draws_feed_presampled_objectives_only():
    tf = pt.mean_field_t_variational_family(10, 40)
    obj = pt.black_box_chivi(2, tf, tncp(), 10)
    with pytest.raises(ValueError, match='presampled'):
        pt.adagrad_optimize(5, obj, np.zeros(20), device='cpu',
                            draws=torch.zeros(5, 10, 10))


@pytest.mark.parametrize('kind', ['mf_t', 'mf_gaussian'])
def test_init_from_moments_matches_jax(kind):
    jf, tf = _families(kind)
    jm = jncp()
    got = pt.init_from_moments(tf, jm.true_mean, jm.true_cov)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(vt.init_from_moments(jf, jm.true_mean,
                                                     jm.true_cov)))
    with pytest.raises(ValueError, match='shape'):
        pt.init_from_moments(tf, jm.true_mean[:9], jm.true_cov)


def test_init_from_moments_refuses_full_rank_families():
    """A family that is not mean-field gets the full-rank layout ``[mean,
    log diag L, strict lower L]`` of cov's Cholesky factor, as the JAX
    package's does (the port refused it before it had the full-rank
    families)."""
    full_rank = pt.VariationalFamily(*[None] * 5, 6, 2, 'full_rank_gaussian')
    jfull = vt.full_rank_gaussian_variational_family(2)
    cov = np.array([[2.0, 0.6], [0.6, 1.0]])
    got = pt.init_from_moments(full_rank, np.ones(2), cov)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(vt.init_from_moments(jfull, np.ones(2), cov)))
