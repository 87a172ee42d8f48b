"""The port's PSIS against viabel_tpu.psis at float64.

float64 keeps tied weights out of the tail boundary, where `torch.topk`
and ``lax.top_k`` may order ties differently (viabel_tpu/psis.py:145-150).
The oracle values are those of tests/test_psis.py, on the same
JAX-generated log-weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viabel_tpu import psis as jp
from viabel_tpu_torch import psis as tp

# (seed, n, dist) -> (khat, smoothed[:5], max), from tests/test_psis.py
_ORACLE = {
    (0, 4000, 'lognormal'): (
        0.4299937356,
        [-9.6887458295, -10.557131285, -6.6379478972, -9.098216601,
         -9.2586807988],
        -4.005192692353574),
    (1, 20000, 'frechet'): (
        0.7275445881,
        [-11.4956290904, -10.7996031521, -10.564370621, -9.7846731721,
         -11.2922764043],
        -3.4379327095319687),
    (2, 4000, 'normal'): (
        0.0715072742,
        [-8.4042726679, -8.6597956256, -8.2182335103, -8.3933135769,
         -8.5567221765],
        -7.1385720164705075),
}


def _make_lw(seed, n, dist):
    key = jax.random.PRNGKey(seed)
    if dist == 'lognormal':
        return np.array(1.5 * jax.random.normal(key, (n,), jnp.float64))
    if dist == 'frechet':
        u = jax.random.uniform(key, (n,), dtype=jnp.float64,
                               minval=1e-12, maxval=1 - 1e-12)
        return np.array(0.7 * -jnp.log(-jnp.log(u)))
    return np.array(0.3 * jax.random.normal(key, (n,), jnp.float64))


@pytest.mark.parametrize('case', list(_ORACLE))
def test_psislw_matches_jax_and_oracle(case):
    lw = _make_lw(*case)
    smoothed, khat = tp.psislw(torch.as_tensor(lw))
    j_smoothed, j_khat = jp.psislw(jnp.asarray(lw))
    np.testing.assert_allclose(smoothed.numpy(), np.asarray(j_smoothed),
                               rtol=1e-10)
    np.testing.assert_allclose(float(khat), float(j_khat), rtol=1e-10)
    exp_k, exp_head, exp_max = _ORACLE[case]
    np.testing.assert_allclose(float(khat), exp_k, rtol=1e-8)
    np.testing.assert_allclose(smoothed.numpy()[:5], exp_head, rtol=1e-8)
    np.testing.assert_allclose(float(smoothed.max()), exp_max, rtol=1e-8)
    np.testing.assert_allclose(float(torch.exp(smoothed).sum()), 1.0,
                               rtol=1e-10)


def test_psislw_2d_columns_and_reff():
    lw = np.stack([_make_lw(0, 4000, 'lognormal'),
                   _make_lw(2, 4000, 'normal')], axis=1)
    for reff in (1.0, 0.3):
        out, ks = tp.psislw(torch.as_tensor(lw), Reff=reff)
        j_out, j_ks = jp.psislw(jnp.asarray(lw), Reff=reff)
        assert out.shape == (4000, 2) and ks.shape == (2,)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   rtol=1e-10)
        np.testing.assert_allclose(ks.numpy(), np.asarray(j_ks), rtol=1e-10)


def test_short_tail_khat_inf_and_validation():
    lw = np.random.default_rng(0).normal(size=16)
    _, khat = tp.psislw(torch.as_tensor(lw))
    assert np.isinf(float(khat))
    with pytest.raises(ValueError):
        tp.psislw(torch.zeros(1))
    with pytest.raises(ValueError):
        tp.psislw(torch.zeros(2, 2, 2))


def test_gpdfit_gpinv_and_sumlogs():
    p = torch.linspace(0.05, 0.95, 7, dtype=torch.float64)
    for k in (0.0, 0.3, -0.2):
        np.testing.assert_allclose(
            tp.gpinv(p, torch.tensor(k, dtype=torch.float64),
                     torch.tensor(2.0, dtype=torch.float64)).numpy(),
            np.asarray(jp.gpinv(jnp.asarray(p.numpy()), k, 2.0)),
            rtol=1e-13)
    assert torch.isnan(tp.gpinv(p, torch.tensor(0.3, dtype=torch.float64),
                                torch.tensor(-1.0, dtype=torch.float64))
                       ).all()
    x = np.random.default_rng(1).normal(size=(30, 4))
    np.testing.assert_allclose(tp.sumlogs(torch.as_tensor(x)).numpy(),
                               np.asarray(jp.sumlogs(x)), rtol=1e-13)
    np.testing.assert_allclose(tp.sumlogs(torch.as_tensor(x), axis=0)
                               .numpy(), np.asarray(jp.sumlogs(x, axis=0)),
                               rtol=1e-13)


def test_psisloo_matches_jax_in_both_shapes():
    rng = np.random.default_rng(2)
    log_lik = rng.normal(-1.0, 0.7, (3000, 3))
    for arr in (log_lik, log_lik[:, 0]):
        loo, loos, ks = tp.psisloo(torch.as_tensor(arr))
        j_loo, j_loos, j_ks = jp.psisloo(jnp.asarray(arr))
        assert np.shape(loos) == np.shape(j_loos)
        assert np.shape(ks) == np.shape(j_ks)
        np.testing.assert_allclose(loo, j_loo, rtol=1e-12)
        np.testing.assert_allclose(loos, j_loos, rtol=1e-12)
        np.testing.assert_allclose(ks, j_ks, rtol=1e-10)


def test_weighted_moments_match_jax():
    rng = np.random.default_rng(3)
    samples = rng.normal(size=(5000, 4))
    slw = rng.normal(size=5000) * 2
    got = tp.weighted_moments(torch.as_tensor(samples), torch.as_tensor(slw))
    want = jp.weighted_moments(jnp.asarray(samples), jnp.asarray(slw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
