"""The port's mean-field families against viabel_tpu.families at float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu_torch import interop

RTOL = 1e-12
FAMILIES = [
    ('mf_t', lambda m: m.mean_field_t_variational_family(10, 40)),
    ('mf_t_df3', lambda m: m.mean_field_t_variational_family(10, 3)),
    ('mf_gaussian', lambda m: m.mean_field_gaussian_variational_family(10)),
]


@pytest.mark.parametrize('name,make', FAMILIES, ids=[f[0] for f in FAMILIES])
def test_family_matches(name, make):
    jf, tf = make(vt), make(pt)
    assert (tf.name, tf.dim, tf.var_param_dim) == (jf.name, jf.dim,
                                                   jf.var_param_dim)
    rng = np.random.default_rng(0)
    vp = rng.normal(0, 0.5, 20)
    jvp, tvp = jnp.asarray(vp), interop.var_param(vp)
    z = np.asarray(jf.base_sample(jax.random.PRNGKey(1), 500, jnp.float64))
    x_j = jf.transform(jvp, jnp.asarray(z))
    x_t = tf.transform(tvp, interop.base_draws(z))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=RTOL)
    np.testing.assert_allclose(tf.log_prob(tvp, x_t).numpy(),
                               np.asarray(jf.log_prob(jvp, x_j)), rtol=RTOL)
    np.testing.assert_allclose(float(tf.entropy(tvp)),
                               float(jf.entropy(jvp)), rtol=RTOL)
    for a, b in zip(tf.mean_and_cov(tvp), jf.mean_and_cov(jvp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    for p in (2, 4):
        if name == 'mf_t_df3' and p == 4:  # df <= p: no closed form
            with pytest.raises(pt.NoClosedFormMomentError):
                tf.pth_moment(tvp, p)
            continue
        np.testing.assert_allclose(float(tf.pth_moment(tvp, p)),
                                   float(jf.pth_moment(jvp, p)), rtol=RTOL)
    with pytest.raises(ValueError):
        tf.pth_moment(tvp, 3)


def test_sample_is_transform_of_base_sample():
    fam = pt.mean_field_t_variational_family(3, 40)
    vp = torch.linspace(-1, 1, 6, dtype=torch.float64)
    a = fam.sample(torch.Generator().manual_seed(4), vp, 100)
    b = fam.transform(vp, fam.base_sample(torch.Generator().manual_seed(4),
                                          100, torch.float64))
    assert torch.equal(a, b)


def test_base_sample_statistics():
    """The mf-t base draws are Student-t(df) in every coordinate."""
    import scipy.stats as sps
    fam = pt.mean_field_t_variational_family(4, 5)
    z = fam.base_sample(torch.Generator().manual_seed(0), 30000,
                        torch.float64).numpy()
    for k in range(4):
        assert sps.kstest(z[:, k], sps.t(5).cdf).pvalue > 0.005


def test_constructors_are_memoized_and_validate():
    assert (pt.mean_field_t_variational_family(2, 3)
            is pt.mean_field_t_variational_family(2.0, 3.0))
    assert (pt.mean_field_gaussian_variational_family(2)
            is pt.mean_field_gaussian_variational_family(dim=2))
    with pytest.raises(ValueError):
        pt.mean_field_t_variational_family(2, 2)
    fam = pt.mean_field_t_variational_family(2, 3)
    assert fam.df == 3.0
    assert pt.mean_field_gaussian_variational_family(2).df is None
    p = fam.init_param(torch.float64)
    assert p.shape == (4,) and p.dtype == torch.float64 and not p.any()


@pytest.mark.parametrize('kind', ['mean_field', 'full_rank'])
def test_logdensity_alias_matches_jax(kind):
    """`VariationalFamily.logdensity(x, var_param)`, the reference's
    argument order, is `log_prob(var_param, x)` in both packages
    (viabel_tpu/families.py:138-140)."""
    if kind == 'mean_field':
        jf = vt.mean_field_gaussian_variational_family(4)
        tf = pt.mean_field_gaussian_variational_family(4)
    else:
        jf = vt.full_rank_gaussian_variational_family(4)
        tf = pt.full_rank_gaussian_variational_family(4)
    rng = np.random.default_rng(3)
    vp = rng.normal(0, 0.3, jf.var_param_dim)
    x = rng.normal(0, 1.5, (50, 4))
    got = tf.logdensity(torch.as_tensor(x), interop.var_param(vp))
    np.testing.assert_array_equal(
        got.numpy(), tf.log_prob(interop.var_param(vp),
                                 torch.as_tensor(x)).numpy())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jf.logdensity(jnp.asarray(x),
                                              jnp.asarray(vp))),
        rtol=RTOL)
