"""The port's eight-schools models against viabel_tpu.models at float64."""
import jax.numpy as jnp
import numpy as np
import torch

from viabel_tpu.models import eight_schools as je
from viabel_tpu_torch.models import eight_schools as te


def _points(seed=0, n=50):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 2, (n, 10))
    z[:, 1] = rng.normal(1, 1.5, n)  # log_tau
    return z


def test_cp_and_ncp_log_prob_match():
    z = _points()
    for jmodel, tmodel in ((je.eight_schools_cp_model(),
                            te.eight_schools_cp_model()),
                           (je.eight_schools_ncp_model(),
                            te.eight_schools_ncp_model())):
        assert tmodel.dim == jmodel.dim == 10
        assert tmodel.name == jmodel.name
        assert tmodel.param_names == jmodel.param_names
        np.testing.assert_allclose(
            tmodel.log_prob(torch.as_tensor(z)).numpy(),
            np.asarray(jmodel.log_prob(jnp.asarray(z))), rtol=1e-12)
        # one point: a scalar, as in the JAX package
        one = tmodel(torch.as_tensor(z[0]))
        assert one.dim() == 0
        np.testing.assert_allclose(float(one),
                                   float(jmodel.log_prob(jnp.asarray(z[0]))),
                                   rtol=1e-12)
        np.testing.assert_array_equal(tmodel.true_mean, jmodel.true_mean)
        np.testing.assert_array_equal(tmodel.true_cov, jmodel.true_cov)


def test_custom_data_and_kernel_tag():
    y, sigma = np.arange(8.0), np.full(8, 3.0)
    z = _points(1)
    t = te.eight_schools_cp_model(y, sigma)
    j = je.eight_schools_cp_model(y, sigma)
    np.testing.assert_allclose(t.log_prob(torch.as_tensor(z)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(z))),
                               rtol=1e-12)
    assert t.true_mean is None
    assert t.kernel == 'eight_schools_cp'
    np.testing.assert_array_equal(t.kernel_data[0].numpy(), y)
    # the CUDA density unrolls J = 8; other data sizes have no kernel
    assert te.eight_schools_cp_model(y[:5], sigma[:5]).kernel is None
    assert te.eight_schools_ncp_model().kernel == 'eight_schools_ncp'
    assert te.eight_schools_ncp_model(y[:5], sigma[:5]).kernel is None


def test_log_prob_follows_input_dtype():
    z = torch.as_tensor(_points(2), dtype=torch.float32)
    lp = te.eight_schools_cp_model().log_prob(z)
    assert lp.dtype == torch.float32
    np.testing.assert_allclose(
        lp.numpy(),
        te.eight_schools_cp_model().log_prob(z.double()).numpy(), rtol=1e-5)


def test_ncp_to_cp():
    z = _points(3)
    want = je.eight_schools_ncp_to_cp(z)
    np.testing.assert_allclose(te.eight_schools_ncp_to_cp(z), want,
                               rtol=1e-15)
    np.testing.assert_allclose(
        te.eight_schools_ncp_to_cp(torch.as_tensor(z)).numpy(), want,
        rtol=1e-15)


def test_kernel_data_is_a_snapshot_with_one_cache():
    """The model copies its data when it is made, `kernel_data_like` and
    `log_prob` share one converted copy per dtype, and other data gives
    another `ModelSpec`."""
    from viabel_tpu_torch.models import (funnel_model,
                                         robust_regression_model)
    from viabel_tpu_torch.ops import lw_stats as ops

    y, sigma = np.arange(8.0), np.full(8, 3.0)
    t = te.eight_schools_cp_model(y, sigma)
    z = torch.as_tensor(_points(4), dtype=torch.float32)
    before = t.log_prob(z)
    y[0] = 100.0    # the caller's array changes after the model was made
    np.testing.assert_array_equal(t.kernel_data[0].numpy(), np.arange(8.0))
    np.testing.assert_array_equal(t.log_prob(z).numpy(), before.numpy())
    like = t.kernel_data_like(z)
    assert all(a.dtype == torch.float32 for a in like)
    assert all(a is b for a, b in zip(like, t.kernel_data_like(z)))
    np.testing.assert_array_equal(like[0].numpy(),
                                  np.arange(8.0, dtype=np.float32))
    spec, held = ops.model_spec(t.kernel, like, 'cpu', torch.float32)
    assert spec.a == like[0].data_ptr() == held[0].data_ptr()  # no copy
    changed = te.eight_schools_cp_model(y, sigma)
    spec2, held2 = ops.model_spec(changed.kernel, changed.kernel_data_like(z),
                                  'cpu', torch.float32)
    assert spec2.a != spec.a and float(held2[0][0]) == 100.0
    # scalars ride along; a model without tensors returns its kernel_data
    robust = robust_regression_model()
    rl = robust.kernel_data_like(z)
    assert rl[0].dtype == torch.float32 and rl[2:] == robust.kernel_data[2:]
    funnel = funnel_model()
    assert funnel.kernel_data_like(z) is funnel.kernel_data
