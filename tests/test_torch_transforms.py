"""The port's constrained-parameter transforms and normal-mixture model
against the JAX package's (viabel_tpu.transforms, viabel_tpu.models.mixture)
on shared points, float64, rtol 1e-12; the transforms' Jacobians against
autograd, and a lifted density driving the port's KLVI fit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu_torch as pt
from viabel_tpu import transforms as jt
from viabel_tpu.models import mixture as jmix
from viabel_tpu_torch import transforms as tt
from viabel_tpu_torch.models import mixture as tmix

RTOL = 1e-12


def _pair(name, *args):
    return getattr(jt, name)(*args), getattr(tt, name)(*args)


TRANSFORMS = [('identity_transform', ()), ('positive_transform', ()),
              ('lower_bounded_transform', (1.5,)),
              ('interval_transform', (-1.0, 3.0))]


@pytest.mark.parametrize('name,args', TRANSFORMS)
def test_transform_matches_jax(name, args):
    j, t = _pair(name, *args)
    assert t.name == j.name
    z = np.random.RandomState(0).randn(50) * 3.0
    z = np.concatenate([z, [-40.0, 0.0, 40.0]])
    x_j = np.asarray(j.constrain(jnp.asarray(z)))
    x_t = t.constrain(torch.as_tensor(z))
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=RTOL)
    inside = z[np.abs(z) < 30]
    x_in = np.array(j.constrain(jnp.asarray(inside)))
    np.testing.assert_allclose(
        t.unconstrain(torch.as_tensor(x_in)).numpy(),
        np.asarray(j.unconstrain(jnp.asarray(x_in))), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(
        t.log_det_jacobian(torch.as_tensor(z)).numpy(),
        np.asarray(j.log_det_jacobian(jnp.asarray(z))), rtol=RTOL,
        atol=1e-14)


@pytest.mark.parametrize('name,args', TRANSFORMS)
def test_transform_round_trip_and_jacobian_by_autograd(name, args):
    t = getattr(tt, name)(*args)
    z = torch.linspace(-2, 2, 9, dtype=torch.float64)
    np.testing.assert_allclose(t.unconstrain(t.constrain(z)).numpy(),
                               z.numpy(), rtol=1e-8)
    zz = z.clone().requires_grad_(True)
    grad, = torch.autograd.grad(t.constrain(zz).sum(), zz)
    np.testing.assert_allclose(t.log_det_jacobian(z).numpy(),
                               np.log(np.abs(grad.numpy())), rtol=1e-10)


def _constrained_density(lib):
    """x0 ~ N(0, 1), x1 ~ LogNormal(0, 0.5), x2 ~ Uniform(-1, 3)."""
    def density(x):
        return (-0.5 * x[:, 0] ** 2
                - 0.5 * (lib.log(x[:, 1]) / 0.5) ** 2 - lib.log(x[:, 1])
                + 0.0 * x[:, 2])
    return density


def test_parameter_transforms_match_jax():
    spec = [('identity_transform', ()), ('positive_transform', ()),
            ('interval_transform', (-1.0, 3.0))]
    jts = jt.ParameterTransforms([getattr(jt, n)(*a) for n, a in spec])
    tts = tt.ParameterTransforms([getattr(tt, n)(*a) for n, a in spec])
    assert tts.dim == jts.dim == 3
    z = np.random.RandomState(1).randn(7, 3)
    for method in ('constrain', 'log_det_jacobian'):
        np.testing.assert_allclose(
            getattr(tts, method)(torch.as_tensor(z)).numpy(),
            np.asarray(getattr(jts, method)(jnp.asarray(z))), rtol=RTOL)
    x = np.array(jts.constrain(jnp.asarray(z)))
    np.testing.assert_allclose(tts.unconstrain(torch.as_tensor(x)).numpy(),
                               np.asarray(jts.unconstrain(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-14)
    lifted_j = jts.transformed_log_density(_constrained_density(jnp))
    lifted_t = tts.transformed_log_density(_constrained_density(torch))
    np.testing.assert_allclose(lifted_t(torch.as_tensor(z)).numpy(),
                               np.asarray(lifted_j(jnp.asarray(z))),
                               rtol=RTOL)
    # one point in, a scalar out
    one = lifted_t(torch.as_tensor(z[0]))
    assert one.dim() == 0
    np.testing.assert_allclose(float(one), float(lifted_j(jnp.asarray(z[0]))),
                               rtol=RTOL)


def test_lifted_density_drives_the_port_fit():
    """On the unconstrained scale x0 ~ N(0, 1), log x1 ~ N(0, 0.5): the
    port's presampled KLVI under adagrad recovers both (the JAX package's
    test_transformed_density_usable_in_vi)."""
    t = pt.ParameterTransforms([pt.identity_transform(),
                                pt.positive_transform()])

    def constrained(x):
        return (-0.5 * x[:, 0] ** 2 - 0.5 * (torch.log(x[:, 1]) / 0.5) ** 2
                - torch.log(x[:, 1]))

    fam = pt.mean_field_gaussian_variational_family(2)
    obj = pt.black_box_klvi(fam, t.transformed_log_density(constrained), 100,
                            presampled=True)
    opt, _, _, _ = pt.adagrad_optimize(
        1500, obj, torch.zeros(4, dtype=torch.float64), learning_rate=.05,
        generator=torch.Generator().manual_seed(0), device='cpu')
    mean, cov = fam.mean_and_cov(opt)
    np.testing.assert_allclose(mean.numpy(), [0.0, 0.0], atol=0.05)
    np.testing.assert_allclose(np.sqrt(np.diag(cov.numpy())), [1.0, 0.5],
                               atol=0.07)


@pytest.mark.parametrize('shape', [(40,), (40, 1), (1,)])
def test_normal_mixture_matches_jax(shape):
    jm, tm = jmix.normal_mixture_model(), tmix.normal_mixture_model()
    x = np.random.RandomState(2).randn(*shape) * 4.0
    got = tm.log_prob(torch.as_tensor(x))
    want = np.asarray(jm.log_prob(jnp.asarray(x)))
    assert tuple(got.shape) == want.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert (tm.dim, tm.name, tm.param_names) == (jm.dim, jm.name,
                                                 jm.param_names)
    np.testing.assert_array_equal(tm.true_mean, jm.true_mean)
    np.testing.assert_array_equal(tm.true_cov, jm.true_cov)
    assert tm.kernel is None  # scored by the plain composition, then K3


def test_normal_mixture_other_components_match_jax():
    jm = jmix.normal_mixture_model(locs=(-1.0, 3.5), scale=0.7)
    tm = tmix.normal_mixture_model(locs=(-1.0, 3.5), scale=0.7)
    x = np.linspace(-6, 8, 29)
    np.testing.assert_allclose(tm.log_prob(torch.as_tensor(x)).numpy(),
                               np.asarray(jm.log_prob(jnp.asarray(x))),
                               rtol=RTOL)
    np.testing.assert_allclose(tm.true_cov, jm.true_cov, rtol=RTOL)
