"""The port's bridge for host-side log densities
(viabel_tpu_torch/models/external.py) against the JAX package's
(viabel_tpu/models/external.py), float64 on the CPU, on the same numpy host
functions; its behaviour under `torch.func`; and the driver rule that
keeps a host density out of CUDA graphs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.models import \
    make_callback_log_density as j_make_callback_log_density
from viabel_tpu_torch import _device, interop
from viabel_tpu_torch.models import Model, make_callback_log_density
from viabel_tpu_torch.models.external import is_host_callback
from viabel_tpu_torch.optimizers import (_adagrad_run, _batched_step,
                                         _wrap_objective)

D = 3
A = np.array([[2.0, 0.4, 0.0], [0.4, 1.0, -0.3], [0.0, -0.3, 0.5]])
B = np.array([0.5, -1.0, 0.25])


def _log_prob_row(x):
    """A non-Gaussian density on one point: a correlated Gaussian, a
    linear tilt and a quartic term."""
    return float(-0.5 * x @ A @ x + B @ x - 0.05 * np.sum(x ** 4))


def _grad_row(x):
    return -(A @ x) + B - 0.2 * x ** 3


def _log_prob_batch(X):
    return (-0.5 * np.einsum('ni,ij,nj->n', X, A, X) + X @ B
            - 0.05 * np.sum(X ** 4, axis=1))


def _grad_batch(X):
    return -(X @ A) + B - 0.2 * X ** 3


def _densities(batched):
    fns = ((_log_prob_batch, _grad_batch) if batched
           else (_log_prob_row, _grad_row))
    return (make_callback_log_density(*fns, D, batched=batched),
            j_make_callback_log_density(*fns, D, batched=batched))


def _points(n, seed=0):
    return np.random.RandomState(seed).randn(n, D)


@pytest.mark.parametrize('batched', [False, True])
def test_value_and_gradient_match_jax(batched):
    """Values and gradients of the same host functions through both
    bridges, rtol 1e-12; one point ``(dim,) -> ()`` as well."""
    t_density, j_density = _densities(batched)
    x = _points(7)
    np.testing.assert_allclose(t_density(torch.tensor(x)).numpy(),
                               np.asarray(j_density(jnp.asarray(x))),
                               rtol=1e-12)
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad((t_density(xt) * torch.arange(7.)).sum(), xt)
    j_g = jax.grad(lambda z: jnp.sum(j_density(z) * jnp.arange(7.)))(
        jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-12)
    one = t_density(torch.tensor(x[2]))
    assert one.shape == ()
    assert float(one) == pytest.approx(_log_prob_row(x[2]), rel=1e-12)
    assert t_density(torch.tensor(x, dtype=torch.float32)).dtype == \
        torch.float32


@pytest.mark.parametrize('batched', [False, True])
def test_under_torch_func(batched):
    """``grad_and_value``, ``vjp`` and ``vmap`` (of both, and of a vjp with
    a weight cotangent, the CHIVI form) give the host gradient, rtol
    1e-12; the vmapped axis reaches the host as part of one batch."""
    density, _ = _densities(batched)
    x = _points(5, 1)
    xt = torch.tensor(x)
    g, v = torch.func.grad_and_value(lambda z: density(z).sum())(xt)
    np.testing.assert_allclose(g.numpy(), _grad_batch(x), rtol=1e-12)
    assert float(v) == pytest.approx(_log_prob_batch(x).sum(), rel=1e-12)
    out, vjp_fn = torch.func.vjp(density, xt)
    w = torch.arange(1.0, 6.0, dtype=torch.float64)
    np.testing.assert_allclose(vjp_fn(w)[0].numpy(),
                               w.numpy()[:, None] * _grad_batch(x),
                               rtol=1e-12)
    xb = _points(4 * 5, 2).reshape(4, 5, D)
    gb, vb = torch.func.vmap(torch.func.grad_and_value(
        lambda z: density(z).mean()))(torch.tensor(xb))
    np.testing.assert_allclose(gb.numpy(), _grad_batch(
        xb.reshape(-1, D)).reshape(4, 5, D) / 5, rtol=1e-12)
    np.testing.assert_allclose(vb.numpy(), _log_prob_batch(
        xb.reshape(-1, D)).reshape(4, 5).mean(axis=1), rtol=1e-12)

    def weighted(z):
        lw, fn = torch.func.vjp(density, z)
        return fn(torch.exp(lw - lw.max()))[0]

    got = torch.func.vmap(weighted)(torch.tensor(xb))
    lw = _log_prob_batch(xb.reshape(-1, D)).reshape(4, 5)
    wts = np.exp(lw - lw.max(axis=1, keepdims=True))
    np.testing.assert_allclose(got.numpy(), wts[..., None] * _grad_batch(
        xb.reshape(-1, D)).reshape(4, 5, D), rtol=1e-12)


def test_vmap_calls_the_host_once_per_batch():
    calls = []

    def log_prob(X):
        calls.append(X.shape)
        return _log_prob_batch(X)

    density = make_callback_log_density(log_prob, _grad_batch, D,
                                        batched=True)
    torch.func.vmap(density)(torch.tensor(_points(12).reshape(3, 4, D)))
    assert calls == [(12, D)]


@pytest.mark.parametrize('batched', [False, True])
def test_adagrad_on_host_density_matches_jax(batched):
    """Presampled KLVI on the host density under `adagrad_optimize` (and
    the state-based run with the JAX package's own draws) against the JAX
    package's run on the same draws, rtol 1e-8; the run is eager."""
    t_density, j_density = _densities(batched)
    n_iters = 60
    jf = vt.mean_field_gaussian_variational_family(D)
    jobj = vt.black_box_klvi(jf, j_density, 8, presampled=True)
    key = jax.random.PRNGKey(3)
    kw = dict(learning_rate=0.05, learning_rate_end=0.005)
    ref = vt.adagrad_optimize(n_iters, jobj, jnp.zeros(2 * D), key=key,
                              unroll=1, **kw)
    draws = interop.presampled_draws(jobj.make_draws(key, n_iters,
                                                     jnp.float64))
    tf = pt.mean_field_gaussian_variational_family(D)
    tobj = pt.black_box_klvi(tf, t_density, 8, presampled=True)
    assert tobj.host_callback
    opt, hist, values, _ = pt.adagrad_optimize(
        n_iters, tobj, torch.zeros(2 * D, dtype=torch.float64), draws=draws,
        device='cpu', **kw)
    np.testing.assert_allclose(opt.numpy(), np.asarray(ref[0]), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(hist.numpy(), np.asarray(ref[1]), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(values.numpy(), np.asarray(ref[2]),
                               rtol=1e-8)


def test_driver_rule_keeps_host_densities_out_of_graphs():
    """The stated rule (`_device.pick_driver`): a host density is never
    captured; asking for the graph with one raises, on the CPU and (by
    the rule alone) on the card, before anything runs."""
    density, _ = _densities(True)
    tf = pt.mean_field_gaussian_variational_family(D)
    model = Model(density, D, 'host')
    for log_density in (density, model):
        assert is_host_callback(log_density)
        for factory in (pt.black_box_klvi, pt.black_box_klvi_pd):
            obj = factory(tf, log_density, 4, presampled=True)
            assert obj.host_callback
            assert _wrap_objective(obj, None).host_callback
            assert _batched_step(obj, None).host_callback
        assert pt.black_box_chivi(2.0, tf, log_density, 4).host_callback
    assert not pt.black_box_klvi(
        tf, lambda x: -0.5 * torch.sum(x ** 2, dim=-1), 4).host_callback
    assert _device.pick_driver(None, 'cuda', True) == 'eager'
    assert _device.pick_driver(None, 'cuda', False) == 'graph'
    assert _device.pick_driver(None, 'cuda', False, False) == 'eager'
    assert _device.pick_driver(None, 'cpu', False) == 'eager'
    for device in ('cpu', 'cuda'):
        with pytest.raises(ValueError, match='host-side log density'):
            _device.pick_driver('graph', device, True)
    obj = pt.black_box_klvi(tf, density, 4, presampled=True)
    draws = obj.make_draws(torch.Generator().manual_seed(0), 5,
                           torch.float64)
    init = torch.zeros(2 * D, dtype=torch.float64)
    with pytest.raises(ValueError, match='host-side log density'):
        _adagrad_run(_wrap_objective(obj, None), 5, 10, 0.01, 0.1, None,
                     init, draws, driver='graph')
    out = _adagrad_run(_wrap_objective(obj, None), 5, 10, 0.01, 0.1, None,
                       init, draws)
    assert np.all(np.isfinite(out[0].numpy()))


def test_ia_chains_on_host_density_match_torch_density():
    """The IA chains' batched step vmaps the host density: RMSProp-IA
    with 2 chains on it equals the same run on a torch density of the
    same function, rtol 1e-10."""
    host, _ = _densities(True)
    At, Bt = torch.tensor(A), torch.tensor(B)

    def torch_density(x):
        return (-0.5 * torch.einsum('...i,ij,...j->...', x, At, x)
                + x @ Bt - 0.05 * torch.sum(x ** 4, dim=-1))

    tf = pt.mean_field_gaussian_variational_family(D)
    outs = []
    for density in (host, torch_density):
        obj = pt.black_box_klvi(tf, density, 10, presampled=True)
        outs.append(pt.rmsprop_IA_optimize_with_rhat(
            40, obj, torch.zeros(2 * D, dtype=torch.float64), D,
            generator=torch.Generator().manual_seed(1), n_optimisers=2,
            rhat_window=10, tail_avg_iters=10, device='cpu'))
    for got, want in zip(outs[0][:2], outs[1][:2]):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
