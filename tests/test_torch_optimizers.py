"""The port's windowed adagrad against viabel_tpu.optimizers, float64.

The JAX package's own draws (its presampled objective's ``make_draws``
with the key its runner uses) feed both packages, so whole trajectories
compare at rtol 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.models import eight_schools_cp_model as jcp
from viabel_tpu_torch import interop
from viabel_tpu_torch.models import eight_schools_cp_model as tcp
from viabel_tpu_torch.optimizers import _adagrad_run, _wrap_objective

N_ITERS = 200


@pytest.mark.parametrize('lr_end', [None, 0.002])
def test_learning_rate_schedule_matches(lr_end):
    got = [pt.learning_rate_schedule(i, 100, 0.01, lr_end)
           for i in range(100)]
    want = [float(vt.learning_rate_schedule(i, 100, 0.01, lr_end))
            for i in range(100)]
    np.testing.assert_allclose(got, want, rtol=1e-15)


def test_learning_rate_schedule_validates():
    with pytest.raises(ValueError):
        pt.learning_rate_schedule(0, 10, 0.0)
    with pytest.raises(ValueError):
        pt.learning_rate_schedule(0, 10, 0.01, 0.02)


@pytest.fixture(scope='module')
def reference():
    jf = vt.mean_field_t_variational_family(10, 40)
    jobj = vt.black_box_klvi(jf, jcp().log_prob, 20, presampled=True)
    init = jnp.zeros(20, dtype=jnp.float64)
    key = jax.random.PRNGKey(11)
    kw = dict(learning_rate=0.01, learning_rate_end=0.001, unroll=1)
    with_hist = vt.adagrad_optimize(N_ITERS, jobj, init, key=key, **kw)
    without = vt.adagrad_optimize(N_ITERS, jobj, init, key=key,
                                  return_history=False, **kw)
    draws = jobj.make_draws(key, N_ITERS, jnp.float64)
    return with_hist, without, interop.presampled_draws(draws)


@pytest.mark.parametrize('keep_history', [True, False])
def test_adagrad_trajectory_matches(reference, keep_history):
    with_hist, without, draws = reference
    tf = pt.mean_field_t_variational_family(10, 40)
    tobj = pt.black_box_klvi(tf, tcp(), 20, presampled=True)
    values, log_norms, params, tail_mean = _adagrad_run(
        _wrap_objective(tobj, None), N_ITERS, 10, 0.01, 0.1, 0.001,
        torch.zeros(20, dtype=torch.float64), draws,
        keep_history=keep_history)
    ref = with_hist if keep_history else without
    np.testing.assert_allclose(tail_mean.numpy(), np.asarray(ref[0]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(values.numpy(), np.asarray(ref[2]), rtol=1e-9)
    np.testing.assert_array_equal(log_norms.numpy(), 0.0)
    if keep_history:
        np.testing.assert_allclose(params[3 * N_ITERS // 4:].numpy(),
                                   np.asarray(ref[1]), rtol=1e-9, atol=1e-12)
    else:
        assert params is None


def test_window_accum_rescales_by_min_log_norm():
    """Slots are filled in order and rescaled by exp(min - log_norm), as
    in the JAX package's ring buffer."""
    from viabel_tpu.optimizers import _WindowState
    from viabel_tpu.optimizers import _window_accum as j_accum
    from viabel_tpu_torch.optimizers import _window_accum as t_accum
    rng = np.random.default_rng(0)
    grads = torch.zeros(3, 4, dtype=torch.float64)
    lns = torch.zeros(3, dtype=torch.float64)
    state = _WindowState(jnp.zeros((3, 4)), jnp.zeros(3))
    for i in range(7):
        g, ln = rng.normal(size=4), rng.normal()
        state, want = j_accum(state, i, jnp.asarray(g), ln, 3)
        got = t_accum(grads, lns, i, torch.as_tensor(g),
                      torch.tensor(ln, dtype=torch.float64))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def test_adagrad_optimize_public_path_on_cpu():
    fam = pt.mean_field_gaussian_variational_family(10)
    obj = pt.black_box_klvi(fam, tcp(), 10, presampled=True)
    g = torch.Generator().manual_seed(0)
    opt, hist, values, log_norms = pt.adagrad_optimize(
        40, obj, np.zeros(20), generator=g, learning_rate=0.05,
        device='cpu')
    assert opt.shape == (20,) and hist.shape == (10, 20)
    np.testing.assert_allclose(opt.numpy(), hist.mean(0).numpy(), rtol=1e-12)
    assert values.shape == (40,) and torch.isfinite(values).all()
    opt2, none, _, _ = pt.adagrad_optimize(
        40, obj, np.zeros(20), generator=torch.Generator().manual_seed(0),
        learning_rate=0.05, device='cpu', return_history=False)
    assert none is None and torch.equal(opt, opt2)
