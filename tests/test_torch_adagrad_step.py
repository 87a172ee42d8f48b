"""The windowed-adagrad step kernel's plain version and the state-based
adagrad run against viabel_tpu.optimizers, float64; and, on the card, the
kernel against its plain version and the replayed graph against the eager
loop.

The JAX package is imported inside the fixture that uses it, so that the
card tests run where only PyTorch is installed
(``python -m pytest tests/test_torch_adagrad_step.py -q --noconftest``).
The CPU tests feed both packages the same numpy-made gradients, values,
log-norms or base draws; trajectories compare at rtol 1e-12 for one step
sequence and 1e-9 for whole runs (the tolerance of the port's other
adagrad parity tests), the card's float64 graph against its eager loop at
1e-10 relative, and the kernel against its plain version at 1e-12 in
float64 and 2e-5 in float32.
"""
import numpy as np
import pytest
import torch

import viabel_tpu_torch as pt
from viabel_tpu_torch import optimizers
from viabel_tpu_torch.models import eight_schools_cp_model as tcp
from viabel_tpu_torch.ops import adagrad as aops
from viabel_tpu_torch.optimizers import (_adagrad_run, _learning_rates,
                                         _wrap_objective)

WINDOW = 10
LR, LR_END, EPS = 0.05, 0.005, 0.1


@pytest.fixture(scope='module')
def jx():
    """The JAX package's optimizers and families, on the CPU at x64."""
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    import viabel_tpu as vt
    from viabel_tpu import optimizers
    from viabel_tpu.models import eight_schools_cp_model
    return jax, jnp, vt, optimizers, eight_schools_cp_model


def _step_inputs(n_steps, with_log_norms, P=6, seed=0):
    rng = np.random.default_rng(seed)
    grads = rng.normal(size=(n_steps, P)) * rng.uniform(0.1, 3.0, (n_steps, 1))
    values = rng.normal(size=n_steps)
    log_norms = (rng.normal(size=n_steps) * 3.0 if with_log_norms
                 else np.zeros(n_steps))
    return grads, values, log_norms


@pytest.mark.parametrize('with_log_norms', [False, True])
@pytest.mark.parametrize('n_steps', [3, WINDOW, WINDOW + 1, 3 * WINDOW + 4])
def test_step_plain_matches_jax_step(jx, n_steps, with_log_norms):
    """Steps i < window, i = window - 1 (the ring just full) and i >= window
    (the ring wrapped): the plain step on the device-side state against the
    JAX package's `_make_adagrad_step` (its `_window_accum` and update)
    fed the same gradients, values and log-norms, with the learning-rate
    schedule of a 40-iteration run."""
    _, jnp, _, jopt, _ = jx
    n_iters, P = 40, 6
    grads, values, log_norms = _step_inputs(n_steps, with_log_norms, P)

    def fake_obj(param, k):
        return values[k], jnp.asarray(grads)[k], log_norms[k]

    jstep = jopt._make_adagrad_step(fake_obj, n_iters, WINDOW, LR, EPS,
                                    LR_END, jnp.float64)
    carry = (jnp.zeros(P), jopt._WindowState(jnp.zeros((WINDOW, P)),
                                             jnp.zeros(WINDOW)))
    state = aops.new_state(
        torch.zeros(P, dtype=torch.float64),
        _learning_rates(n_iters, LR, LR_END, torch.float64), WINDOW, EPS,
        True)
    for i in range(n_steps):
        carry, (value, log_norm, param) = jstep(carry, (i, i))
        aops.adagrad_step_plain(
            state, torch.as_tensor(grads[i]),
            torch.tensor(values[i], dtype=torch.float64),
            torch.tensor(log_norms[i], dtype=torch.float64))
        np.testing.assert_allclose(state.param.numpy(), np.asarray(param),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(state.params[i].numpy(), np.asarray(param),
                                   rtol=1e-12, atol=1e-15)
    assert int(state.counter) == n_steps
    np.testing.assert_array_equal(state.values[:n_steps].numpy(), values)
    np.testing.assert_array_equal(state.log_norms[:n_steps].numpy(),
                                  log_norms)
    np.testing.assert_allclose(state.grads.numpy(),
                               np.asarray(carry[1].grads), rtol=0)
    np.testing.assert_allclose(state.ring_log_norms.numpy(),
                               np.asarray(carry[1].log_norms), rtol=0)


def test_step_adds_the_tail_from_its_start_and_checks_its_inputs():
    P, n_iters = 3, 8
    state = aops.new_state(torch.zeros(P, dtype=torch.float64),
                           torch.full((n_iters,), 0.1, dtype=torch.float64),
                           4, EPS, False)
    assert state.tail_start == 6 and state.params is None
    grads, values, log_norms = _step_inputs(n_iters, True, P, seed=1)
    seen = []
    for i in range(n_iters):
        aops.adagrad_step_plain(
            state, torch.as_tensor(grads[i]),
            torch.tensor(values[i], dtype=torch.float64),
            torch.tensor(log_norms[i], dtype=torch.float64))
        seen.append(state.param.clone())
    np.testing.assert_allclose(state.tail_sum.numpy(),
                               (seen[6] + seen[7]).numpy(), rtol=1e-15)
    with pytest.raises(TypeError):  # dtypes must agree
        aops.adagrad_step(state, torch.zeros(P), torch.tensor(0.0),
                          torch.tensor(0.0))
    with pytest.raises(ValueError):  # and shapes
        aops.adagrad_step(state, torch.zeros(P + 1, dtype=torch.float64),
                          torch.tensor(0.0, dtype=torch.float64),
                          torch.tensor(0.0, dtype=torch.float64))
    before = dict(aops.launches)
    fresh = state._replace(counter=torch.zeros(1, dtype=torch.int64))
    aops.adagrad_step(fresh, torch.zeros(P, dtype=torch.float64),
                      torch.tensor(0.0, dtype=torch.float64),
                      torch.tensor(0.0, dtype=torch.float64))
    assert aops.launches == before  # the plain version launches nothing


def _objectives(jx, method, n_mc):
    """The JAX and the port's presampled objective of `method` on
    eight-schools CP with a mean-field Student-t(40) family."""
    _, _, vt, _, jcp = jx
    jf = vt.mean_field_t_variational_family(10, 40)
    tf = pt.mean_field_t_variational_family(10, 40)
    if method == 'KLVI':
        return (vt.black_box_klvi(jf, jcp().log_prob, n_mc, presampled=True),
                pt.black_box_klvi(tf, tcp(), n_mc, presampled=True))
    return (vt.black_box_chivi(2, jf, jcp().log_prob, n_mc, presampled=True),
            pt.black_box_chivi(2, tf, tcp(), n_mc, presampled=True))


@pytest.mark.parametrize('keep_history', [True, False])
@pytest.mark.parametrize('n_iters', [7, 53])
@pytest.mark.parametrize('method', ['KLVI', 'CHIVI'])
def test_adagrad_run_matches_jax(jx, method, n_iters, keep_history):
    """The whole run on shared draws (numpy): fewer iterations than the
    window, and a count that is no multiple of it, whose tail quarter
    starts inside a window (iteration 39 of 53)."""
    jax, jnp, _, jopt, _ = jx
    n_mc = 12
    draws = np.random.default_rng(n_iters).standard_t(
        40, size=(n_iters, n_mc, 10))
    jobj, tobj = _objectives(jx, method, n_mc)
    jobj.make_draws = lambda key, n, dtype: jnp.asarray(draws, dtype)
    init = 0.1 * np.random.default_rng(1).normal(size=20)
    want = jopt._adagrad_run(jopt._wrap_objective(jobj, None), n_iters,
                             WINDOW, LR, EPS, LR_END, jnp.asarray(init),
                             jax.random.PRNGKey(0), unroll=1,
                             keep_history=keep_history)
    values, log_norms, params, tail_mean = _adagrad_run(
        _wrap_objective(tobj, None), n_iters, WINDOW, LR, EPS, LR_END,
        torch.as_tensor(init), torch.as_tensor(draws),
        keep_history=keep_history)
    np.testing.assert_allclose(values.numpy(), np.asarray(want[0]),
                               rtol=1e-9)
    np.testing.assert_allclose(log_norms.numpy(), np.asarray(want[1]),
                               rtol=1e-9)
    np.testing.assert_allclose(tail_mean.numpy(), np.asarray(want[-1]),
                               rtol=1e-9, atol=1e-12)
    if keep_history:
        np.testing.assert_allclose(params.numpy(), np.asarray(want[2]),
                                   rtol=1e-9, atol=1e-12)
    else:
        assert params is None
    if method == 'KLVI':
        np.testing.assert_array_equal(log_norms.numpy(), 0.0)


def test_adagrad_run_drivers_are_chosen_by_objective_and_device():
    """On the CPU every run is eager; the graph driver is refused there
    and for an objective that samples from a generator."""
    fam = pt.mean_field_gaussian_variational_family(10)
    keyed = pt.black_box_klvi(fam, tcp(), 5)
    init = torch.zeros(20, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    out = _adagrad_run(_wrap_objective(keyed, None), 12, WINDOW, LR, EPS,
                       None, init, gen)
    assert torch.isfinite(out[0]).all() and out[2].shape == (12, 20)
    for obj, source in ((keyed, gen),
                        (pt.black_box_klvi(fam, tcp(), 5, presampled=True),
                         torch.zeros(12, 5, 10, dtype=torch.float64))):
        with pytest.raises(ValueError, match='graph'):
            _adagrad_run(_wrap_objective(obj, None), 12, WINDOW, LR, EPS,
                         None, init, source, driver='graph')


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('with_log_norms', [False, True])
def test_step_kernel_matches_plain(cuda, dtype, with_log_norms):
    n_steps, P = 3 * WINDOW + 4, 22
    grads, values, log_norms = _step_inputs(n_steps, with_log_norms, P)
    lr = _learning_rates(n_steps, LR, LR_END, dtype)
    states = [aops.new_state(torch.zeros(P, dtype=dtype, device=cuda), lr,
                             WINDOW, EPS, True) for _ in range(2)]
    before = aops.launches['adagrad_step']
    for i in range(n_steps):
        args = [torch.as_tensor(a, dtype=dtype, device=cuda)
                for a in (grads[i], values[i], log_norms[i])]
        aops.adagrad_step(states[0], *args)
        aops.adagrad_step_plain(states[1], *args)
    assert aops.launches['adagrad_step'] == before + n_steps
    rtol = 1e-12 if dtype == torch.float64 else 2e-5
    for key in ('param', 'values', 'log_norms', 'params', 'tail_sum',
                'grads', 'ring_log_norms', 'counter'):
        np.testing.assert_allclose(
            getattr(states[0], key).cpu().double().numpy(),
            getattr(states[1], key).cpu().double().numpy(), rtol=rtol,
            atol=1e-3 * rtol, err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize('depth', [1, 4])
@pytest.mark.parametrize('method', ['KLVI', 'CHIVI'])
def test_graph_run_matches_eager_run(cuda, method, depth, monkeypatch):
    """The replayed graph against the eager loop of the same body, float64,
    on shared draws: the window's warm-up iterations, then graphs of
    `depth` iterations replayed three times and, at depth 4, a remainder
    of one-iteration graphs."""
    monkeypatch.setattr(optimizers, '_GRAPH_ITERS', depth)
    n_iters, n_mc = WINDOW + 3 * depth + 5, 20
    fam = pt.mean_field_t_variational_family(10, 40)
    if method == 'KLVI':
        obj = pt.black_box_klvi(fam, tcp(), n_mc, presampled=True)
    else:
        obj = pt.black_box_chivi(2, fam, tcp(), n_mc, presampled=True)
    g = torch.Generator(device=cuda).manual_seed(3)
    draws = obj.make_draws(g, n_iters, torch.float64)
    init = torch.zeros(20, dtype=torch.float64, device=cuda)
    outs = {}
    for driver in ('graph', 'eager'):
        aops.reset_launches()
        outs[driver] = _adagrad_run(_wrap_objective(obj, None), n_iters,
                                    WINDOW, LR, EPS, LR_END, init, draws,
                                    keep_history=True, driver=driver)
        assert aops.launches['adagrad_step'] == n_iters
        assert aops.replayed['adagrad_step'] == (
            n_iters - WINDOW if driver == 'graph' else 0)
    for got, want in zip(outs['graph'], outs['eager']):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-10, atol=1e-300)
