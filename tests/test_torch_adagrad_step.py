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
from viabel_tpu_torch.ops import _launch
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


@pytest.mark.parametrize('n_steps', [3, WINDOW, WINDOW + 1, 3 * WINDOW + 4])
def test_step_plain_without_log_norm_matches_zeros_and_jax(jx, n_steps):
    """``log_norm=None`` (an objective without one, as the adagrad drivers
    now pass it) against the same steps fed a log-norm of zeros, bit for
    bit in every field of the state, and against the JAX package's
    `_make_adagrad_step` fed zero log-norms."""
    _, jnp, _, jopt, _ = jx
    n_iters, P = 40, 6
    grads, values, zeros = _step_inputs(n_steps, False, P)

    def fake_obj(param, k):
        return values[k], jnp.asarray(grads)[k], zeros[k]

    jstep = jopt._make_adagrad_step(fake_obj, n_iters, WINDOW, LR, EPS,
                                    LR_END, jnp.float64)
    carry = (jnp.zeros(P), jopt._WindowState(jnp.zeros((WINDOW, P)),
                                             jnp.zeros(WINDOW)))
    lr = _learning_rates(n_iters, LR, LR_END, torch.float64)
    states = [aops.new_state(torch.zeros(P, dtype=torch.float64), lr, WINDOW,
                             EPS, True) for _ in range(2)]
    for i in range(n_steps):
        carry, (_, _, param) = jstep(carry, (i, i))
        grad = torch.as_tensor(grads[i])
        value = torch.tensor(values[i], dtype=torch.float64)
        aops.adagrad_step_plain(states[0], grad, value, None)
        aops.adagrad_step_plain(states[1], grad, value,
                                torch.zeros((), dtype=torch.float64))
        np.testing.assert_allclose(states[0].param.numpy(), np.asarray(param),
                                   rtol=1e-12, atol=1e-15)
    for key in ('param', 'grads', 'ring_log_norms', 'counter', 'values',
                'log_norms', 'params', 'tail_sum'):
        got, want = getattr(states[0], key), getattr(states[1], key)
        if key in ('values', 'log_norms', 'params'):
            got, want = got[:n_steps], want[:n_steps]
        assert torch.equal(got, want), key
    np.testing.assert_array_equal(states[0].log_norms[:n_steps].numpy(), 0.0)
    np.testing.assert_allclose(states[0].grads.numpy(),
                               np.asarray(carry[1].grads), rtol=0)


def _covered_columns(shape, K, P):
    """How often the kernel's column mapping under `shape` (the
    `LaunchShape` docstring's rule) reaches each column of each run."""
    blocks = np.arange(shape.grid)
    runs, ranks = blocks // shape.cluster, blocks % shape.cluster
    first = ranks[:, None] * shape.threads + np.arange(shape.threads)[None]
    seen = np.zeros((K, P), np.int64)
    stride = shape.cluster * shape.threads
    for j in range(-(-P // stride)):
        cols = first + j * stride
        ok = cols < P
        np.add.at(seen, (np.broadcast_to(runs[:, None], cols.shape)[ok],
                         cols[ok]), 1)
    return seen


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('K', [1, 2, 16])
def test_launch_shape_covers_every_column_once(K, dtype):
    """`launch_shape` over P from 1 to the d = 300 family's 45450 and
    windows 7, 10 and 40: every column of every run is one thread's, once;
    blocks hold whole warps of at most 512 threads; one block a run up to
    a block's share of a ring row and a cluster of 2-16 blocks above it
    (more than 8 only as non-portable); the unrolled instance exactly at
    window 10."""
    share = aops.BLOCK_BYTES // torch.empty((), dtype=dtype).element_size()
    for P in (1, 4, 20, 31, 32, 33, share - 1, share, share + 1, 1000,
              4 * share + 1, 5150, 45450):
        for window in (7, 10, 40):
            shape = aops.launch_shape(K, P, window, dtype)
            assert shape.unrolled == (window == 10)
            assert shape.threads % 32 == 0 and 32 <= shape.threads <= 512
            assert shape.grid == K * shape.cluster
            if P <= share:
                assert shape.cluster == 1 and shape.threads >= P
            else:
                assert shape.threads == share and 2 <= shape.cluster <= 16
                assert shape.cluster & (shape.cluster - 1) == 0
                assert shape.nonportable == (shape.cluster > 8)
                assert shape.cluster == min(16, 1 << (-(-P // share) - 1)
                                            .bit_length())
            seen = _covered_columns(shape, K, P)
            assert (seen == 1).all(), (K, P, window, shape)
    assert aops.launch_shape(1, 45450, 10, dtype).cluster == 16
    assert aops.launch_shape(1, share + 1, 10, dtype).cluster == 2


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
    before = dict(_launch.launches)
    fresh = state._replace(counter=torch.zeros(1, dtype=torch.int64))
    aops.adagrad_step(fresh, torch.zeros(P, dtype=torch.float64),
                      torch.tensor(0.0, dtype=torch.float64),
                      torch.tensor(0.0, dtype=torch.float64))
    assert _launch.launches == before  # the plain version launches nothing


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


@pytest.mark.parametrize('n_iters', [7, 53])
def test_batched_klvi_runs_match_jax(jx, n_iters):
    """`_adagrad_runs` of a KLVI objective (no log-norm: the batched body
    passes None to the step) against the JAX package's `_adagrad_run` of
    each run on its draws, rate and init, float64, rtol 1e-9; the
    log-norm history is zeros."""
    jax, jnp, _, jopt, _ = jx
    n_mc, K = 12, 3
    draws = np.random.default_rng(30 + n_iters).standard_t(
        40, size=(K, n_iters, n_mc, 10))
    inits = 0.1 * np.random.default_rng(31).normal(size=(K, 20))
    rates = [(0.05, 0.005), (0.02, None), (0.1, 0.01)]
    _, tobj = _objectives(jx, 'KLVI', n_mc)
    lr = torch.stack([_learning_rates(n_iters, a, b, torch.float64)
                      for a, b in rates])
    values, log_norms, params, tail = optimizers._adagrad_runs(
        tobj, None, n_iters, WINDOW, lr, EPS, torch.as_tensor(inits),
        torch.as_tensor(draws), keep_history=True)
    np.testing.assert_array_equal(log_norms.numpy(), 0.0)
    for k, (a, b) in enumerate(rates):
        # an objective a run: the JAX run is compiled once an objective
        jobj = _objectives(jx, 'KLVI', n_mc)[0]
        jobj.make_draws = lambda key, n, dtype, k=k: jnp.asarray(draws[k],
                                                                 dtype)
        want = jopt._adagrad_run(jopt._wrap_objective(jobj, None), n_iters,
                                 WINDOW, a, EPS, b, jnp.asarray(inits[k]),
                                 jax.random.PRNGKey(0), unroll=1,
                                 keep_history=True)
        np.testing.assert_allclose(values[k].numpy(), np.asarray(want[0]),
                                   rtol=1e-9)
        np.testing.assert_allclose(params[k].numpy(), np.asarray(want[2]),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tail[k].numpy(), np.asarray(want[-1]),
                                   rtol=1e-9, atol=1e-12)


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


@pytest.mark.parametrize('with_log_norms', [False, True])
def test_batched_step_plain_matches_independent_jax_steps(jx,
                                                          with_log_norms):
    """K = 3 runs in one batched state, each with its own learning-rate
    table (its own rate and end), against three independent runs of the
    JAX package's `_make_adagrad_step` fed each run's gradients, values
    and log-norms; 3 windows and a bit, so every run's ring wraps."""
    _, jnp, _, jopt, _ = jx
    n_iters, P, K = 40, 5, 3
    n_steps = 3 * WINDOW + 4
    rates = [(0.05, 0.005), (0.01, None), (0.2, 0.01)]
    inputs = [_step_inputs(n_steps, with_log_norms, P, seed=10 + k)
              for k in range(K)]
    lr = torch.stack([_learning_rates(n_iters, a, b, torch.float64)
                      for a, b in rates])
    init = torch.as_tensor(np.random.default_rng(2).normal(size=(K, P)))
    state = aops.new_state(init, lr, WINDOW, EPS, True)
    assert state.counter.shape == (K,) and state.grads.shape == (K, WINDOW,
                                                                 P)
    for i in range(n_steps):
        aops.adagrad_step_plain(
            state, *[torch.as_tensor(np.stack([inp[j][i] for inp in inputs]))
                     for j in range(3)])
    for k, (a, b) in enumerate(rates):
        grads, values, log_norms = inputs[k]

        def fake_obj(param, i, grads=grads, values=values,
                     log_norms=log_norms):
            return values[i], jnp.asarray(grads)[i], log_norms[i]

        jstep = jopt._make_adagrad_step(fake_obj, n_iters, WINDOW, a, EPS, b,
                                        jnp.float64)
        carry = (jnp.asarray(init[k].numpy()),
                 jopt._WindowState(jnp.zeros((WINDOW, P)),
                                   jnp.zeros(WINDOW)))
        for i in range(n_steps):
            carry, (value, log_norm, param) = jstep(carry, (i, i))
            np.testing.assert_allclose(state.params[k, i].numpy(),
                                       np.asarray(param), rtol=1e-12,
                                       atol=1e-15)
        np.testing.assert_allclose(state.param[k].numpy(),
                                   np.asarray(carry[0]), rtol=1e-12)
        np.testing.assert_allclose(state.grads[k].numpy(),
                                   np.asarray(carry[1].grads), rtol=0)
        np.testing.assert_array_equal(state.values[k, :n_steps].numpy(),
                                      values)
    assert state.counter.tolist() == [n_steps] * K


@pytest.mark.parametrize('method', ['KLVI', 'CHIVI'])
def test_batched_run_equals_independent_runs(jx, method):
    """`_adagrad_runs` (vmapped objective, one batched step an iteration)
    against K single `_adagrad_run`s on the same per-run draws and
    schedules, 1e-12 relative."""
    n_iters, n_mc, K = 23, 8, 3
    _, tobj = _objectives(jx, method, n_mc)
    draws = torch.as_tensor(np.random.default_rng(4).standard_t(
        40, size=(K, n_iters, n_mc, 10)))
    inits = torch.as_tensor(0.1 * np.random.default_rng(5).normal(
        size=(K, 20)))
    rates = [(0.05, 0.005), (0.02, None), (0.1, 0.01)]
    lr = torch.stack([_learning_rates(n_iters, a, b, torch.float64)
                      for a, b in rates])
    values, log_norms, params, tail = optimizers._adagrad_runs(
        tobj, None, n_iters, WINDOW, lr, EPS, inits, draws,
        keep_history=True)
    for k, (a, b) in enumerate(rates):
        want = _adagrad_run(_wrap_objective(tobj, None), n_iters, WINDOW, a,
                            EPS, b, inits[k], draws[k])
        for got, w in zip((values[k], log_norms[k], params[k], tail[k]),
                          want):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-12,
                                       atol=1e-14)


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
    before = _launch.launches['adagrad_step']
    for i in range(n_steps):
        args = [torch.as_tensor(a, dtype=dtype, device=cuda)
                for a in (grads[i], values[i], log_norms[i])]
        aops.adagrad_step(states[0], *args)
        aops.adagrad_step_plain(states[1], *args)
    assert _launch.launches['adagrad_step'] == before + n_steps
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
    monkeypatch.setattr(optimizers, '_FUSED_GRAPH_ITERS', depth)
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
        _launch.reset_launches()
        outs[driver] = _adagrad_run(_wrap_objective(obj, None), n_iters,
                                    WINDOW, LR, EPS, LR_END, init, draws,
                                    keep_history=True, driver=driver)
        assert _launch.launches['adagrad_step'] == n_iters
        assert _launch.replayed['adagrad_step'] == (
            n_iters - WINDOW if driver == 'graph' else 0)
    for got, want in zip(outs['graph'], outs['eager']):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-10, atol=1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize('K,P', [(1, 4), (4, 4), (16, 4), (1, 5150),
                                 (4, 5150), (16, 5150)])
def test_batched_step_kernel_matches_plain(cuda, K, P):
    """The step kernel with one block a run against its plain version,
    float64, 1e-12 relative: K runs, each with its own learning-rate
    table, gradients, values and log-norms, past the ring's wrap."""
    n_steps = 2 * WINDOW + 3
    rng = np.random.default_rng(K * P)
    lr = torch.stack([_learning_rates(n_steps, a, a / 10, torch.float64)
                      for a in np.geomspace(0.01, 0.1, K)]).to(cuda)
    init = torch.as_tensor(rng.normal(size=(K, P)), device=cuda)
    states = [aops.new_state(init, lr, WINDOW, EPS, True) for _ in range(2)]
    for i in range(n_steps):
        args = [torch.as_tensor(a, device=cuda) for a in (
            rng.normal(size=(K, P)), rng.normal(size=K),
            3.0 * rng.normal(size=K))]
        aops.adagrad_step(states[0], *args)
        aops.adagrad_step_plain(states[1], *args)
    for key in ('param', 'values', 'log_norms', 'params', 'tail_sum',
                'grads', 'ring_log_norms', 'counter'):
        np.testing.assert_allclose(
            getattr(states[0], key).cpu().double().numpy(),
            getattr(states[1], key).cpu().double().numpy(), rtol=1e-12,
            atol=1e-15, err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize('method', ['KLVI', 'CHIVI'])
def test_batched_graph_run_matches_eager_run(cuda, method):
    """The batched run replayed from a graph against the eager loop of the
    same body, float64, 1e-10 relative; the step launches once an
    iteration."""
    n_iters, n_mc, K = WINDOW + 12, 20, 4
    fam = pt.mean_field_t_variational_family(10, 40)
    if method == 'KLVI':
        obj = pt.black_box_klvi(fam, tcp(), n_mc, presampled=True)
    else:
        obj = pt.black_box_chivi(2, fam, tcp(), n_mc, presampled=True)
    g = torch.Generator(device=cuda).manual_seed(3)
    draws = obj.make_draws(g, K * n_iters, torch.float64).reshape(
        K, n_iters, n_mc, 10)
    inits = 0.1 * torch.randn(K, 20, dtype=torch.float64, device=cuda,
                              generator=g)
    lr = _learning_rates(n_iters, LR, LR_END, torch.float64).repeat(K, 1)
    outs = {}
    for driver in ('graph', 'eager'):
        _launch.reset_launches()
        outs[driver] = optimizers._adagrad_runs(
            obj, None, n_iters, WINDOW, lr, EPS, inits, draws,
            keep_history=True, driver=driver)
        assert _launch.launches['adagrad_step'] == n_iters
    for got, want in zip(outs['graph'], outs['eager']):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-10, atol=1e-300)


def _kernel_against_plain(cuda, dtype, K, P, window, with_log_norms=True,
                          seed=0):
    """Two copies of a K-run state, one stepped by the kernel and one by
    its plain version on the same inputs, past the ring's wrap; returns
    both."""
    n_steps = 2 * window + 3
    rng = np.random.default_rng(seed)
    lr = torch.stack([_learning_rates(n_steps, a, a / 10, dtype)
                      for a in np.geomspace(0.01, 0.1, K)]).to(cuda)
    init = torch.as_tensor(rng.normal(size=(K, P)), dtype=dtype, device=cuda)
    states = [aops.new_state(init, lr, window, EPS, True) for _ in range(2)]
    for _ in range(n_steps):
        grad, value, log_norm = [
            torch.as_tensor(a, dtype=dtype, device=cuda) for a in (
                rng.normal(size=(K, P)), rng.normal(size=K),
                3.0 * rng.normal(size=K))]
        if not with_log_norms:
            log_norm = None
        aops.adagrad_step(states[0], grad, value, log_norm)
        aops.adagrad_step_plain(states[1], grad, value, log_norm)
    return states


def _assert_states_close(states, dtype):
    """The kernel's state against the plain version's: float64 to 1e-12
    relative and 1e-15 absolute, float32 to 2e-5 relative plus 8 ulps of
    the largest value (chip_smoke.py's rule: the two sum the ring in
    another order, and a parameter or tail sum near zero keeps the error
    of its O(1) terms)."""
    rtol = 1e-12 if dtype == torch.float64 else 2e-5
    for key in ('param', 'values', 'log_norms', 'params', 'tail_sum',
                'grads', 'ring_log_norms', 'counter'):
        want = getattr(states[1], key).cpu().double().numpy()
        atol = (1e-15 if dtype == torch.float64 else
                8 * torch.finfo(dtype).eps * float(np.abs(want).max()))
        np.testing.assert_allclose(
            getattr(states[0], key).cpu().double().numpy(), want, rtol=rtol,
            atol=atol, err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('K,P,window', [
    (1, 45450, WINDOW), (2, 5150, WINDOW), (1, 20, 7), (2, 5150, 7),
    (3, 'share', WINDOW), (3, 'share + 1', WINDOW)])
def test_step_kernel_instances_match_plain(cuda, dtype, K, P, window):
    """Every instance of `launch_shape` against the plain version: the
    d = 300 family's P = 45450 and two clusters at P = 5150 (two runs),
    the runtime window (7) on one block and on clusters, and the P on each
    side of the one-block / cluster switch."""
    share = aops.BLOCK_BYTES // torch.empty((), dtype=dtype).element_size()
    P = {'share': share, 'share + 1': share + 1}.get(P, P)
    shape = aops.launch_shape(K, P, window, dtype)
    assert shape.unrolled == (window == WINDOW)
    assert (shape.cluster > 1) == (P > share)
    _assert_states_close(_kernel_against_plain(cuda, dtype, K, P, window),
                         dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('K,P', [(1, 20), (16, 4), (1, 5150)])
def test_step_kernel_without_log_norm(cuda, dtype, K, P):
    """``log_norm=None`` launches with no log-norm and matches the plain
    version, and equals the kernel fed zeros bit for bit."""
    _assert_states_close(_kernel_against_plain(cuda, dtype, K, P, WINDOW,
                                               False), dtype)
    n_steps = 2 * WINDOW + 3
    rng = np.random.default_rng(P)
    lr = torch.full((K, n_steps), 0.05, dtype=dtype, device=cuda)
    init = torch.as_tensor(rng.normal(size=(K, P)), dtype=dtype, device=cuda)
    states = [aops.new_state(init, lr, WINDOW, EPS, True) for _ in range(2)]
    for _ in range(n_steps):
        grad = torch.as_tensor(rng.normal(size=(K, P)), dtype=dtype,
                               device=cuda)
        value = torch.as_tensor(rng.normal(size=K), dtype=dtype, device=cuda)
        aops.adagrad_step(states[0], grad, value, None)
        aops.adagrad_step(states[1], grad, value, torch.zeros_like(value))
    for key in ('param', 'values', 'log_norms', 'params', 'tail_sum',
                'grads', 'ring_log_norms', 'counter'):
        assert torch.equal(getattr(states[0], key), getattr(states[1], key))


@pytest.mark.cuda
def test_refused_step_launch_raises(cuda, monkeypatch):
    """A launch the library refuses (here a cluster of 32 blocks) raises;
    nothing falls back to another instance or to the plain version."""
    state = aops.new_state(torch.zeros(1, 5150, device=cuda),
                           torch.full((1, 4), 0.1, device=cuda), WINDOW, EPS,
                           False)
    monkeypatch.setattr(aops, 'launch_shape',
                        lambda *a: aops.LaunchShape(True, 512, 32, 32))
    before = int(state.counter[0])
    with pytest.raises(RuntimeError, match='launch'):
        aops.adagrad_step(state, torch.zeros(1, 5150, device=cuda),
                          torch.zeros(1, device=cuda), None)
    assert int(state.counter[0]) == before


@pytest.mark.cuda
def test_cluster_graph_run_matches_eager_run(cuda):
    """A run whose step is a cluster instance (a full-rank Gaussian at
    d = 40, P = 860: 4 blocks a run in float64) replayed from a graph
    against the eager loop, float64, 1e-10 relative."""
    from viabel_tpu_torch.models import (data_generator_linear,
                                         linear_regression_model)
    d, n_iters, n_mc = 40, WINDOW + 15, 20
    data = data_generator_linear(N=4 * d, D=d, alpha=1.0,
                                 noise_variance=0.25, rho=0.5, seed=7)
    model = linear_regression_model(data['X'], data['Y'], noise_scale=0.5,
                                    prior_std=3.0)
    fam = pt.full_rank_gaussian_variational_family(d)
    assert aops.launch_shape(1, fam.var_param_dim, WINDOW,
                             torch.float64).cluster == 4
    obj = pt.black_box_klvi(fam, model, n_mc, presampled=True)
    g = torch.Generator(device=cuda).manual_seed(3)
    draws = obj.make_draws(g, n_iters, torch.float64)
    init = pt.init_from_moments(fam, np.zeros(d), 9.0 * np.eye(d)).to(
        cuda, torch.float64)
    outs = {}
    for driver in ('graph', 'eager'):
        _launch.reset_launches()
        outs[driver] = _adagrad_run(_wrap_objective(obj, None), n_iters,
                                    WINDOW, LR, EPS, LR_END, init, draws,
                                    keep_history=True, driver=driver)
        assert _launch.launches['adagrad_step'] == n_iters
    for got, want in zip(outs['graph'], outs['eager']):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-10, atol=1e-300)
